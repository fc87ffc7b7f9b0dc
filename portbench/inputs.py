"""The inputs every system shares, made from the run's seed, and the
order a traffic mix sends them in. The run hands them to the program and
the reference makes them again from the same seed: numpy and plain Python
only. A system's own inputs (the Merkle tree's leaves) are its recipe,
`recipes/<system>.py`, drawn from the streams `rng` gives.

  * tau, the SRS's secret: 32 random bytes mod r from the stream (seed,
    1), never 0;
  * the order and the arrivals: `Mix`, a traffic mix's parameters and,
    where the mix brings code of its own, `traffic/<name>.py`; without
    it, a closed loop over the mix's witnesses, round robin. `drive`
    runs a window of requests in that order."""

import importlib.util
import os
import time

import numpy as np

R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def rng(seed, *key):
    """The stream `key` of `seed`: (0, k) is witness k's, (1,) tau's."""
    # any whole number: SeedSequence takes non-negative entropy of any size
    return np.random.default_rng(np.random.SeedSequence(
        seed % (1 << 128), spawn_key=key))


def tau(seed):
    t = int.from_bytes(rng(seed, 1).bytes(32), "little") % R_MOD
    return t or 1


# the closed round robin: what a mix without code of its own does

def witness_at(params, i, seed):
    """The witness of the mix's i-th request."""
    if params["loop"] != "closed" or params["order"] != "round_robin":
        raise ValueError(f"no generator for {params['loop']} / "
                         f"{params['order']}: the mix needs a .py")
    return i % params["witnesses"]


def arrival_s(params, i, seed):
    """When the i-th request arrives, in seconds after the window's start;
    None: as soon as the one before it is done (a closed loop)."""
    return None


def more(params, i, elapsed_s, seconds):
    """Whether the window starts its i-th request, `elapsed_s` into a
    window of `seconds`: until the time is up (the one in flight
    finishes)."""
    return elapsed_s < seconds


HOOKS = ("witness_at", "arrival_s", "more")


class Mix:
    """A traffic mix: the parameters of `traffic/<name>.json` and, where
    the mix has one, the module `traffic/<name>.py`, which may define any
    of `HOOKS` with the signatures above; the others are the closed round
    robin's. It pickles (to spawned ranks) as its parameters and the
    module's path."""

    def __init__(self, name, params, code=None):
        self.name, self.params, self.code = name, params, code
        self._mod = None

    def __getitem__(self, key):
        return self.params[key]

    def __getstate__(self):
        return dict(self.__dict__, _mod=None)

    def _hook(self, name):
        if self.code is not None and self._mod is None:
            spec = importlib.util.spec_from_file_location(
                "portbench_traffic_" + self.name.replace("-", "_")
                .replace(".", "_"), self.code)
            self._mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(self._mod)
        return getattr(self._mod, name, None) or globals()[name]

    def witness_at(self, i, seed):
        return self._hook("witness_at")(self.params, i, seed)

    def arrival_s(self, i, seed):
        return self._hook("arrival_s")(self.params, i, seed)

    def more(self, i, elapsed_s, seconds):
        return self._hook("more")(self.params, i, elapsed_s, seconds)


def load_mix(folder, name):
    """The mix `name` of the folder `traffic/`."""
    import json
    with open(os.path.join(folder, name + ".json")) as f:
        params = json.load(f)
    code = os.path.join(folder, name + ".py")
    return Mix(name, params, code if os.path.exists(code) else None)


def drive(mix, seed, seconds, serve, agree=None):
    """Run a window: request i (its witness from the mix) waits for its
    arrival, then `serve(witness)` answers it; the window starts requests
    while `mix.more` says so, by the clock of the process that `agree`
    (when given: ranks) takes as every rank's. Returns (t0, requests): the
    window's start on `time.monotonic` and, for each request, (witness,
    arrival, start, end, answer), times in seconds after t0. The caller
    closes the window."""
    requests = []
    t0 = time.monotonic()
    i = 0
    while True:
        go = mix.more(i, time.monotonic() - t0, seconds)
        if agree is not None:
            go = agree(go)
        if not go:
            break
        k = mix.witness_at(i, seed)
        at = mix.arrival_s(i, seed)
        if at is not None:
            wait = t0 + at - time.monotonic()
            if wait > 0:
                time.sleep(wait)
        start = time.monotonic() - t0
        answer = serve(k)
        end = time.monotonic() - t0
        requests.append((k, start if at is None else at, start, end,
                         answer))
        i += 1
    return t0, requests
