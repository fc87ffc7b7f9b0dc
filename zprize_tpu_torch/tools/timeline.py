"""Where the device time of one prove goes, round by round, without the
profiler — the counterpart of `tools/profile_prove.py` and
`tools/attr_quotient.py`.

Two proves of the Merkle circuit on one set-up:
  1. a plain prove, synchronised once at the end of each round (the rounds
     `prover_torch._round_marker` names): each round's and each
     `commit_batch`'s wall seconds;
  2. the same prove with a CUDA event pair around every device operation:
     every PyTorch operator (a `TorchDispatchMode`) and every launch of a
     hand-written kernel (the ctypes library behind `fields/kernels.py`).
     The pairs' elapsed times, summed per round and per `commit_batch`, are
     the device's busy seconds there: the stream runs one operation at a
     time, and nothing else runs between the two events of a pair. A
     spacer kernel (`torch.cuda._sleep`, ~100 us) goes before each pair,
     so the card is still busy with it while the host enqueues the pair
     and the operation: a pair never times the host's launch latency.

Per round it reports wall s (prove 1), device s (prove 2) and the idle
share 1 - device / wall: the part of an unprofiled prove's wall time in
which the card ran nothing. Prove 2's own wall (spacers included) is
reported too. Prints one JSON line and writes no file.

Run: python3 -m zprize_tpu_torch.tools.timeline [--height 15]
"""

import argparse
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..fields import kernels
from ..protocol import prover_torch
from .cudatime import card, emit, require_cuda
from .merkle_setup import MerkleSetup


# ~100 us at the H100's 1.98 GHz: longer than the host takes to record an
# event and enqueue one operation
SPACER_CYCLES = 200_000


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _open():
    """The first event of a pair, behind a spacer kernel."""
    torch.cuda._sleep(SPACER_CYCLES)
    return _event()


class _Pairs(TorchDispatchMode):
    """An event pair around every non-view operator, tagged with the round
    and the `commit_batch` call it ran in."""

    def __init__(self, spans):
        super().__init__()
        self.spans = spans
        self.pairs = []

    def add(self, a, b):
        self.pairs.append((self.spans.round, self.spans.commit, a, b))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(func, "is_view", False):
            return func(*args, **(kwargs or {}))
        a = _open()
        out = func(*args, **(kwargs or {}))
        self.add(a, _event())
        return out


class _TimedLib:
    """The kernel library with an event pair around every launch."""

    def __init__(self, lib, pairs):
        self._lib, self._pairs = lib, pairs

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def launch(*args):
            a = _open()
            rc = fn(*args)
            self._pairs.add(a, _event())
            return rc
        return launch


class _Spans:
    """Round and commit boundaries of one prove on the host clock."""

    def __init__(self):
        self.round, self.commit = 0, None
        self.rounds, self.commits = [], []
        self.t0 = time.perf_counter()

    def log(self, line):
        # `prover_torch._round_marker` calls this after its sync:
        # "prove <label>: <seconds>s"
        now = time.perf_counter()
        start = self.rounds[-1]["end"] if self.rounds else self.t0
        self.rounds.append({"label": line[len("prove "):].rsplit(":", 1)[0],
                            "wall_s": now - start, "end": now})
        self.round += 1

    def wrap(self, commit_batch):
        def timed(dev_srs, polys, cfg):
            k = len(self.commits)
            self.commits.append({"round": self.round,
                                 "polys": int(polys.shape[1])})
            self.commit = k
            t0 = time.perf_counter()
            try:
                return commit_batch(dev_srs, polys, cfg)
            finally:
                self.commits[k]["wall_s"] = time.perf_counter() - t0
                self.commit = None
        return timed


def _prove(setup, instrument):
    """One prove; returns (spans, pairs or None)."""
    orig_commit = prover_torch.commit_batch
    lib = kernels.load_library()
    torch.cuda.synchronize()
    spans = _Spans()
    pairs = _Pairs(spans) if instrument else None
    prover_torch.commit_batch = spans.wrap(orig_commit)
    try:
        if instrument:
            kernels._LIB = _TimedLib(lib, pairs)
            with pairs:
                setup.prove(log=spans.log)
        else:
            setup.prove(log=spans.log)
    finally:
        prover_torch.commit_batch = orig_commit
        kernels._LIB = lib
    torch.cuda.synchronize()
    spans.wall_s = time.perf_counter() - spans.t0
    return spans, pairs


def measure(setup):
    """The timeline of one prove of `setup` (a `MerkleSetup`) -> dict.
    The process should have proved once already: the first prove builds
    the sub-coset tables."""
    require_cuda()
    plain, _ = _prove(setup, False)
    inst, pairs = _prove(setup, True)
    busy = [0.0] * (len(plain.rounds) + 1)
    ops = [0] * len(busy)
    commit_busy = [0.0] * len(plain.commits)
    for rnd, com, a, b in pairs.pairs:
        s = a.elapsed_time(b) * 1e-3
        busy[rnd] += s
        ops[rnd] += 1
        if com is not None:
            commit_busy[com] += s
    rounds = []
    for i, r in enumerate(plain.rounds):
        rounds.append({"round": r["label"], "wall_s": r["wall_s"],
                       "device_s": busy[i],
                       "idle_share": max(0.0, 1 - busy[i] / r["wall_s"]),
                       "device_ops": ops[i]})
    commits = [{"round": plain.rounds[c["round"]]["label"],
                "polys": c["polys"], "wall_s": c["wall_s"],
                "device_s": commit_busy[i]}
               for i, c in enumerate(plain.commits)]
    device_s = sum(busy)
    return {"card": card(), "height": setup.lay.height, "n": setup.lay.n,
            "wall_s": plain.wall_s, "device_s": device_s,
            "idle_share": max(0.0, 1 - device_s / plain.wall_s),
            "wall_s_instrumented": inst.wall_s,
            "device_ops": sum(ops), "rounds": rounds, "commits": commits}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=15)
    args = ap.parse_args()
    require_cuda()
    setup = MerkleSetup.build(args.height)
    setup.prove()
    emit({"timeline": measure(setup)})
