"""Ways to break the timed path, for the control and the tests: each is a
hook that `window.py` calls in every proving process, as hook("setup")
before the set-up and hook("window") before the window, and each must
make the reference reject the run's proofs. A hook that patches returns
the function that undoes it, which `window.py` calls once its window is
over.

A system's control breaks a guarantee that its configuration states, so
it lives with the system: `systems/<system>.py` names it (`CONTROL`) among
its own hooks (`HOOKS`). The faults here fit every system:

  * `answer_altered`: each proof's first wire evaluation is one more than
    the prover computed, where the proof is produced;
  * `exchange_left_out`: on ranks, every `all_gather` of the sharded
    prover returns the rank's own part in each place (no exchange)."""

import importlib


def answer_altered(stage):
    if stage != "window":
        return
    from zprize_tpu_torch.params import R_MOD
    from zprize_tpu_torch.protocol import prover_torch
    orig = prover_torch.prove_torch

    def prove_torch(*args, **kwargs):
        proof = orig(*args, **kwargs)
        ev = proof.evaluations
        ev.a_eval = (ev.a_eval + 1) % R_MOD
        return proof
    prover_torch.prove_torch = prove_torch
    return lambda: setattr(prover_torch, "prove_torch", orig)


def exchange_left_out(stage):
    if stage != "window":
        return
    from zprize_tpu_torch.parallel import mesh

    orig = mesh._all_gather

    def all_gather(m, t):
        return [t] * m.size
    mesh._all_gather = all_gather
    return lambda: setattr(mesh, "_all_gather", orig)


HOOKS = {"answer_altered": answer_altered,
         "exchange_left_out": exchange_left_out}


def hooks(system):
    """Every hook a cell of `system` can be broken by, by name: the
    system's own, the ones above, and "control", the system's control."""
    mod = importlib.import_module("portbench.systems." + system)
    return dict(mod.HOOKS, **HOOKS, control=mod.HOOKS[mod.CONTROL])
