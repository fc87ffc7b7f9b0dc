"""Ways to break the timed path, for the control and the tests: each is a
hook that `systems/merkle.py` calls in every proving process, as
hook("setup") before the set-up and hook("window") before the window,
and each must make the reference reject the run's proofs. A hook that
patches returns the function that undoes it, which `systems/merkle.py` calls
once its window is over.

  * `other_leaves`, the control: the configuration guarantees a proof of
    the witness's own leaves; here the program proves the tree of leaves
    whose first leaf is one more, a valid proof of another root;
  * `answer_altered`: each proof's first wire evaluation is one more than
    the prover computed, where the proof is produced;
  * `exchange_left_out`: on ranks, every `all_gather` of the sharded
    prover returns the rank's own part in each place (no exchange)."""


def other_leaves(stage):
    if stage != "setup":
        return
    from portbench import inputs
    orig = inputs.leaf_sets

    def leaf_sets(seed, witnesses, m):
        sets = orig(seed, witnesses, m)
        return [[s[0] + 1] + s[1:] for s in sets]
    inputs.leaf_sets = leaf_sets
    return lambda: setattr(inputs, "leaf_sets", orig)


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


HOOKS = {"other_leaves": other_leaves, "answer_altered": answer_altered,
         "exchange_left_out": exchange_left_out}
