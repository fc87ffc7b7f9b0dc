"""The set-up of the Merkle configurations (`window.py` runs the window):
the port's `prove_torch` on one card, or on `ranks` cards as a sharded
prover (`ProverConfig(mesh=...)`).

Each device (or rank) builds the seeded set-up through the port's entry
points (`MerkleLayout`, `device_srs` with the run's tau,
`preprocess_layout`, `MerkleLayout.witness` of each witness's leaves from
`recipes/merkle.py`); ranks then keep only their columns (`shard`) and
drop the whole. Each proof starts from a clone of the key's seeded
transcript.

The control, `other_leaves`, breaks the guarantee the configuration
states: a proof of the witness's own leaves."""

from .. import inputs
from ..recipes import merkle as recipe

CONTROL = "other_leaves"


def setup(config, traffic, seed, dev, mesh):
    """`prove(k)`: the bytes of a proof of witness k (see `window.py`)."""
    from zprize_tpu_torch.params import R_MOD
    from zprize_tpu_torch.fields.mont import FR
    from zprize_tpu_torch.merkle.layout import MerkleLayout
    from zprize_tpu_torch.merkle.preprocess import preprocess_layout
    from zprize_tpu_torch.ops import ntt
    from zprize_tpu_torch.protocol import prover_torch as pt
    from zprize_tpu_torch.protocol.serde import serialize_proof
    from zprize_tpu_torch.protocol.srs import device_srs
    from zprize_tpu_torch.protocol.transcript_protocol import \
        TranscriptProtocol

    lay = MerkleLayout(config["height"], device=dev)
    pts, lite, _ = device_srs(lay.n + 8, tau=inputs.tau(seed), device=dev)
    dev_srs = pt.DevSRS(pts, lite)
    del pts
    base = TranscriptProtocol(recipe.LABEL)
    pk, _vk = preprocess_layout(lay, dev_srs, base, pt.ProverConfig(
        device=dev))
    witnesses = []
    for leaves in recipe.leaf_sets(seed, traffic["witnesses"],
                                   lay.m_leaves):
        wires, root, _ = lay.witness(FR.tensor(leaves, dev))
        witnesses.append(pt.ProverWitness(
            wires, {lay.root_gate_pos: (-root) % R_MOD}))
        del wires
    n = lay.n
    del lay, _vk
    if mesh is not None:
        pk = pk.shard(mesh)
        dev_srs = dev_srs.shard(mesh, n)
        witnesses = [w.shard(mesh) for w in witnesses]
        ntt.clear_caches()
        cfg = pt.ProverConfig(mesh=mesh)
    else:
        cfg = pt.ProverConfig(device=dev)

    def prove(k):
        return serialize_proof(pt.prove_torch(witnesses[k], pk, dev_srs,
                                              base.clone(), cfg))
    return prove


def other_leaves(stage):
    """The control: the program proves the tree of leaves whose first leaf
    is one more, a valid proof of another root."""
    if stage != "setup":
        return
    orig = recipe.leaf_sets

    def leaf_sets(seed, witnesses, m):
        sets = orig(seed, witnesses, m)
        return [[s[0] + 1] + s[1:] for s in sets]
    recipe.leaf_sets = leaf_sets
    return lambda: setattr(recipe, "leaf_sets", orig)


HOOKS = {"other_leaves": other_leaves}
