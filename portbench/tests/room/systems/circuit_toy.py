"""The set-up of the toy general circuit (`recipes/circuit_toy.py`), a
system that only the tests add: the spec's host preprocess of its circuit
under an SRS of the run's tau, and the port's `prove_torch` of each
witness on one device.

The control, `other_values`, breaks the guarantee its configuration
states: a proof of the witness's own values."""

from .. import inputs
from ..recipes import circuit_toy as recipe

CONTROL = "other_values"


def setup(config, traffic, seed, dev, mesh):
    """`prove(k)`: the bytes of a proof of witness k (see `window.py`)."""
    from zprize_tpu_torch.circuit.composer import StandardComposer
    from zprize_tpu_torch.protocol import prover_torch as pt
    from zprize_tpu_torch.protocol.serde import serialize_proof
    from zprize_tpu_torch.protocol.transcript_protocol import \
        TranscriptProtocol
    from zprize_tpu_torch.ref import prover as rp
    from zprize_tpu_torch.ref.kzg import SRS

    circuits = [recipe.build(StandardComposer(), *v)
                for v in recipe.values(seed, traffic["witnesses"])]
    n = circuits[0].circuit_bound()
    srs = SRS.setup(n + 8, tau=inputs.tau(seed))
    base = TranscriptProtocol(recipe.LABEL)
    ref_pk, _vk = rp.preprocess(circuits[0], srs, base)
    pk = pt.DevProverKey.from_ref(ref_pk, dev)
    dev_srs = pt.DevSRS.from_ref(srs, dev)
    witnesses = [pt.ProverWitness.from_composer(cs, n, dev)
                 for cs in circuits]
    # a 2-bit window: the fewest point additions at n = 16
    cfg = pt.ProverConfig(device=dev, msm_window_bits=2)

    def prove(k):
        return serialize_proof(pt.prove_torch(witnesses[k], pk, dev_srs,
                                              base.clone(), cfg))
    return prove


def other_values(stage):
    """The control: the program proves (a + 1 mod 4, b) for (a, b)."""
    if stage != "setup":
        return
    orig = recipe.values

    def values(seed, witnesses):
        return [((a + 1) % 4, b) for a, b in orig(seed, witnesses)]
    recipe.values = values
    return lambda: setattr(recipe, "values", orig)


HOOKS = {"other_values": other_values}
