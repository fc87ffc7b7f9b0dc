"""idle_share: the share of the traced window in which the card ran
nothing, in %: 100 * (1 - busy / traced), over the traced proofs (each
from its "proof" mark to its "proof_end" mark), busy being the union of
the program's device intervals inside them (as
`zprize_tpu_torch/tools/timeline.py` and `chip_smoke.py` count it).
Layer: device."""

from portbench.trace import idle_share

UNIT, LAYER, MOVES = "%", "device", "prove_s"


def read(run):
    return None if run.trace is None else idle_share(run.trace)
