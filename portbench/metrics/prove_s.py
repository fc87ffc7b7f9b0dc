"""prove_s: the window's wall seconds over the proofs it completed, on one
card. The window runs from a synchronize before its first proof to the
last proof's bytes on the host, one proof at a time (`systems/merkle.py`)."""

UNIT = "s"


def read(run):
    return run.window_s / run.proofs if run.proofs else None
