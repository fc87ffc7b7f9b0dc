"""mesh_prove_s: `prove_s` of the sharded prover, kept apart so that the
collectives' noise widens no other cell's bound. Its window runs from a
barrier of all ranks before the first proof to a barrier after the last
proof's bytes are on every rank's host, read on rank 0's clock."""

UNIT = "s"


def read(run):
    return run.window_s / run.proofs if run.proofs else None
