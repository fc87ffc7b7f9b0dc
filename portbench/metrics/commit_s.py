"""commit_s: seconds a proof inside `prover_torch.commit_batch`, on the
device's clock of the traced window: each call from the marker at its
entry (when the device reached it) to the one after its return (its
points are on the host by then): the mean call times the calls a proof
(a call whose marker was dropped from the trace is left out of the
mean). Layer: commitments (`ops/msm`)."""

from portbench.trace import spans

UNIT, LAYER, MOVES = "s", "commitments", "prove_s"


def read(run):
    if run.trace is None or not run.trace.marks:
        return None
    data = run.trace
    got = spans(data, "commit", "commit_end")
    if not got:
        return None
    calls = sum(label == "commit" for label, _ in data.marks)
    return sum(e - s for _, s, e in got) / len(got) * calls / data.proofs
