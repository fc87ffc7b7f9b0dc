"""quotient_s: seconds of round 4's quotient a proof, on the device's
clock of the traced window: from the marker the prover's round 3 end
enqueues to the one its "round4 quotient" line enqueues (the span the
`ProverConfig.log` round line times, without its sync). Mean over the
traced proofs. Layer: prover rounds (`protocol/prover_torch`)."""

from portbench.trace import mean_round_s

UNIT, LAYER, MOVES = "s", "prover rounds", "prove_s"


def read(run):
    if run.trace is None or not run.trace.marks:
        return None
    return mean_round_s(run.trace, "round4 quotient")
