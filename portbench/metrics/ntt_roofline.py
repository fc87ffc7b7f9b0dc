"""ntt_roofline: the NTT layer's share of its roofline, in %: the least
time of every transform of the traced window (`roofline.transform_least_s`
of its length and columns: whole transforms, 32 bytes an Fr element,
the twiddle products at 224 issue slots each) over the device time of
the operations inside each outermost `ops/ntt.transform_last` call
(between its two markers; a call whose marker was dropped from the trace
counts on neither side). Coset scalings outside the call are not in
either. Layer: NTT and poly (`ops/ntt`) on the field kernels
(`csrc/kernels.cu`)."""

from portbench.roofline import transform_least_s
from portbench.trace import ops_within, spans

UNIT, LAYER, MOVES = "%", "NTT and poly", "prove_s"


def read(run):
    data = run.trace
    if data is None or not data.marks:
        return None
    least = device = 0.0
    for k, s, e in spans(data, "ntt", "ntt_end"):
        n, batch = data.transforms[k]
        least += transform_least_s(n, batch)[0]
        device += sum(b - a for _, a, b in ops_within(data, s, e))
    return 100.0 * least / device if device > 0 else None
