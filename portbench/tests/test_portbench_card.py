"""Card-only checks of the traced window's machinery (`portbench/trace.py`):
every mark timed by its marker kernel in the profile, and spans read on
the device's clock around the work enqueued inside them. They skip
without a CUDA device.

Run on the card: python3 -m pytest portbench/tests/test_portbench_card.py"""

import pytest

from portbench.trace import Tracer, spans, union_s


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_markers_match_their_labels_and_bracket_the_work(card):
    import torch
    tracer = Tracer()
    tracer.find_marker_name()
    x = torch.ones(1 << 24, device=card)
    torch.cuda.synchronize()
    with tracer.profiler() as prof:
        y = x * 2.0                      # before the proof: not read
        tracer.mark("proof")
        for _ in range(3):
            tracer.mark("commit")
            x = x * 1.0001 + 1.0
            tracer.mark("commit_end")
        tracer.mark("proof_end")
        y = y * 2.0                      # after it: not read
        torch.cuda.synchronize()
    data = tracer.reduce(prof, 1.0, 1)
    assert "8 marker kernels for 8 marks, 8 marks timed" in data.notes
    assert [label for label, _ in data.marks] == \
        ["proof"] + ["commit", "commit_end"] * 3 + ["proof_end"]
    assert data.traced_proofs == 1
    (a, b), = data.windows
    assert data.window_s == b - a > 0
    got = [(s, e) for _, s, e in spans(data, "commit", "commit_end")]
    assert len(got) == 3 and all(a <= s < e <= b for s, e in got)
    # the work of each span lies inside it, on the device's clock; the
    # work before and after the proof is left out
    inside = [(s0, s1) for _, s0, s1 in data.ops
              if any(s <= s0 < e for s, e in got)]
    assert len(inside) >= 6 and len(data.ops) == len(inside)
    assert 0 < union_s([(s0, s1) for _, s0, s1 in data.ops]) \
        == data.busy_s <= data.window_s
