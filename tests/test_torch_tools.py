"""The host-side logic of the port's measuring tools
(`zprize_tpu_torch/tools/`), which time and attribute work on the card and
have no CPU mode: the allocator-trace replay and the peak-owner choice of
`mem_attr`, the round and commit spans of `timeline`, the seeded leaves
of the shared set-up, and the refusal to run without a card."""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread)

from zprize_tpu_torch.tools import mem_attr, micro, timeline
from zprize_tpu_torch.tools.cudatime import require_cuda
from zprize_tpu_torch.tools.merkle_setup import seeded_leaves


def _alloc(addr, size):
    return {"action": "alloc", "addr": addr, "size": size}


def _free(addr, size, done=False):
    return {"action": "free_completed" if done else "free_requested",
            "addr": addr, "size": size}


def test_replay_finds_the_peak_and_the_blocks_live_at_it():
    trace = [_alloc(1, 10), _alloc(2, 5), _free(1, 10), _free(1, 10, True),
             _alloc(3, 7), _alloc(4, 4), _free(2, 5), _alloc(5, 1)]
    peak, live, at = mem_attr._replay(trace)
    assert (peak, at) == (16, 5)
    assert live == {2: 5, 3: 7, 4: 4}
    # a peak that no free follows is the live set at the end
    peak, live, at = mem_attr._replay([_alloc(1, 3), _alloc(2, 4)])
    assert (peak, live, at) == (7, {1: 3, 2: 4}, 1)


def test_owner_is_the_output_that_held_the_address_at_the_peak():
    outs = mem_attr._Outputs()
    outs.by_addr = {7: [(1, (16, 4), "int32", 0, "a"),
                        (5, (16, 8), "int32", 1, "b"),
                        (9, (16, 2), "int32", 2, "c")],
                    8: [(6, (16, 1), "int32", 1, "d")]}
    outs.peak_op = 5
    assert outs.owner(7)[4] == "b"
    assert outs.owner(8)[4] == "d"          # allocated by the op after it
    assert outs.owner(9) is None


def test_spans_split_rounds_and_commits():
    spans = timeline._Spans()
    seen = []

    def commit_batch(dev_srs, polys, cfg):
        seen.append(spans.commit)
        return ["c"] * polys.shape[1]

    wrapped = spans.wrap(commit_batch)
    assert wrapped(None, torch.zeros(16, 4, 2), None) == ["c"] * 4
    spans.log("prove round1 (wires intt + 4 commits): 0.250s")
    assert wrapped(None, torch.zeros(16, 2, 2), None) == ["c"] * 2
    spans.log("prove round3 (grand products + 2 commits): 0.150s")
    assert seen == [0, 1] and spans.commit is None
    assert [r["label"] for r in spans.rounds] == [
        "round1 (wires intt + 4 commits)",
        "round3 (grand products + 2 commits)"]
    assert [(c["round"], c["polys"]) for c in spans.commits] == \
        [(0, 4), (1, 2)]
    assert all(r["wall_s"] >= 0 for r in spans.rounds)


def test_seeded_leaves_and_scalars_are_reproducible():
    a, b = seeded_leaves(5, 15), seeded_leaves(5, 15)
    assert a == b and a != seeded_leaves(5, 16)
    assert all(0 <= x < 1 << 248 for x in a)
    s = micro.scalars(64, 3)
    assert s.shape == (16, 64) and s.dtype == np.int32
    assert np.array_equal(s, micro.scalars(64, 3))
    assert (s[15] < 0x73ed).all() and (s >= 0).all()


def test_tools_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (require_cuda, micro.run, lambda: timeline.measure(None),
               lambda: mem_attr.measure(None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_port_tests_run_on_one_torch_thread():
    """`tests/torch_threads.py` holds the test process to one intra-op
    thread, and no test file has raised it since."""
    assert torch.get_num_threads() == 1
