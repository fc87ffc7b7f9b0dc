"""Rehearsals of whole runs on the CPU at height 2 (n = 256), with the
port's plain path: the run loop, the result line, and `correct` coming
out false under the control and each fault the cells can have. Each run
builds its set-up and proves for about a minute on the CPU; the mesh
runs spawn two gloo ranks.

Run: python3 -m pytest portbench/tests/test_portbench_run.py -q"""

import json
import os
import shutil
import time

import pytest

from portbench import faults, harness

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
SEED = 2 ** 31 + 4321


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with two height-2 cells of the cells'
    own configurations: one card, and two ranks."""
    root = str(tmp_path_factory.mktemp("bench"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(PB, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for src, name, ranks in (("merkle-h15", "merkle-h2", 1),
                             ("merkle-h15-mesh4", "merkle-h2-mesh2", 2)):
        with open(os.path.join(PB, "configs", src + ".json")) as f:
            config = json.load(f)
        config.update(name=name, height=2, ranks=ranks)
        path = f"portbench/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(config, f)
        spec["configs"].append({"name": name, "source": name, "file": path,
                                "reduced": ["height"], "why": "test"})
        spec["workloads"].append({"name": name, "config": name,
                                  "traffic": "closed-2w", "chips": ranks,
                                  "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def _run(root, cell, hook=None, seconds=1):
    import torch
    torch.set_num_threads(4)
    line, run, verdict = harness.run_cell(
        root, cell, SEED, seconds, False, time.monotonic(), device="cpu",
        hook=hook)
    return line, run, verdict


def test_a_rehearsal_prints_the_line_and_no_device_metric(root):
    line, run, verdict = _run(root, "merkle-h2")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == run.proofs >= 1
    assert line["metrics"] == {}
    assert line["device"] == {"platform": "cpu", "count": 1}
    assert line["compared"] == {"rejected_proofs": {"value": 0, "limit": 0}}
    assert verdict["distinct"] >= 1 and verdict["rejected"] == 0


@pytest.mark.parametrize("hook", ["other_leaves", "answer_altered"])
def test_the_control_and_an_altered_answer_come_out_not_correct(root, hook):
    line, run, verdict = _run(root, "merkle-h2", faults.HOOKS[hook])
    assert line["correct"] is False
    assert line["failed"] == run.proofs >= 1
    assert line["compared"]["rejected_proofs"]["value"] == run.proofs
    assert verdict["reasons"] == ["does not verify"]


def test_a_mesh_rehearsal_is_correct_on_every_rank(root):
    line, run, verdict = _run(root, "merkle-h2-mesh2")
    assert line["correct"] is True
    assert verdict["proofs"] == 2 * run.proofs
    assert run.forbidden == {}
    assert [r[0] for r in run.requests] == [i % 2 for i in
                                            range(run.proofs)]


def plant_jax(stage):
    """On rank 1, load a module named `jax` during the window, as a port
    module that imported JAX lazily on the sharded path would."""
    import sys
    import types
    import torch.distributed as dist
    if stage != "window" or dist.get_rank() != 1:
        return
    sys.modules["jax"] = types.ModuleType("jax")
    return lambda: sys.modules.pop("jax", None)


def test_a_rank_that_loads_jax_refuses_the_run(root, capsys):
    line, run, verdict = _run(root, "merkle-h2-mesh2", plant_jax)
    assert run.forbidden == {1: ["jax"]}
    capsys.readouterr()
    assert harness.report(line, run, verdict) == 3
    out, err = capsys.readouterr()
    assert out == "" and "rank 1 loaded jax" in err


def test_the_exchange_left_out_comes_out_not_correct(root):
    line, run, verdict = _run(root, "merkle-h2-mesh2",
                              faults.exchange_left_out)
    assert line["correct"] is False
    assert line["failed"] == run.proofs >= 1
