"""Rehearsals of whole runs on the CPU at height 2 (n = 256), with the
port's plain path: the run loop, the result line, and `correct` coming
out false under the control and each fault the cells can have. Each run
builds its set-up and proves for about a minute on the CPU; the mesh
runs spawn two gloo ranks. Then a system other than the Merkle tree (the
toy general circuit of `tests/room/`, n = 16) added to a copy of the
benchmark as files of its own, and judged by its own reference.

Run: python3 -m pytest portbench/tests/test_portbench_run.py -q"""

import json
import os
import shutil
import subprocess
import sys
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
    line, run, verdict = _run(root, "merkle-h2", faults.hooks("merkle")[hook])
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


ROOM = os.path.join(PB, "tests", "room")


def _files(top):
    out = {}
    for d, _, files in os.walk(top):
        if "__pycache__" not in d:
            for f in files:
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, top)] = fh.read()
    return out


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """A copy of the benchmark with a configuration of the toy general
    circuit added as new files (`tests/room/`: its configuration, system,
    recipe and reference) and new entries in `BENCHMARK.json`; no file
    that the copy had changes but `BENCHMARK.json`."""
    root = str(tmp_path_factory.mktemp("room"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(PB, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(root)
    added = _files(ROOM)
    for rel in added:
        dst = os.path.join(root, "portbench", rel)
        assert not os.path.exists(dst), rel
        shutil.copy(os.path.join(ROOM, rel), dst)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "circuit-toy", "source": "test",
                            "file": "portbench/configs/circuit-toy.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "toy-prove", "config": "circuit-toy",
                              "traffic": "closed-2w", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("prove_s", "idle_share"):
            m["workloads"].append("toy-prove")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    after = _files(root)
    assert {rel for rel in before if after[rel] != before[rel]} == \
        {"BENCHMARK.json"}
    assert set(after) - set(before) == {os.path.join("portbench", rel)
                                        for rel in added}
    return root


# one run in a process of its own that imports the benchmark from the
# copy (and the port from this checkout), as `run.py` does from its own
RUN_IN_COPY = """
import json, sys, time
root, repo, cell, hook, seed = sys.argv[1:]
sys.path[:0] = [root, repo]
import torch
torch.set_num_threads(4)
import portbench
from portbench import faults, harness
system = harness.Bench(root).config(
    harness.Bench(root).cell(cell)["config"])["system"]
line, run, verdict = harness.run_cell(
    root, cell, int(seed), 1, False, time.monotonic(), device="cpu",
    hook=faults.hooks(system)[hook] if hook else None)
print(json.dumps({"line": line, "verdict": verdict,
                  "portbench": portbench.__file__}))
"""


@pytest.mark.parametrize("hook", [None, "control", "answer_altered"])
def test_another_system_added_as_files_is_judged_by_its_own(room, hook):
    p = subprocess.run(
        [sys.executable, "-c", RUN_IN_COPY, room, ROOT, "toy-prove",
         hook or "", str(SEED)], capture_output=True, text=True,
        timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    line, verdict = out["line"], out["verdict"]
    assert out["portbench"].startswith(room)
    # the toy's reference judged it: its circuit has n = 16
    assert verdict["n"] == 16 and verdict["proofs"] == line["attempted"]
    assert line["attempted"] >= 1
    if hook is None:
        assert line["correct"] is True and line["failed"] == 0
        assert verdict["rejected"] == 0 and verdict["distinct"] >= 1
    else:
        assert line["correct"] is False
        assert line["failed"] == line["attempted"] == verdict["rejected"]
        assert verdict["reasons"] == ["does not verify"]
