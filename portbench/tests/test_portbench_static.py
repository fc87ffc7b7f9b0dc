"""CPU checks of the benchmark that need no proof: what it imports, that
its pieces are found by name, the roofline's counts, the trace readers,
and `BENCHMARK.json` against the contract's shapes.

Run: python3 -m pytest portbench/tests/test_portbench_static.py -q"""

import ast
import json
import os
import pickle
import re
import shutil
from types import SimpleNamespace

import pytest

from portbench import harness, inputs, roofline
from portbench.trace import (LEVELS, TraceData, Tracer, align, clip,
                             device_ops, idle_gaps, ops_within, round_spans,
                             spans, union_s)

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
FORBIDDEN = {"jax", "jaxlib", "flax", "zprize_tpu"}


def _imports(path):
    """(top-level name, level) of every import in the file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0, None
        elif isinstance(node, ast.ImportFrom):
            top = node.module.split(".")[0] if node.module else ""
            yield top, node.level, [a.name for a in node.names]


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    found = [(p, name) for p in _py_files(PB)
             for name, level, _ in _imports(p)
             if level == 0 and name in FORBIDDEN]
    assert not found
    # whole names: the port's name begins with the JAX package's
    assert "zprize_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(PB, "reference")
    allowed = {"json", "multiprocessing", "os", "sys", "time", "numpy",
               "struct", "math", "random", "hashlib", "dataclasses",
               "typing", "collections", "functools"}
    for p in _py_files(ref):
        depth = os.path.relpath(p, ref).count(os.sep)
        for name, level, names in _imports(p):
            if level == 0:
                assert name in allowed, (p, name)
            elif level > depth + 1:
                # out of `reference/`: only the inputs' recipe
                assert level == depth + 2 and name == "" \
                    and names == ["inputs"], (p, level, name, names)


def _copy_bench(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(PB, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = _copy_bench(tmp_path)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "merkle-h16.json"), "w") as f:
        json.dump({"name": "merkle-h16", "system": "merkle", "ranks": 4,
                   "height": 16}, f)
    with open(os.path.join(pb, "traffic", "closed-4w.json"), "w") as f:
        json.dump({"name": "closed-4w", "loop": "closed", "clients": 1,
                   "witnesses": 4, "order": "round_robin"}, f)
    # a mix that brings code: an open loop, witnesses in reverse
    with open(os.path.join(pb, "traffic", "open-4w.json"), "w") as f:
        json.dump({"name": "open-4w", "loop": "open", "witnesses": 4,
                   "order": "reverse", "gap_s": 0.01, "requests": 3}, f)
    with open(os.path.join(pb, "traffic", "open-4w.py"), "w") as f:
        f.write("def witness_at(params, i, seed):\n"
                "    return params['witnesses'] - 1 - i % "
                "params['witnesses']\n\n"
                "def arrival_s(params, i, seed):\n"
                "    return params['gap_s'] * (i + 1)\n\n"
                "def more(params, i, elapsed_s, seconds):\n"
                "    return i < params['requests']\n")
    with open(os.path.join(pb, "metrics", "window_proofs.py"), "w") as f:
        f.write('UNIT, LAYER, MOVES = "1", "device", "mesh_prove_s"\n\n'
                'def read(run):\n    return run.proofs\n')
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "merkle-h16", "source": "s",
                            "file": "portbench/configs/merkle-h16.json",
                            "reduced": [], "why": "w"})
    spec["workloads"].append({"name": "h16-mesh4", "config": "merkle-h16",
                              "traffic": "closed-4w", "chips": 4,
                              "why": "w"})
    spec["workloads"].append({"name": "h16-open", "config": "merkle-h16",
                              "traffic": "open-4w", "chips": 4,
                              "why": "w"})
    spec["per_layer"].append({"name": "window_proofs", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "mesh_prove_s",
                              "workloads": ["h16-mesh4"]})
    for m in spec["end_to_end"]:
        if m["name"] == "mesh_prove_s":
            m["workloads"].append("h16-mesh4")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    bench = harness.Bench(root)
    cell = bench.cell("h16-mesh4")
    assert bench.config(cell["config"])["height"] == 16
    assert bench.traffic(cell["traffic"])["witnesses"] == 4
    e2e = [m["name"] for m in bench.metrics("h16-mesh4", False)]
    assert e2e == ["mesh_prove_s", "peak_mem_gib", "setup_s"]
    names = [m["name"] for m in bench.metrics("h16-mesh4", True)]
    assert names == ["window_proofs"]
    assert bench.reader("window_proofs").read(SimpleNamespace(proofs=7)) == 7
    # the existing cells do not see it
    assert "window_proofs" not in [m["name"] for m in
                                   bench.metrics("h15-mesh4", True)]
    # a mix of data alone is the closed round robin
    closed = bench.traffic("closed-4w")
    assert closed.code is None
    assert [closed.witness_at(i, 9) for i in range(6)] == [0, 1, 2, 3, 0, 1]
    assert closed.arrival_s(5, 9) is None
    # a mix with code of its own: its order, arrivals and end, also
    # after it pickles to a spawned rank
    mix = bench.traffic(bench.cell("h16-open")["traffic"])
    assert mix.code.endswith(os.path.join("traffic", "open-4w.py"))
    assert mix.witness_at(0, 9) == 3
    mix = pickle.loads(pickle.dumps(mix))
    served = []
    t0, requests = inputs.drive(mix, 9, 60.0, lambda k: served.append(k)
                                or f"answer {k}")
    assert served == [3, 2, 1]
    assert [r[0] for r in requests] == served
    assert [r[4] for r in requests] == ["answer 3", "answer 2", "answer 1"]
    for i, (_, arrival, start, end, _) in enumerate(requests):
        assert arrival == pytest.approx(0.01 * (i + 1))
        assert arrival <= start <= end


def test_an_unknown_order_without_code_is_refused():
    mix = inputs.Mix("x", {"loop": "open", "order": "round_robin",
                           "witnesses": 2})
    with pytest.raises(ValueError, match="needs a .py"):
        mix.witness_at(0, 1)


def _twiddles_radix2(n):
    """Twiddle exponents of every butterfly of a radix-2 transform."""
    out, log_n = [], n.bit_length() - 1
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        for _ in range(n >> s):
            out.extend(j * (n >> s) for j in range(half))
    return out


def _twiddles_four_step(n1, n2):
    """Twiddle exponents (mod n) of a four-step n1 x n2 transform: n1
    columns of length n2, the mid twiddles w^(i1 k2), n2 rows of n1."""
    n = n1 * n2
    out = [e * n1 for _ in range(n1) for e in _twiddles_radix2(n2)]
    out += [i1 * k2 % n for i1 in range(n1) for k2 in range(n2)]
    out += [e * n2 for _ in range(n2) for e in _twiddles_radix2(n1)]
    return out


@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 8, 11])
def test_transform_products_count_every_twiddle_but_one(log_n):
    n = 1 << log_n
    radix2 = sum(e % n != 0 for e in _twiddles_radix2(n))
    assert radix2 == roofline.transform_products(n)
    for log_n1 in range(1, log_n):
        n1 = 1 << log_n1
        four = sum(e % n != 0 for e in _twiddles_four_step(n1, n // n1))
        assert four == roofline.transform_products(n)


def test_transform_least_time_counts_columns_and_whole_transforms():
    n = 1 << 22
    one, by = roofline.transform_least_s(n)
    assert by == "products"
    assert roofline.MONT_SLOTS == 224
    want = (n // 2 * 22 - (n - 1)) * 224 / (64 * 132 * 1.98e9)
    assert one == pytest.approx(want, rel=1e-12)
    assert roofline.transform_least_s(n, 5)[0] == pytest.approx(5 * one)
    # the bytes bound: read and write 32 bytes an element once
    assert roofline.transform_bytes(n) == 64 * n


def _data():
    """Two proofs of a made-up trace: marks and operations in seconds."""
    marks = [("proof", 0.0), ("ntt", 0.1), ("ntt_end", 0.3),
             ("commit", 0.3), ("commit_end", 0.6),
             ("round:round1 (wires intt + 4 commits)", 0.6),
             ("round:round4 quotient", 1.6), ("proof_end", 1.9),
             ("proof", 2.0), ("ntt", 2.1), ("ntt_end", 2.3),
             ("commit", 2.3), ("commit_end", 2.6),
             ("round:round1 (wires intt + 4 commits)", 2.6),
             ("round:round4 quotient", 3.8), ("proof_end", 3.9)]
    ops = [("k_ntt", 0.1, 0.25), ("msm", 0.35, 0.5), ("quot", 0.7, 1.6),
           ("k_ntt", 2.1, 2.2), ("nccl_allgather", 2.2, 2.3),
           ("msm", 2.3, 2.6), ("quot", 2.6, 3.8)]
    return TraceData(window_s=3.8, proofs=2, ops=ops, marks=marks,
                     transforms=[(1 << 22, 1), (1 << 22, 2)],
                     busy_s=union_s([(s, e) for _, s, e in ops]),
                     windows=[(0.0, 1.9), (2.0, 3.9)])


def test_the_trace_readers():
    d = _data()
    assert union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert d.busy_s == pytest.approx(0.15 + 0.15 + 0.9 + 0.2 + 0.3 + 1.2)
    assert spans(d, "commit", "commit_end") == [(0, 0.3, 0.6),
                                                 (1, 2.3, 2.6)]
    assert spans(d, "proof", "proof_end") == [(0, 0.0, 1.9), (1, 2.0, 3.9)]
    rounds = round_spans(d)
    assert [r[0] for r in rounds] == ["round1 (wires intt + 4 commits)",
                                      "round4 quotient"] * 2
    assert rounds[1][1:] == (0.6, 1.6) and rounds[3][1:] == (2.6, 3.8)
    assert ops_within(d, 2.1, 2.3) == [("k_ntt", 2.1, 2.2),
                                       ("nccl_allgather", 2.2, 2.3)]
    top = device_ops(d)
    assert top[0] == ["quot", pytest.approx((0.9 + 1.2) / 2)]
    gaps = dict(idle_gaps(d))
    # 0-0.1 and 2.0-2.1 before each proof's first operation, 0.25-0.35
    # inside the commit, 0.5-0.7 before the quotient's work, 1.6-1.9 and
    # 3.8-3.9 after each proof's last operation
    assert gaps["round1 (wires intt + 4 commits)"] == pytest.approx(0.2 / 2)
    assert gaps["round1 (wires intt + 4 commits) / commit_batch"] == \
        pytest.approx(0.1 / 2)
    assert gaps["round4 quotient"] == pytest.approx(0.2 / 2)
    assert gaps["after the last round"] == pytest.approx(0.4 / 2)
    assert len(gaps) == 4


def test_clip_keeps_what_lies_inside_the_windows():
    events = [("a", 0.0, 0.5), ("b", 0.8, 1.2), ("c", 1.5, 1.7),
              ("d", 1.9, 2.1), ("e", 3.5, 3.6), ("f", 4.0, 4.2)]
    assert clip(events, [(1.0, 2.0), (3.0, 4.0)]) == [
        ("b", 1.0, 1.2), ("c", 1.5, 1.7), ("d", 1.9, 2.0),
        ("e", 3.5, 3.6)]
    assert clip(events, []) == []


def _profile(events):
    """A stand-in for a finished `torch.profiler.profile`: its device
    events (name, start_s, end_s)."""
    from torch.autograd import DeviceType
    rows = [SimpleNamespace(name=n, device_type=DeviceType.CUDA,
                            time_range=SimpleNamespace(start=s * 1e6,
                                                       end=e * 1e6))
            for n, s, e in events]
    return SimpleNamespace(events=lambda: rows)


def test_reduce_reads_only_the_proofs_not_the_harness_collectives():
    """The harness's barrier before the window, its broadcast between the
    proofs and its barrier after them are NCCL kernels too: none of them
    is in the trace's operations, busy time or window."""
    tracer = Tracer()
    tracer.marker_name = "sleep"
    labels = ["proof", "proof_end", "proof", "proof_end"]
    tracer.labels = list(labels)
    at = [1.0, 2.0, 2.5, 3.5]
    marker = [("sleep", t, t + LEVELS[i % 3] / 1.5e9 + 1e-6)
              for i, t in enumerate(at)]
    harness_ops = [("ncclDevKernel_AllReduce_Sum_f32", 0.2, 0.99),
                   ("ncclDevKernel_Broadcast_RING_LL", 2.1, 2.4),
                   ("ncclDevKernel_AllReduce_Sum_f32", 3.6, 3.9)]
    program_ops = [("ncclDevKernel_AllGather_RING_LL", 1.2, 1.3),
                   ("k5", 1.3, 1.8), ("ncclDevKernel_SendRecv", 2.6, 2.7),
                   ("k1", 2.7, 3.4)]
    data = tracer.reduce(_profile(marker + harness_ops + program_ops),
                         3.0, 2)
    assert data.windows == [(1.0, 2.0), (2.5, 3.5)]
    assert data.window_s == pytest.approx(2.0)
    assert [op[0] for op in data.ops] == [op[0] for op in program_ops]
    assert data.busy_s == pytest.approx(0.6 + 0.8)
    got = harness.Bench(ROOT).reader("collective_s.mesh4").read(
        SimpleNamespace(trace=data))
    assert got == pytest.approx((0.1 + 0.1) / 2)
    assert harness.Bench(ROOT).reader("idle_share.mesh4").read(
        SimpleNamespace(trace=data)) == pytest.approx(100 * (1 - 1.4 / 2.0))
    assert "2 of 2 proofs traced" in data.notes[1]


@pytest.mark.parametrize("dropped", [[], [0], [1, 2], [5, 40], [98, 99]])
def test_align_gives_each_mark_its_kernel_and_none_to_dropped_ones(dropped):
    labels = [f"m{i}" for i in range(100)]
    # a kernel's length at a 1.5 GHz clock, plus 1 us of its own
    kernels = [(float(i), LEVELS[i % 3] / 1.5e9 + 1e-6)
               for i in range(100) if i not in dropped]
    got = align(labels, kernels)
    assert [label for label, _ in got] == labels
    assert [t for _, t in got] == [None if i in dropped else float(i)
                                   for i in range(100)]


def test_readers_leave_out_spans_of_untimed_marks():
    d = _data()
    d.marks[3] = ("commit", None)              # the first proof's commit
    d.marks[13] = (d.marks[13][0], None)       # the second proof's round1
    assert spans(d, "commit", "commit_end") == [(1, 2.3, 2.6)]
    # the second proof's round 1 ends untimed: its round 4 has no start
    assert [r[0] for r in round_spans(d)] == [
        "round1 (wires intt + 4 commits)", "round4 quotient"]
    assert harness.Bench(ROOT).reader("commit_s").read(
        SimpleNamespace(trace=d)) == pytest.approx(0.3)


@pytest.mark.parametrize("name,want", [
    ("quotient_s", (1.0 + 1.2) / 2),
    ("quotient_s.mesh4", (1.0 + 1.2) / 2),
    ("commit_s", 0.3),
    ("collective_s.mesh4", 0.05),
    ("idle_share", None),
    ("ntt_roofline", None)])
def test_the_per_layer_metrics_read_the_trace(name, want):
    d = _data()
    bench = harness.Bench(ROOT)
    run = SimpleNamespace(trace=d, proofs=2)
    got = bench.reader(name).read(run)
    if name.startswith("idle_share"):
        want = 100 * (1 - d.busy_s / d.window_s)
    if name == "ntt_roofline":
        least = 3 * roofline.transform_least_s(1 << 22)[0]
        want = 100 * least / (0.15 + 0.2)
    assert got == pytest.approx(want)
    assert bench.reader(name).read(SimpleNamespace(trace=None)) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract_shapes():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    layer = {m["name"]: m for m in spec["per_layer"]}
    assert "setup_s" in e2e and all(m["bound"] <= 0.25
                                    for m in e2e.values())
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    assert len({c["source"] for c in spec["configs"]}) == len(configs)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(PB, "traffic",
                                           w["traffic"] + ".json"))
        cell = w["name"]
        mine = [m for m in e2e.values()
                if cell in m.get("workloads", [cell])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in layer.values())
    for m in list(e2e.values()) + list(layer.values()):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        mod = harness.Bench(ROOT).reader(m["name"])
        assert mod.UNIT == m["unit"]
    for m in layer.values():
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        mod = harness.Bench(ROOT).reader(m["name"])
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_a_rank_that_loaded_jax_refuses_the_run(capsys):
    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
            "device": {}, "compared": {}}
    run = SimpleNamespace(forbidden={2: ["jax"]}, trace=None)
    assert harness.report(line, run, {}) == 3
    out, err = capsys.readouterr()
    assert out == "" and "rank 2 loaded jax" in err
    run.forbidden = {}
    if not harness.forbidden_modules():
        assert harness.report(line, run, {}) == 0
        assert json.loads(capsys.readouterr().out) == line
