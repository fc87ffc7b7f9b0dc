#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`zprize_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--height H] [--phases probe,build,kernels,h6,main]

Phases, in order; each prints a JSON line before it starts and one with its
seconds when it ends:
  probe    the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc-builds the kernel library from zprize_tpu_torch/csrc
  kernels  each of the seven kernels against its plain PyTorch version at
           n = 2^16 + 37 (random + edge values, exact equality), then its
           time per launch at n = 2^22
  h6       Merkle gen_proof at height 6 through the kernels and through the
           plain versions: the proof bytes must be equal and verify
  main     the main path at height H (default 15, n = 2^22), through the
           entry points a user calls: device_srs, MerkleLayout,
           preprocess_layout, witness, prove_torch, verify; every kernel
           launch is counted, and every kernel must have run

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. The last line is the result object.
"""

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time

# a hang dumps every thread's stack and exits non-zero before any outer
# limit (1200 s) cuts the run
faulthandler.dump_traceback_later(1140, exit=True)

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_HEIGHT = 15


def emit(obj):
    print(json.dumps(obj), flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        emit({"phase": self.name, "event": "start"})
        self.t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        emit({"phase": self.name, "event": "end" if exc is None else "fail",
              "seconds": round(time.time() - self.t0, 3)})
        return False


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# kernel checks: each kernel against its plain PyTorch version
# ---------------------------------------------------------------------------

CHECK_N = (1 << 16) + 37
TIME_N = 1 << 22
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (data sheet)
INT_OPS_S = 67e12              # table's non-tensor 32-bit rate (float32)


def _field_ops(N):
    """32-bit integer operations per element: CIOS product = 2 N^2
    multiply-adds, each a lo and a hi instruction; add/sub ~4 N."""
    return {"mul": 4 * N * N + 2 * N, "addsub": 4 * N, "neg": 2 * N}


def _rand_field(C, n, rng):
    import numpy as np
    import torch
    a = rng.integers(0, 1 << 16, size=(C.L, n), dtype=np.int64)
    a[-1] = rng.integers(0, int(C.mod_limbs[-1]), size=n)
    edges = [0, 1, C.mod - 1, C.R]
    for i, v in enumerate(edges):
        a[:, i] = [(v >> (16 * k)) & 0xFFFF for k in range(C.L)]
    return torch.from_numpy(a.astype(np.int32)).cuda()


def _rand_points(n, rng):
    """Affine (x, y) and xyzz test operands with the special cases in the
    first columns: identity, P == Q (two representations), P == -Q."""
    import torch
    from zprize_tpu_torch.curve import g1
    from zprize_tpu_torch.ref.curve import G1_GEN, g1_mul
    pool = [g1_mul(G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, 64)]
    px, py, _ = g1.affine_points_to_device(pool, "cuda")
    idx = [torch.from_numpy(rng.integers(0, 64, n)).cuda() for _ in range(4)]
    ax, ay = px[:, idx[0]], py[:, idx[0]]
    bx, by = px[:, idx[1]], py[:, idx[1]]
    # affine specials
    ax[:, 0] = 0
    ay[:, 0] = 0
    bx[:, 1] = 0
    by[:, 1] = 0
    ax[:, 2] = ay[:, 2] = bx[:, 2] = by[:, 2] = 0
    bx[:, 3], by[:, 3] = ax[:, 3], ay[:, 3]
    bx[:, 4] = ax[:, 4]
    from zprize_tpu_torch.fields import mont
    from zprize_tpu_torch.fields.mont import FQ
    by[:, 4] = mont.neg(FQ, ay[:, 4:5].contiguous())[:, 0]
    # xyzz operands with random Z: P = a + c, Q = b + d (plain version)
    cx, cy = px[:, idx[2]], py[:, idx[2]]
    dx, dy = px[:, idx[3]], py[:, idx[3]]
    from zprize_tpu_torch.fields import kernels
    with kernels.impl("plain"):
        P = g1.xyzz_add_affine2(ax, ay, cx, cy)
        Q = g1.xyzz_add_affine2(bx, by, dx, dy)
        P[:, 0] = 0                                # P = O
        Q[:, 1] = 0                                # Q = O
        P[:, 2] = 0
        Q[:, 2] = 0
        Q[:, 3] = P[:, 3]                          # P == Q, same coords
        Q[:, 4] = g1.xyzz_neg(P[:, 4:5].contiguous())[:, 0]   # P == -Q
        Q[:, 5] = g1.xyzz_add_affine2(cx[:, 5:6], cy[:, 5:6], ax[:, 5:6],
                                      ay[:, 5:6])[:, 0]
    return (ax.contiguous(), ay.contiguous(), bx.contiguous(),
            by.contiguous()), (P.contiguous(), Q.contiguous())


def _time(fn, reps):
    """(ms per call over `reps` calls, the output of a first call). A
    second untimed call lets the allocator cache the block that the timed
    calls reuse while the first output is held."""
    import torch
    out = fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def _tile(t, n):
    reps = -(-n // t.shape[1])
    return t.repeat(1, reps)[:, :n].contiguous()


def _plain(fn):
    """`fn` run through the plain PyTorch versions instead of the
    kernels."""
    from zprize_tpu_torch.fields import kernels

    def run():
        with kernels.impl("plain"):
            return fn()
    return run


def check_kernels():
    """Returns {name: record} for the seven kernels; raises on a
    mismatch, at n = 2^16 + 37 and at the timed n = 2^22."""
    import numpy as np
    import torch
    from zprize_tpu_torch.fields import kernels
    from zprize_tpu_torch.fields.mont import FR, FQ
    from zprize_tpu_torch.curve import g1
    from zprize_tpu_torch.ops import ntt

    rng = np.random.default_rng(20261017)
    n = CHECK_N
    cases = {}
    for C in (FR, FQ):
        a = _rand_field(C, n, rng)
        b = _rand_field(C, n, rng)
        b[:, :4] = a[:, :4].flip(1)
        cases[C.name] = (a, b)

    plan = ntt.get_plan(12, "cuda")
    stage_inputs = [(_rand_field(FR, 2 * n, rng), 1),
                    (_rand_field(FR, 37 * 4096, rng), 2048)]
    aff, xyzz = _rand_points(n, rng)

    def compare(name, got, want):
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}")
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
        if int(err) != 0:
            bad = (got != want).any(0).nonzero()[:5, 0].tolist()
            raise AssertionError(f"{name}: kernel != plain at columns {bad}")
        return int(err)

    checks = {}

    def check(name, case, fn):
        checks.setdefault(name, []).append(
            compare(f"{name}/{case}", fn(), _plain(fn)()))

    for C in (FR, FQ):
        a, b = cases[C.name]
        for name in ("mul", "add", "sub"):
            fn = getattr(kernels, name)
            check(name, C.name, lambda: fn(C.P, a, b))
        check("neg", C.name, lambda: kernels.neg(C.P, a))
    for x, half in stage_inputs:
        step = plan.n // (2 * half)
        check("mul_add_sub", f"half={half}",
              lambda: kernels.butterfly_stage(FR.P, x, plan.tw, half, step))
    P, Q = xyzz
    check("xyzz_add", "specials", lambda: g1.xyzz_add(P, Q))
    check("xyzz_add_affine2", "specials",
          lambda: g1.xyzz_add_affine2(*aff))
    torch.cuda.synchronize()

    # time per launch at n = 2^22, kernel and plain version, with bounds;
    # the outputs of the two are held equal at this size too
    N = TIME_N
    fr_ops, fq_ops = _field_ops(8), _field_ops(12)
    big = {C.name: (_tile(cases[C.name][0], N), _tile(cases[C.name][1], N))
           for C in (FR, FQ)}
    bigP, bigQ = _tile(P, N), _tile(Q, N)
    big_aff = [_tile(t, N) for t in aff]
    big_tw = ntt.get_plan(22, "cuda").tw
    bx = _tile(stage_inputs[0][0], N)

    def rec(name, replaces, fn, bytes_moved, ops, field):
        ms, got = _time(fn, 10)
        plain_ms, want = _time(_plain(fn), 1)
        checks[name].append(compare(f"{name}/n={N}", got, want))
        del got, want
        t_bytes = bytes_moved / HBM_BYTES_S * 1e3
        t_ops = ops / INT_OPS_S * 1e3
        return {"name": name, "route": "cuda",
                "source": "zprize_tpu_torch/csrc/kernels.cu",
                "replaces": replaces, "field": field, "launches": None,
                "max_abs_err": max(checks[name]),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "n": N}

    fq_a, fq_b = big["fq"]
    fr_a, fr_b = big["fr"]
    out = {}
    out["mul"] = rec("mul", "zprize_tpu/fields/pkern.py:128",
                     lambda: kernels.mul(FQ.P, fq_a, fq_b),
                     3 * 24 * 4 * N, fq_ops["mul"] * N, "fq")
    out["add"] = rec("add", "zprize_tpu/fields/pkern.py:139",
                     lambda: kernels.add(FR.P, fr_a, fr_b),
                     3 * 16 * 4 * N, fr_ops["addsub"] * N, "fr")
    out["sub"] = rec("sub", "zprize_tpu/fields/pkern.py:150",
                     lambda: kernels.sub(FR.P, fr_a, fr_b),
                     3 * 16 * 4 * N, fr_ops["addsub"] * N, "fr")
    out["neg"] = rec("neg", "zprize_tpu/fields/pkern.py:161",
                     lambda: kernels.neg(FR.P, fr_a),
                     2 * 16 * 4 * N, fr_ops["neg"] * N, "fr")
    out["mul_add_sub"] = rec(
        "mul_add_sub", "zprize_tpu/fields/pkern.py:172",
        lambda: kernels.butterfly_stage(FR.P, bx, big_tw, 1 << 10, 1 << 11),
        # the stage reads `half` = 2^10 distinct twiddle columns
        2 * 16 * 4 * N + 16 * 4 * (1 << 10),
        (fr_ops["mul"] + 2 * fr_ops["addsub"]) * (N // 2), "fr")
    pt_ops = 14 * fq_ops["mul"] + 7 * fq_ops["addsub"]
    out["xyzz_add"] = rec(
        "xyzz_add", "zprize_tpu/fields/pkern.py:215",
        lambda: g1.xyzz_add(bigP, bigQ),
        3 * 96 * 4 * N, pt_ops * N, "fq")
    out["xyzz_add_affine2"] = rec(
        "xyzz_add_affine2", "zprize_tpu/fields/pkern.py:245",
        lambda: g1.xyzz_add_affine2(*big_aff),
        (4 * 24 + 96) * 4 * N, pt_ops * N, "fq")
    for k, r in out.items():
        emit({"kernel_check": k, "equal": True, "cases": len(checks[k]),
              "ms": r["ms"], "plain_ms": r["plain_ms"]})
    del big, bigP, bigQ, big_aff, bx
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Merkle gen_proof
# ---------------------------------------------------------------------------

def _leaves(m, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(31), "little") for _ in range(m)]


def _profile_prove(prove, height):
    """One more prove under torch.profiler: device time by kernel, and the
    device's busy share of the wall time (union of kernel intervals); the
    full table goes to chiprun_out/."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prove()
        torch.cuda.synchronize()
    wall = time.time() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy, end = 0.0, None
    for s0, s1 in sorted(spans):
        if end is None or s0 > end:
            busy += s1 - s0
            end = s1
        elif s1 > end:
            busy += s1 - end
            end = s1
    busy /= 1e6
    rows = sorted(((t, k, c) for k, (t, c) in by_name.items()),
                  reverse=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", f"profile_h{height}.txt")
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    emit({"profile": {"height": height, "wall_s": wall,
                      "device_busy_s": busy,
                      "device_idle_share": max(0.0, 1 - busy / wall),
                      "top": [{"kernel": k[:90], "device_s": us / 1e6,
                               "calls": c} for us, k, c in rows[:16]],
                      "table": path}})


def gen_proof(height, impls=("kernel",), timed=False, profile=False,
              on_done=None):
    """SRS -> layout -> preprocess -> witness -> prove (once per impl) ->
    verify. Returns (proof bytes per impl, phase seconds, pass counts).
    timed: log preprocess phases and prove rounds; profile: one more
    prove under torch.profiler."""
    import torch
    from zprize_tpu_torch.params import R_MOD
    from zprize_tpu_torch.fields.mont import FR
    from zprize_tpu_torch.merkle.layout import MerkleLayout
    from zprize_tpu_torch.merkle.preprocess import preprocess_layout
    from zprize_tpu_torch.protocol import prover_torch as pt
    from zprize_tpu_torch.protocol.srs import device_srs
    from zprize_tpu_torch.protocol.serde import serialize_proof
    from zprize_tpu_torch.protocol.transcript_protocol import \
        TranscriptProtocol
    from zprize_tpu_torch.ref.prover import seed_transcript
    from zprize_tpu_torch.ref.verifier import verify

    secs = {}

    def phase(name, fn):
        with Phase(f"h{height}.{name}"):
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            secs[name] = time.time() - t0
        return out

    lay = phase("layout", lambda: MerkleLayout(height, device="cuda"))
    n = lay.n
    pts, lite, _ = phase("device_srs", lambda: device_srs(n + 8,
                                                         device="cuda"))
    dev_srs = pt.DevSRS(pts, lite)
    cfg = pt.ProverConfig(device="cuda")
    tr = TranscriptProtocol(b"Merkle tree")
    pk, vk = phase("preprocess", lambda: preprocess_layout(
        lay, dev_srs, tr, cfg,
        log=lambda s: emit({"log": s}) if timed else None))
    pre_passes = list(cfg.commit_passes)
    leaves = FR.tensor(_leaves(lay.m_leaves, height), "cuda")
    wires, root, _ = phase("witness", lambda: lay.witness(leaves))
    pi = {lay.root_gate_pos: (-root) % R_MOD}
    proofs = {}
    passes = {}
    for impl in impls:
        t = TranscriptProtocol(b"Merkle tree")
        seed_transcript(t, vk)
        c = pt.ProverConfig(device="cuda", impl=impl,
                            log=(lambda s: emit({"log": s})) if timed
                            else None)
        proof = phase(f"prove_{impl}", lambda: pt.prove_torch(
            pt.ProverWitness(wires, pi), pk, dev_srs, t, c))
        proofs[impl] = serialize_proof(proof)
        passes[impl] = c.commit_passes
        vtr = TranscriptProtocol(b"Merkle tree")
        seed_transcript(vtr, vk)
        ok = phase(f"verify_{impl}",
                   lambda: verify(vk, lite, proof, pi, vtr))
        if not ok:
            raise AssertionError(f"h{height} {impl} proof does not verify")
        emit({"verify": "PASS", "height": height, "impl": impl})
    if on_done:
        on_done()
    if profile:
        t = TranscriptProtocol(b"Merkle tree")
        seed_transcript(t, vk)
        _profile_prove(lambda: pt.prove_torch(
            pt.ProverWitness(wires, pi), pk, dev_srs, t,
            pt.ProverConfig(device="cuda")), height)
    return proofs, secs, {"preprocess": pre_passes, **passes}


def check_h6():
    proofs, secs, passes = gen_proof(6, impls=("kernel", "plain"))
    if proofs["kernel"] != proofs["plain"]:
        raise AssertionError("h6: kernel-path proof bytes differ from the "
                             "plain-path proof")
    emit({"h6": {"proof_bytes_equal": True, "bytes": len(proofs["kernel"]),
                 "seconds": secs, "commit_passes": passes}})


def main_path(height, profile=False):
    """The main path at `height`; returns the kernel launch counts of
    exactly this run (a profiled extra prove comes after the count)."""
    import torch
    from zprize_tpu_torch.fields import kernels
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    counts = {}
    with Phase(f"main_h{height}"):
        _, secs, passes = gen_proof(
            height, timed=True, profile=profile,
            on_done=lambda: counts.update(kernels.COUNTS))
    emit({"main": {"height": height, "n": 1 << (
        (4 + 193 * ((1 << (height - 1)) - 1) + 1 - 1).bit_length()),
        "seconds": secs, "commit_passes": passes,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": counts}})
    return counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=MAIN_HEIGHT)
    ap.add_argument("--phases", default="probe,build,kernels,h6,main")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more main-path prove")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not os.path.isdir(os.path.join(ROOT, "zprize_tpu_torch", "csrc")):
        fail("zprize_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    with Phase("probe"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        card = smi[0] if smi else "nvidia-smi gave no answer"
        from zprize_tpu_torch.fields import kernels
        nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
        emit({"probe": {"card": card,
                        "device": torch.cuda.get_device_name(0),
                        "count": torch.cuda.device_count(),
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda,
                        "nvcc": nvcc[-1] if nvcc else None,
                        "python": sys.version.split()[0]}})

    with Phase("build"):
        kernels.load_library()
        info = dict(kernels.BUILD_INFO)
        ptxas = [ln.strip() for ln in info.pop("ptxas", "").splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"build": info, "ptxas": ptxas})

    results = {}
    if "kernels" in phases:
        with Phase("kernels"):
            results = check_kernels()
    if "h6" in phases:
        with Phase("h6"):
            check_h6()
    if "main" in phases:
        counts = main_path(args.height, args.profile)
        missing = [k for k in kernels.KERNEL_NAMES if counts[k] == 0]
        if missing:
            fail(f"kernels never launched on the main path: {missing}")
        for k, r in results.items():
            r["launches"] = counts[k]
    if results:
        emit({"kernels": list(results.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
