#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`zprize_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--height H]
                          [--phases probe,build,kernels,circuit,h6,main]

Phases, in order; each prints a JSON line before it starts and one with its
seconds when it ends:
  probe    the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc-builds the kernel library from zprize_tpu_torch/csrc
  kernels  each of the nine kernels against its plain PyTorch version at
           n = 2^16 + 37 (random + edge values, exact equality), then its
           time per launch at n = 2^22
  circuit  a general PLONK circuit with every widget and a 256-row lookup
           table, padded to n = 2^10: spec preprocess on the host, then
           DevSRS.from_ref, DevProverKey.from_ref,
           ProverWitness.from_composer and prove_torch four times (kernels,
           plain versions, host MSM, key saved and loaded by keys_io): the
           proof bytes must be equal and verify
  h6       Merkle gen_proof at height 6 through the kernels and through the
           plain versions: the proof bytes must be equal and verify
  main     the main path at height H (default 15, n = 2^22), through the
           entry points a user calls: device_srs, MerkleLayout,
           preprocess_layout, witness, prove_torch, verify; then
           prove_many over that witness and one with other leaves. The
           kernel launches of each path are counted, and every kernel of a
           path must have run in it

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. The last line is the result object.
"""

import argparse
import faulthandler
import json
import os
import re
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
# kernels with no caller in either package: held against their plain
# versions in the kernels phase, launched by no path
OFF_PATH = ("mul3", "xyzz_add_mixed")
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


def _mixed_operands(P, aff):
    """K8 operands: xyzz P (random Z) and affine Q with the special cases
    in the first columns: P = O; Q = O; both; P == lift(Q) with ZZ != 1;
    P == -lift(Q); P == lift(Q) with ZZ = 1."""
    import torch
    from zprize_tpu_torch.curve import g1
    from zprize_tpu_torch.fields import kernels, mont
    from zprize_tpu_torch.fields.mont import FQ
    L = FQ.L
    P = P.clone()
    qx, qy = aff[2].clone(), aff[3].clone()
    with kernels.impl("plain"):
        P[:, 0] = 0
        qx[:, 1] = qy[:, 1] = 0
        P[:, 2] = 0
        qx[:, 2] = qy[:, 2] = 0
        x, y = g1.xyzz_to_affine_device(P[:, 3:5].contiguous())
        qx[:, 3:5] = x
        qy[:, 3] = y[:, 0]
        qy[:, 4] = mont.neg(FQ, y[:, 1:2].contiguous())[:, 0]
        P[:, 5] = g1.xyzz_from_affine(qx[:, 5:6], qy[:, 5:6])[:, 0]
    if not bool((P[2 * L:3 * L, 3] != FQ.const("one", P.device)[:, 0])
                .any()):
        raise AssertionError("K8 case P == lift(Q) needs ZZ != 1")
    return P.contiguous(), qx.contiguous(), qy.contiguous()


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
    """Returns {name: record} for the nine kernels; raises on a
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
        c = _rand_field(C, n, rng)
        cases[C.name] = (a, b, c)

    plan = ntt.get_plan(12, "cuda")
    stage_inputs = [(_rand_field(FR, 2 * n, rng), 1),
                    (_rand_field(FR, 37 * 4096, rng), 2048)]
    aff, xyzz = _rand_points(n, rng)
    mixed = _mixed_operands(xyzz[0], aff)

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
        a, b, c = cases[C.name]
        for name in ("mul", "add", "sub"):
            fn = getattr(kernels, name)
            check(name, C.name, lambda: fn(C.P, a, b))
        check("neg", C.name, lambda: kernels.neg(C.P, a))
        check("mul3", C.name, lambda: kernels.mul3(C.P, a, b, c))
        check("mul3", C.name + "/broadcast",
              lambda: kernels.mul3(C.P, a, b[:, :1].contiguous(), c))
    for x, half in stage_inputs:
        step = plan.n // (2 * half)
        check("mul_add_sub", f"half={half}",
              lambda: kernels.butterfly_stage(FR.P, x, plan.tw, half, step))
    P, Q = xyzz
    check("xyzz_add", "specials", lambda: g1.xyzz_add(P, Q))
    check("xyzz_add_mixed", "specials", lambda: g1.xyzz_add_mixed(*mixed))
    check("xyzz_add_affine2", "specials",
          lambda: g1.xyzz_add_affine2(*aff))
    torch.cuda.synchronize()

    # time per launch at n = 2^22, kernel and plain version, with bounds;
    # the outputs of the two are held equal at this size too
    N = TIME_N
    fr_ops, fq_ops = _field_ops(8), _field_ops(12)
    big = {C.name: tuple(_tile(t, N) for t in cases[C.name])
           for C in (FR, FQ)}
    bigP, bigQ = _tile(P, N), _tile(Q, N)
    big_aff = [_tile(t, N) for t in aff]
    big_mixed = [_tile(t, N) for t in mixed]
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

    fq_a, fq_b, fq_c = big["fq"]
    fr_a, fr_b, _ = big["fr"]
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
    out["mul3"] = rec("mul3", "zprize_tpu/fields/pkern.py:187",
                      lambda: kernels.mul3(FQ.P, fq_a, fq_b, fq_c),
                      4 * 24 * 4 * N, 2 * fq_ops["mul"] * N, "fq")
    pt_ops = 14 * fq_ops["mul"] + 7 * fq_ops["addsub"]
    out["xyzz_add"] = rec(
        "xyzz_add", "zprize_tpu/fields/pkern.py:215",
        lambda: g1.xyzz_add(bigP, bigQ),
        3 * 96 * 4 * N, pt_ops * N, "fq")
    # the lift: two 12-word zero tests and two 12-word selects
    out["xyzz_add_mixed"] = rec(
        "xyzz_add_mixed", "zprize_tpu/fields/pkern.py:230",
        lambda: g1.xyzz_add_mixed(*big_mixed),
        (96 + 48 + 96) * 4 * N, (pt_ops + 4 * 12) * N, "fq")
    out["xyzz_add_affine2"] = rec(
        "xyzz_add_affine2", "zprize_tpu/fields/pkern.py:245",
        lambda: g1.xyzz_add_affine2(*big_aff),
        (4 * 24 + 96) * 4 * N, pt_ops * N, "fq")
    for k, r in out.items():
        emit({"kernel_check": k, "equal": True, "cases": len(checks[k]),
              "ms": r["ms"], "plain_ms": r["plain_ms"]})
    del big, bigP, bigQ, big_aff, big_mixed, bx
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# a general circuit: every widget, real lookups
# ---------------------------------------------------------------------------

CIRCUIT_LOG_N = 10


def build_circuit():
    """A StandardComposer circuit that uses every widget: arithmetic with
    public inputs, range, XOR and AND logic, a fixed-base scalar
    multiplication, a variable-base one (an 8-bit scalar: the 255-bit
    gadget alone needs ~2,000 gates, twice this domain), and a lookup of
    every row of a 256-row XOR table. ~620 gates, padded to n = 2^10."""
    from zprize_tpu_torch.params import R_MOD
    from zprize_tpu_torch.circuit import StandardComposer, Point
    from zprize_tpu_torch.curve import jubjub
    M = R_MOD
    cs = StandardComposer()
    cs.lookup_table.insert_multiple_xor(0, 16)
    a = cs.add_input(20)
    b = cs.add_input(5)
    cs.arithmetic_gate(q_l=1, q_r=1, w_l=a, w_r=b, q_o=0, w_o=cs.zero_var,
                       pi=(-25) % M)
    cs.constrain_to_constant(cs.mul(a, b), 100)
    cs.range_gate(a, 6)
    cs.range_gate(cs.add_input(0xDEADBEEF), 32)
    u, v = cs.add_input(0xB5), cs.add_input(0x6C)
    cs.constrain_to_constant(cs.xor_gate(u, v, 8), 0xB5 ^ 0x6C)
    cs.constrain_to_constant(cs.and_gate(u, v, 8), 0xB5 & 0x6C)

    def public_point(p, want):
        cs.constrain_to_constant(p.x, 0, pi=(-want[0]) % M)
        cs.constrain_to_constant(p.y, 0, pi=(-want[1]) % M)

    k = 67 * 5
    public_point(cs.fixed_base_scalar_mul(cs.add_input(k)),
                 jubjub.mul(jubjub.GENERATOR, k))
    # variable base: variable_base_scalar_mul's gadgets on 8 bits
    base = jubjub.mul(jubjub.GENERATOR, 7)
    point = Point(cs.add_input(base[0]), cs.add_input(base[1]))
    s = 0xA7
    s_var = cs.add_input(s)
    bits = [cs.add_input((s >> i) & 1) for i in range(8)]
    acc = cs.zero_var
    for power, bv in enumerate(bits):
        cs.boolean_gate(bv)
        acc = cs.arithmetic_gate(q_l=pow(2, power, M), q_r=1, w_l=bv,
                                 w_r=acc)
    cs.assert_equal(acc, s_var)
    result = Point.identity(cs)
    for bit in reversed(bits):
        result = cs.point_addition_gate(result, result)
        result = cs.point_addition_gate(
            result, cs.conditional_select_identity(bit, point))
    public_point(result, jubjub.mul(base, s))
    for x in range(16):
        for y in range(16):
            cs.lookup_gate(cs.add_input(x), cs.add_input(y),
                           cs.add_input(x ^ y))
    return cs


def _host_srs(points, lite):
    """Device SRS points -> the spec's SRS (Python-int points)."""
    from zprize_tpu_torch.fields.mont import FQ
    from zprize_tpu_torch.ref.kzg import SRS
    x, y, inf = points
    xs, ys = FQ.from_mont_host(x), FQ.from_mont_host(y)
    pts = [None if i else (a, b) for a, b, i in zip(xs, ys, inf.tolist())]
    return SRS(pts, lite.h, lite.beta_h)


def check_circuit(device="cuda", counts=None):
    """Path (a): a general circuit from the composer to a verified proof,
    proved four ways that must give equal bytes. `counts`, if given,
    receives the kernel launches of the first (kernel) prove alone."""
    import tempfile
    import torch
    from zprize_tpu_torch.fields import kernels
    from zprize_tpu_torch.protocol import prover_torch as pt
    from zprize_tpu_torch.protocol import keys_io
    from zprize_tpu_torch.protocol.serde import serialize_proof
    from zprize_tpu_torch.protocol.srs import device_srs
    from zprize_tpu_torch.protocol.transcript_protocol import \
        TranscriptProtocol
    from zprize_tpu_torch.ref import prover as rp
    from zprize_tpu_torch.ref.verifier import verify

    secs = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        secs[name] = time.time() - t0
        return out

    cs = timed("build", build_circuit)
    cs.check_circuit_satisfied()
    gates = cs.n
    n = cs.circuit_bound()
    if n != 1 << CIRCUIT_LOG_N:
        raise AssertionError(f"circuit pads to {n}, not 2^{CIRCUIT_LOG_N}")
    pts, lite, _ = timed("device_srs", lambda: device_srs(n + 8,
                                                          device=device))
    srs = _host_srs(pts, lite)
    label = b"circuit"
    tr = TranscriptProtocol(label)
    pk, vk = timed("preprocess", lambda: rp.preprocess(cs, srs, tr))
    if pk.n != n:
        raise AssertionError(f"key domain {pk.n} != {n}")

    proofs = {}

    def prove(name, dev_pk, **kw):
        cfg = pt.ProverConfig(device=device, **kw)
        proof = timed(f"prove_{name}", lambda: pt.prove_torch(
            pt.ProverWitness.from_composer(cs, n, device), dev_pk, dev_srs,
            tr.clone(), cfg))
        proofs[name] = serialize_proof(proof)
        return proof

    kernels.reset_counts()
    dev_srs = timed("dev_srs_from_ref", lambda: pt.DevSRS.from_ref(srs,
                                                                  device))
    dev_pk = timed("dev_pk_from_ref", lambda: pt.DevProverKey.from_ref(
        pk, device))
    if dev_pk.lookup_degenerate:
        raise AssertionError("the circuit's lookup must not be degenerate")
    proof = prove("kernel", dev_pk)
    if counts is not None:
        counts.update(kernels.COUNTS)
    vtr = TranscriptProtocol(label)
    rp.seed_transcript(vtr, vk)
    if not timed("verify", lambda: verify(vk, srs, proof, cs.public_inputs,
                                          vtr)):
        raise AssertionError("circuit proof does not verify")
    prove("plain", dev_pk, impl="plain")
    prove("host_msm", dev_pk, msm_backend="host")
    with tempfile.TemporaryDirectory() as d:
        keys_io.save_prover_key(dev_pk, os.path.join(d, "pk.npz"))
        keys_io.save_verifier_key(vk, os.path.join(d, "vk.json"))
        loaded = keys_io.load_prover_key(os.path.join(d, "pk.npz"), device)
        vk2 = keys_io.load_verifier_key(os.path.join(d, "vk.json"))
    proof = prove("keys_io", loaded)
    vtr = TranscriptProtocol(label)
    rp.seed_transcript(vtr, vk2)
    if not verify(vk2, srs, proof, cs.public_inputs, vtr):
        raise AssertionError("proof from the loaded key does not verify "
                             "with the loaded verifier key")
    ref = proofs["kernel"]
    differ = [k for k, v in proofs.items() if v != ref]
    if differ:
        raise AssertionError(f"circuit proofs differ from the kernel "
                             f"path's: {differ}")
    return {"gates": gates, "n": n, "lookup_rows": cs.lookup_table.size(),
            "proof_bytes_equal": True, "proofs": sorted(proofs),
            "verify": "PASS", "seconds": secs}


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
              on_done=None, many_counts=None):
    """SRS -> layout -> preprocess -> witness -> prove (once per impl) ->
    verify. Returns (proof bytes per impl, phase seconds, pass counts).
    timed: log preprocess phases and prove rounds; on_done: called right
    after the verify; many_counts: a dict, to run prove_many after that
    (see _prove_many) and receive its kernel launches; profile: one more
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
    if many_counts is not None:
        _prove_many(lay, pk, vk, dev_srs, lite, wires, pi, proofs["kernel"],
                    many_counts)
    if profile:
        t = TranscriptProtocol(b"Merkle tree")
        seed_transcript(t, vk)
        _profile_prove(lambda: pt.prove_torch(
            pt.ProverWitness(wires, pi), pk, dev_srs, t,
            pt.ProverConfig(device="cuda")), height)
    return proofs, secs, {"preprocess": pre_passes, **passes}


def _prove_many(lay, pk, vk, dev_srs, lite, wires, pi, first_bytes,
                counts):
    """Path (b): prove_many over the main witness and one with other
    seeded leaves, one proof at a time on device 0's thread; the first
    proof must equal the main proof and both must verify. `counts`
    receives the kernel launches of the prove_many call alone."""
    import torch
    from zprize_tpu_torch.params import R_MOD
    from zprize_tpu_torch.fields import kernels
    from zprize_tpu_torch.fields.mont import FR
    from zprize_tpu_torch.protocol import prover_torch as pt
    from zprize_tpu_torch.protocol.batch import prove_many
    from zprize_tpu_torch.protocol.serde import serialize_proof
    from zprize_tpu_torch.protocol.transcript_protocol import \
        TranscriptProtocol
    from zprize_tpu_torch.ref.prover import seed_transcript
    from zprize_tpu_torch.ref.verifier import verify

    h = lay.height
    with Phase(f"h{h}.prove_many"):
        leaves = FR.tensor(_leaves(lay.m_leaves, h + 1000), "cuda")
        wires2, root2, _ = lay.witness(leaves)
        pis = [pi, {lay.root_gate_pos: (-root2) % R_MOD}]
        witnesses = [pt.ProverWitness(wires, pis[0]),
                     pt.ProverWitness(wires2, pis[1])]
        base = TranscriptProtocol(b"Merkle tree")
        seed_transcript(base, vk)
        torch.cuda.synchronize()
        kernels.reset_counts()
        proofs, wall, pps = prove_many(
            witnesses, pk, dev_srs, base, pt.ProverConfig(device="cuda"),
            devices=[torch.device("cuda", 0)])
        counts.update(kernels.COUNTS)
        if serialize_proof(proofs[0]) != first_bytes:
            raise AssertionError("prove_many's first proof differs from "
                                 "the main path's proof")
        for proof, p in zip(proofs, pis):
            vtr = TranscriptProtocol(b"Merkle tree")
            seed_transcript(vtr, vk)
            if not verify(vk, lite, proof, p, vtr):
                raise AssertionError("a prove_many proof does not verify")
    emit({"prove_many": {"height": h, "proofs": len(proofs),
                         "wall_s": wall, "proofs_per_s": pps,
                         "first_equals_main": True, "verify": "PASS",
                         "launches": dict(counts)}})


def check_h6():
    proofs, secs, passes = gen_proof(6, impls=("kernel", "plain"))
    if proofs["kernel"] != proofs["plain"]:
        raise AssertionError("h6: kernel-path proof bytes differ from the "
                             "plain-path proof")
    emit({"h6": {"proof_bytes_equal": True, "bytes": len(proofs["kernel"]),
                 "seconds": secs, "commit_passes": passes}})


def main_path(height, profile=False):
    """The main path at `height`, then prove_many; returns the kernel
    launch counts of each, {"main": ..., "prove_many": ...}, of exactly
    that run (a profiled extra prove comes after both counts)."""
    import torch
    from zprize_tpu_torch.fields import kernels
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    counts = {"main": {}, "prove_many": {}}
    peak = {}

    def on_done():
        counts["main"].update(kernels.COUNTS)
        peak["main"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    with Phase(f"main_h{height}"):
        _, secs, passes = gen_proof(
            height, timed=True, profile=profile, on_done=on_done,
            many_counts=counts["prove_many"])
    emit({"main": {"height": height, "n": 1 << (
        (4 + 193 * ((1 << (height - 1)) - 1) + 1 - 1).bit_length()),
        "seconds": secs, "commit_passes": passes,
        "max_memory_allocated": peak["main"],
        "max_memory_allocated_prove_many":
            torch.cuda.max_memory_allocated(),
        "launches": counts["main"]}})
    return counts


def _require_launched(path, counts):
    """Every kernel that the paths run must have launched in `path`."""
    from zprize_tpu_torch.fields import kernels
    missing = [k for k in kernels.KERNEL_NAMES
               if k not in OFF_PATH and counts[k] == 0]
    if missing:
        fail(f"kernels never launched on the {path} path: {missing}")


def _kernel_name(mangled):
    """'_ZN<anonymous namespace>13mul3_kernelI2FqEE...' -> 'mul3_kernel<Fq>'
    (the identifier plus the template's field and op)."""
    nested = mangled.startswith("_ZN")
    i = 3 if nested else 2

    def token(i):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j == i:
            return None, i
        k = int(mangled[i:j])
        return mangled[j:j + k], j + k

    name, i = token(i)
    if name is None:
        return mangled
    if nested and name.startswith("_GLOBAL__N"):
        name, i = token(i)
    tmpl = re.match(r"I2(F[rq])(?:Li(\d)E)?", mangled[i:])
    if tmpl:
        name += "<" + ",".join(g for g in tmpl.groups() if g) + ">"
    return name


def _ptxas_summary(log):
    """ptxas -v output -> {kernel: registers and spill bytes}."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=MAIN_HEIGHT)
    ap.add_argument("--phases",
                    default="probe,build,kernels,circuit,h6,main")
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
        emit({"build": info,
              "ptxas": _ptxas_summary(info.pop("ptxas", ""))})

    results = {}
    if "kernels" in phases:
        with Phase("kernels"):
            results = check_kernels()
    path_counts = {}
    if "circuit" in phases:
        with Phase("circuit"):
            counts = {}
            out = check_circuit("cuda", counts)
            emit({"circuit": out, "launches": counts})
            for k in ("preprocess", "prove_kernel", "verify"):
                print(f"circuit {k} seconds: {out['seconds'][k]}",
                      flush=True)
        _require_launched("circuit", counts)
        path_counts["circuit"] = counts
    if "h6" in phases:
        with Phase("h6"):
            check_h6()
    if "main" in phases:
        counts = main_path(args.height, args.profile)
        for path in ("main", "prove_many"):
            _require_launched(path, counts[path])
        path_counts["prove_many"] = counts["prove_many"]
        for k, r in results.items():
            r["launches"] = counts["main"][k]
    for k, r in results.items():
        r["launches_by_path"] = {p: c[k] for p, c in path_counts.items()}
    if results:
        emit({"kernels": list(results.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
