#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`zprize_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--height H]
                          [--phases probe,build,kernels,msm,entry,circuit,
                                    h6,main,mesh]

Phases, in order; each prints a JSON line before it starts and one with its
seconds when it ends:
  probe    the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc-builds the kernel library from zprize_tpu_torch/csrc;
           prints ptxas's registers and spills, SASS instruction counts
           and the card's measured issue rates of the 32-bit multiply
           forms a Montgomery product compiles to (int_rate)
  kernels  each of the nine elementwise kernels against its plain
           PyTorch version at n = 2^16 + 37 (random + edge values, exact
           equality; K5 also along axis -2 with a lane stride, at a small
           odd shape and at the h15 four-step's 2^11 rows x 2^11 lanes),
           then its time per launch at n = 2^22 (K5 flat and with lanes);
           then ops/ntt's four-step NTT and INTT of two 2^22 columns
           against the flat radix-2 stage chain (four_step_check)
  msm      the MSM's bucket kernels (bucket_acc, bucket_sum) and the
           tree-level K7 (xyzz_add_pairs) bit-equal to their plain versions
           on 2^16 points (random, skewed and all-equal digits, every
           level); then one MSM at the h15 shape (2^22 SRS points, 16-bit
           windows, seeded scalars) with CUDA-event times of its stages
           (sort + bounds, chunk list, bucket kernel, partial levels, fold,
           device window fold, copy to the host), the window fold held to
           the Python-int host fold and the result to (sum s_i tau^i) G,
           and each of the three kernels timed and held to its plain
           version at the shape that MSM gives it
  entry    the entry step (zprize_tpu_torch.entry: 128 Poseidon hashes,
           then a 2^7 INTT) on the card, held equal to the CPU's
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
           path must have run in it. Then, on the same set-up, one prove
           timed round by round (tools.timeline) and one with its memory
           peak attributed (tools.mem_attr); both examples at small sizes
           (each must verify); the micro-benchmarks (tools.micro). The
           mesh phase always runs inside it, on its set-up, after the
           timeline and memory attribution
  mesh     the sharded prover (parallel/mesh.py) on one NCCL group of
           every card, one rank a card: in this process on the main
           path's set-up with one card, else one spawned process a card,
           each building that set-up on its own card. On each rank: the
           four-step NTT and INTT of the five round-1 columns (n1 = n2 =
           2^11 at h15) held equal to ops/ntt's and timed
           beside them, and the sharded transforms of the rank's columns
           alone; the sharded MSM window and the meshed commit held to
           msm.msm; then the rank keeps its columns of the key, witness and
           SRS, frees the whole and proves: every rank's proof must equal
           the main proof, and verify; the bytes resident before that
           prove and its max_memory_allocated are reported per rank. Then
           entry.dryrun_multichip over the cards; the sharded prover at
           an odd log n (h6, n = 2^13, the four-step sides 64 and 128,
           so the INTT takes the swapped plan) at world size 1 in this
           process and, with the cards, at 2 and 4 spawned ranks, every
           rank's proof equal to the whole h6 proof; and with several
           cards prove_many over them (4 proofs a card), one process a
           card, timed beside the thread design it replaced, with each
           process's start-up seconds and each prove's host CPU
           seconds. Listed with main it changes
           nothing (main runs it); listed without main it is a rehearsal
           of the mesh phase: the main path's set-up, prove and verify,
           then the mesh phase, and nothing else of main (no prove_many
           on one card, tools, examples or micro)

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
# kernels that a path does not launch, each held against its plain version
# all the same: mul3 has no caller in either package; xyzz_add_mixed's
# device code runs inside bucket_acc; xyzz_add_affine2 is called by
# device_srs, which only the main path runs after its counts start; and
# bucket_sum runs only where a bucket has more than msm.CHUNK members,
# which the circuit's n = 2^10 does not promise
OFF_PATH = ("mul3", "xyzz_add_mixed")
# K5 runs flat (mul_add_sub) in the radix-2 transforms below n = 2^13 and
# along axis -2 (mul_add_sub_lanes) in the four-step ones from 2^13 up:
# every transform of the h15 path (n = 2^22) is four-step, a sharded
# rank's are the mesh's four-step on 2^11-point radix-2 sub-transforms
FLAT_ONLY = ("mul_add_sub_lanes",)
LANES_ONLY = ("mul_add_sub",)
NOT_LAUNCHED = {
    # the entry step runs the Poseidon rounds (mul, add) and a 2^7 INTT
    # (mul_add_sub, mul)
    "entry": OFF_PATH + FLAT_ONLY + (
        "sub", "neg", "xyzz_add", "xyzz_add_affine2", "xyzz_add_pairs",
        "bucket_acc", "bucket_sum"),
    "main": OFF_PATH + LANES_ONLY,
    "prove_many": OFF_PATH + LANES_ONLY + ("xyzz_add_affine2",),
    # one rank's sharded prove: no device_srs either
    "sharded": OFF_PATH + FLAT_ONLY + ("xyzz_add_affine2",),
    # one rank's sharded prove at h6 (n = 2^13), whose MSM buckets need
    # not outgrow msm.CHUNK
    "sharded_h6": OFF_PATH + FLAT_ONLY + ("xyzz_add_affine2", "bucket_sum"),
    # prove_many's processes, one a card, added up
    "prove_many_cards": OFF_PATH + LANES_ONLY + ("xyzz_add_affine2",),
    # n = 2^10
    "circuit": OFF_PATH + FLAT_ONLY + ("xyzz_add_affine2", "bucket_sum"),
    # the set-up's or the dry run's device_srs launches xyzz_add_affine2
    "mesh": OFF_PATH,
}
TIME_N = 1 << 22
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (data sheet)
# 32-bit integer multiply-add (and add) instructions per clock per SM on
# compute capability 9.0: NVIDIA CUDA C++ Programming Guide, arithmetic
# instruction throughput table; times SMs and the SM clock (int_ops_s)
INT_OPS_PER_CLOCK_SM = 64
_RATE = {}


def int_ops_s():
    """32-bit integer operations per second of card 0: 64 a clock per SM
    at `nvidia-smi --query-gpu=clocks.max.sm`."""
    if "ops" not in _RATE:
        import torch
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        if not out:
            fail("nvidia-smi gave no SM clock")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _RATE.update(mhz=float(out[0]), sms=sms,
                     ops=INT_OPS_PER_CLOCK_SM * sms * float(out[0]) * 1e6)
    return _RATE["ops"]


# Issue rates, measured on the card, of the two 32-bit multiply forms:
# mad.lo.u32 (IMAD) and the mad.lo.cc / madc.hi.cc pairs of
# csrc/field.cuh's carry chains, which ptxas fuses into one
# IMAD.WIDE.U32(.X) a pair (one 32x32 -> 64-bit product). Each kernel runs
# 96 of its operations an iteration over independent accumulators.
_RATE_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
extern "C" __global__ void rate_mad_lo(uint32_t* out, uint32_t s, int iters) {
  uint32_t a = s ^ (blockIdx.x * blockDim.x + threadIdx.x), acc[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) acc[i] = a + i;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 12; ++i)
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(acc[i]) : "r"(s), "r"(a));
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) x ^= acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}
// acc[0..11] += (v0..v5) * s as in field.cuh's mac_even: six lo/hi pairs
// on one carry chain, the carry out into top
__device__ __forceinline__ void chain(uint32_t* acc, uint32_t& top,
                                      const uint32_t* v, uint32_t s) {
  asm volatile(
      "mad.lo.cc.u32 %0, %13, %19, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
      "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
      "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
      "addc.u32 %12, %12, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(top)
      : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(v[4]), "r"(v[5]),
        "r"(s));
}
// two independent chains interleaved, as field.cuh's even and odd words
extern "C" __global__ void rate_carry_pair(uint32_t* out, uint32_t s, int iters) {
  uint32_t a = s ^ (blockIdx.x * blockDim.x + threadIdx.x);
  uint32_t x0[12], x1[12], t0 = 0, t1 = 0, v[6], s1 = s * 3u + 1u;
#pragma unroll
  for (int i = 0; i < 12; ++i) x0[i] = a + i, x1[i] = a ^ i;
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = a * (2u * i + 3u);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      chain(x0, t0, v, s);
      chain(x1, t1, v, s1);
    }
  uint32_t x = t0 ^ t1;
#pragma unroll
  for (int i = 0; i < 12; ++i) x ^= x0[i] ^ x1[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}
extern "C" int rate_launch(int form, int blocks, int threads, int iters,
                           uint32_t* out, cudaStream_t stream) {
  if (form == 0) rate_mad_lo<<<blocks, threads, 0, stream>>>(out, 0x9e3779b9u, iters);
  if (form == 1) rate_carry_pair<<<blocks, threads, 0, stream>>>(out, 0x9e3779b9u, iters);
  return int(cudaGetLastError());
}
"""
RATE_FORMS = ("mad_lo", "carry_pair")


def start_rate_build():
    """Start nvcc on the rate probe (beside the kernel library's build);
    returns (process, library path)."""
    import hashlib
    from zprize_tpu_torch.fields import kernels
    d = os.path.join(ROOT, ".torch_ext", "rate-" + hashlib.sha256(
        _RATE_SRC.encode()).hexdigest()[:16])
    os.makedirs(d, exist_ok=True)
    src, lib = os.path.join(d, "rate.cu"), os.path.join(d, "librate.so")
    with open(src, "w") as f:
        f.write(_RATE_SRC)
    cmd = [kernels.nvcc_path(), "-O3", kernels.ARCH_FLAG, "-shared",
           "-Xcompiler", "-fPIC", "-o", lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def measure_rates(proc, lib):
    """Operations per clock per SM (at clocks.max.sm) of each RATE_FORMS
    kernel, median of 3 timed launches, and the SASS of the probe."""
    import ctypes
    import torch
    log, _ = proc.communicate(timeout=300)
    if proc.returncode != 0:
        fail(f"rate probe build failed:\n{log}")
    h = ctypes.CDLL(lib)
    h.rate_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    int_ops_s()
    blocks, threads, iters = _RATE["sms"] * 16, 256, 2048
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for form, name in enumerate(RATE_FORMS):
        ms = []
        for rep in range(4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rc = h.rate_launch(form, blocks, threads, iters, out.data_ptr(),
                               stream)
            b.record()
            torch.cuda.synchronize()
            if rc != 0:
                fail(f"rate probe {name} failed to launch ({rc})")
            if rep:                                 # the first warms up
                ms.append(a.elapsed_time(b))
        t = sorted(ms)[1] * 1e-3
        rates[name] = (blocks * threads * iters * 96 / t
                       / (_RATE["sms"] * _RATE["mhz"] * 1e6))
    return {"per_clock_sm": rates, "sass": _sass_counts(lib)}


def _field_ops(N):
    """32-bit multiply-add issue slots (64 a clock per SM) per element: a
    Montgomery product is 2 N^2 32x32 -> 64-bit products (a_j b_i and
    m p_j), each a lo/hi pair that ptxas fuses into one IMAD.WIDE.U32(.X),
    which issues at half the IMAD rate (the int_rate line: carry_pair ~31.5
    a clock per SM, mad_lo ~64), so two slots each; plus N for m; add/sub
    ~4 N."""
    return {"mul": 4 * N * N + N, "addsub": 4 * N, "neg": 2 * N}


_FQ = _field_ops(12)
# multiply-adds and add/subs of one point addition, by formula
# (csrc/field.cuh): K7 xyzz + xyzz 14 products, K8 xyzz + affine 10
# (ZZ2 = ZZZ2 = 1), K9 affine + affine 6; 7 additions/subtractions each
K7_OPS = 14 * _FQ["mul"] + 7 * _FQ["addsub"]
K8_OPS = 10 * _FQ["mul"] + 7 * _FQ["addsub"]
K9_OPS = 6 * _FQ["mul"] + 7 * _FQ["addsub"]


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
    # b, c, d are other pool points than a, so no column outside the
    # special ones doubles (a doubling is a divergent branch of K7-K9
    # that the MSM's distinct SRS points do not take)
    first = rng.integers(0, 64, n)
    idx = [torch.from_numpy(first).cuda()] + [
        torch.from_numpy((first + rng.integers(1, 64, n)) % 64).cuda()
        for _ in range(3)]
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


def compare(name, got, want):
    """Max |kernel - plain| over the words, which must be 0."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}")
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
    if int(err) != 0:
        bad = (got != want).reshape(got.shape[0], -1).any(0).nonzero()
        raise AssertionError(f"{name}: kernel != plain at columns "
                             f"{bad[:5, 0].tolist()}")
    return int(err)


def record(name, replaces, fn, bytes_moved, ops, errs, reps=10, **extra):
    """Time `fn` (one kernel launch) and its plain version, hold the two
    outputs equal, and build the kernel's entry of the `kernels` line."""
    from zprize_tpu_torch.tools.cudatime import time_ms
    ms, got = time_ms(fn, reps)
    plain_ms, want = time_ms(_plain(fn), 1)
    errs.append(compare(f"{name}/timed", got, want))
    del got, want
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / int_ops_s() * 1e3
    return {"name": name, "route": "cuda",
            "source": "zprize_tpu_torch/csrc/kernels.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, **extra}


def check_kernels():
    """Returns {name: record} for the nine elementwise kernels (K5 twice:
    flat, and along axis -2 with a lane stride); raises on a mismatch, at
    n = 2^16 + 37 (K5 with lanes at a small odd shape and at the h15
    four-step's) and at the timed n = 2^22. Then the four-step transforms
    at 2^22 against the flat radix-2 chain (check_four_step)."""
    import numpy as np
    import torch
    from zprize_tpu_torch.fields import kernels
    from zprize_tpu_torch.fields.mont import FR, FQ
    from zprize_tpu_torch.curve import g1
    from zprize_tpu_torch.ops import ntt, poly
    from zprize_tpu_torch.ref.field import root_of_unity

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
    # K5 along axis -2: a small odd shape (3 x 2^6 rows x 2^3 lanes, so a
    # warp spans four pairs of rows) and the h15 four-step's (2^11 rows x
    # 2^11 lanes), with its 2^11-point sub-plan's twiddles
    tw11 = ntt.get_plan(11, "cuda").tw
    lane_inputs = [(_rand_field(FR, 3 * 64 * 8, rng), 8, 1, plan.tw, 64),
                   (_rand_field(FR, 3 * 64 * 8, rng), 8, 16, plan.tw, 1),
                   (_rand_field(FR, 1 << 22, rng), 1 << 11, 1, tw11,
                    1 << 10),
                   (_rand_field(FR, 1 << 22, rng), 1 << 11, 1 << 10, tw11,
                    1)]
    aff, xyzz = _rand_points(n, rng)
    mixed = _mixed_operands(xyzz[0], aff)

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
    for x, lanes, half, tw, step in lane_inputs:
        check("mul_add_sub_lanes", f"lanes={lanes},half={half}",
              lambda: kernels.butterfly_stage(FR.P, x, tw, half, step,
                                              lanes))
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
    # the flat stage's table, w^j for j < 2^21 (a four-step plan holds
    # no radix-2 table)
    big_tw = poly.powers(FR, FR.scalar(root_of_unity(22), "cuda"), N // 2)
    bx = _tile(stage_inputs[0][0], N)

    def rec(name, replaces, fn, bytes_moved, ops, field, **extra):
        return record(name, replaces, fn, bytes_moved, ops, checks[name],
                      field=field, n=N, **extra)

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
        (fr_ops["mul"] + 2 * fr_ops["addsub"]) * (N // 2), "fr", lanes=1)
    # the last stage of the h15 four-step's first sub-transform: 2^11
    # rows of 2^11 lanes, half = 2^10, one twiddle row
    lx = lane_inputs[2][0]
    out["mul_add_sub_lanes"] = rec(
        "mul_add_sub_lanes", "zprize_tpu/fields/pkern.py:172",
        lambda: kernels.butterfly_stage(FR.P, lx, tw11, 1 << 10, 1,
                                        1 << 11),
        2 * 16 * 4 * N + 16 * 4 * (1 << 10),
        (fr_ops["mul"] + 2 * fr_ops["addsub"]) * (N // 2), "fr",
        lanes=1 << 11)
    out["mul3"] = rec("mul3", "zprize_tpu/fields/pkern.py:187",
                      lambda: kernels.mul3(FQ.P, fq_a, fq_b, fq_c),
                      4 * 24 * 4 * N, 2 * fq_ops["mul"] * N, "fq")
    out["xyzz_add"] = rec(
        "xyzz_add", "zprize_tpu/fields/pkern.py:215",
        lambda: g1.xyzz_add(bigP, bigQ),
        3 * 96 * 4 * N, K7_OPS * N, "fq")
    out["xyzz_add_mixed"] = rec(
        "xyzz_add_mixed", "zprize_tpu/fields/pkern.py:230",
        lambda: g1.xyzz_add_mixed(*big_mixed),
        (96 + 48 + 96) * 4 * N, K8_OPS * N, "fq")
    out["xyzz_add_affine2"] = rec(
        "xyzz_add_affine2", "zprize_tpu/fields/pkern.py:245",
        lambda: g1.xyzz_add_affine2(*big_aff),
        (4 * 24 + 96) * 4 * N, K9_OPS * N, "fq")
    for k, r in out.items():
        emit({"kernel_check": k, "equal": True, "cases": len(checks[k]),
              "ms": r["ms"], "plain_ms": r["plain_ms"]})
    del big, bigP, bigQ, big_aff, big_mixed, bx, lx, lane_inputs
    emit({"four_step_check": check_four_step(big_tw)})
    del big_tw
    torch.cuda.empty_cache()
    return out


FOUR_STEP_COLUMNS = 2


def check_four_step(tw):
    """ops/ntt's NTT and INTT (four-step: two 2^11-point sub-transforms
    along axis -2, the mid twiddles, one transpose) of two 2^22 columns
    against the flat radix-2 chain on the same columns: a bit-reversal
    gather, 22 flat K5 stages on `tw` (w^j, j < 2^21) or its inverse
    built here, and 1/n for the inverse; and intt(ntt(x)) == x. Raises on
    a mismatch; returns both chains' times."""
    import numpy as np
    import torch
    from zprize_tpu_torch.fields import kernels, mont
    from zprize_tpu_torch.fields.mont import FR
    from zprize_tpu_torch.ops import ntt, poly
    from zprize_tpu_torch.params import R_MOD
    from zprize_tpu_torch.ref.field import root_of_unity
    from zprize_tpu_torch.tools.cudatime import time_ms

    log_n, n, L = 22, TIME_N, FR.L
    rng = np.random.default_rng(20261020)
    x = _rand_field(FR, FOUR_STEP_COLUMNS * n, rng).reshape(
        L, FOUR_STEP_COLUMNS, n)
    plan = ntt.get_plan(log_n, "cuda")
    if plan.p1 is None or (plan.p1.n, plan.p2.n) != (1 << 11, 1 << 11):
        raise AssertionError("the 2^22 plan is not a 2^11 x 2^11 four-step")
    itw = poly.powers(FR, FR.scalar(pow(root_of_unity(log_n), -1, R_MOD),
                                    "cuda"), n // 2)
    rev = torch.from_numpy(ntt._bit_reverse_indices(n)).cuda()
    n_inv = FR.scalar(pow(n, -1, R_MOD), "cuda")

    def flat(a, table, invert):
        y = a.index_select(2, rev).reshape(L, -1)
        for s in range(1, log_n + 1):
            y = kernels.butterfly_stage(FR.P, y, table, 1 << (s - 1),
                                        n >> s)
        y = y.reshape(a.shape)
        return mont.mont_mul(FR, y, n_inv) if invert else y

    out = {"n": n, "columns": FOUR_STEP_COLUMNS,
           "plan": [plan.p2.n, plan.p1.n]}
    out["ntt_ms"], ev = time_ms(lambda: ntt.ntt(plan, x), 5)
    out["flat_ntt_ms"], want = time_ms(lambda: flat(x, tw, False), 5)
    out["ntt_equal"] = torch.equal(ev, want)
    del want
    out["intt_ms"], co = time_ms(lambda: ntt.intt(plan, x), 5)
    out["flat_intt_ms"], want = time_ms(lambda: flat(x, itw, True), 5)
    out["intt_equal"] = torch.equal(co, want)
    del want, co
    out["roundtrip_equal"] = torch.equal(ntt.intt(plan, ev), x)
    if not (out["ntt_equal"] and out["intt_equal"]
            and out["roundtrip_equal"]):
        raise AssertionError(f"four-step transform != flat chain: {out}")
    return out


# ---------------------------------------------------------------------------
# the MSM: bucket kernels, tree-level K7, stage times at the h15 shape
# ---------------------------------------------------------------------------

MSM_LOG_N = 22
MSM_WINDOW_BITS = 16
MSM_CHECK_LOG_N = 16
MSM_SEED = 20261018


def _levels(pts, idx, starts, lens):
    """The bucket sums of one chunk list, level by level, through the
    kernels and through the plain versions, held bit-equal at every level;
    returns the number of levels."""
    from zprize_tpu_torch.ops import msm
    nb = starts.shape[0]
    chunks = msm.chunk_list(starts, lens)
    part = msm.first_level(pts, idx, chunks, nb)
    compare("bucket_acc/level0", part,
            _plain(lambda: msm.first_level(pts, idx, chunks, nb))())
    levels = 1
    while not chunks.final:
        nxt, nchunks = msm.next_level(part, chunks, nb)
        compare(f"bucket_sum/level{levels}", nxt,
                _plain(lambda: msm.next_level(part, chunks, nb)[0])())
        part, chunks, levels = nxt, nchunks, levels + 1
    return levels


def check_msm():
    """Returns {name: record} for bucket_acc, bucket_sum and
    xyzz_add_pairs; raises on a mismatch or a wrong MSM."""
    import numpy as np
    import torch
    from zprize_tpu_torch.curve import g1
    from zprize_tpu_torch.fields.mont import FQ
    from zprize_tpu_torch.ops import msm
    from zprize_tpu_torch.protocol.srs import device_srs
    from zprize_tpu_torch.tools.cudatime import median, stage
    from zprize_tpu_torch.tools.micro import msm_stages, scalars, sum_s_tau_g
    L = FQ.L
    rng = np.random.default_rng(20261018)

    # bit-equality at 2^16 points, 8-bit digits in 4 windows: random;
    # 3 of 4 points in one bucket (48-of-64 skew); all digits equal
    n = 1 << MSM_CHECK_LOG_N
    (x, y, _), _, _ = device_srs(n - 1, device="cuda")
    pts = g1.pack_affine(x, y)
    levels = {}
    for case in ("random", "skewed", "equal"):
        d = rng.integers(0, 256, size=(4, n))
        if case == "skewed":
            d[:, rng.permutation(n)[:3 * n // 4]] = 77
        if case == "equal":
            d[:] = 200
        digits = torch.from_numpy(d).to("cuda")
        levels[case] = _levels(pts, *msm.sort_members(digits, 8))
    emit({"msm_check": {"points": n, "window_bits": 8, "windows": 4,
                        "bit_equal": True, "levels": levels}})
    del x, y, pts

    # the h15 shape: 2^22 SRS points, 16-bit windows
    n = 1 << MSM_LOG_N
    wb = MSM_WINDOW_BITS
    (x, y, _), _, tau = device_srs(n - 1, device="cuda")
    pts = g1.pack_affine(x, y)
    del x, y
    raw = torch.from_numpy(scalars(n, MSM_SEED)).to("cuda")
    times, oracle = {}, {}
    msm_stages(pts, raw, wb, {})                   # warm-up
    for _ in range(3):
        res, mid = msm_stages(pts, raw, wb, times)
        # the device window fold against its oracle, the Python-int fold
        # of the same window points
        host = stage(oracle, "host_fold", lambda: msm.fold_windows_host(
            g1.xyzz_to_affine_host(mid["wp"]), wb))
        if res != host:
            raise AssertionError("h15-shape MSM: device window fold != "
                                 "host fold")
    # (sum_i s_i tau^i) G is the MSM over the SRS powers tau^i G
    if res != sum_s_tau_g(raw, tau):
        raise AssertionError("h15-shape MSM != (sum s_i tau^i) G")

    c, idx, nb = mid["chunks"], mid["idx"], mid["starts"].shape[0]
    levels, cc = 1, c
    while not cc.final:
        cc = msm.chunk_list(cc.offsets, cc.counts)
        levels += 1
    lens = (c.end - c.start).to(torch.int64)
    pairs = int((lens >= 2).sum())
    mixed = int((lens - 2).clamp(min=0).sum())
    chunks = int(lens.shape[0])
    col = torch.arange(chunks, dtype=torch.int32, device="cuda")

    def new(m, zero=False):
        fn = torch.zeros if zero else torch.empty
        return fn((4 * L, m), dtype=torch.int32, device="cuda")
    recs = {}
    recs["bucket_acc"] = record(
        "bucket_acc", "zprize_tpu/fields/pkern.py:245",
        lambda: msm.bucket_acc(pts, idx, c.start, c.end, col, new(chunks)),
        n * 96 + idx.numel() * 4 + chunks * (12 + 384),
        pairs * K9_OPS + mixed * K8_OPS, [0], reps=3,
        members=int(lens.sum()), chunks=chunks)
    # the first partial level (the one every h15 MSM runs)
    c1 = msm.chunk_list(c.offsets, c.counts)
    l1 = (c1.end - c1.start).to(torch.int64)
    m1 = int(l1.shape[0])
    col1 = c1.bucket if c1.final else torch.arange(
        m1, dtype=torch.int32, device="cuda")
    part = mid["part"]
    recs["bucket_sum"] = record(
        "bucket_sum", "zprize_tpu/fields/pkern.py:215",
        lambda: msm.bucket_sum(part, c1.start, c1.end, col1,
                               new(nb if c1.final else m1, c1.final)),
        part.shape[1] * 384 + m1 * (12 + 384),
        int((l1 - 1).sum()) * K7_OPS, [0], reps=10,
        partials=int(part.shape[1]), chunks=m1)
    # the fold's first tree level: (4L, W * B2, B1) row sums
    W = mid["W"]
    B1 = 1 << ((1 << wb).bit_length() // 2)
    G = mid["S"].reshape(4 * L, -1, B1)
    recs["xyzz_add_pairs"] = record(
        "xyzz_add_pairs", "zprize_tpu/fields/pkern.py:215",
        lambda: g1.xyzz_add_pairs(G),
        G.numel() * 4 * 3 // 2, G.shape[1] * (B1 // 2) * K7_OPS, [0],
        reps=10, rows=int(G.shape[1]), m=B1)
    stage_ms = {k: median(v) for k, v in times.items()}
    emit({"msm": {"points": n, "window_bits": wb, "windows": W,
                  "buckets": nb, "chunks": chunks,
                  "levels": levels,
                  "stage_ms": stage_ms,
                  "stage_ms_runs": times,
                  "total_ms": sum(stage_ms.values()),
                  "host_fold_ms": median(oracle["host_fold"]),
                  "window_fold_equals_host_fold": True,
                  "result_equals_sum_s_tau_G": True}})
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# the entry step
# ---------------------------------------------------------------------------

def check_entry(counts):
    """`entry()` on the card held equal to `entry(device="cpu")` (the plain
    versions) on the same 128 seeded pairs; `counts` receives the kernel
    launches of the card's step alone."""
    import torch
    from zprize_tpu_torch.entry import entry
    from zprize_tpu_torch.fields import kernels
    step, (left, right) = entry()
    torch.cuda.synchronize()
    kernels.reset_counts()
    out = step(left, right)
    torch.cuda.synchronize()
    counts.update(kernels.COUNTS)
    cpu_step, (cl, cr) = entry(device="cpu")
    if not (torch.equal(left.cpu(), cl) and torch.equal(right.cpu(), cr)):
        raise AssertionError("entry: the card's inputs differ from the CPU's")
    err = compare("entry", out.cpu(), cpu_step(cl, cr))
    return {"shape": list(out.shape), "equal": True, "max_abs_err": err}


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
    from zprize_tpu_torch.protocol.srs import device_srs, host_srs
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
    srs = host_srs(pts, lite)
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
              on_done=None, many_counts=None, tools=False, mesh_counts=None):
    """SRS -> layout -> preprocess -> witness -> prove (once per impl) ->
    verify. Returns (proof bytes per impl, phase seconds).
    timed: log preprocess phases and prove rounds; on_done: called with
    "main" right after the verify and with "prove_many" right after
    prove_many; many_counts: a dict, to run prove_many after that
    (see _prove_many) and receive its kernel launches; mesh_counts: a
    dict, to run the mesh phase after those and the tools (see
    _mesh_phase) and receive its kernel launches under "mesh" and
    "sharded"; tools: then time
    one more prove round by round (tools.timeline) and attribute one more
    prove's memory peak (tools.mem_attr); profile: one more prove under
    torch.profiler."""
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
    from zprize_tpu_torch.tools.merkle_setup import seeded_leaves

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
    leaves = FR.tensor(seeded_leaves(lay.m_leaves, height), "cuda")
    wires, root, _ = phase("witness", lambda: lay.witness(leaves))
    pi = {lay.root_gate_pos: (-root) % R_MOD}
    proofs = {}
    for impl in impls:
        t = TranscriptProtocol(b"Merkle tree")
        seed_transcript(t, vk)
        c = pt.ProverConfig(device="cuda", impl=impl,
                            log=(lambda s: emit({"log": s})) if timed
                            else None)
        proof = phase(f"prove_{impl}", lambda: pt.prove_torch(
            pt.ProverWitness(wires, pi), pk, dev_srs, t, c))
        proofs[impl] = serialize_proof(proof)
        vtr = TranscriptProtocol(b"Merkle tree")
        seed_transcript(vtr, vk)
        ok = phase(f"verify_{impl}",
                   lambda: verify(vk, lite, proof, pi, vtr))
        if not ok:
            raise AssertionError(f"h{height} {impl} proof does not verify")
        emit({"verify": "PASS", "height": height, "impl": impl})
    if on_done:
        on_done("main")
    if many_counts is not None:
        _prove_many(lay, pk, vk, dev_srs, lite, wires, pi, proofs["kernel"],
                    many_counts)
        if on_done:
            on_done("prove_many")
    if tools:
        from zprize_tpu_torch.tools import mem_attr, timeline
        from zprize_tpu_torch.tools.merkle_setup import MerkleSetup
        setup = MerkleSetup(lay, dev_srs, lite, pk, vk,
                            pt.ProverWitness(wires, pi))
        with Phase(f"h{height}.timeline"):
            emit({"timeline": timeline.measure(setup)})
        with Phase(f"h{height}.mem_attr"):
            emit({"mem_attr": mem_attr.measure(setup)})
        del setup
    if mesh_counts is not None:
        _mesh_phase(lay, pk, vk, dev_srs, lite, wires, pi, proofs["kernel"],
                    secs["prove_kernel"], mesh_counts)
    if profile:
        t = TranscriptProtocol(b"Merkle tree")
        seed_transcript(t, vk)
        _profile_prove(lambda: pt.prove_torch(
            pt.ProverWitness(wires, pi), pk, dev_srs, t,
            pt.ProverConfig(device="cuda")), height)
    return proofs, secs


# proofs a card of prove_many over several cards: enough that the
# processes' start-up does not hide the proving
MANY_PER_CARD = 4


def _prove_many(lay, pk, vk, dev_srs, lite, wires, pi, first_bytes,
                counts, devices=(0,)):
    """Path (b): prove_many over the main witness and one with other
    seeded leaves, proof i of witness i % 2. On one card (`devices`
    (0,)): two proofs, in this process. On several: MANY_PER_CARD x
    len(devices) proofs, proof i in card i % len(devices)'s process
    against its replica of the key and SRS; then the same proofs through
    the thread design that prove_many had before (`_prove_many_threads`),
    timed beside it and held to the same bytes. Every proof of the main
    witness must equal the main proof, those of the other witness one
    another, and one of each verifies. `counts` receives the kernel
    launches of the prove_many call alone (its processes' on several
    cards). Returns the emitted summary."""
    import torch
    from zprize_tpu_torch.params import R_MOD
    from zprize_tpu_torch.fields import kernels
    from zprize_tpu_torch.fields.mont import FR
    from zprize_tpu_torch.ops import ntt
    from zprize_tpu_torch.protocol import prover_torch as pt
    from zprize_tpu_torch.protocol.batch import prove_many
    from zprize_tpu_torch.protocol.serde import serialize_proof
    from zprize_tpu_torch.protocol.transcript_protocol import \
        TranscriptProtocol
    from zprize_tpu_torch.ref.prover import seed_transcript
    from zprize_tpu_torch.ref.verifier import verify

    from zprize_tpu_torch.tools.merkle_setup import seeded_leaves
    h = lay.height
    cards = len(devices)
    with Phase(f"h{h}.prove_many" + (f"_{cards}cards" if cards > 1 else "")):
        leaves = FR.tensor(seeded_leaves(lay.m_leaves, h + 1000), "cuda")
        wires2, root2, _ = lay.witness(leaves)
        pis = [pi, {lay.root_gate_pos: (-root2) % R_MOD}]
        witnesses = [pt.ProverWitness(wires, pis[0]),
                     pt.ProverWitness(wires2, pis[1])]
        if cards > 1:
            witnesses = witnesses * (MANY_PER_CARD * cards // 2)
            # the processes share card 0 with this one: hand back the
            # whole tables and what the allocator caches
            ntt.clear_caches()
        base = TranscriptProtocol(b"Merkle tree")
        seed_transcript(base, vk)
        torch.cuda.synchronize()
        kernels.reset_counts()
        stats = []
        proofs, wall, pps = prove_many(
            witnesses, pk, dev_srs, base, pt.ProverConfig(device="cuda"),
            devices=[torch.device("cuda", d) for d in devices], stats=stats)
        if cards > 1:
            for one in stats:
                for k, v in one.pop("launches").items():
                    counts[k] = counts.get(k, 0) + v
        else:
            counts.update(kernels.COUNTS)
        got = [serialize_proof(p) for p in proofs]
        if got[0::2] != [first_bytes] * len(got[0::2]):
            raise AssertionError("a prove_many proof of the main witness "
                                 "differs from the main path's proof")
        if len(set(got[1::2])) != 1:
            raise AssertionError("prove_many's proofs of one witness "
                                 "differ")
        # every other proof is byte-equal to one of these two
        for proof, p in zip(proofs[:2], pis):
            vtr = TranscriptProtocol(b"Merkle tree")
            seed_transcript(vtr, vk)
            if not verify(vk, lite, proof, p, vtr):
                raise AssertionError("a prove_many proof does not verify")
        del proofs
        threads = None
        if cards > 1:
            threads = _prove_many_threads(witnesses, pk, dev_srs, base,
                                          devices)
            if threads.pop("proofs") != got:
                raise AssertionError("the thread design's proofs differ "
                                     "from prove_many's")
    out = {"height": h, "proofs": len(got), "cards": cards,
           "wall_s": wall, "proofs_per_s": pps, "first_equals_main": True,
           "verify": "PASS"}
    if cards > 1:
        start = [one["start_s"] for one in stats]
        out.update(
            design="one process a card", per_card=stats,
            start_s=start,
            # the proving alone: from the last process's start to the end
            proofs_per_s_after_start=len(got) / (wall - max(start)),
            threads=threads,
            speedup_over_threads=threads["wall_s"] / wall)
    emit({"prove_many": dict(out, launches=dict(counts))})
    return out


def _prove_many_threads(witnesses, dev_pk, dev_srs, base, devices):
    """prove_many's earlier design, kept here only to be timed beside
    the one with a process a card in the same call: one thread a card,
    each proving its witnesses i = k (mod cards) in order against its
    replica of the key and SRS. Returns the proof bytes, the wall, the
    proofs a second, and for each thread the wall and the host CPU
    seconds (time.thread_time) of each prove_torch call, with the CPU
    seconds of this whole process (time.process_time) beside the wall:
    a thread held back by the interpreter lock waits off the CPU, while
    the CUDA synchronizations spin on it."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from zprize_tpu_torch.protocol import prover_torch as pt
    from zprize_tpu_torch.protocol.batch import _replica
    from zprize_tpu_torch.protocol.serde import serialize_proof

    devs = [torch.device("cuda", d) for d in devices]
    D = len(devs)
    proofs = [None] * len(witnesses)
    per = [{"device": str(d), "prove_s": [], "cpu_s": []} for d in devs]
    torch.cuda.synchronize()
    t0, c0 = time.time(), time.process_time()
    pks = [_replica(dev_pk, d) for d in devs]
    srss = [_replica(dev_srs, d) for d in devs]

    def run(k):
        with torch.cuda.device(devs[k]):
            cfg = pt.ProverConfig(device=devs[k])
            for i in range(k, len(witnesses), D):
                w = _replica(witnesses[i], devs[k])
                t, c = time.time(), time.thread_time()
                proofs[i] = serialize_proof(pt.prove_torch(
                    w, pks[k], srss[k], base.clone(), cfg))
                per[k]["prove_s"].append(time.time() - t)
                per[k]["cpu_s"].append(time.thread_time() - c)

    with ThreadPoolExecutor(max_workers=D) as ex:
        for f in [ex.submit(run, k) for k in range(D)]:
            f.result()
    wall = time.time() - t0
    cpu = time.process_time() - c0
    del pks, srss
    return {"proofs": proofs, "wall_s": wall,
            "proofs_per_s": len(witnesses) / wall, "per_card": per,
            "process_cpu_s": cpu,
            "thread_cpu_share": [sum(p["cpu_s"]) / sum(p["prove_s"])
                                 for p in per]}


MESH_SEED = 20261019


def _mesh_rank(mesh, height, setup=None):
    """One rank of the mesh phase, on its card. Builds the main path's
    seeded set-up there (or takes `setup`, the main path's own, when the
    world size is 1); on its whole tensors holds the four-step NTT / INTT
    of the five round-1 columns to ops/ntt's (and times both, and
    the sharded transforms alone), the sharded MSM window and the meshed
    commit to msm.msm; then keeps only its columns of the key, witness and
    SRS (`shard`), frees the whole, and proves. Returns Python values:
    the proof bytes, the prove's seconds, the bytes resident before it and
    its max_memory_allocated, and the launches of the whole rank ("mesh")
    and of the sharded prove alone ("sharded")."""
    import gc
    import numpy as np
    import torch
    from zprize_tpu_torch.fields import kernels, mont
    from zprize_tpu_torch.fields.mont import FR
    from zprize_tpu_torch.ops import msm, ntt
    from zprize_tpu_torch.parallel import mesh as pmesh
    from zprize_tpu_torch.protocol import prover_torch as pt
    from zprize_tpu_torch.protocol.serde import serialize_proof
    from zprize_tpu_torch.tools.cudatime import time_ms
    from zprize_tpu_torch.tools.merkle_setup import MerkleSetup

    kernels.reset_counts()
    if setup is None:
        setup = MerkleSetup.build(height, mesh.device)
    n = setup.lay.n
    log_n = n.bit_length() - 1
    L = FR.L
    dev = mesh.device
    # the five round-1 columns (wires and the public-input column), as
    # prove_torch stacks them
    pi = setup.witness.public_inputs
    pi_col = torch.zeros((L, n), dtype=torch.int32, device=dev)
    pi_col[:, torch.tensor(list(pi), dtype=torch.int64, device=dev)] = \
        FR.tensor(list(pi.values()), dev)
    evals = torch.stack(list(setup.witness.wires_dev) + [pi_col], dim=1)
    plan = ntt.get_plan(log_n, dev)
    whole = {}
    whole["intt_ms"], coeffs = time_ms(lambda: ntt.intt(plan, evals), 5)
    whole["ntt_ms"], evals2 = time_ms(lambda: ntt.ntt(plan, coeffs), 5)
    _same("ops/ntt ntt(intt(x))", evals2, evals)
    del evals2
    fsp = pmesh.four_step_plan(log_n, dev)
    # rows[i1, i2] = coeffs[i1 + n1*i2]
    rows = coeffs.reshape(L, 5, fsp.n2, fsp.n1).transpose(-1, -2) \
        .contiguous()
    four = {}
    four["ntt_ms"], R = time_ms(
        lambda: pmesh.four_step_ntt(fsp, mesh, rows), 5)
    _same("four-step ntt", R.reshape(L, 5, n), evals)
    four["intt_ms"], co = time_ms(
        lambda: pmesh.four_step_intt_natural(fsp, mesh, evals), 5)
    _same("four-step intt", co, coeffs)
    del R, co, rows
    # the prover's transforms: the rank's columns in and out, no gather
    cols = pmesh.Columns(log_n, dev, mesh)
    sharded, plans = {}, {}
    if cols.sharded:
        c_part, e_part = cols.coef.take(coeffs), cols.evals.take(evals)
        sharded["ntt_ms"], got = time_ms(lambda: cols.ntt(c_part), 5)
        _same("sharded ntt", got, e_part)
        sharded["intt_ms"], got = time_ms(lambda: cols.intt(e_part), 5)
        _same("sharded intt", got, c_part)
        del c_part, e_part, got
        # at odd log n the two layouts differ and the INTT runs on the
        # plan with n1 and n2 swapped; its twiddles exist once it ran
        fwd, inv = cols._fwd, cols._inv
        plans = {"ntt_plan": [fwd.n1, fwd.n2], "intt_plan": [inv.n1, inv.n2],
                 "layouts_differ": cols.coef.layout != cols.evals.layout,
                 "swapped_intt_ran": inv is not fwd and any(
                     k[2] for k in inv._tw)}
    # one window of seeded digits, as wide as the prover's windows at this
    # n (16 bits at h15); its reference is msm.msm of scalars equal to
    # those digits
    srs = setup.dev_srs
    wb = msm.auto_window_bits(n)
    digits = torch.from_numpy(np.random.default_rng(MESH_SEED).integers(
        0, 1 << wb, n)).to(dev)
    raw_d = torch.zeros((16, n), dtype=torch.int32, device=dev)
    raw_d[0] = digits.to(torch.int32)
    x, y, _ = srs.points
    part = pmesh.sharded_msm_window_partials(
        mesh, x[:, :n].contiguous(), y[:, :n].contiguous(), digits, wb)
    if _affine(part) != msm.msm(srs.packed, raw_d, wb):
        raise AssertionError("sharded MSM window != msm.msm")
    wire_polys = coeffs[:, :4]
    raw_w = mont.from_mont(FR, wire_polys)
    commit_ref = [msm.msm(srs.packed, raw_w[:, b], wb) for b in range(4)]
    t0 = time.time()
    commits = pt.commit_batch(srs, wire_polys, pt.ProverConfig(mesh=mesh))
    commit_s = time.time() - t0
    if commits != commit_ref:
        raise AssertionError("meshed commit != msm.msm")
    del evals, coeffs, wire_polys, raw_w, raw_d, pi_col, digits, part, x, y

    # the sharded prove: this rank's columns only
    pk = setup.pk.shard(mesh)
    dev_srs = srs.shard(mesh, n)
    witness = setup.witness.shard(mesh)
    transcript = setup.transcript()
    del setup, srs, plan
    ntt.clear_caches()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.COUNTS)
    kernels.reset_counts()
    t0 = time.time()
    proof = pt.prove_torch(witness, pk, dev_srs, transcript,
                           pt.ProverConfig(mesh=mesh))
    torch.cuda.synchronize()
    prove_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    prove_counts = dict(kernels.COUNTS)
    torch.cuda.reset_peak_memory_stats()
    return {"rank": mesh.rank, "device": str(dev), "n": n,
            "proof": serialize_proof(proof), "prove_s": prove_s,
            "sharded": cols.sharded, "width": cols.coef.layout.width,
            "plans": plans,
            "resident_bytes": resident, "peak_bytes": peak,
            "four_step_ms": four, "ops_ntt_ms": whole,
            "sharded_ms": sharded, "meshed_commit_s": commit_s,
            "launches": {"mesh": {k: before[k] + prove_counts[k]
                                  for k in before},
                         "sharded": prove_counts}}


def _mesh_phase(lay, pk, vk, dev_srs, lite, wires, pi, main_bytes,
                main_prove_s, counts):
    """The meshed prover over every card of the machine, one NCCL rank a
    card (`_mesh_rank` on each: spawned processes, each building the
    set-up on its card, when there are several; in this process on the
    main path's set-up when there is one). Every rank's sharded h15 proof
    must equal the main proof and verify; then the dry run over all the
    cards, the sharded prover at an odd log n (`_odd_log_n_meshes`) and,
    with more than one card, prove_many with one process a card beside
    the thread design. `counts` receives the launches of rank 0's whole
    run ("mesh"), of each rank's sharded prove ("sharded", a list), of
    the dry run when it runs in this process, of each h6 rank's sharded
    prove ("sharded_h6", a list) and of prove_many's processes
    ("prove_many_cards")."""
    import tempfile
    import torch
    from zprize_tpu_torch.entry import dryrun_multichip
    from zprize_tpu_torch.fields import kernels
    from zprize_tpu_torch.ops import ntt
    from zprize_tpu_torch.parallel import mesh as pmesh
    from zprize_tpu_torch.protocol import prover_torch as pt
    from zprize_tpu_torch.protocol.serde import deserialize_proof
    from zprize_tpu_torch.protocol.transcript_protocol import \
        TranscriptProtocol
    from zprize_tpu_torch.ref.prover import seed_transcript
    from zprize_tpu_torch.ref.verifier import verify
    from zprize_tpu_torch.tools.merkle_setup import MerkleSetup

    h, n = lay.height, lay.n
    world = torch.cuda.device_count()
    with Phase(f"h{h}.mesh"):
        torch.cuda.synchronize()
        if world == 1:
            setup = MerkleSetup(lay, dev_srs, lite, pk, vk,
                                pt.ProverWitness(wires, pi))
            rdzv = tempfile.mkdtemp(prefix="zk-mesh-")
            with pmesh.make_mesh("cuda", init_method=f"file://{rdzv}/r",
                                 rank=0, world_size=1) as mesh:
                ranks = [_mesh_rank(mesh, h, setup)]
            del setup
        else:
            # rank 0 shares card 0 with this process: hand back what the
            # allocator caches and the whole tables
            ntt.clear_caches()
            torch.cuda.empty_cache()
            ranks = pmesh.spawn_cuda(_mesh_rank, world, h)
        kernels.reset_counts()
        dry = dryrun_multichip(world)
        torch.cuda.synchronize()
        counts["mesh"] = {k: v + (kernels.COUNTS[k] if world == 1 else 0)
                          for k, v in ranks[0]["launches"]["mesh"].items()}
        counts["sharded"] = [r["launches"]["sharded"] for r in ranks]
        for r in ranks:
            if r["proof"] != main_bytes:
                raise AssertionError(f"rank {r['rank']}: sharded h{h} "
                                     f"proof != the main proof")
        vtr = TranscriptProtocol(b"Merkle tree")
        seed_transcript(vtr, vk)
        if not verify(vk, lite, deserialize_proof(ranks[0]["proof"]), pi,
                      vtr):
            raise AssertionError("sharded proof does not verify")
        counts["sharded_h6"] = []
        odd = _odd_log_n_meshes(world, counts["sharded_h6"])
        many = None
        if world > 1:
            counts["prove_many_cards"] = {}
            many = _prove_many(lay, pk, vk, dev_srs, lite, wires, pi,
                               main_bytes, counts["prove_many_cards"],
                               devices=list(range(world)))
    per_rank = {k: [r[k] for r in ranks] for k in (
        "device", "prove_s", "resident_bytes", "peak_bytes", "sharded_ms",
        "four_step_ms", "meshed_commit_s")}
    r0 = ranks[0]
    emit({"mesh": {"height": h, "world_size": world, "backend": "nccl",
                   "n": n, "columns": 5, "sharded": r0["sharded"],
                   "rank_width": r0["width"],
                   "ops_ntt_ms": r0["ops_ntt_ms"],
                   "ntt_equal": True, "intt_equal": True,
                   "msm_window_equal": True, "meshed_commit_equal": True,
                   "main_prove_s": main_prove_s,
                   "proof_bytes_equal": True, "verify": "PASS",
                   "per_rank_prove_s": per_rank["prove_s"],
                   "per_rank_resident_bytes": per_rank["resident_bytes"],
                   "per_rank_peak_bytes": per_rank["peak_bytes"],
                   "per_rank": per_rank, "dryrun": dry,
                   "odd_log_n": odd,
                   "prove_many_cards": many,
                   "launches": counts["mesh"],
                   "launches_sharded": counts["sharded"]}})


# n = 2^13: an odd log n, whose four-step sides are 2^6 and 2^7
ODD_HEIGHT = 6


def _odd_log_n_meshes(cards, counts):
    """The sharded prover at an odd log n: the seeded h6 set-up (n =
    2^13, the four-step sides 64 and 128, so the coefficient and the
    evaluation layouts differ and the INTT takes the swapped plan) proved
    whole on this card, then by `_mesh_rank` at world size 1 in this
    process and, with the cards for them, at 2 and 4 spawned NCCL ranks,
    each building the set-up on its card. Every rank's proof must equal
    the whole proof, which verifies, and every rank must have run the
    swapped INTT plan. `counts` (a list) receives each rank's sharded
    prove launches. Returns the mesh line's entry, by world size."""
    import tempfile
    from zprize_tpu_torch.parallel import mesh as pmesh
    from zprize_tpu_torch.protocol.serde import serialize_proof
    from zprize_tpu_torch.ref.verifier import verify
    from zprize_tpu_torch.tools.merkle_setup import MerkleSetup

    h = ODD_HEIGHT
    out = {}
    with Phase(f"h{h}.mesh"):
        setup = MerkleSetup.build(h, "cuda")
        proof = setup.prove()
        if not verify(setup.vk, setup.lite, proof,
                      setup.witness.public_inputs, setup.transcript()):
            raise AssertionError(f"h{h}: the whole proof does not verify")
        whole = serialize_proof(proof)
        for world in (1, 2, 4):
            if world > cards:
                break
            if world == 1:
                rdzv = tempfile.mkdtemp(prefix="zk-mesh-")
                with pmesh.make_mesh("cuda", init_method=f"file://{rdzv}/r",
                                     rank=0, world_size=1) as mesh:
                    ranks = [_mesh_rank(mesh, h, setup)]
            else:
                ranks = pmesh.spawn_cuda(_mesh_rank, world, h)
            for r in ranks:
                if r["proof"] != whole:
                    raise AssertionError(f"world size {world}, rank "
                                         f"{r['rank']}: sharded h{h} proof "
                                         f"!= the whole proof")
                if not (r["sharded"] and r["plans"]["layouts_differ"]
                        and r["plans"]["swapped_intt_ran"]):
                    raise AssertionError(f"world size {world}, rank "
                                         f"{r['rank']}: the swapped INTT "
                                         f"plan did not run")
            counts.extend(r["launches"]["sharded"] for r in ranks)
            r0 = ranks[0]
            out[str(world)] = {
                "n": r0["n"], "log_n": r0["n"].bit_length() - 1,
                "rank_width": r0["width"], **r0["plans"],
                "sharded_ntt_intt_equal": True, "proof_bytes_equal": True,
                "verify": "PASS",
                "per_rank_prove_s": [r["prove_s"] for r in ranks],
                "per_rank_peak_bytes": [r["peak_bytes"] for r in ranks]}
    return out


def _same(name, got, want):
    import torch
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: differs from ops/ntt's transform")


def _affine(p):
    """xyzz (4L,) on the card -> affine Python-int point (or None)."""
    from zprize_tpu_torch.curve import g1
    return g1.xyzz_to_affine_host(p[:, None])[0]


def check_h6():
    proofs, secs = gen_proof(6, impls=("kernel", "plain"))
    if proofs["kernel"] != proofs["plain"]:
        raise AssertionError("h6: kernel-path proof bytes differ from the "
                             "plain-path proof")
    emit({"h6": {"proof_bytes_equal": True, "bytes": len(proofs["kernel"]),
                 "seconds": secs}})


def main_path(height, profile=False, mesh_only=False):
    """The main path at `height`, then prove_many, the timeline and the
    memory attribution of one more prove each, the mesh phase, then both
    examples and the micro-benchmarks; returns the kernel launch counts of
    the main path, prove_many, the mesh phase (rank 0) and each rank's
    sharded prove at the main height and at h6, and, with several cards,
    of prove_many's processes: {"main": ..., "prove_many": ..., "mesh":
    ..., "sharded": [...], "sharded_h6": [...], "prove_many_cards": ...},
    each of exactly its own run. mesh_only: the
    rehearsal of the mesh phase (see the module docstring), without
    prove_many, the tools, the examples and the micro-benchmarks."""
    import torch
    from zprize_tpu_torch.fields import kernels
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    counts = {"main": {}, "mesh": {}, "sharded": []}
    if not mesh_only:
        counts["prove_many"] = {}
    peak = {}

    def on_done(path):
        if path == "main":
            counts["main"].update(kernels.COUNTS)
        peak[path] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    with Phase(f"main_h{height}"):
        _, secs = gen_proof(
            height, timed=True, profile=profile, on_done=on_done,
            many_counts=counts.get("prove_many"), tools=not mesh_only,
            mesh_counts=counts)
    emit({"main": {"height": height, "n": 1 << (
        (4 + 193 * ((1 << (height - 1)) - 1) + 1 - 1).bit_length()),
        "seconds": secs,
        "max_memory_allocated": peak["main"],
        "max_memory_allocated_prove_many": peak.get("prove_many"),
        "launches": counts["main"]}})
    if not mesh_only:
        run_examples_and_micro()
    return counts


def run_examples_and_micro():
    """Both examples at small sizes on the card (each must verify), then
    the micro-benchmarks."""
    from zprize_tpu_torch.examples import merkle_tree, simple_circuit
    from zprize_tpu_torch.tools import micro
    with Phase("example.simple_circuit"):
        emit({"example": "simple_circuit",
              **simple_circuit.main("cuda")})
    with Phase("example.merkle_tree"):
        emit({"example": "merkle_tree", **merkle_tree.main(3, "cuda")})
    with Phase("micro"):
        emit({"micro": micro.run()})


def _require_launched(path, counts):
    """Every kernel that `path` runs must have launched in it."""
    from zprize_tpu_torch.fields import kernels
    missing = [k for k in kernels.KERNEL_NAMES
               if k not in NOT_LAUNCHED[path] and counts[k] == 0]
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


def _sass_counts(lib):
    """`cuobjdump -sass` of a kernel library -> {kernel: instruction counts}
    (IMAD.WIDE: one 32x32 -> 64-bit product; imad: the other multiply-adds
    apart from the IMAD.MOV/SHL/IADD forms, which move, shift or add); {}
    where the toolkit has no cuobjdump."""
    from zprize_tpu_torch.fields import kernels
    exe = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    if not os.path.exists(exe):
        return {}
    out = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                         timeout=300).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = _kernel_name(m.group(1)) or m.group(1)
            counts[name] = {"imad": 0, "imad_wide": 0, "imad_other": 0,
                            "iadd3": 0, "total": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", ln)
        if m and name:
            op, c = m.group(1), counts[name]
            c["total"] += 1
            if op.startswith(("IMAD.MOV", "IMAD.SHL", "IMAD.IADD")):
                c["imad_other"] += 1
            elif op.startswith("IMAD.WIDE"):
                c["imad_wide"] += 1
            elif op.startswith("IMAD"):
                c["imad"] += 1
            elif op.startswith("IADD3"):
                c["iadd3"] += 1
    return counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=MAIN_HEIGHT)
    ap.add_argument("--phases",
                    default="probe,build,kernels,msm,entry,circuit,h6,"
                            "main")
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
        from zprize_tpu_torch.fields import kernels
        from zprize_tpu_torch.tools.cudatime import card as query_card
        card = query_card()
        nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
        int_ops_s()
        emit({"probe": {"card": card,
                        "sm_clock_max_mhz": _RATE["mhz"], "sms": _RATE["sms"],
                        "int_ops_s": _RATE["ops"],
                        "device": torch.cuda.get_device_name(0),
                        "count": torch.cuda.device_count(),
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda,
                        "nvcc": nvcc[-1] if nvcc else None,
                        "python": sys.version.split()[0]}})

    with Phase("build"):
        rate_build = start_rate_build()
        kernels.load_library()
        info = dict(kernels.BUILD_INFO)
        emit({"build": info,
              "ptxas": _ptxas_summary(info.pop("ptxas", ""))})
        emit({"sass": _sass_counts(info["path"])})
        emit({"int_rate": measure_rates(*rate_build)})

    results = {}
    if "kernels" in phases:
        with Phase("kernels"):
            results = check_kernels()
    if "msm" in phases:
        with Phase("msm"):
            results.update(check_msm())
    path_counts = {}
    if "entry" in phases:
        with Phase("entry"):
            counts = {}
            emit({"entry": check_entry(counts), "launches": counts})
        _require_launched("entry", counts)
        path_counts["entry"] = counts
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
    if "main" in phases or "mesh" in phases:
        counts = main_path(args.height, args.profile,
                           mesh_only="main" not in phases)
        for path, c in counts.items():
            # a sharded prove's launches are one count per rank
            for one in (c if isinstance(c, list) else [c]):
                _require_launched(path, one)
            if path != "main":
                path_counts[path] = c
        for k, r in results.items():
            r["launches"] = counts["main"][k]
    for k, r in results.items():
        # a sharded prove's launches are one count per rank
        r["launches_by_path"] = {
            p: [one[k] for one in c] if isinstance(c, list) else c[k]
            for p, c in path_counts.items()}
    if results:
        emit({"kernels": list(results.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
