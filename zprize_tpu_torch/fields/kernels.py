"""Build, bind and launch the CUDA kernels of `csrc/`, and run the plain
PyTorch version of each kernel for tensors on the CPU.

The kernels (sources `csrc/kernels.cu` + `csrc/field.cuh`) are compiled on
first use with `nvcc` for sm_90a into a shared library with a plain C
interface, loaded with ctypes. The library lives in
`<repo>/.torch_ext/<hash of sources, torch version and arch>/`, so a
directory built from other sources is never reused. A build takes an
exclusive lock file beside the library; a second process waits for it at
most `LOCK_TIMEOUT_S` seconds and then raises with the lock's path.

Every wrapper takes limbs-leading int32 tensors of 16-bit limbs:
  * on a CUDA tensor it launches its kernel and adds one to
    `COUNTS[name]` (inside `with impl("plain"):`, which the comparisons on
    the card use and which holds for the calling thread, it runs the plain
    version); a build or launch error raises — there is no fallback;
  * on a CPU tensor it runs the plain version (`limbmath.py`).

The wrappers here are K1-K6 of `zprize_tpu/fields/pkern.py` and the fused
NTT pass that runs K5's stages several at a time (`ntt_pass`); the curve
kernels K7-K9 and K7's tree level are wrapped in `curve/g1.py`, the MSM
bucket kernels in `ops/msm.py`.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from . import limbmath

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
CSRC = os.path.join(PKG_DIR, "csrc")
SOURCES = ("kernels.cu", "field.cuh")
ARCH_FLAG = "-gencode=arch=compute_90a,code=sm_90a"
LOCK_TIMEOUT_S = 600
BUILD_TIMEOUT_S = 600

KERNEL_NAMES = ("mul", "add", "sub", "neg", "mul_add_sub",
                "mul_add_sub_lanes", "ntt_pass", "mul3", "xyzz_add",
                "xyzz_add_mixed", "xyzz_add_affine2", "xyzz_add_pairs",
                "bucket_acc", "bucket_sum")
# launches of each CUDA kernel since the last reset_counts(); K5's flat
# stages (mul_add_sub) and its stages along axis -2 (mul_add_sub_lanes)
# are counted apart
COUNTS = {k: 0 for k in KERNEL_NAMES}

_LIB = None
BUILD_INFO = {}
# the impl() stack of each thread (prove_many proves in several threads)
_LOCAL = threading.local()
_COUNT_LOCK = threading.Lock()


def reset_counts():
    with _COUNT_LOCK:
        for k in COUNTS:
            COUNTS[k] = 0


def count(name):
    """One launch of kernel `name` (called by its wrapper only)."""
    with _COUNT_LOCK:
        COUNTS[name] += 1


def _impl_stack():
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = ["kernel"]
    return _LOCAL.stack


@contextlib.contextmanager
def impl(name):
    """Run CUDA tensors through the kernels ("kernel", the default) or
    through the plain versions ("plain") inside the block, in this
    thread."""
    assert name in ("kernel", "plain"), name
    stack = _impl_stack()
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def use_kernel(t):
    """True if `t` goes to the CUDA kernel; False for the plain version
    (a CPU tensor, or inside `impl("plain")`)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return _impl_stack()[-1] == "kernel"


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------

def nvcc_path():
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir():
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(torch.__version__.encode() + ARCH_FLAG.encode())
    return os.path.join(REPO_DIR, ".torch_ext", h.hexdigest()[:16])


def _acquire(lock, lib):
    """Take the build lock, or wait (bounded) for another builder."""
    deadline = time.time() + LOCK_TIMEOUT_S
    while True:
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            return True
        except FileExistsError:
            if os.path.exists(lib):
                return False
            if time.time() > deadline:
                raise RuntimeError(
                    f"kernel build lock {lock} held for more than "
                    f"{LOCK_TIMEOUT_S} s; remove it if no build is running")
            time.sleep(0.5)


def load_library():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle. BUILD_INFO records the build seconds and ptxas's report."""
    global _LIB
    if _LIB is not None:
        return _LIB
    d = build_dir()
    lib = os.path.join(d, "libzk_kernels.so")
    t0 = time.time()
    if not os.path.exists(lib):
        os.makedirs(d, exist_ok=True)
        lock = os.path.join(d, "lock")
        if _acquire(lock, lib):
            try:
                if not os.path.exists(lib):
                    tmp = lib + f".tmp{os.getpid()}"
                    cmd = [nvcc_path(), "-O3", "-std=c++17", ARCH_FLAG,
                           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                           "-o", tmp, os.path.join(CSRC, "kernels.cu")]
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=BUILD_TIMEOUT_S)
                    with open(os.path.join(d, "build.log"), "w") as f:
                        f.write(" ".join(cmd) + "\n" + r.stdout + r.stderr)
                    if r.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed ({r.returncode}):\n{r.stderr}")
                    os.replace(tmp, lib)
                    BUILD_INFO["ptxas"] = r.stderr
            finally:
                os.unlink(lock)
        BUILD_INFO["built"] = True
    else:
        BUILD_INFO["built"] = False
    BUILD_INFO["seconds"] = time.time() - t0
    BUILD_INFO["path"] = lib
    h = ctypes.CDLL(lib)
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("zk_mul", "zk_add", "zk_sub"):
        getattr(h, name).argtypes = [I, P, LL, P, LL, P, LL, P]
    h.zk_mul3.argtypes = [I, P, LL, P, LL, P, LL, P, LL, P]
    h.zk_neg.argtypes = [I, P, LL, P, LL, P]
    h.zk_butterfly_stage.argtypes = [P, P, LL, I, I, P, LL, LL, P]
    h.zk_ntt_pass.argtypes = [P, P, LL, I, I, I, I, I, P, LL, P, LL, I, I,
                              I, P]
    h.zk_xyzz_add.argtypes = [P, P, P, LL, P]
    h.zk_xyzz_add_mixed.argtypes = [P, P, P, P, LL, P]
    h.zk_xyzz_add_affine2.argtypes = [P, P, P, P, P, LL, P]
    h.zk_xyzz_add_pairs.argtypes = [P, P, LL, LL, P]
    h.zk_bucket_acc.argtypes = [P, P, P, P, P, P, LL, LL, P]
    h.zk_bucket_sum.argtypes = [P, LL, P, P, P, P, LL, LL, P]
    for name in ("zk_mul", "zk_add", "zk_sub", "zk_mul3", "zk_neg",
                 "zk_butterfly_stage", "zk_ntt_pass", "zk_xyzz_add",
                 "zk_xyzz_add_mixed",
                 "zk_xyzz_add_affine2", "zk_xyzz_add_pairs", "zk_bucket_acc",
                 "zk_bucket_sum"):
        getattr(h, name).restype = I
    _LIB = h
    return h


def stream():
    return torch.cuda.current_stream().cuda_stream


def check(rc, name):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def check_operand(x, L, device):
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != L \
            or not x.is_contiguous() or x.device != device:
        raise ValueError(
            f"kernel operand must be a contiguous int32 ({L}, n) tensor on "
            f"{device}; got {tuple(x.shape)} {x.dtype} on {x.device}")


# ---------------------------------------------------------------------------
# K1-K4, K6: elementwise field ops over (L, n); an operand may be (L, per)
# with per dividing n (a broadcast scalar or a tile along the flattened
# batch)
# ---------------------------------------------------------------------------

def _elementwise(name, plain_fn, P, *ops):
    """K1-K3 and K6 over (L, n) operands, each (L, per) with per | n."""
    n = max(x.shape[1] for x in ops)
    if not use_kernel(ops[0]):
        wide = [x.to(torch.int64) for x in ops]
        wide = [x if x.shape[1] == n else x.repeat(1, n // x.shape[1])
                for x in wide]
        return plain_fn(P, *wide).to(torch.int32)
    args = []
    for x in ops:
        check_operand(x, P.L, ops[0].device)
        if n % x.shape[1]:
            raise ValueError("operand period must divide n")
        args += [x.data_ptr(), x.shape[1]]
    out = torch.empty((P.L, n), dtype=torch.int32, device=ops[0].device)
    rc = getattr(load_library(), "zk_" + name)(
        0 if P.L == 16 else 1, *args, out.data_ptr(), n, stream())
    check(rc, name)
    count(name)
    return out


def mul(P, a, b):
    """K1 (pkern.mul): a*b*R^-1 mod p."""
    return _elementwise("mul", limbmath.mul, P, a, b)


def add(P, a, b):
    """K2 (pkern.add): a + b mod p."""
    return _elementwise("add", limbmath.add, P, a, b)


def sub(P, a, b):
    """K3 (pkern.sub): a - b mod p."""
    return _elementwise("sub", limbmath.sub, P, a, b)


def mul3(P, a, b, c):
    """K6 (pkern.mul3): a*b*c with both Montgomery reductions in one
    launch."""
    return _elementwise("mul3", limbmath.mul3, P, a, b, c)


def neg(P, a):
    """K4 (pkern.neg): p - a, 0 -> 0."""
    if not use_kernel(a):
        return limbmath.neg(P, a.to(torch.int64)).to(torch.int32)
    check_operand(a, P.L, a.device)
    n = a.shape[1]
    out = torch.empty_like(a)
    rc = load_library().zk_neg(0 if P.L == 16 else 1, a.data_ptr(), n,
                               out.data_ptr(), n, stream())
    check(rc, "neg")
    count("neg")
    return out


# ---------------------------------------------------------------------------
# K5: one radix-2 NTT stage over Fr
# ---------------------------------------------------------------------------

def butterfly_stage_plain(P, a, tw, half, tw_step, lanes=1):
    """Plain version of K5 on (16, N) int64: the columns form blocks of
    2*half rows of `lanes` columns; u = the first half of a block's rows,
    v = the second, w = tw[:, j * tw_step] for row j of a half (the same
    for every lane); returns the stage output (u + v*w | u - v*w)."""
    L, N = a.shape
    blocks = N // (2 * half * lanes)
    x = a.reshape(L, blocks, 2, half * lanes)
    u = x[:, :, 0].reshape(L, -1)
    v = x[:, :, 1].reshape(L, -1)
    w = tw[:, :half * tw_step:tw_step]
    w = w[:, None, :, None].expand(L, blocks, half, lanes).reshape(L, -1)
    vw = limbmath.mul(P, v, w)
    hi = limbmath.add(P, u, vw).reshape(L, blocks, 1, half * lanes)
    lo = limbmath.sub(P, u, vw).reshape(L, blocks, 1, half * lanes)
    return torch.cat([hi, lo], dim=2).reshape(L, N)


def butterfly_stage(P, a, tw, half, tw_step, lanes=1):
    """K5 (pkern.mul_add_sub, the fused butterfly (u + v*w, u - v*w)) for
    one whole NTT stage: a is (16, N), the flattened (16, ..., rows,
    lanes) with rows a multiple of 2*half, and the stage runs along the
    rows (axis -2) with `lanes` (a power of two) columns a row; lanes = 1
    is the flat stage along the last axis. tw is a (16, T) twiddle table
    read at column j * tw_step. Counted as "mul_add_sub" with lanes = 1,
    "mul_add_sub_lanes" otherwise."""
    if not use_kernel(a):
        return butterfly_stage_plain(P, a.to(torch.int64),
                                     tw.to(torch.int64), half, tw_step,
                                     lanes).to(torch.int32)
    check_operand(a, 16, a.device)
    check_operand(tw, 16, a.device)
    N = a.shape[1]
    if lanes & (lanes - 1) or half & (half - 1) \
            or N % (2 * half * lanes) or (half - 1) * tw_step >= tw.shape[1]:
        raise ValueError("bad butterfly stage shape")
    out = torch.empty_like(a)
    rc = load_library().zk_butterfly_stage(
        a.data_ptr(), out.data_ptr(), N, half.bit_length() - 1,
        lanes.bit_length() - 1, tw.data_ptr(), tw.shape[1], tw_step,
        stream())
    name = "mul_add_sub" if lanes == 1 else "mul_add_sub_lanes"
    check(rc, name)
    count(name)
    return out


# ---------------------------------------------------------------------------
# the fused NTT pass: several of K5's stages on a tile in shared memory
# ---------------------------------------------------------------------------

# a pass's tile holds at most 2^PASS_TILE_LOG elements (`kPassTileLog` in
# csrc/kernels.cu), of which at least min(lanes, 8) lanes a row: a whole
# 32-byte sector of each limb row
PASS_TILE_LOG = 11


def ntt_pass_plan(log_rows, lanes):
    """The stages of a radix-2 transform of 2^log_rows rows of `lanes`
    lanes, split into passes: [(s0, s1), ...], pass k running stages s0+1
    .. s1, as few passes as the tile allows and as even as can be, the
    first the longest. One pass of no stage where log_rows = 0."""
    per = PASS_TILE_LOG - min(lanes.bit_length() - 1, 3)
    k = max(-(-log_rows // per), 1)
    bounds = [-(-log_rows * i // k) for i in range(k + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def bit_reverse_indices(log_n, device="cpu"):
    """bitrev(i) for i < 2^log_n, int64."""
    i = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(i)
    for b in range(log_n):
        rev |= ((i >> b) & 1) << (log_n - 1 - b)
    return rev


def pack_words(x):
    """(16, N) 16-bit limbs -> (8, N) int32 words of two limbs each (limb
    2k in the low half of word k), the layout between the passes of one
    transform."""
    w = (x[0::2].to(torch.int64) & 0xFFFF) | (x[1::2].to(torch.int64) << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_words(w):
    """(8, N) words -> (16, N) int64 limbs."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(
        2 * w.shape[0], -1)


def ntt_pass_plain(P, a, tw, log_rows, lanes, s0, s1, bitrev=False,
                   mul=None, transpose=False):
    """Plain version of the fused pass on (16, N) int64, N = batch * R *
    lanes with R = 2^log_rows: the product by `mul` ((16, 1), or (16, R *
    lanes) indexed [row, lane] of the input), the bit-reversal row gather
    (`bitrev`), K5's stages s0+1 .. s1 through `butterfly_stage_plain`
    (stage s: half = 2^(s-1), twiddle step R >> s) and the transposing
    copy to (batch, lanes, R) (`transpose`)."""
    L, N = a.shape
    R = 1 << log_rows
    x = a
    if mul is not None:
        x = limbmath.mul(P, x, mul.repeat(1, N // mul.shape[1]))
    if bitrev:
        x = x.reshape(L, -1, R, lanes).index_select(
            2, bit_reverse_indices(log_rows, a.device)).reshape(L, N)
    for s in range(s0 + 1, s1 + 1):
        x = butterfly_stage_plain(P, x, tw, 1 << (s - 1), R >> s, lanes)
    if transpose:
        x = x.reshape(L, -1, R, lanes).transpose(-1, -2).reshape(L, N)
    return x


def ntt_pass(P, a, tw, log_rows, lanes, s0, s1, bitrev=False, mul=None,
             transpose=False, packed_in=False, packed_out=False):
    """Stages s0+1 .. s1 of K5's radix-2 schedule in one launch (counted
    as "ntt_pass"): a is (16, N), the flattened (16, batch, R, lanes) with
    R = 2^log_rows, transformed along its rows (axis -2) with `lanes` (a
    power of two) columns a row, as `butterfly_stage(P, x, tw, 2^(s-1), R
    >> s, lanes)` for each stage s; tw is the (16, >= R/2) table w^j of
    the length-R transform. `mul` ((16, 1), or (16, R * lanes) indexed
    [row, lane]) multiplies the input as it is read; with `bitrev` (s0 =
    0 only) the pass reads row bitrev(p) for position p (the radix-2
    transform's gather); `transpose` stores the output as (batch, lanes,
    R). With `packed_in` (`packed_out`) the input (output) is (8, N) in
    `pack_words`' layout, as between two passes of one transform. Returns
    a new tensor; a pass of no stage (s0 = s1) copies, times `mul`."""
    check_operand(a, 8 if packed_in else 16, a.device)
    check_operand(tw, 16, a.device)
    N, rows = a.shape[1], 1 << log_rows
    if lanes & (lanes - 1) or N % (rows * lanes) \
            or not 0 <= s0 <= s1 <= log_rows \
            or s1 - s0 > PASS_TILE_LOG or (bitrev and s0) \
            or (s1 and tw.shape[1] < rows // 2):
        raise ValueError("bad NTT pass shape")
    mul_n = 0
    if mul is not None:
        check_operand(mul, 16, a.device)
        mul_n = mul.shape[1]
        if mul_n not in (1, rows * lanes):
            raise ValueError("an NTT pass multiplies by a scalar or an "
                             "(R, lanes) table")
    if not use_kernel(a):
        out = ntt_pass_plain(
            P, unpack_words(a) if packed_in else a.to(torch.int64),
            tw.to(torch.int64), log_rows, lanes, s0, s1, bitrev,
            None if mul is None else mul.to(torch.int64), transpose)
        return pack_words(out) if packed_out else out.to(torch.int32)
    out = torch.empty((8 if packed_out else 16, N), dtype=torch.int32,
                      device=a.device)
    rc = load_library().zk_ntt_pass(
        a.data_ptr(), out.data_ptr(), N // (rows * lanes), log_rows,
        lanes.bit_length() - 1, s0, s1, int(bitrev), tw.data_ptr(),
        tw.shape[1], None if mul is None else mul.data_ptr(), mul_n,
        int(transpose), int(packed_in), int(packed_out), stream())
    check(rc, "ntt_pass")
    count("ntt_pass")
    return out
