"""Montgomery field arithmetic over 16-bit limbs on limbs-leading
`(L, *batch)` int32 tensors — the port of `zprize_tpu/fields/mont.py`.

Values are bit-for-bit the JAX package's: 16-bit limbs in 32-bit words,
L = 16 (Fr) / 24 (Fq), Montgomery R = 2^256 / 2^384, fully reduced. The
public ops broadcast their batch axes like the JAX ones (trailing
alignment) and dispatch through `kernels.py`: the CUDA kernel for a tensor
on the card, the plain version for one on the CPU.

`batch_inv` does the single final inversion on the host (a 64-byte round
trip and a Python `pow`), as the JAX package does; `inv_in_graph` inverts
the total by a Fermat power on the device instead, so the device never
waits on the host.
"""

import numpy as np
import torch

from ..params import R_MOD, Q_MOD
from .limb import int_to_limbs, ints_to_limbs, limbs_to_ints, LIMB_BITS
from . import kernels
from .limbmath import LimbParams

I32 = torch.int32


class FieldCtx:
    """Static field configuration plus per-device constant tensors."""

    def __init__(self, mod: int, L: int, name: str):
        self.mod = mod
        self.L = L
        self.name = name
        self.R = (1 << (LIMB_BITS * L)) % mod
        self.R2 = (self.R * self.R) % mod
        self.mod_limbs = int_to_limbs(mod, L)
        self.r2_limbs = int_to_limbs(self.R2, L)
        self.one_mont = int_to_limbs(self.R, L)
        self.inv_exp_bits = [(mod - 2) >> i & 1
                             for i in range((mod - 2).bit_length())]
        self.P = LimbParams(mod, L)
        self._dev = {}

    # ---------------- host conversions (limbs-leading numpy) ----------------
    def to_mont_host(self, xs) -> np.ndarray:
        """ints -> (L, len(xs)) uint32 Montgomery limbs."""
        return ints_to_limbs([x * self.R % self.mod for x in xs],
                             self.L).T.copy()

    def from_mont_host(self, arr) -> list:
        """(L, m) Montgomery limbs (numpy or tensor) -> list of ints."""
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        rinv = pow(self.R, -1, self.mod)
        a = np.asarray(arr).astype(np.uint32)
        return [v * rinv % self.mod for v in limbs_to_ints(a.T)]

    def raw_to_limbs_host(self, xs) -> np.ndarray:
        return ints_to_limbs([x % self.mod for x in xs], self.L).T.copy()

    def scalar_mont(self, x: int) -> np.ndarray:
        """single int -> (L,) Montgomery limbs."""
        return self.to_mont_host([x % self.mod])[:, 0]

    # ---------------- device helpers ----------------
    def tensor(self, ints, device, mont=True):
        """ints -> (L, len) int32 tensor on `device` (Montgomery form
        unless mont=False). Large lists pack raw limbs on the host and
        convert to Montgomery form on the device."""
        if mont and len(ints) <= 4096:
            return torch.from_numpy(
                self.to_mont_host(ints).astype(np.int32)).to(device)
        raw = torch.from_numpy(
            self.raw_to_limbs_host(ints).astype(np.int32)).to(device)
        return to_mont(self, raw) if mont else raw

    def scalar(self, x: int, device):
        """int -> (L,) Montgomery int32 tensor."""
        return torch.from_numpy(self.scalar_mont(x).astype(np.int32)).to(
            device)

    def const(self, name, device):
        """(L, 1) constants: 'one' (Montgomery 1), 'r2', 'one_raw'."""
        key = (name, str(device))
        c = self._dev.get(key)
        if c is None:
            if name == "one":
                v = self.one_mont
            elif name == "r2":
                v = self.r2_limbs
            elif name == "one_raw":
                v = int_to_limbs(1, self.L)
            else:
                raise KeyError(name)
            c = torch.from_numpy(np.asarray(v, dtype=np.int32)[:, None]).to(
                device)
            self._dev[key] = c
        return c


FR = FieldCtx(R_MOD, 16, "fr")
FQ = FieldCtx(Q_MOD, 24, "fq")


# ---------------------------------------------------------------------------
# broadcasting: (L, *batch) operands -> (L, per) columns for the kernels
# ---------------------------------------------------------------------------

def _periodic(x, bshape):
    """(L, *xb) -> (L, per) contiguous, where column c of the broadcast
    (L, prod(bshape)) operand is column c % per. Materializes only when
    the operand's non-unit batch axes are not a trailing block."""
    L = x.shape[0]
    xb = tuple(x.shape[1:])
    i = 0
    while i < len(xb) and xb[i] == 1:
        i += 1
    suf = xb[i:]
    if len(suf) <= len(bshape) and tuple(bshape[len(bshape) - len(suf):]) \
            == suf:
        return x.reshape(L, -1).contiguous()
    return x.expand((L,) + tuple(bshape)).reshape(L, -1).contiguous()


def broadcast_shapes(s, t):
    """The broadcast of shapes s and t, by numpy's rule. (The same as
    `torch.broadcast_shapes`, whose first call imports torch.fx's
    symbolic shapes and sympy: seconds in every new process.)"""
    n = max(len(s), len(t))
    s = (1,) * (n - len(s)) + tuple(s)
    t = (1,) * (n - len(t)) + tuple(t)
    if any(x != y and 1 not in (x, y) for x, y in zip(s, t)):
        raise ValueError(f"shapes {s} and {t} do not broadcast")
    return tuple(y if x == 1 else x for x, y in zip(s, t))


def _binary(fn, cfg, a, b):
    bshape = broadcast_shapes(a.shape[1:], b.shape[1:])
    out = fn(cfg.P, _periodic(a, bshape), _periodic(b, bshape))
    return out.reshape((cfg.L,) + bshape)


def add(cfg, a, b):
    return _binary(kernels.add, cfg, a, b)


def sub(cfg, a, b):
    return _binary(kernels.sub, cfg, a, b)


def mont_mul(cfg, a, b):
    return _binary(kernels.mul, cfg, a, b)


def mont_sqr(cfg, a):
    return mont_mul(cfg, a, a)


def neg(cfg, a):
    return kernels.neg(cfg.P, a.reshape(cfg.L, -1).contiguous()).reshape(
        a.shape)


def to_mont(cfg, a_raw):
    return mont_mul(cfg, a_raw, cfg.const("r2", a_raw.device)[:, 0])


def from_mont(cfg, a):
    return mont_mul(cfg, a, cfg.const("one_raw", a.device)[:, 0])


def is_zero(a):
    return (a == 0).all(dim=0)


def eq(a, b):
    return (a == b).all(dim=0)


def select(mask, a, b):
    """mask over the batch axes -> a where set, else b (limb-broadcast)."""
    return torch.where(mask[None], a, b)


def mont_pow_fixed(cfg, a, exp_bits_le):
    """a^e for an exponent known on the host (bits least significant
    first): square-and-multiply on the multiplication kernel. The bits are
    host ints, so a product is launched only where a bit is set."""
    acc = cfg.const("one", a.device).reshape(
        (cfg.L,) + (1,) * (a.dim() - 1)).expand_as(a)
    base = a
    for i, bit in enumerate(exp_bits_le):
        if bit:
            acc = mont_mul(cfg, acc, base)
        if i + 1 < len(exp_bits_le):
            base = mont_sqr(cfg, base)
    return acc


def _pad_pow2(cfg, flat):
    """Pad (L, n) to the next power of two with Montgomery ones."""
    n = flat.shape[1]
    n_pad = 1 << max(0, n - 1).bit_length() if n > 1 else 1
    if n_pad != n:
        one = cfg.const("one", flat.device).expand(cfg.L, n_pad - n)
        flat = torch.cat([flat, one], dim=1)
    return flat


def prod_tree_total(cfg, a):
    """Product of all elements over the batch axes of (L, *batch) via a
    log-depth pairwise tree -> (L,). No zeros handling."""
    cur = _pad_pow2(cfg, a.reshape(cfg.L, -1))
    while cur.shape[1] > 1:
        cur = mont_mul(cfg, cur[:, 0::2], cur[:, 1::2])
    return cur[:, 0]


def inv_apply(cfg, a, inv_total):
    """Elementwise inverses of (L, *batch) given the Montgomery inverse of
    the total product (L,). Elements must be units."""
    batch = a.shape[1:]
    flat = a.reshape(cfg.L, -1)
    n = flat.shape[1]
    levels = [_pad_pow2(cfg, flat)]
    cur = levels[0]
    while cur.shape[1] > 1:
        cur = mont_mul(cfg, cur[:, 0::2], cur[:, 1::2])
        levels.append(cur)
    inv_cur = inv_total[:, None]
    for lvl in range(len(levels) - 2, -1, -1):
        vals = levels[lvl]
        left = mont_mul(cfg, inv_cur, vals[:, 1::2])
        right = mont_mul(cfg, inv_cur, vals[:, 0::2])
        inv_cur = torch.stack([left, right], dim=2).reshape(
            cfg.L, vals.shape[1])
    return inv_cur[:, :n].reshape((cfg.L,) + tuple(batch))


def inv_in_graph(cfg, a):
    """Batched inversion of (L, *batch) on the device alone: product tree,
    one Fermat power of the (L,) total, down-sweep. Elements must be
    units: a zero gives garbage."""
    total = prod_tree_total(cfg, a)
    inv_total = mont_pow_fixed(cfg, total, cfg.inv_exp_bits)
    return inv_apply(cfg, a, inv_total)


def host_inverse(cfg, total):
    """(L,) Montgomery device value -> its inverse as an (L,) tensor
    (0 -> 0); one 2-byte-per-limb round trip and a Python pow."""
    t = cfg.from_mont_host(total[:, None])[0]
    inv = pow(t, -1, cfg.mod) if t % cfg.mod else 0
    return cfg.scalar(inv, total.device)


def batch_inv(cfg, a):
    """Batched inversion along the batch axes of (L, *batch): up/down
    product tree + one host inversion of the total. Zeros map to zeros."""
    batch = a.shape[1:]
    flat = a.reshape(cfg.L, -1)
    is_z = is_zero(flat)
    one = cfg.const("one", flat.device)
    safe = torch.where(is_z[None], one, flat)
    inv_total = host_inverse(cfg, prod_tree_total(cfg, safe))
    out = inv_apply(cfg, safe, inv_total)
    out = torch.where(is_z[None], torch.zeros_like(out), out)
    return out.reshape((cfg.L,) + tuple(batch))


def inv(cfg, a):
    """Inverse of (L, *batch) or of one (L,) element; zero maps to zero
    (host round trip for the total, as `batch_inv`)."""
    if a.dim() == 1:
        return batch_inv(cfg, a[:, None])[:, 0]
    return batch_inv(cfg, a)
