"""BLS12-381 G1 in xyzz coordinates over limbed Fq tensors — the port of
`zprize_tpu/curve/g1.py`, and the wrappers of the curve kernels:

  K7 `xyzz_add`          (pkern.xyzz_add,          csrc/kernels.cu)
  K7 `xyzz_add_pairs`    K7 over one tree level: adjacent column pairs
  K8 `xyzz_add_mixed`    (pkern.xyzz_add_mixed,    csrc/kernels.cu)
  K9 `xyzz_add_affine2`  (pkern.xyzz_add_affine2,  csrc/kernels.cu)

A point batch is ONE stacked int32 tensor (4L, *batch) = X, Y, ZZ, ZZZ
(L = 24 rows each, Montgomery form), x = X/ZZ, y = Y/ZZZ; the identity has
ZZ == 0. Affine points are (x, y) pairs of (L, *batch) tensors with (0, 0)
for the identity (0 is not an x on y^2 = x^3 + 4). The stacked layout is
what the kernels read, so no call concatenates coordinates; a tree level
reads its pairs in place, so no strided half is copied.

The MSM gathers affine points from a point-major copy instead
(`pack_affine`: per point x then y as 12 packed 32-bit words, 96 B), so
one gathered point is six 16-byte reads, not 48 scattered 4-byte ones.

The device code (csrc/field.cuh) keeps one point and a few temporaries in
registers and reads the other operand's coordinates as it needs them; each
curve kernel is bound by the card's 32-bit integer multiply-add rate
(12M + 2S = 14 Fq products of 588 multiply-adds for K7), not by its
bytes.
"""

import numpy as np
import torch

from ..params import Q_MOD
from ..device import resolve
from ..fields import kernels, limbmath, mont
from ..fields.limb import ints_to_limbs, limbs_to_ints
from ..fields.mont import FQ

L = FQ.L
# K7's plain version runs on Python ints up to this many points: through
# the limb-array version a small batch costs thousands of tiny tensor
# operations a call, and the window fold makes ~255 such calls in a row
INT_BATCH = 256
_RINV = pow(FQ.R, -1, Q_MOD)


def _split(p):
    return {k: p[i * L:(i + 1) * L] for i, k in enumerate(limbmath.COORDS)}


def _stack(d):
    return torch.cat([d[k] for k in limbmath.COORDS], dim=0)


def xyzz_zero(shape=(), device=None):
    """The identity (all coordinates 0) as a (4L, *shape) batch."""
    return torch.zeros((4 * L,) + tuple(shape), dtype=torch.int32,
                       device=resolve(device))


def xyzz_index(p, idx):
    """Points idx (an index tensor) of the first batch axis."""
    return p[:, idx]


def xyzz_select(mask, p, q):
    """mask over the batch axes -> p where set, else q."""
    return mont.select(mask, p, q)


def xyzz_from_affine(x, y):
    """(L, ...) affine with (0, 0) identity -> stacked xyzz."""
    inf = mont.is_zero(x) & mont.is_zero(y)
    one = FQ.const("one", x.device).reshape((L,) + (1,) * (x.dim() - 1))
    zz = torch.where(inf[None], torch.zeros_like(x), one.expand_as(x))
    return torch.cat([x, y, zz, zz], dim=0)


def is_identity(p):
    return mont.is_zero(p[2 * L:3 * L])


# ---------------------------------------------------------------------------
# K7 / K8 / K9 and their plain versions
# ---------------------------------------------------------------------------

def _to_ints(p):
    """(4L, N) words -> [X, Y, ZZ, ZZZ], each N Montgomery
    representatives."""
    a = p.cpu().numpy().astype(np.uint32)
    return [limbs_to_ints(a[i * L:(i + 1) * L].T) for i in range(4)]


def _from_ints(coords, device):
    a = np.concatenate([ints_to_limbs(c, L).T for c in coords], axis=0)
    return torch.from_numpy(a.astype(np.int32)).to(device)


def _mul(a, b):
    return a * b * _RINV % Q_MOD


def _double_int(X, Y, ZZ, ZZZ):
    """dbl-2008-s-1 on Montgomery representatives, step for step as
    `limbmath.xyzz_double`."""
    q = Q_MOD
    U = 2 * Y % q
    V = _mul(U, U)
    W = _mul(U, V)
    S = _mul(X, V)
    M = 3 * _mul(X, X) % q
    X3 = (_mul(M, M) - 2 * S) % q
    Y3 = (_mul(M, (S - X3) % q) - _mul(W, Y)) % q
    return X3, Y3, _mul(V, ZZ), _mul(W, ZZZ)


def _add_int(p, r):
    """add-2008-s-1 with `limbmath.xyzz_add`'s selection order on
    Montgomery representatives: r = O -> p; p = O -> r; P == Q doubles."""
    (X1, Y1, ZZ1, ZZZ1), (X2, Y2, ZZ2, ZZZ2) = p, r
    if ZZ2 == 0:
        return p
    if ZZ1 == 0:
        return r
    q = Q_MOD
    U1, U2 = _mul(X1, ZZ2), _mul(X2, ZZ1)
    S1, S2 = _mul(Y1, ZZZ2), _mul(Y2, ZZZ1)
    Pd, R = (U2 - U1) % q, (S2 - S1) % q
    if Pd == 0 and R == 0:
        return _double_int(*p)
    PP = _mul(Pd, Pd)
    PPP = _mul(Pd, PP)
    Qv = _mul(U1, PP)
    X3 = (_mul(R, R) - PPP - 2 * Qv) % q
    Y3 = (_mul(R, (Qv - X3) % q) - _mul(S1, PPP)) % q
    return (X3, Y3, _mul(_mul(ZZ1, ZZ2), PP), _mul(_mul(ZZZ1, ZZZ2), PPP))


def xyzz_add_plain(p, q):
    """Plain version of K7 on stacked (4L, N) tensors (on Python ints up
    to INT_BATCH points, else on limb arrays: the same words)."""
    if p.shape[1] <= INT_BATCH:
        out = [_add_int(a, b) for a, b in zip(zip(*_to_ints(p)),
                                              zip(*_to_ints(q)))]
        return _from_ints(list(zip(*out)) or [[]] * 4, p.device)
    r = limbmath.xyzz_add(FQ.P, _split(p.to(torch.int64)),
                          _split(q.to(torch.int64)))
    return _stack(r).to(torch.int32)


def xyzz_add_mixed_plain(p, qx, qy):
    """Plain version of K8: p (4L, N) xyzz + affine (L, N) (qx, qy)."""
    q = limbmath.affine_lift(FQ.P, qx.to(torch.int64), qy.to(torch.int64))
    r = limbmath.xyzz_add(FQ.P, _split(p.to(torch.int64)), q)
    return _stack(r).to(torch.int32)


def xyzz_add_pairs_plain(p):
    """Plain version of the tree-level K7 on (4L, R, m): (4L, R, ceil(m/2))
    with out[:, r, i] = p[:, r, 2i] + p[:, r, 2i+1], an odd tail kept."""
    R, m = p.shape[1], p.shape[2]
    h = m // 2
    s = xyzz_add_plain(p[:, :, 0:2 * h:2].reshape(4 * L, -1),
                       p[:, :, 1:2 * h:2].reshape(4 * L, -1))
    s = s.reshape(4 * L, R, h)
    return torch.cat([s, p[:, :, 2 * h:]], dim=2) if m % 2 else s


def xyzz_add_affine2_plain(px, py, qx, qy):
    """Plain version of K9 on (L, N) affine operands."""
    a = limbmath.affine_lift(FQ.P, px.to(torch.int64), py.to(torch.int64))
    b = limbmath.affine_lift(FQ.P, qx.to(torch.int64), qy.to(torch.int64))
    return _stack(limbmath.xyzz_add(FQ.P, a, b)).to(torch.int32)


def xyzz_add(p, q):
    """K7: complete xyzz + xyzz (identity, doubling and cancellation
    cases) over stacked (4L, *batch) tensors of one shape."""
    if p.shape != q.shape:
        shape = mont.broadcast_shapes(p.shape, q.shape)
        p, q = p.expand(shape), q.expand(shape)
    batch = p.shape[1:]
    a = p.reshape(4 * L, -1).contiguous()
    b = q.reshape(4 * L, -1).contiguous()
    if not kernels.use_kernel(a):
        return xyzz_add_plain(a, b).reshape(p.shape)
    for x in (a, b):
        kernels.check_operand(x, 4 * L, a.device)
    n = a.shape[1]
    out = torch.empty_like(a)
    rc = kernels.load_library().zk_xyzz_add(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, kernels.stream())
    kernels.check(rc, "xyzz_add")
    kernels.count("xyzz_add")
    return out.reshape((4 * L,) + tuple(batch))


def xyzz_add_mixed(p, qx, qy):
    """K8: stacked xyzz (4L, *batch) + affine (qx, qy) of (L, *batch), with
    (0, 0) the identity; the special cases of K7."""
    batch = p.shape[1:]
    a = p.reshape(4 * L, -1).contiguous()
    x = qx.reshape(L, -1).contiguous()
    y = qy.reshape(L, -1).contiguous()
    if not kernels.use_kernel(a):
        return xyzz_add_mixed_plain(a, x, y).reshape(p.shape)
    kernels.check_operand(a, 4 * L, a.device)
    for t in (x, y):
        kernels.check_operand(t, L, a.device)
        if t.shape[1] != a.shape[1]:
            raise ValueError("affine operand must match the xyzz batch")
    n = a.shape[1]
    out = torch.empty_like(a)
    rc = kernels.load_library().zk_xyzz_add_mixed(
        a.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
        kernels.stream())
    kernels.check(rc, "xyzz_add_mixed")
    kernels.count("xyzz_add_mixed")
    return out.reshape((4 * L,) + tuple(batch))


def xyzz_add_affine2(px, py, qx, qy):
    """K9: affine + affine -> stacked xyzz (first level of the MSM bucket
    trees); (0, 0) is the identity."""
    batch = px.shape[1:]
    ops = [t.reshape(L, -1).contiguous() for t in (px, py, qx, qy)]
    if not kernels.use_kernel(ops[0]):
        return xyzz_add_affine2_plain(*ops).reshape((4 * L,) + tuple(batch))
    for x in ops:
        kernels.check_operand(x, L, ops[0].device)
        if x.shape != ops[0].shape:
            raise ValueError("affine operands must have one shape")
    n = ops[0].shape[1]
    out = torch.empty((4 * L, n), dtype=torch.int32, device=px.device)
    rc = kernels.load_library().zk_xyzz_add_affine2(
        *[x.data_ptr() for x in ops], out.data_ptr(), n, kernels.stream())
    kernels.check(rc, "xyzz_add_affine2")
    kernels.count("xyzz_add_affine2")
    return out.reshape((4 * L,) + tuple(batch))


def xyzz_add_pairs(p):
    """K7 over one tree level along the LAST batch axis: (4L, *batch, m) ->
    (4L, *batch, ceil(m/2)), out[..., i] = p[..., 2i] + p[..., 2i+1], the
    odd tail p[..., m-1] kept. The pairs are read in place."""
    m = p.shape[-1]
    h = (m + 1) // 2
    a = p.reshape(4 * L, -1, m).contiguous()
    rows = a.shape[1]
    if not kernels.use_kernel(a):
        out = xyzz_add_pairs_plain(a)
    else:
        kernels.check_operand(a.reshape(4 * L, -1), 4 * L, a.device)
        out = torch.empty((4 * L, rows, h), dtype=torch.int32,
                          device=a.device)
        rc = kernels.load_library().zk_xyzz_add_pairs(
            a.data_ptr(), out.data_ptr(), rows, m, kernels.stream())
        kernels.check(rc, "xyzz_add_pairs")
        kernels.count("xyzz_add_pairs")
    return out.reshape(p.shape[:-1] + (h,))


def xyzz_double_plain(p):
    """Plain version of K7 on (p, p): dbl-2008-s-1 alone, which is what
    K7's P == Q case computes; an identity stays as it is."""
    if p.shape[1] <= INT_BATCH:
        out = [c if c[2] == 0 else _double_int(*c)
               for c in zip(*_to_ints(p))]
        return _from_ints(list(zip(*out)) or [[]] * 4, p.device)
    d = _stack(limbmath.xyzz_double(FQ.P, _split(p.to(torch.int64))))
    return torch.where(is_identity(p)[None], p, d.to(torch.int32))


def xyzz_double(p):
    """2P through K7 (its P == Q case is dbl-2008-s-1)."""
    a = p.reshape(4 * L, -1)
    if not kernels.use_kernel(a):
        return xyzz_double_plain(a).reshape(p.shape)
    return xyzz_add(p, p)


def xyzz_neg(p):
    return torch.cat([p[:L], mont.neg(FQ, p[L:2 * L]), p[2 * L:]], dim=0)


def xyzz_tree_sum(p):
    """Sum along the LAST batch axis by a pairwise halving tree (the
    tree-level K7; an odd tail rides up a level unchanged, as its sum with
    the identity would)."""
    while p.shape[-1] > 1:
        p = xyzz_add_pairs(p)
    return p[..., 0]


def affine_add_batched(ax, ay, bx, by):
    """Affine + affine -> affine over (L, *batch) with (0, 0) the identity,
    through one batched inversion on the device (`mont.inv_in_graph`);
    every special case: either operand the identity, P + P, P + (-P).
    The degenerate lanes get the denominator 1 before the inversion, since
    a zero would spoil the whole batch's product."""
    def mul(a, b):
        return mont.mont_mul(FQ, a, b)

    def add(a, b):
        return mont.add(FQ, a, b)

    def sub(a, b):
        return mont.sub(FQ, a, b)

    inf_a = mont.is_zero(ax) & mont.is_zero(ay)
    inf_b = mont.is_zero(bx) & mont.is_zero(by)
    same_x = mont.eq(ax, bx)
    same_y = mont.eq(ay, by)
    dbl = same_x & same_y
    cancel = same_x & ~same_y
    xx = mul(ax, ax)
    num = mont.select(dbl, add(add(xx, xx), xx), sub(by, ay))
    den = mont.select(dbl, add(ay, ay), sub(bx, ax))
    degenerate = inf_a | inf_b | cancel
    one = FQ.const("one", ax.device).reshape(
        (L,) + (1,) * (ax.dim() - 1)).expand_as(ax)
    lam = mul(num, mont.inv_in_graph(FQ, mont.select(~degenerate, den, one)))
    rx = sub(sub(mul(lam, lam), ax), bx)
    ry = sub(mul(lam, sub(ax, rx)), ay)
    zero = torch.zeros_like(ax)
    rx = mont.select(cancel, zero, rx)
    ry = mont.select(cancel, zero, ry)
    rx = mont.select(inf_b, ax, rx)
    ry = mont.select(inf_b, ay, ry)
    rx = mont.select(inf_a, bx, rx)
    ry = mont.select(inf_a, by, ry)
    return rx, ry


def affine_tree_sum(x, y):
    """Sum along the LAST batch axis of affine (x, y), (L, *batch, m), by a
    pairwise halving tree that stays affine (one batched inversion a
    level; an odd axis is padded with the identity) -> (L, *batch)."""
    m = x.shape[-1]
    while m > 1:
        if m % 2:
            pad = torch.zeros_like(x[..., :1])
            x = torch.cat([x, pad], dim=-1)
            y = torch.cat([y, pad], dim=-1)
            m += 1
        x, y = affine_add_batched(x[..., 0::2], y[..., 0::2],
                                  x[..., 1::2], y[..., 1::2])
        m //= 2
    return x[..., 0], y[..., 0]


def xyzz_to_affine_device(p):
    """Device xyzz (4L, *batch) -> affine (x, y) with (0, 0) identity;
    one batched inversion for both ZZ and ZZZ."""
    batch = p.shape[1:]
    flat = p.reshape(4 * L, -1)
    n = flat.shape[1]
    both = torch.cat([flat[2 * L:3 * L], flat[3 * L:]], dim=1)
    inv_both = mont.batch_inv(FQ, both)
    x = mont.mont_mul(FQ, flat[:L], inv_both[:, :n])
    y = mont.mont_mul(FQ, flat[L:2 * L], inv_both[:, n:])
    inf = mont.is_zero(flat[2 * L:3 * L])
    x = torch.where(inf[None], torch.zeros_like(x), x)
    y = torch.where(inf[None], torch.zeros_like(y), y)
    return x.reshape((L,) + tuple(batch)), y.reshape((L,) + tuple(batch))


def xyzz_to_affine_host(p):
    """Small xyzz batch -> list of Python-int affine points (or None); one
    device-to-host copy."""
    flat = p.reshape(4 * L, -1)
    m = flat.shape[1]
    ints = FQ.from_mont_host(torch.cat([flat[i * L:(i + 1) * L]
                                        for i in range(4)], dim=1))
    X, Y, ZZ, ZZZ = (ints[i * m:(i + 1) * m] for i in range(4))
    out = []
    for x, y, zz, zzz in zip(X, Y, ZZ, ZZZ):
        if zz == 0:
            out.append(None)
        else:
            out.append((x * pow(zz, -1, Q_MOD) % Q_MOD,
                        y * pow(zzz, -1, Q_MOD) % Q_MOD))
    return out


def pack_affine(x, y):
    """Affine (L, n) limb tensors -> (n, 24) int32, per point x then y as
    12 little-endian 32-bit words each (two 16-bit limbs a word)."""
    def words(a):
        a = a.to(torch.int64)
        w = a[0::2] | (a[1::2] << 16)                   # (12, n), < 2^32
        return w - ((w >> 31) << 32)                    # as int32 bits
    return torch.cat([words(x), words(y)], dim=0).t().to(
        torch.int32).contiguous()


def unpack_affine(rows):
    """(k, 24) packed points -> affine (x, y), each (L, k) limbs."""
    w = rows.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=2).reshape(-1, 2 * L)
    limbs = limbs.t().to(torch.int32)
    return limbs[:L].contiguous(), limbs[L:].contiguous()


def affine_points_to_device(points, device):
    """Python-int affine points [(x, y) | None] -> (x (L, n), y (L, n),
    inf (n,)) on `device`; identity -> (0, 0)."""
    xs = [0 if pt is None else pt[0] for pt in points]
    ys = [0 if pt is None else pt[1] for pt in points]
    inf = torch.tensor([pt is None for pt in points], device=device)
    return FQ.tensor(xs, device), FQ.tensor(ys, device), inf
