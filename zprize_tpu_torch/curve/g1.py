"""BLS12-381 G1 in xyzz coordinates over limbed Fq tensors — the port of
`zprize_tpu/curve/g1.py`, and the wrappers of the two curve kernels:

  K7 `xyzz_add`          (pkern.xyzz_add,          csrc/kernels.cu)
  K8 `xyzz_add_mixed`    (pkern.xyzz_add_mixed,    csrc/kernels.cu)
  K9 `xyzz_add_affine2`  (pkern.xyzz_add_affine2,  csrc/kernels.cu)

A point batch is ONE stacked int32 tensor (4L, *batch) = X, Y, ZZ, ZZZ
(L = 24 rows each, Montgomery form), x = X/ZZ, y = Y/ZZZ; the identity has
ZZ == 0. Affine points are (x, y) pairs of (L, *batch) tensors with (0, 0)
for the identity (0 is not an x on y^2 = x^3 + 4). The stacked layout is
what the kernels read, so no call concatenates coordinates.
"""

import torch

from ..params import Q_MOD
from ..fields import kernels, limbmath, mont
from ..fields.mont import FQ

L = FQ.L


def _split(p):
    return {k: p[i * L:(i + 1) * L] for i, k in enumerate(limbmath.COORDS)}


def _stack(d):
    return torch.cat([d[k] for k in limbmath.COORDS], dim=0)


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

def xyzz_add_plain(p, q):
    """Plain version of K7 on stacked (4L, N) tensors."""
    r = limbmath.xyzz_add(FQ.P, _split(p.to(torch.int64)),
                          _split(q.to(torch.int64)))
    return _stack(r).to(torch.int32)


def xyzz_add_mixed_plain(p, qx, qy):
    """Plain version of K8: p (4L, N) xyzz + affine (L, N) (qx, qy)."""
    q = limbmath.affine_lift(FQ.P, qx.to(torch.int64), qy.to(torch.int64))
    r = limbmath.xyzz_add(FQ.P, _split(p.to(torch.int64)), q)
    return _stack(r).to(torch.int32)


def xyzz_add_affine2_plain(px, py, qx, qy):
    """Plain version of K9 on (L, N) affine operands."""
    a = limbmath.affine_lift(FQ.P, px.to(torch.int64), py.to(torch.int64))
    b = limbmath.affine_lift(FQ.P, qx.to(torch.int64), qy.to(torch.int64))
    return _stack(limbmath.xyzz_add(FQ.P, a, b)).to(torch.int32)


def xyzz_add(p, q):
    """K7: complete xyzz + xyzz (identity, doubling and cancellation
    cases) over stacked (4L, *batch) tensors of one shape."""
    if p.shape != q.shape:
        shape = torch.broadcast_shapes(p.shape, q.shape)
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


def xyzz_double(p):
    """2P through K7 (its P == Q case is dbl-2008-s-1)."""
    return xyzz_add(p, p)


def xyzz_neg(p):
    return torch.cat([p[:L], mont.neg(FQ, p[L:2 * L]), p[2 * L:]], dim=0)


def xyzz_tree_sum(p):
    """Sum along the LAST batch axis by a pairwise halving tree."""
    while p.shape[-1] > 1:
        if p.shape[-1] % 2:
            p = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
        p = xyzz_add(p[..., 0::2], p[..., 1::2])
    return p[..., 0]


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


def affine_points_to_device(points, device):
    """Python-int affine points [(x, y) | None] -> (x (L, n), y (L, n),
    inf (n,)) on `device`; identity -> (0, 0)."""
    xs = [0 if pt is None else pt[0] for pt in points]
    ys = [0 if pt is None else pt[1] for pt in points]
    inf = torch.tensor([pt is None for pt in points], device=device)
    return FQ.tensor(xs, device), FQ.tensor(ys, device), inf
