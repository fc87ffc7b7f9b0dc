"""Polynomial utilities over limbs-leading (L, n) tensors — the port of
`zprize_tpu/ops/poly.py`: powers tables, evaluation, prefix products and
synthetic division. `jax.lax.associative_scan` has no PyTorch counterpart;
`scan` below is a blocked scan over the field ops (Hillis-Steele inside
blocks of `SCAN_BLOCK`, the block totals scanned recursively, then one
combine of every block with its exclusive prefix).
"""

import torch

from ..fields import mont

SCAN_BLOCK = 1024


def powers(cfg, x, n):
    """[1, x, x^2, ..., x^(n-1)] as (L, n) Montgomery; x is (L,) mont.
    Log-doubling: concat(arr, arr * x^len)."""
    one = cfg.const("one", x.device)
    arr = torch.cat([one, x[:, None]], dim=1) if n > 1 else one
    x_pow = mont.mont_sqr(cfg, x)
    while arr.shape[1] < n:
        ext = mont.mont_mul(cfg, arr, x_pow[:, None])
        arr = torch.cat([arr, ext], dim=1)
        x_pow = mont.mont_sqr(cfg, x_pow)
    return arr[:, :n]


def sum_last(cfg, a):
    """Modular sum along the last axis of (L, ..., n) via an add tree."""
    while a.shape[-1] > 1:
        if a.shape[-1] % 2:
            a = torch.cat([a, torch.zeros_like(a[..., :1])], dim=-1)
        a = mont.add(cfg, a[..., 0::2], a[..., 1::2])
    return a[..., 0]


def poly_eval(cfg, coeffs, pows_of_x):
    prods = mont.mont_mul(cfg, coeffs, pows_of_x[:, :coeffs.shape[1]])
    return sum_last(cfg, prods)


def poly_eval_many(cfg, coeff_list, pows_of_x):
    """Evaluate several (L, n) polys at one point -> (L, k)."""
    stacked = torch.stack(coeff_list, dim=1)
    return sum_last(cfg, mont.mont_mul(cfg, stacked, pows_of_x[:, None, :]))


def _hillis_steele(combine, xs):
    """Inclusive scan along the last axis; combine(earlier, later)."""
    n = xs[0].shape[-1]
    d = 1
    while d < n:
        c = combine([x[..., :-d] for x in xs], [x[..., d:] for x in xs])
        xs = [torch.cat([x[..., :d], cc], dim=-1) for x, cc in zip(xs, c)]
        d *= 2
    return xs


def scan(combine, xs, ident):
    """Inclusive scan of a tuple of (L, ..., n) tensors along the last axis
    with an associative `combine(earlier, later)`; `ident` is the tuple of
    (L,) identity elements (used to pad to whole blocks)."""
    n = xs[0].shape[-1]
    if n <= SCAN_BLOCK:
        return _hillis_steele(combine, xs)
    B = SCAN_BLOCK
    nb = -(-n // B)
    pad = nb * B - n
    if pad:
        xs = [torch.cat([x, e.reshape((e.shape[0],) + (1,) * (x.dim() - 1))
                         .expand(x.shape[:-1] + (pad,))], dim=-1)
              for x, e in zip(xs, ident)]
    blocks = [x.reshape(x.shape[:-1] + (nb, B)) for x in xs]
    s = _hillis_steele(combine, blocks)
    tot = scan(combine, [v[..., -1] for v in s], ident)
    excl = [torch.cat([e.reshape((e.shape[0],) + (1,) * (t.dim() - 1))
                       .expand(t.shape[:-1] + (1,)), t[..., :-1]], dim=-1)
            for t, e in zip(tot, ident)]
    out = combine([e[..., None] for e in excl], s)
    return [o.reshape(o.shape[:-2] + (nb * B,))[..., :n] for o in out]


def prefix_product(cfg, a, shift_one=False):
    """Inclusive prefix product along axis 1 of (L, n); shift_one=True
    returns [1, a0, a0*a1, ...] of the same length."""
    one = cfg.const("one", a.device)[:, 0]
    (scanned,) = scan(lambda x, y: [mont.mont_mul(cfg, x[0], y[0])], [a],
                      [one])
    if not shift_one:
        return scanned
    return torch.cat([one[:, None], scanned[:, :-1]], dim=1)


def divide_linear(cfg, coeffs, z):
    """Synthetic division by (X - z): (quotient (L, n-1), remainder (L,)).
    Scan over the affine maps v -> z*v + d_k, as in the JAX package."""
    n = coeffs.shape[1]
    d = coeffs.flip(1)
    zb = z[:, None].expand(d.shape).contiguous()

    def combine(a, b):
        v1, p1 = a
        v2, p2 = b
        return [mont.add(cfg, v2, mont.mont_mul(cfg, p2, v1)),
                mont.mont_mul(cfg, p1, p2)]

    zero = torch.zeros_like(z)
    one = cfg.const("one", z.device)[:, 0]
    s, _ = scan(combine, [d, zb], [zero, one])
    return s[:, :n - 1].flip(1), s[:, n - 1]
