"""Polynomial utilities over limbs-leading (L, n) tensors — the port of
`zprize_tpu/ops/poly.py`: powers tables, evaluation, prefix products and
synthetic division. `jax.lax.associative_scan` has no PyTorch counterpart;
`scan` below is a blocked scan over the field ops (Hillis-Steele inside
blocks of `SCAN_BLOCK`, the block totals scanned recursively, then one
combine of every block with its exclusive prefix).

The scans also come in a carry-in form, for one block of a longer axis
whose earlier blocks another rank holds (`parallel/mesh.Split`): the carry
is what the blocks before contribute. `Layout` says which columns of an
n-axis a rank holds.
"""

from typing import NamedTuple

import torch

from ..fields import mont

SCAN_BLOCK = 1024


def _bits(e):
    return [(e >> i) & 1 for i in range(e.bit_length())]


class Layout(NamedTuple):
    """The columns of an n-axis that rank `rank` of `size` holds: those g
    with (g mod m) // c == rank, c = m / size, in increasing order. Local
    column q*c + l is g = q*m + rank*c + l (q < rows = n/m, l < c): the
    rank holds block `rank` of each of the n/m rows of length m. Layout(n,
    n, 1, 0) is the whole axis."""
    n: int
    m: int
    size: int
    rank: int

    @property
    def c(self):
        return self.m // self.size

    @property
    def rows(self):
        return self.n // self.m

    @property
    def width(self):
        return self.n // self.size

    def take(self, t):
        """This rank's columns of the whole (..., n) tensor t (a copy; t
        itself when the layout is the whole axis)."""
        if self.size == 1 and self.rows == 1:
            return t
        s = t.shape[:-1]
        return t.reshape(s + (self.rows, self.size, self.c))[
            ..., self.rank, :].reshape(s + (self.width,))

    def local(self, g):
        """The local column of global column g, or None on another rank."""
        q, rem = divmod(g, self.m)
        r, l = divmod(rem, self.c)
        return q * self.c + l if r == self.rank else None

    def powers(self, cfg, x):
        """x^g for this rank's columns g, (L, width); x is (L,) Montgomery:
        x^(q m) from one small table times x^(rank c + l) from another."""
        if self.size == 1 and self.rows == 1:
            return powers(cfg, x, self.n)
        xc = mont.mont_pow_fixed(cfg, x, _bits(self.c))
        inner = powers(cfg, x, self.c, start=mont.mont_pow_fixed(
            cfg, xc, _bits(self.rank)) if self.rank else None)
        outer = powers(cfg, mont.mont_pow_fixed(cfg, xc, _bits(self.size)),
                       self.rows)
        return mont.mont_mul(cfg, outer[:, :, None],
                             inner[:, None, :]).reshape(cfg.L, self.width)


def powers(cfg, x, n, start=None):
    """[s, s*x, s*x^2, ..., s*x^(n-1)] along a new last axis, Montgomery:
    x is (L, ...), start s has x's shape (default 1), the result (L, ...,
    n). Log-doubling: concat(arr, arr * x^len)."""
    if start is None:
        first = cfg.const("one", x.device).reshape(
            (cfg.L,) + (1,) * x.dim()).expand(x.shape + (1,))
        second = x[..., None]
    else:
        first = start[..., None]
        second = mont.mont_mul(cfg, first, x[..., None])
    arr = torch.cat([first, second], dim=-1) if n > 1 else first
    x_pow = mont.mont_sqr(cfg, x)
    while arr.shape[-1] < n:
        ext = mont.mont_mul(cfg, arr, x_pow[..., None])
        arr = torch.cat([arr, ext], dim=-1)
        x_pow = mont.mont_sqr(cfg, x_pow)
    return arr[..., :n]


def sum_last(cfg, a):
    """Modular sum along the last axis of (L, ..., n) via an add tree."""
    while a.shape[-1] > 1:
        if a.shape[-1] % 2:
            a = torch.cat([a, torch.zeros_like(a[..., :1])], dim=-1)
        a = mont.add(cfg, a[..., 0::2], a[..., 1::2])
    return a[..., 0]


def prod_last(cfg, a):
    """Modular product along the last axis of (L, ..., n) via a multiply
    tree."""
    while a.shape[-1] > 1:
        if a.shape[-1] % 2:
            one = cfg.const("one", a.device).reshape(
                (cfg.L,) + (1,) * (a.dim() - 1))
            a = torch.cat([a, one.expand(a.shape[:-1] + (1,))], dim=-1)
        a = mont.mont_mul(cfg, a[..., 0::2], a[..., 1::2])
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


def prefix_product(cfg, a, shift_one=False, carry=None):
    """Inclusive prefix product along the last axis of (L, ..., n);
    shift_one=True returns [1, a0, a0*a1, ...] of the same length. The
    carry-in form: `carry` (L, ...), the product of what comes before
    a[..., 0], multiplies every element."""
    one = cfg.const("one", a.device)[:, 0]
    (scanned,) = scan(lambda x, y: [mont.mont_mul(cfg, x[0], y[0])], [a],
                      [one])
    if shift_one:
        first = one.reshape((cfg.L,) + (1,) * (a.dim() - 1)).expand(
            a.shape[:-1] + (1,))
        scanned = torch.cat([first, scanned[..., :-1]], dim=-1)
    if carry is not None:
        scanned = mont.mont_mul(cfg, scanned, carry[..., None])
    return scanned


def divide_linear(cfg, coeffs, z, carry=None):
    """Synthetic division by (X - z) along the last axis of (L, ..., n):
    (quotient (L, ..., n-1), remainder (L, ...)); z is (L,). Scan over the
    affine maps v -> z*v + d_k, as in the JAX package.

    The carry-in form, for a block of a longer polynomial: `carry` (L,
    ...) is the remainder of the coefficients above the block, sum_j
    c_(n+j) z^j. It stands as coefficient n, so the quotient has n
    coefficients (the last is the carry) and the remainder counts the
    blocks above."""
    if carry is not None:
        coeffs = torch.cat([coeffs, carry[..., None]], dim=-1)
    n = coeffs.shape[-1]
    d = coeffs.flip(-1)
    zb = z.reshape(z.shape + (1,) * (d.dim() - 1)).expand(d.shape) \
        .contiguous()

    def combine(a, b):
        v1, p1 = a
        v2, p2 = b
        return [mont.add(cfg, v2, mont.mont_mul(cfg, p2, v1)),
                mont.mont_mul(cfg, p1, p2)]

    zero = torch.zeros_like(z)
    one = cfg.const("one", z.device)[:, 0]
    s, _ = scan(combine, [d, zb], [zero, one])
    return s[..., :n - 1].flip(-1), s[..., n - 1]
