"""BLS12-381 G1/G2 group arithmetic over Python ints — oracle for the JAX
curve layer (`zprize_tpu/curve/g1.py`; reference counterpart:
`lib/PLONK/utils/zkp/cuda/ec/{jacobian_t.hpp,xyzz_t.hpp}`).

G1 points are (x, y) affine tuples or None for infinity.
G2 points are ((x0,x1),(y0,y1)) over Fq2 = Fq[u]/(u^2+1), or None.
"""

from ..params import Q_MOD, G1_X, G1_Y, G2_X_C0, G2_X_C1, G2_Y_C0, G2_Y_C1

P = Q_MOD

G1_GEN = (G1_X, G1_Y)
G2_GEN = ((G2_X_C0, G2_X_C1), (G2_Y_C0, G2_Y_C1))


# ---------------------------------------------------------------------------
# G1 (affine formulas; slow but obviously correct)
# ---------------------------------------------------------------------------

def g1_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 4) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P)


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = 3 * x1 * x1 % P * pow(2 * y1 % P, -1, P) % P
    else:
        lam = (y2 - y1) % P * pow((x2 - x1) % P, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(a):
    return g1_add(a, a)


def g1_mul(pt, k: int):
    k = int(k)
    if k == 0 or pt is None:
        return None
    if k < 0:
        return g1_mul(g1_neg(pt), -k)
    acc = None
    base = pt
    while k:
        if k & 1:
            acc = g1_add(acc, base)
        base = g1_add(base, base)
        k >>= 1
    return acc


def g1_msm(points, scalars):
    """Pippenger MSM oracle (counterpart of sppark `mult_pippenger`,
    `lib/PLONK/utils/zkp/cuda/msm/pippenger.cuh:565`)."""
    n = len(points)
    assert n == len(scalars)
    if n == 0:
        return None
    c = max(3, n.bit_length() - 2)
    nbits = 255
    windows = (nbits + c - 1) // c
    result = None
    for w in range(windows - 1, -1, -1):
        if result is not None:
            for _ in range(c):
                result = g1_double(result)
        buckets = {}
        shift = w * c
        mask = (1 << c) - 1
        for pt, s in zip(points, scalars):
            digit = (int(s) >> shift) & mask
            if digit and pt is not None:
                if digit in buckets:
                    buckets[digit] = g1_add(buckets[digit], pt)
                else:
                    buckets[digit] = pt
        # running-sum bucket reduction
        acc = None
        window_sum = None
        for d in range(mask, 0, -1):
            if d in buckets:
                acc = g1_add(acc, buckets[d])
            window_sum = g1_add(window_sum, acc)
        result = g1_add(result, window_sum)
    return result


# ---------------------------------------------------------------------------
# Fq2 and G2 (needed for the SRS [tau]H and pairing-based verification)
# ---------------------------------------------------------------------------

def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0 % P
    t1 = a1 * b1 % P
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    ninv = pow(norm, -1, P)
    return (a0 * ninv % P, (-a1) * ninv % P)


def fq2_mul_scalar(a, s):
    return (a[0] * s % P, a[1] * s % P)


FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def g2_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    # y^2 = x^3 + 4(u+1)
    b = (4, 4)
    lhs = fq2_mul(y, y)
    rhs = fq2_add(fq2_mul(fq2_mul(x, x), x), b)
    return lhs == rhs


def g2_neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, fq2_neg(y))


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        num = fq2_mul_scalar(fq2_mul(x1, x1), 3)
        den = fq2_mul_scalar(y1, 2)
        lam = fq2_mul(num, fq2_inv(den))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_mul(lam, lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(pt, k: int):
    k = int(k)
    if k == 0 or pt is None:
        return None
    if k < 0:
        return g2_mul(g2_neg(pt), -k)
    acc = None
    base = pt
    while k:
        if k & 1:
            acc = g2_add(acc, base)
        base = g2_add(base, base)
        k >>= 1
    return acc
