"""JubJub (twisted Edwards a=-1 over Fr) host arithmetic for the ECC gadget
witnesses (ark-ed-on-bls12-381 semantics). Points are (x, y) ints; identity
is (0, 1)."""

from ..params import R_MOD, JUBJUB_A, JUBJUB_D

M = R_MOD
IDENTITY = (0, 1)


def is_on_curve(p):
    x, y = p
    lhs = (JUBJUB_A * x * x + y * y) % M
    rhs = (1 + JUBJUB_D * x * x % M * y % M * y) % M
    return lhs == rhs


def add(p, q):
    x1, y1 = p
    x2, y2 = q
    x1x2 = x1 * x2 % M
    y1y2 = y1 * y2 % M
    x1y2 = x1 * y2 % M
    y1x2 = y1 * x2 % M
    dxy = JUBJUB_D * x1x2 % M * y1y2 % M
    x3 = (x1y2 + y1x2) * pow((1 + dxy) % M, -1, M) % M
    y3 = (y1y2 - JUBJUB_A * x1x2) * pow((1 - dxy) % M, -1, M) % M
    return (x3, y3)


def neg(p):
    return ((-p[0]) % M, p[1])


def double(p):
    return add(p, p)


def mul(p, k: int):
    acc = IDENTITY
    base = p
    k = int(k)
    if k < 0:
        base = neg(base)
        k = -k
    while k:
        if k & 1:
            acc = add(acc, base)
        base = double(base)
        k >>= 1
    return acc


def _sqrt(a):
    """Tonelli-Shanks over Fr; returns None if non-residue."""
    if a == 0:
        return 0
    if pow(a, (M - 1) // 2, M) != 1:
        return None
    # M - 1 = q * 2^s
    q, s = M - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (M - 1) // 2, M) != M - 1:
        z += 1
    m_, c, t, r = s, pow(z, q, M), pow(a, q, M), pow(a, (q + 1) // 2, M)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % M
            i += 1
        b = pow(c, 1 << (m_ - i - 1), M)
        m_, c, t, r = i, b * b % M, t * b % M * b % M, r * b % M
    return r


def _find_generator():
    """Deterministic on-curve point of prime order (cofactor-cleared)."""
    x = 1
    while True:
        num = (1 - JUBJUB_A * x * x) % M
        den = (1 - JUBJUB_D * x * x) % M
        y2 = num * pow(den, -1, M) % M
        y = _sqrt(y2)
        if y is not None:
            p = (x % M, y)
            p8 = mul(p, 8)  # clear cofactor
            if p8 != IDENTITY:
                return p8
        x += 1


GENERATOR = _find_generator()
assert is_on_curve(GENERATOR)


def wnaf2(k: int):
    """NAF (width-2 wNAF) digits little-endian, values in {-1, 0, 1} —
    arkworks BigInteger::find_wnaf(2) semantics."""
    out = []
    while k > 0:
        if k & 1:
            z = 2 - (k % 4)
            k -= z
        else:
            z = 0
        out.append(z)
        k >>= 1
    return out
