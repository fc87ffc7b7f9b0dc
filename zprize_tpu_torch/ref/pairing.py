"""BLS12-381 pairing (pure Python) — used by the in-repo PLONK verifier to
check KZG openings, playing the role arkworks' pairing plays for the
reference verifier (`plonk-core/src/proof_system/proof.rs:415-441`).

Construction: generic Miller loop over E(Fq12) with the sextic untwist,
loop length |BLS_X|, final exponentiation by (q^12-1)/r.  We deliberately skip
the low-x conjugation: the resulting map is the inverse of the standard ate
pairing, which is still bilinear and non-degenerate — sufficient (and
consistent on both sides) for pairing-product equality checks.
"""

from ..params import Q_MOD, BLS_X, R_MOD

P = Q_MOD

# Fq12 = Fq[w] / (w^12 - 2 w^6 + 2)   (since u = w^6 - 1, u^2 = -1, v = w^2)
_MOD_COEFFS = [2, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0]  # w^12 = -(sum c_i w^i)

DEG = 12


def _poly_rounded_div(a, b):
    dega = _deg(a)
    degb = _deg(b)
    temp = list(a)
    o = [0] * len(a)
    for i in range(dega - degb, -1, -1):
        if temp[degb + i] == 0:
            continue
        c = temp[degb + i] * pow(b[degb], -1, P) % P
        o[i] = (o[i] + c) % P
        for j in range(degb + 1):
            temp[i + j] = (temp[i + j] - c * b[j]) % P
    return o[: _deg(o) + 1]


def _deg(p):
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


class Fq12:
    __slots__ = ("c",)

    def __init__(self, coeffs):
        assert len(coeffs) == DEG
        self.c = [x % P for x in coeffs]

    @staticmethod
    def one():
        return Fq12([1] + [0] * 11)

    @staticmethod
    def zero():
        return Fq12([0] * 12)

    @staticmethod
    def from_fq(x):
        return Fq12([x] + [0] * 11)

    @staticmethod
    def from_fq2(x):
        """Embed a+bu with u = w^6 - 1:  (a-b) + b w^6."""
        a, b = x
        c = [0] * 12
        c[0] = (a - b) % P
        c[6] = b % P
        return Fq12(c)

    def __add__(self, o):
        return Fq12([(a + b) % P for a, b in zip(self.c, o.c)])

    def __sub__(self, o):
        return Fq12([(a - b) % P for a, b in zip(self.c, o.c)])

    def __neg__(self):
        return Fq12([(-a) % P for a in self.c])

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq12([a * o % P for a in self.c])
        b = [0] * (2 * DEG - 1)
        for i, ai in enumerate(self.c):
            if ai:
                for j, bj in enumerate(o.c):
                    if bj:
                        b[i + j] = (b[i + j] + ai * bj) % P
        # reduce by w^12 = 2 w^6 - 2
        for i in range(2 * DEG - 2, DEG - 1, -1):
            top = b[i]
            if top:
                b[i] = 0
                b[i - DEG + 6] = (b[i - DEG + 6] + 2 * top) % P
                b[i - DEG] = (b[i - DEG] - 2 * top) % P
        return Fq12(b[:DEG])

    def square(self):
        return self * self

    def inv(self):
        # extended Euclid on polynomials over Fq
        lm, hm = [1] + [0] * DEG, [0] * (DEG + 1)
        low = self.c + [0]
        high = [x % P for x in _MOD_COEFFS] + [1]
        while _deg(low):
            r = _poly_rounded_div(high, low)
            r += [0] * (DEG + 1 - len(r))
            nm = list(hm)
            new = list(high)
            for i in range(DEG + 1):
                for j in range(DEG + 1 - i):
                    nm[i + j] = (nm[i + j] - lm[i] * r[j]) % P
                    new[i + j] = (new[i + j] - low[i] * r[j]) % P
            lm, low, hm, high = nm, new, lm, low
        inv0 = pow(low[0], -1, P)
        return Fq12([x * inv0 % P for x in lm[:DEG]])

    def pow(self, e):
        e = int(e)
        if e < 0:
            return self.inv().pow(-e)
        acc = Fq12.one()
        base = self
        while e:
            if e & 1:
                acc = acc * base
            base = base * base
            e >>= 1
        return acc

    def __eq__(self, o):
        return self.c == o.c

    def is_one(self):
        return self.c[0] == 1 and all(x == 0 for x in self.c[1:])


_W = Fq12([0, 1] + [0] * 10)
_W2_INV = (_W * _W).inv()
_W3_INV = (_W * _W * _W).inv()


def untwist(q):
    """Map a point of E'(Fq2) to E(Fq12): (x/w^2, y/w^3)."""
    if q is None:
        return None
    x, y = q
    return (Fq12.from_fq2(x) * _W2_INV, Fq12.from_fq2(y) * _W3_INV)


def g1_to_fq12(pt):
    if pt is None:
        return None
    return (Fq12.from_fq(pt[0]), Fq12.from_fq(pt[1]))


def _line(t, q, p):
    """Evaluate the line through t and q (affine, E(Fq12)) at p; returns
    (line_value, t+q)."""
    xt, yt = t
    xp, yp = p
    if q is None or (xt == q[0] and yt == q[1]):
        # doubling: lambda = 3 xt^2 / 2 yt
        lam = xt.square() * 3 * (yt * 2).inv()
        x3 = lam.square() - xt - xt
        y3 = lam * (xt - x3) - yt
        val = (yp - yt) - lam * (xp - xt)
        return val, (x3, y3)
    xq, yq = q
    if xt == xq:
        # vertical line
        val = xp - xt
        return val, None
    lam = (yq - yt) * (xq - xt).inv()
    x3 = lam.square() - xt - xq
    y3 = lam * (xt - x3) - yt
    val = (yp - yt) - lam * (xp - xt)
    return val, (x3, y3)


def miller_loop(p, q):
    """f_{|BLS_X|, Q}(P) for P in G1, Q in G2 (affine int tuples)."""
    if p is None or q is None:
        return Fq12.one()
    pe = g1_to_fq12(p)
    qe = untwist(q)
    t = qe
    f = Fq12.one()
    m = -BLS_X  # positive loop count
    for bit in bin(m)[3:]:
        val, t = _line(t, None, pe)
        f = f.square() * val
        if bit == "1":
            val, t = _line(t, qe, pe)
            f = f * val
    return f


_FINAL_EXP = (P ** 12 - 1) // R_MOD


def final_exponentiation(f):
    return f.pow(_FINAL_EXP)


def pairing(p, q):
    return final_exponentiation(miller_loop(p, q))


def pairing_product_is_one(pairs):
    """Check prod e(P_i, Q_i) == 1 with a single final exponentiation."""
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f).is_one()
