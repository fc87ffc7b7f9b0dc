"""Plain PyTorch versions of the limb field and curve kernels — the
array-wise algorithms of `zprize_tpu/fields/limbmath.py` transcribed onto
int64 tensors.

Every function takes and returns limbs-leading `(L, N)` int64 tensors of
16-bit limbs (Montgomery form, fully reduced). They are what the kernel
wrappers run for a tensor on the CPU, and what a comparison on the card
holds each CUDA kernel against (`kernels.impl("plain")`).

Carries are resolved with whole-array carry-save rounds, repeated until no
limb carries. The two Montgomery-reduction products with a constant
(m = T·N' mod R and m·p) are matrix products with a Toeplitz matrix of the
constant's limbs in float64: every column sum is an integer below
24·2^16·2^21 < 2^53, so the product is exact.
"""

import torch

LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1


def _limbs(x: int, L: int):
    return [(x >> (LIMB_BITS * i)) & MASK for i in range(L)]


class LimbParams:
    """Per-field constants; device tensors are built once per device."""

    def __init__(self, mod: int, L: int):
        self.modint = mod
        self.L = L
        R = 1 << (LIMB_BITS * L)
        self.mod_list = _limbs(mod, L)
        self.nprime_list = _limbs((-pow(mod, -1, R)) % R, L)
        self.one_list = _limbs(R % mod, L)
        self._dev = {}

    def consts(self, device):
        key = str(device)
        c = self._dev.get(key)
        if c is None:
            L = self.L
            tn = torch.zeros(L, L, dtype=torch.float64)
            tp = torch.zeros(2 * L + 1, L, dtype=torch.float64)
            for i in range(L):
                for j in range(L):
                    if i + j < L:
                        tn[i + j, i] = self.nprime_list[j]
                    tp[i + j, i] = self.mod_list[j]
            c = {
                "mod": torch.tensor(self.mod_list, dtype=torch.int64,
                                    device=device)[:, None],
                "one": torch.tensor(self.one_list, dtype=torch.int64,
                                    device=device)[:, None],
                "toep_np": tn.to(device),
                "toep_p": tp.to(device),
            }
            self._dev[key] = c
        return c


def norm(t):
    """Column sums (K, N), each below 2^53 -> (K + 1, N) 16-bit limbs:
    carry-save rounds (every limb keeps its low 16 bits and passes the
    rest one row up) until no row carries. The carry out of row K is
    dropped."""
    t = torch.cat([t, torch.zeros_like(t[:1])], dim=0)
    while True:
        c = t >> LIMB_BITS
        if not bool(c.any()):
            return t
        t = t & MASK
        t[1:] += c[:-1]


def sub_limbs(a, b):
    """a - b over (L, N) limbs -> (difference mod 2^(16L), no_borrow):
    a + (2^(16L) - 1 - b) + 1 in two's complement."""
    L = a.shape[0]
    t = a + (MASK - b)
    t[0] += 1
    f = norm(t)
    return f[:L], f[L] != 0


def cond_sub_mod(P, r, extra=None):
    mod = P.consts(r.device)["mod"]
    d, no_borrow = sub_limbs(r, mod.expand_as(r))
    take = no_borrow if extra is None else (no_borrow | (extra != 0))
    return torch.where(take[None], d, r)


def add(P, a, b):
    f = norm(a + b)
    return cond_sub_mod(P, f[:P.L], extra=f[P.L])


def sub(P, a, b):
    d, no_borrow = sub_limbs(a, b)
    mod = P.consts(a.device)["mod"]
    d2 = norm(d + mod)[:P.L]
    return torch.where(no_borrow[None], d, d2)


def neg(P, a):
    mod = P.consts(a.device)["mod"].expand_as(a)
    d, _ = sub_limbs(mod, a)
    is_z = (a == 0).all(dim=0, keepdim=True)
    return torch.where(is_z, a, d)


def conv_cols(a, b, width):
    """Column sums of the limb product a (La, N) x b (Lb, N), `width`
    columns; every column is below La * 2^32."""
    La, Lb = a.shape[0], b.shape[0]
    T = torch.zeros((width,) + b.shape[1:], dtype=torch.int64,
                    device=b.device)
    for i in range(min(La, width)):
        w = min(Lb, width - i)
        T[i:i + w] += a[i] * b[:w]
    return T


# columns per step of the plain product: keeps its (2L+1, N) int64
# temporaries cache-sized on the CPU
MUL_CHUNK = 16384


def mul(P, a, b):
    """Montgomery REDC: (a*b + m*p) / R with m = (a*b mod R) * N' mod R."""
    N = a.shape[1]
    if a.device.type == "cpu" and N > MUL_CHUNK:
        return torch.cat([_mul(P, a[:, s:s + MUL_CHUNK],
                               b[:, s:s + MUL_CHUNK])
                          for s in range(0, N, MUL_CHUNK)], dim=1)
    return _mul(P, a, b)


def _mul(P, a, b):
    L = P.L
    c = P.consts(a.device)
    T = conv_cols(a, b, 2 * L + 1)
    # m = (T mod R) * N' mod R from the low L columns split into 16-bit
    # halves (T_k = Tl_k + 2^16 Th_k), as limbmath.mul does
    tn = c["toep_np"]
    Tl = (T[:L] & MASK).to(torch.float64)
    Th = (T[:L] >> LIMB_BITS).to(torch.float64)
    m_cols = (tn @ Tl).to(torch.int64)
    m_cols[1:] += (tn[:L - 1, :L - 1] @ Th[:L - 1]).to(torch.int64)
    m = norm(m_cols)[:L]
    Uc = (c["toep_p"] @ m.to(torch.float64)).to(torch.int64)
    Xn = norm(T + Uc)
    return cond_sub_mod(P, Xn[L:2 * L], extra=Xn[2 * L])


def mul3(P, a, b, c):
    """Plain version of K6: (a*b*R^-1) * c * R^-1."""
    return mul(P, mul(P, a, b), c)


def is_zero(a):
    return (a == 0).all(dim=0)


# ---------------------------------------------------------------------------
# xyzz curve core over Fq: p, q are dicts of (L, N) coordinates
# ---------------------------------------------------------------------------

COORDS = ("X", "Y", "ZZ", "ZZZ")


def xyzz_double(P, p):
    """dbl-2008-s-1 (a = 0): 6M + 2S."""
    U = add(P, p["Y"], p["Y"])
    V = mul(P, U, U)
    W = mul(P, U, V)
    S = mul(P, p["X"], V)
    XX = mul(P, p["X"], p["X"])
    Mv = add(P, add(P, XX, XX), XX)
    X3 = sub(P, mul(P, Mv, Mv), add(P, S, S))
    Y3 = sub(P, mul(P, Mv, sub(P, S, X3)), mul(P, W, p["Y"]))
    return {"X": X3, "Y": Y3, "ZZ": mul(P, V, p["ZZ"]),
            "ZZZ": mul(P, W, p["ZZZ"])}


def _xyzz_add_finite(P, p, q):
    """add-2008-s-1 for operands that are both not the identity; P == Q
    doubles, P == -Q gives ZZ = ZZZ = 0 (PP = PPP = 0)."""
    U1 = mul(P, p["X"], q["ZZ"])
    U2 = mul(P, q["X"], p["ZZ"])
    S1 = mul(P, p["Y"], q["ZZZ"])
    S2 = mul(P, q["Y"], p["ZZZ"])
    Pd = sub(P, U2, U1)
    R = sub(P, S2, S1)
    PP = mul(P, Pd, Pd)
    PPP = mul(P, Pd, PP)
    Q = mul(P, U1, PP)
    X3 = sub(P, sub(P, mul(P, R, R), PPP), add(P, Q, Q))
    Y3 = sub(P, mul(P, R, sub(P, Q, X3)), mul(P, S1, PPP))
    ZZ3 = mul(P, mul(P, p["ZZ"], q["ZZ"]), PP)
    ZZZ3 = mul(P, mul(P, p["ZZZ"], q["ZZZ"]), PPP)
    out = {"X": X3, "Y": Y3, "ZZ": ZZ3, "ZZZ": ZZZ3}
    dbl = is_zero(Pd) & is_zero(R)
    if bool(dbl.any()):
        idx = dbl.nonzero()[:, 0]
        d = xyzz_double(P, {k: v[:, idx] for k, v in p.items()})
        for k in COORDS:
            out[k][:, idx] = d[k]
    return out


def xyzz_add(P, p, q):
    """Complete xyzz addition with the selection order of
    limbmath.xyzz_add: q = O -> p; else p = O -> q; else the formula
    (doubling when P == Q). The formula runs only on the columns where
    both operands are finite, which gives the same values."""
    p_inf = is_zero(p["ZZ"])
    q_inf = is_zero(q["ZZ"])
    out = {k: torch.where(q_inf[None], p[k], q[k]) for k in COORDS}
    live = ~(p_inf | q_inf)
    if bool(live.any()):
        idx = live.nonzero()[:, 0]
        r = _xyzz_add_finite(P, {k: v[:, idx] for k, v in p.items()},
                             {k: v[:, idx] for k, v in q.items()})
        for k in COORDS:
            out[k][:, idx] = r[k]
    return out


def affine_lift(P, x, y):
    """affine (x, y) -> xyzz dict; (0, 0) encodes the identity."""
    inf = is_zero(x) & is_zero(y)
    one = P.consts(x.device)["one"].expand_as(x)
    zz = torch.where(inf[None], torch.zeros_like(x), one)
    return {"X": x, "Y": y, "ZZ": zz, "ZZZ": zz}
