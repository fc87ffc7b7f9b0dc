"""Inner-product-argument polynomial commitment (IPA) — the reference's
alternative commitment scheme (`plonk-core/src/commitment.rs:52+` exposes
ark-poly-commit's IPA next to KZG; every generic test matrix instantiates
both). This is a self-contained Bulletproofs-style IPA over BLS12-381 G1:
transparent setup (no trusted tau), log-size opening proofs, Fiat-Shamir via
the same merlin transcript stack.

Not byte-compatible with ark-poly-commit's ipa_pc (different generator
derivation); provides the capability with the in-repo transcript/curve
primitives.
"""

import hashlib

from ..params import R_MOD, Q_MOD
from ..protocol.transcript_protocol import TranscriptProtocol
from .curve import G1_GEN, g1_add, g1_mul, g1_neg, g1_msm, g1_is_on_curve
from .field import fr_inv

M = R_MOD


def _hash_to_point(seed: bytes):
    """Deterministic generator derivation: hash -> x candidate -> lift."""
    ctr = 0
    while True:
        h = hashlib.sha256(seed + ctr.to_bytes(4, "little")).digest()
        x = int.from_bytes(h + hashlib.sha256(h).digest()[:16], "little") % Q_MOD
        y2 = (pow(x, 3, Q_MOD) + 4) % Q_MOD
        y = pow(y2, (Q_MOD + 1) // 4, Q_MOD)
        if y * y % Q_MOD == y2:
            p = (x, min(y, Q_MOD - y))
            # clear cofactor to land in the prime-order subgroup
            cofactor = 0x396C8C005555E1568C00AAAB0000AAAB
            p = g1_mul(p, cofactor)
            if p is not None:
                return p
        ctr += 1


class IpaParams:
    def __init__(self, n: int):
        assert n & (n - 1) == 0
        self.n = n
        self.gens = [_hash_to_point(b"zprize-tpu-ipa-G%d" % i)
                     for i in range(n)]
        self.u = _hash_to_point(b"zprize-tpu-ipa-U")


def commit(params: IpaParams, coeffs):
    c = list(coeffs) + [0] * (params.n - len(coeffs))
    return g1_msm(params.gens, c)


def open_proof(params: IpaParams, coeffs, z: int, transcript=None):
    """Prove p(z) = v. Returns (v, proof dict)."""
    t = transcript or TranscriptProtocol(b"ipa")
    n = params.n
    a = [c % M for c in coeffs] + [0] * (n - len(coeffs))
    b = []
    acc = 1
    for _ in range(n):
        b.append(acc)
        acc = acc * z % M
    v = sum(ai * bi for ai, bi in zip(a, b)) % M

    t.append_fr(b"ipa_z", z)
    t.append_fr(b"ipa_v", v)
    xi = t.challenge_scalar(b"ipa_xi")
    u_prime = g1_mul(params.u, xi)

    g = list(params.gens)
    ls, rs = [], []
    while len(a) > 1:
        half = len(a) // 2
        a_lo, a_hi = a[:half], a[half:]
        b_lo, b_hi = b[:half], b[half:]
        g_lo, g_hi = g[:half], g[half:]
        cl = sum(x * y for x, y in zip(a_lo, b_hi)) % M
        cr = sum(x * y for x, y in zip(a_hi, b_lo)) % M
        L = g1_add(g1_msm(g_hi, a_lo), g1_mul(u_prime, cl))
        R = g1_add(g1_msm(g_lo, a_hi), g1_mul(u_prime, cr))
        t.append_g1(b"ipa_L", L)
        t.append_g1(b"ipa_R", R)
        ch = t.challenge_scalar(b"ipa_ch")
        ch_inv = fr_inv(ch)
        a = [(lo + ch * hi) % M for lo, hi in zip(a_lo, a_hi)]
        b = [(lo + ch_inv * hi) % M for lo, hi in zip(b_lo, b_hi)]
        g = [g1_add(lo, g1_mul(hi, ch_inv)) for lo, hi in zip(g_lo, g_hi)]
        ls.append(L)
        rs.append(R)
    return v, {"L": ls, "R": rs, "a": a[0]}


def check(params: IpaParams, commitment, z: int, v: int, proof,
          transcript=None) -> bool:
    t = transcript or TranscriptProtocol(b"ipa")
    n = params.n
    t.append_fr(b"ipa_z", z)
    t.append_fr(b"ipa_v", v % M)
    xi = t.challenge_scalar(b"ipa_xi")
    u_prime = g1_mul(params.u, xi)

    p = g1_add(commitment, g1_mul(u_prime, v))
    chs = []
    for L, R in zip(proof["L"], proof["R"]):
        t.append_g1(b"ipa_L", L)
        t.append_g1(b"ipa_R", R)
        ch = t.challenge_scalar(b"ipa_ch")
        chs.append(ch)
        # folds: a' = a_lo + ch*a_hi, b'/g' fold with ch^-1
        # => P' = P + ch^-1 * L + ch * R
        p = g1_add(p, g1_add(g1_mul(L, fr_inv(ch)), g1_mul(R, ch)))

    # folded generator g_final = sum_i (prod of ch_inv for set bits) G_i,
    # folded b_final likewise with z powers
    k = len(chs)
    s = [1] * n
    for i in range(n):
        acc = 1
        for j in range(k):
            # round j splits on bit (k-1-j); hi half picks ch_inv
            if (i >> (k - 1 - j)) & 1:
                acc = acc * fr_inv(chs[j]) % M
        s[i] = acc
    g_final = g1_msm(params.gens, s)
    b_final = 0
    acc = 1
    for i in range(n):
        b_final = (b_final + s[i] * acc) % M
        acc = acc * z % M

    a0 = proof["a"] % M
    expect = g1_add(g1_mul(g_final, a0),
                    g1_mul(u_prime, a0 * b_final % M))
    return p == expect
