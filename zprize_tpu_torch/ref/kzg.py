"""KZG10 (SonicKZG10-compatible, degree bounds unused) over BLS12-381 —
pure-Python oracle for the TPU commit/open path
(reference: `plonk-core/lib/PLONK/src/KZG/kzg10.cu`, ark-poly-commit sonic_pc).

Hiding is disabled, matching the reference (SURVEY.md §5 note 3: hiding_bound
NULL, blinders commented out — proofs are deterministic).
"""

from ..params import R_MOD
from .curve import (G1_GEN, G2_GEN, g1_msm, g1_mul, g1_add, g1_neg,
                    g2_mul, g2_add, g2_neg)
from .domain import poly_divide_linear, poly_eval


class SRS:
    """Universal params: powers of tau in G1 + [1]_2, [tau]_2."""

    def __init__(self, powers_of_g, h, beta_h):
        self.powers_of_g = powers_of_g
        self.h = h
        self.beta_h = beta_h

    @staticmethod
    def setup(max_degree: int, tau: int = None, seed: int = 42):
        """Deterministic test SRS (tau is NOT toxic-waste-safe; this mirrors
        the role of `KZG10::setup` in benches, zprize_bench.rs:33)."""
        if tau is None:
            import random
            tau = random.Random(seed).randrange(1, R_MOD)
        powers = []
        acc = 1
        g = G1_GEN
        for _ in range(max_degree + 1):
            powers.append(g1_mul(g, acc))
            acc = acc * tau % R_MOD
        return SRS(powers, G2_GEN, g2_mul(G2_GEN, tau))


def commit(srs: SRS, coeffs):
    """[p(tau)]_1 via MSM over the SRS powers (kzg10.cu `commit`)."""
    # skip trailing zeros (skip_leading_zeros_and_convert in arkworks)
    n = len(coeffs)
    while n > 0 and coeffs[n - 1] == 0:
        n -= 1
    if n == 0:
        return None
    return g1_msm(srs.powers_of_g[:n], coeffs[:n])


def open_aggregate(srs: SRS, polys, point: int, challenge: int):
    """W = [sum_i chi^i (p_i(X) - p_i(z)) / (X - z)](tau).

    Equivalent to arkworks SonicKZG10::open with opening challenge powers;
    the reference GPU computes the same via chi-aggregation then synthetic
    division (kzg10.cu:87-146)."""
    agg = []
    chi = 1
    for p in polys:
        if len(agg) < len(p):
            agg = agg + [0] * (len(p) - len(agg))
        for i, c in enumerate(p):
            agg[i] = (agg[i] + chi * c) % R_MOD
        chi = chi * challenge % R_MOD
    w = poly_divide_linear(agg, point)
    return commit(srs, w)


def check(srs: SRS, commitments, point: int, evals, proof_w, challenge: int):
    """Batched KZG check:
    e(W, [tau]_2 - z H) == e(sum chi^i C_i - (sum chi^i v_i) G, H).
    """
    from .pairing import pairing_product_is_one
    c_comb = None
    v_comb = 0
    chi = 1
    for c, v in zip(commitments, evals):
        if c is not None:
            c_comb = g1_add(c_comb, g1_mul(c, chi))
        v_comb = (v_comb + chi * v) % R_MOD
        chi = chi * challenge % R_MOD
    rhs = g1_add(c_comb, g1_neg(g1_mul(G1_GEN, v_comb)))
    tau_minus_z_h = g2_add(srs.beta_h, g2_neg(g2_mul(srs.h, point)))
    return pairing_product_is_one([
        (proof_w, tau_minus_z_h),
        (g1_neg(rhs) if rhs is not None else None, srs.h),
    ])
