"""Poseidon round-number calculation — behavioral clone of
`plonk-hashing/src/poseidon/round_numbers.rs` (neptune-derived):
security inequalities from the Poseidon paper, 128-bit level, 256-bit prime.
"""

import math

PRIME_BITLEN = 256
M_SEC = 128


def _round_numbers_are_secure(t, rf, rp):
    rp_f, t_f, n, m = float(rp), float(t), float(PRIME_BITLEN), float(M_SEC)
    rf_stat = 6.0 if m <= (n - 3.0) * (t_f + 1.0) else 10.0
    rf_interp = 0.43 * m + math.log2(t_f) - rp_f
    rf_grob_1 = 0.21 * n - rp_f
    rf_grob_2 = (0.14 * n - 1.0 - rp_f) / (t_f - 1.0)
    rf_max = max(math.ceil(rf_stat), math.ceil(rf_interp),
                 math.ceil(rf_grob_1), math.ceil(rf_grob_2))
    return rf >= rf_max


def calc_round_numbers(t, security_margin=True):
    rf = rp = 0
    n_sboxes_min = float("inf")
    for rf_test in range(2, 1001, 2):
        for rp_test in range(4, 200):
            if _round_numbers_are_secure(t, rf_test, rp_test):
                rf_eff, rp_eff = rf_test, rp_test
                if security_margin:
                    rf_eff = rf_test + 2
                    # f32 semantics: 1.075 * rp then ceil
                    rp_eff = math.ceil(1.075 * rp_test)
                n_sboxes = t * rf_eff + rp_eff
                if n_sboxes < n_sboxes_min or (n_sboxes == n_sboxes_min
                                               and rf_eff < rf):
                    rf, rp = rf_eff, rp_eff
                    n_sboxes_min = n_sboxes
    return rf, rp
