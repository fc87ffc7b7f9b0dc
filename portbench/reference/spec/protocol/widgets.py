"""Scalar gate-constraint formulas shared by quotient computation,
linearisation, and the verifier's linearisation commitment.

Clones of `plonk-core/src/proof_system/widget/{range,logic}.rs` and
`widget/ecc/{fixed_base_scalar_mul,curve_addition}.rs` `constraints()`.
All args/returns are canonical Fr ints.
"""

from ..params import R_MOD, JUBJUB_A, JUBJUB_D

M = R_MOD


def delta(f):
    """f(f-1)(f-2)(f-3)"""
    return f * ((f - 1) % M) % M * ((f - 2) % M) % M * ((f - 3) % M) % M


def delta_xor_and(a, b, w, c, q_c):
    """widget/logic.rs:108-137 (B + E)."""
    F_ = w * ((w * ((4 * w - 18 * (a + b) + 81) % M)
               + 18 * (a * a + b * b) % M - 81 * (a + b) + 83) % M) % M
    E = (3 * (a + b + c) - 2 * F_) % M
    B = q_c * ((9 * c - 3 * (a + b)) % M) % M
    return (B + E) % M


def range_constraint(sep, a, b, c, d, d_next):
    kappa = sep * sep % M
    k2 = kappa * kappa % M
    k3 = k2 * kappa % M
    b1 = delta((c - 4 * d) % M)
    b2 = delta((b - 4 * c) % M) * kappa % M
    b3 = delta((a - 4 * b) % M) * k2 % M
    b4 = delta((d_next - 4 * a) % M) * k3 % M
    return (b1 + b2 + b3 + b4) * sep % M


def logic_constraint(sep, a, b, c, d, a_next, b_next, d_next, q_c):
    kappa = sep * sep % M
    k2 = kappa * kappa % M
    k3 = k2 * kappa % M
    k4 = k3 * kappa % M
    qa = (a_next - 4 * a) % M
    c0 = delta(qa)
    qb = (b_next - 4 * b) % M
    c1 = delta(qb) * kappa % M
    qd = (d_next - 4 * d) % M
    c2 = delta(qd) * k2 % M
    w = c
    c3 = (w - qa * qb) % M * k3 % M
    c4 = delta_xor_and(qa, qb, w, qd, q_c) * k4 % M
    return (c0 + c1 + c2 + c3 + c4) * sep % M


def fbsm_constraint(sep, a, b, c, d, a_next, b_next, d_next, q_l, q_r, q_c):
    kappa = sep * sep % M
    k2 = kappa * kappa % M
    k3 = k2 * kappa % M
    x_beta, y_beta = q_l, q_r
    acc_x, acc_x_next = a, a_next
    acc_y, acc_y_next = b, b_next
    xy_alpha = c
    bit = (d_next - 2 * d) % M
    bit_consistency = bit * ((bit - 1) % M) % M * ((bit + 1) % M) % M
    y_alpha = (bit * bit % M * ((y_beta - 1) % M) + 1) % M
    x_alpha = x_beta * bit % M
    xy_consistency = ((bit * q_c - xy_alpha) % M) * kappa % M
    x3 = acc_x_next
    lhs = (x3 + x3 * xy_alpha % M * acc_x % M * acc_y % M * JUBJUB_D) % M
    rhs = (x_alpha * acc_y + y_alpha * acc_x) % M
    x_acc = (lhs - rhs) % M * k2 % M
    y3 = acc_y_next
    lhs = (y3 - y3 * xy_alpha % M * acc_x % M * acc_y % M * JUBJUB_D) % M
    rhs = (y_alpha * acc_y - JUBJUB_A * x_alpha % M * acc_x) % M
    y_acc = (lhs - rhs) % M * k3 % M
    return (bit_consistency + x_acc + y_acc + xy_consistency) * sep % M


def ca_constraint(sep, a, b, c, d, a_next, b_next, d_next):
    x1, y1, x2, y2 = a, b, c, d
    x3, y3, x1y2 = a_next, b_next, d_next
    kappa = sep * sep % M
    xy_consistency = (x1 * y2 - x1y2) % M
    y1x2 = y1 * x2 % M
    y1y2 = y1 * y2 % M
    x1x2 = x1 * x2 % M
    x3_lhs = (x1y2 + y1x2) % M
    x3_rhs = (x3 + x3 * JUBJUB_D % M * x1y2 % M * y1x2) % M
    x3_consistency = (x3_lhs - x3_rhs) % M * kappa % M
    y3_lhs = (y1y2 - JUBJUB_A * x1x2) % M
    y3_rhs = (y3 - y3 * JUBJUB_D % M * x1y2 % M * y1x2) % M
    y3_consistency = (y3_lhs - y3_rhs) % M * (kappa * kappa % M) % M
    return (xy_consistency + x3_consistency + y3_consistency) * sep % M


def arithmetic_constraint(q_arith, q_m, q_l, q_r, q_o, q_4, q_c,
                          q_hl, q_hr, q_h4, a, b, c, d):
    """widget/arithmetic.rs compute_quotient_i."""
    acc = (a * b % M * q_m + a * q_l + b * q_r + c * q_o + d * q_4
           + pow(a, 5, M) * q_hl + pow(b, 5, M) * q_hr
           + pow(d, 5, M) * q_h4 + q_c) % M
    return acc * q_arith % M


def lookup_quotient_term(q_lookup_i, a, b, c, d, f_i, t_i, t_next, h1_i,
                         h1_next, h2_i, z2_i, z2_next, l1_i,
                         delta_ch, epsilon, zeta, lookup_sep):
    """widget/lookup.rs compute_quotient_i."""
    ls2 = lookup_sep * lookup_sep % M
    ls3 = ls2 * lookup_sep % M
    one_plus_delta = (delta_ch + 1) % M
    eps_opd = epsilon * one_plus_delta % M
    compressed = lc([a, b, c, d], zeta)
    term_a = q_lookup_i * ((compressed - f_i) % M) % M * lookup_sep % M
    b0 = (epsilon + f_i) % M
    b1 = (eps_opd + t_i + delta_ch * t_next) % M
    term_b = z2_i * one_plus_delta % M * b0 % M * b1 % M * ls2 % M
    c0 = (eps_opd + h1_i + delta_ch * h2_i) % M
    c1 = (eps_opd + h2_i + delta_ch * h1_next) % M
    term_c = (-z2_next) % M * c0 % M * c1 % M * ls2 % M
    term_d = (z2_i - 1) % M * l1_i % M * ls3 % M
    return (term_a + term_b + term_c + term_d) % M


def permutation_quotient_term(x_i, ls_i, rs_i, os_i, fs_i, a, b, c, d,
                              z_i, z_next, alpha, l1_alpha_sq, beta, gamma):
    """proof_system/permutation.rs compute_quotient_i."""
    from ..params import K1, K2, K3
    ta = ((a + beta * x_i + gamma) % M
          * ((b + beta * K1 % M * x_i + gamma) % M) % M
          * ((c + beta * K2 % M * x_i + gamma) % M) % M
          * ((d + beta * K3 % M * x_i + gamma) % M) % M
          * z_i % M * alpha % M)
    tb = ((a + beta * ls_i + gamma) % M
          * ((b + beta * rs_i + gamma) % M) % M
          * ((c + beta * os_i + gamma) % M) % M
          * ((d + beta * fs_i + gamma) % M) % M
          * z_next % M * alpha % M)
    tc = (z_i - 1) % M * l1_alpha_sq % M
    return (ta - tb + tc) % M


def lc(values, challenge):
    """v_0 + ch*v_1 + ... + ch^k*v_k (util.rs:154-173, full fold)."""
    acc = values[-1] % M
    for v in reversed(values[:-1]):
        acc = (acc * challenge + v) % M
    return acc
