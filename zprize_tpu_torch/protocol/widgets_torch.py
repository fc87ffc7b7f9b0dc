"""`zprize_tpu/protocol/widgets_jax.py`, copied verbatim onto the port's FV.

Vectorized gate-widget formulas over FV tensors — same math as
`protocol/widgets.py` (the scalar spec), evaluated across all 8n coset points
at once on device. Counterpart of the reference's widget CUDA chains
(`lib/PLONK/src/plonk_core/src/proof_system/widget/*.cu`)."""

from ..fields.frvec import FV


def delta(f: FV) -> FV:
    one = FV.one()
    return f * (f - one) * (f - FV.const(2)) * (f - FV.const(3))


def delta_xor_and(a, b, w, c, q_c):
    F_ = w * (w * (w.scale(4) - (a + b).scale(18) + FV.const(81))
              + (a.sqr() + b.sqr()).scale(18) - (a + b).scale(81)
              + FV.const(83))
    E = (a + b + c).scale(3) - F_.scale(2)
    B = q_c * (c.scale(9) - (a + b).scale(3))
    return B + E


def range_constraint(sep: FV, a, b, c, d, d_next):
    kappa = sep.sqr()
    k2 = kappa.sqr()
    k3 = k2 * kappa
    four = FV.const(4)
    b1 = delta(c - four * d)
    b2 = delta(b - four * c) * kappa
    b3 = delta(a - four * b) * k2
    b4 = delta(d_next - four * a) * k3
    return (b1 + b2 + b3 + b4) * sep


def logic_constraint(sep, a, b, c, d, a_next, b_next, d_next, q_c):
    kappa = sep.sqr()
    k2 = kappa.sqr()
    k3 = k2 * kappa
    k4 = k3 * kappa
    four = FV.const(4)
    qa = a_next - four * a
    qb = b_next - four * b
    qd = d_next - four * d
    c0 = delta(qa)
    c1 = delta(qb) * kappa
    c2 = delta(qd) * k2
    c3 = (c - qa * qb) * k3
    c4 = delta_xor_and(qa, qb, c, qd, q_c) * k4
    return (c0 + c1 + c2 + c3 + c4) * sep


def fbsm_constraint(sep, a, b, c, d, a_next, b_next, d_next, q_l, q_r, q_c,
                    coeff_a: FV, coeff_d: FV):
    kappa = sep.sqr()
    k2 = kappa.sqr()
    k3 = k2 * kappa
    one = FV.one()
    bit = d_next - d.scale(2)
    bit_consistency = bit * (bit - one) * (bit + one)
    y_alpha = bit.sqr() * (q_r - one) + one
    x_alpha = q_l * bit
    xy_consistency = (bit * q_c - c) * kappa
    lhs = a_next + a_next * c * a * b * coeff_d
    rhs = x_alpha * b + y_alpha * a
    x_acc = (lhs - rhs) * k2
    lhs = b_next - b_next * c * a * b * coeff_d
    rhs = y_alpha * b - coeff_a * x_alpha * a
    y_acc = (lhs - rhs) * k3
    return (bit_consistency + x_acc + y_acc + xy_consistency) * sep


def ca_constraint(sep, a, b, c, d, a_next, b_next, d_next, coeff_a, coeff_d):
    x1, y1, x2, y2 = a, b, c, d
    x3, y3, x1y2 = a_next, b_next, d_next
    kappa = sep.sqr()
    xy_consistency = x1 * y2 - x1y2
    y1x2 = y1 * x2
    x3_lhs = x1y2 + y1x2
    x3_rhs = x3 + x3 * coeff_d * x1y2 * y1x2
    x3_consistency = (x3_lhs - x3_rhs) * kappa
    y3_lhs = y1 * y2 - coeff_a * x1 * x2
    y3_rhs = y3 - y3 * coeff_d * x1y2 * y1x2
    y3_consistency = (y3_lhs - y3_rhs) * kappa.sqr()
    return (xy_consistency + x3_consistency + y3_consistency) * sep


def arithmetic_constraint(q_arith, q_m, q_l, q_r, q_o, q_4, q_c, q_hl, q_hr,
                          q_h4, a, b, c, d):
    acc = (a * b * q_m + a * q_l + b * q_r + c * q_o + d * q_4
           + a.pow5() * q_hl + b.pow5() * q_hr + d.pow5() * q_h4 + q_c)
    return acc * q_arith


def lc4(a, b, c, d, ch):
    """a + ch*b + ch^2*c + ch^3*d (full fold, util.rs lc)."""
    return ((d * ch + c) * ch + b) * ch + a


def lookup_quotient_term(q_lookup, a, b, c, d, f, t, t_next, h1, h1_next, h2,
                         z2, z2_next, l1, delta_ch, epsilon, zeta,
                         lookup_sep):
    ls2 = lookup_sep.sqr()
    ls3 = ls2 * lookup_sep
    one = FV.one()
    one_plus_delta = delta_ch + one
    eps_opd = epsilon * one_plus_delta
    compressed = lc4(a, b, c, d, zeta)
    term_a = q_lookup * (compressed - f) * lookup_sep
    b0 = epsilon + f
    b1 = eps_opd + t + delta_ch * t_next
    term_b = z2 * one_plus_delta * b0 * b1 * ls2
    c0 = eps_opd + h1 + delta_ch * h2
    c1 = eps_opd + h2 + delta_ch * h1_next
    term_c = -(z2_next * c0 * c1 * ls2)
    term_d = (z2 - one) * l1 * ls3
    return term_a + term_b + term_c + term_d


def permutation_quotient_term(x, ls, rs, os, fs, a, b, c, d, z, z_next,
                              alpha, l1_alpha_sq, beta, gamma, k1, k2, k3):
    ta = ((a + beta * x + gamma)
          * (b + beta * k1 * x + gamma)
          * (c + beta * k2 * x + gamma)
          * (d + beta * k3 * x + gamma) * z * alpha)
    tb = ((a + beta * ls + gamma)
          * (b + beta * rs + gamma)
          * (c + beta * os + gamma)
          * (d + beta * fs + gamma) * z_next * alpha)
    tc = (z - FV.one()) * l1_alpha_sq
    return ta - tb + tc
