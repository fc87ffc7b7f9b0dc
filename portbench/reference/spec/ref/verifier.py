"""PLONK verifier — clone of `Proof::verify`
(`plonk-core/src/proof_system/proof.rs:123-441`), with the batched opening
check passed in as `pc`. It plays the role arkworks' verifier plays in
`pnp_bench.rs:124-136`.
"""

from ..params import R_MOD, K1, K2, K3
from ..protocol.transcript_protocol import TranscriptProtocol
from ..protocol.widgets import (range_constraint, logic_constraint,
                                fbsm_constraint, ca_constraint, lc)
from .domain import Domain
from .field import fr_batch_inv
from .curve import g1_add, g1_mul, g1_msm

M = R_MOD


def verify(vk, proof, public_inputs, transcript: TranscriptProtocol, pc):
    # `pc.check(commitments, point, evals, opening, challenge)` is the
    # batched opening check (the benchmark's `check.KnownTauPC`).
    # Returns True iff the proof verifies; `transcript` must be seeded
    # with the verifier key (preprocessing view), as in `verify_proof`.
    n = vk.n
    domain = Domain(n)
    t = transcript
    ev = proof.evaluations

    t.append_pi(b"pi", public_inputs)

    t.append_g1(b"w_l", proof.a_comm)
    t.append_g1(b"w_r", proof.b_comm)
    t.append_g1(b"w_o", proof.c_comm)
    t.append_g1(b"w_4", proof.d_comm)

    zeta = t.challenge_scalar(b"zeta")
    t.append_fr(b"zeta", zeta)

    t.append_g1(b"f", proof.f_comm)
    t.append_g1(b"h1", proof.h_1_comm)
    t.append_g1(b"h2", proof.h_2_comm)

    beta = t.challenge_scalar(b"beta")
    t.append_fr(b"beta", beta)
    gamma = t.challenge_scalar(b"gamma")
    t.append_fr(b"gamma", gamma)
    delta_ch = t.challenge_scalar(b"delta")
    t.append_fr(b"delta", delta_ch)
    epsilon = t.challenge_scalar(b"epsilon")
    t.append_fr(b"epsilon", epsilon)

    t.append_g1(b"z", proof.z_comm)

    alpha = t.challenge_scalar(b"alpha")
    t.append_fr(b"alpha", alpha)
    range_sep = t.challenge_scalar(b"range separation challenge")
    t.append_fr(b"range seperation challenge", range_sep)
    logic_sep = t.challenge_scalar(b"logic separation challenge")
    t.append_fr(b"logic seperation challenge", logic_sep)
    fbsm_sep = t.challenge_scalar(b"fixed base separation challenge")
    t.append_fr(b"fixed base separation challenge", fbsm_sep)
    ca_sep = t.challenge_scalar(b"variable base separation challenge")
    t.append_fr(b"variable base separation challenge", ca_sep)
    lookup_sep = t.challenge_scalar(b"lookup separation challenge")
    t.append_fr(b"lookup separation challenge", lookup_sep)

    for i in range(8):
        t.append_g1(b"t_" + str(i + 1).encode(), proof.t_comms[i])

    z_ch = t.challenge_scalar(b"z")
    t.append_fr(b"z", z_ch)

    z_h_eval = domain.evaluate_vanishing_polynomial(z_ch)
    l1_eval = z_h_eval * pow(n * ((z_ch - 1) % M) % M, -1, M) % M

    r0 = compute_r0(domain, public_inputs, alpha, beta, gamma, delta_ch,
                    epsilon, z_ch, l1_eval, ev, lookup_sep)

    t.append_fr(b"a_eval", ev.a_eval)
    t.append_fr(b"b_eval", ev.b_eval)
    t.append_fr(b"c_eval", ev.c_eval)
    t.append_fr(b"d_eval", ev.d_eval)
    t.append_fr(b"left_sig_eval", ev.left_sigma_eval)
    t.append_fr(b"right_sig_eval", ev.right_sigma_eval)
    t.append_fr(b"out_sig_eval", ev.out_sigma_eval)
    t.append_fr(b"perm_eval", ev.permutation_eval)
    t.append_fr(b"f_eval", ev.f_eval)
    t.append_fr(b"q_lookup_eval", ev.q_lookup_eval)
    t.append_fr(b"lookup_perm_eval", ev.z2_next_eval)
    t.append_fr(b"h_1_eval", ev.h1_eval)
    t.append_fr(b"h_1_next_eval", ev.h1_next_eval)
    t.append_fr(b"h_2_eval", ev.h2_eval)
    for label, value in ev.custom_evals:
        t.append_fr(label.encode(), value)

    lin_comm = compute_linearisation_commitment(
        domain, vk, proof, alpha, beta, gamma, delta_ch, epsilon, zeta,
        range_sep, logic_sep, fbsm_sep, ca_sep, lookup_sep, z_ch, l1_eval)

    zeta_sq = zeta * zeta % M
    table_comm = g1_msm(
        [c for c in vk.table_commitments],
        [1, zeta, zeta_sq, zeta_sq * zeta % M])

    aw_challenge = t.challenge_scalar(b"aggregate_witness")
    aw_commits = [lin_comm, vk.commitments["left_sigma"],
                  vk.commitments["right_sigma"], vk.commitments["out_sigma"],
                  proof.f_comm, proof.h_2_comm, table_comm,
                  proof.a_comm, proof.b_comm, proof.c_comm, proof.d_comm]
    aw_evals = [(-r0) % M, ev.left_sigma_eval, ev.right_sigma_eval,
                ev.out_sigma_eval, ev.f_eval, ev.h2_eval, ev.table_eval,
                ev.a_eval, ev.b_eval, ev.c_eval, ev.d_eval]

    saw_challenge = t.challenge_scalar(b"aggregate_witness")
    saw_commits = [proof.z_comm, proof.a_comm, proof.b_comm, proof.d_comm,
                   proof.h_1_comm, proof.z_2_comm, table_comm]
    saw_evals = [ev.permutation_eval, ev.get_custom("a_next_eval"),
                 ev.get_custom("b_next_eval"), ev.get_custom("d_next_eval"),
                 ev.h1_next_eval, ev.z2_next_eval, ev.table_next_eval]

    ok1 = pc.check(aw_commits, z_ch, aw_evals, proof.aw_opening,
                    aw_challenge)
    if not ok1:
        return False
    shifted = z_ch * domain.element(1) % M
    return pc.check(saw_commits, shifted, saw_evals, proof.saw_opening,
                     saw_challenge)


def compute_r0(domain, public_inputs, alpha, beta, gamma, delta_ch, epsilon,
               z_ch, l1_eval, ev, lookup_sep):
    """proof.rs compute_r0 (:444-503)."""
    pi_eval = compute_barycentric_eval(domain, public_inputs, z_ch)
    alpha_sq = alpha * alpha % M
    ls2 = lookup_sep * lookup_sep % M
    ls3 = ls2 * lookup_sep % M

    b0 = (ev.a_eval + beta * ev.left_sigma_eval + gamma) % M
    b1 = (ev.b_eval + beta * ev.right_sigma_eval + gamma) % M
    b2 = (ev.c_eval + beta * ev.out_sigma_eval + gamma) % M
    b3 = (ev.d_eval + gamma) % M * ev.permutation_eval % M * alpha % M
    b = b0 * b1 % M * b2 % M * b3 % M

    c = l1_eval * alpha_sq % M

    eps_opd = epsilon * ((1 + delta_ch) % M) % M
    d0 = ls2 * ev.z2_next_eval % M
    d1 = (eps_opd + delta_ch * ev.h2_eval) % M
    d2 = (eps_opd + ev.h2_eval + delta_ch * ev.h1_next_eval) % M
    d = d0 * d1 % M * d2 % M

    e = ls3 * l1_eval % M
    return (pi_eval - b - c - d - e) % M


def compute_barycentric_eval(domain, public_inputs, point):
    """proof.rs compute_barycentric_eval (:660-706) over sparse PI."""
    numerator = domain.evaluate_vanishing_polynomial(point) * domain.n_inv % M
    if numerator == 0:
        # point in domain: PI poly evaluates to the PI value there (or 0)
        w = 1
        for i in range(domain.n):
            if w == point:
                return public_inputs.get(i, 0)
            w = w * domain.omega % M
        return 0
    idxs = sorted(public_inputs.keys())
    if not idxs:
        return 0
    g_inv = domain.omega_inv
    denoms = [(pow(g_inv, i, M) * point - 1) % M for i in idxs]
    dinv = fr_batch_inv(denoms)
    acc = 0
    for i, dv in zip(idxs, dinv):
        acc = (acc + public_inputs[i] * dv) % M
    return acc * numerator % M


def compute_linearisation_commitment(domain, vk, proof, alpha, beta, gamma,
                                     delta_ch, epsilon, zeta, range_sep,
                                     logic_sep, fbsm_sep, ca_sep, lookup_sep,
                                     z_ch, l1_eval):
    """proof.rs compute_linearisation_commitment (:505-633)."""
    ev = proof.evaluations
    scalars = []
    points = []
    q_arith_eval = ev.get_custom("q_arith_eval")
    a, b, c, d = ev.a_eval, ev.b_eval, ev.c_eval, ev.d_eval

    # arithmetic (widget/arithmetic.rs compute_linearisation_commitment —
    # note its q_4-before-q_o ordering)
    scalars.append(a * b % M * q_arith_eval % M)
    points.append(vk.commitments["q_m"])
    scalars.append(a * q_arith_eval % M)
    points.append(vk.commitments["q_l"])
    scalars.append(b * q_arith_eval % M)
    points.append(vk.commitments["q_r"])
    scalars.append(d * q_arith_eval % M)
    points.append(vk.commitments["q_4"])
    scalars.append(c * q_arith_eval % M)
    points.append(vk.commitments["q_o"])
    scalars.append(pow(a, 5, M) * q_arith_eval % M)
    points.append(vk.commitments["q_hl"])
    scalars.append(pow(b, 5, M) * q_arith_eval % M)
    points.append(vk.commitments["q_hr"])
    scalars.append(pow(d, 5, M) * q_arith_eval % M)
    points.append(vk.commitments["q_h4"])
    scalars.append(q_arith_eval)
    points.append(vk.commitments["q_c"])

    a_next = ev.get_custom("a_next_eval")
    b_next = ev.get_custom("b_next_eval")
    d_next = ev.get_custom("d_next_eval")
    q_c_eval = ev.get_custom("q_c_eval")
    q_l_eval = ev.get_custom("q_l_eval")
    q_r_eval = ev.get_custom("q_r_eval")

    scalars.append(range_constraint(range_sep, a, b, c, d, d_next))
    points.append(vk.commitments["q_range"])
    scalars.append(logic_constraint(logic_sep, a, b, c, d, a_next, b_next,
                                    d_next, q_c_eval))
    points.append(vk.commitments["q_logic"])
    scalars.append(fbsm_constraint(fbsm_sep, a, b, c, d, a_next, b_next,
                                   d_next, q_l_eval, q_r_eval, q_c_eval))
    points.append(vk.commitments["q_fixed_group_add"])
    scalars.append(ca_constraint(ca_sep, a, b, c, d, a_next, b_next, d_next))
    points.append(vk.commitments["q_variable_group_add"])

    # lookup (widget/lookup.rs compute_linearisation_commitment)
    one_plus_delta = (1 + delta_ch) % M
    eps_opd = epsilon * one_plus_delta % M
    ls2 = lookup_sep * lookup_sep % M
    ls3 = ls2 * lookup_sep % M
    compressed = lc([a, b, c, d], zeta)
    scalars.append((compressed - ev.f_eval) % M * lookup_sep % M)
    points.append(vk.commitments["q_lookup"])
    b0 = (epsilon + ev.f_eval) % M
    b1 = (eps_opd + ev.table_eval + delta_ch * ev.table_next_eval) % M
    b2 = l1_eval * ls3 % M
    scalars.append((one_plus_delta * b0 % M * b1 % M * ls2 + b2) % M)
    points.append(proof.z_2_comm)
    c0 = (-ev.z2_next_eval) % M * ls2 % M
    c1 = (eps_opd + ev.h2_eval + delta_ch * ev.h1_next_eval) % M
    scalars.append(c0 * c1 % M)
    points.append(proof.h_1_comm)

    # permutation (proof_system/permutation.rs compute_linearisation_commitment)
    alpha_sq = alpha * alpha % M
    beta_z = beta * z_ch % M
    x = ((a + beta_z + gamma) % M
         * ((b + K1 * beta_z + gamma) % M) % M
         * ((c + K2 * beta_z + gamma) % M) % M
         * (((d + K3 * beta_z + gamma) % M) * alpha % M) % M)
    r = l1_eval * alpha_sq % M
    scalars.append((x + r) % M)
    points.append(proof.z_comm)
    y = ((a + beta * ev.left_sigma_eval + gamma) % M
         * ((b + beta * ev.right_sigma_eval + gamma) % M) % M
         * ((c + beta * ev.out_sigma_eval + gamma) % M) % M
         * (beta * ev.permutation_eval % M * alpha % M) % M)
    scalars.append((-y) % M)
    points.append(vk.commitments["fourth_sigma"])

    # quotient pieces
    vanishing = domain.evaluate_vanishing_polynomial(z_ch)
    z_to_n = (vanishing + 1) % M
    t_scalar = (-vanishing) % M
    for i in range(8):
        scalars.append(t_scalar)
        points.append(proof.t_comms[i])
        t_scalar = t_scalar * z_to_n % M

    # MSM (skip None commitments with their scalars)
    pts, scs = [], []
    for p, s in zip(points, scalars):
        if p is not None:
            pts.append(p)
            scs.append(s)
    return g1_msm(pts, scs)
