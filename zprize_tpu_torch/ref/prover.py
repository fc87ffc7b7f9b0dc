"""Pure-Python PLONK prover — executable spec of the full 5-round pipeline.

Round structure, transcript labels, and formulas are behavioral clones of
`plonk-core/src/proof_system/prover.rs:171-660` (CPU reference path of the
ZPrize submission) with quotient/linearisation from `quotient_poly.rs` /
`linearisation_poly.rs`. The TPU prover must produce byte-identical proofs.
"""

from ..params import R_MOD, FR_GENERATOR, K1, K2, K3
from ..protocol.proof import Proof, Evaluations
from ..protocol.widgets import (arithmetic_constraint, range_constraint,
                                logic_constraint, fbsm_constraint,
                                ca_constraint, lookup_quotient_term,
                                permutation_quotient_term, lc)
from ..protocol.transcript_protocol import TranscriptProtocol
from ..circuit.permutation import compute_sigma_polynomials
from .domain import Domain, poly_eval, poly_divide_linear
from .field import fr_batch_inv
from . import kzg

M = R_MOD

SELECTOR_ORDER = [  # commit order in preprocess_shared (preprocess.rs:418-440)
    "q_m", "q_l", "q_r", "q_o", "q_4", "q_c", "q_hl", "q_hr", "q_h4",
    "q_arith", "q_range", "q_logic", "q_lookup", "q_fixed_group_add",
    "q_variable_group_add",
]

SEED_ORDER = [  # transcript seeding order (widget/mod.rs seed_transcript)
    ("q_m", b"q_m"), ("q_l", b"q_l"), ("q_r", b"q_r"), ("q_o", b"q_o"),
    ("q_c", b"q_c"), ("q_4", b"q_4"), ("q_hl", b"q_hl"), ("q_hr", b"q_hr"),
    ("q_h4", b"q_h4"), ("q_arith", b"q_arith"), ("q_range", b"q_range"),
    ("q_logic", b"q_logic"),
    ("q_variable_group_add", b"q_variable_group_add"),
    ("q_fixed_group_add", b"q_fixed_group_add"),
    ("left_sigma", b"left_sigma"), ("right_sigma", b"right_sigma"),
    ("out_sigma", b"out_sigma"), ("fourth_sigma", b"fourth_sigma"),
]

SIGMA_NAMES = ["left_sigma", "right_sigma", "out_sigma", "fourth_sigma"]


class ProverKey:
    def __init__(self):
        self.n = 0
        self.selector_polys = {}     # name -> coeff list (len n)
        self.selector_8n = {}        # name -> coset evals (len 8n)
        self.sigma_polys = []        # 4 coeff lists
        self.sigma_8n = []           # 4 coset eval lists
        self.sigma_evals_n = []      # 4 evaluation-form lists over H
        self.linear_8n = []          # coset evals of X over 8n
        self.v_h_coset_8n = []       # coset evals of X^n - 1 over 8n
        self.table_columns = []      # 4 padded lookup columns (len n)


class VerifierKey:
    def __init__(self, n, commitments, table_commitments):
        self.n = n
        self.commitments = commitments          # name -> G1 point
        self.table_commitments = table_commitments  # 4 points


def pad_lookup_column(col, n):
    """MultiSet::pad (lookup/multiset.rs:69-79)."""
    col = list(col)
    if not col:
        col = [0]
    if n > len(col):
        col = col + [col[0]] * (n - len(col))
    return col


def preprocess(cs, srs, transcript: TranscriptProtocol, pc=None):
    """pc: optional PC backend (ref/pc.py); defaults to KZG over `srs`
    (commitment.rs:8-56 HomomorphicCommitment parameterization)."""
    from .pc import KzgPC
    pc = pc or KzgPC(srs)
    # `StandardComposer::preprocess_prover` + `preprocess_shared`
    # (proof_system/preprocess.rs:162-492)
    n = cs.circuit_bound()
    domain = Domain(n)
    domain8 = Domain(8 * n)

    # lookup table preprocessing (lookup/preprocess.rs:42-70)
    raw_cols = cs.lookup_table.columns()
    table_columns = [pad_lookup_column(c, n) for c in raw_cols]
    table_commitments = [pc.commit(domain.ifft(c)) for c in table_columns]

    cs.pad_to(n)

    pk = ProverKey()
    pk.n = n
    for name in SELECTOR_ORDER:
        col = [x % M for x in getattr(cs, name)]
        pk.selector_polys[name] = domain.ifft(col)

    sigma_polys, sigma_evals = compute_sigma_polynomials(cs, n, domain)
    pk.sigma_polys = sigma_polys
    pk.sigma_evals_n = sigma_evals

    commitments = {}
    for name in SELECTOR_ORDER:
        commitments[name] = pc.commit(pk.selector_polys[name])
    for name, poly in zip(SIGMA_NAMES, sigma_polys):
        commitments[name] = pc.commit(poly)

    # 8n coset evaluations
    for name in SELECTOR_ORDER:
        pk.selector_8n[name] = domain8.coset_fft(pk.selector_polys[name])
    pk.sigma_8n = [domain8.coset_fft(p) for p in sigma_polys]
    pk.linear_8n = domain8.coset_fft([0, 1])
    pk.v_h_coset_8n = compute_vanishing_over_coset(domain8, n)
    pk.table_columns = table_columns

    vk = VerifierKey(n, commitments, table_commitments)
    seed_transcript(transcript, vk)
    return pk, vk


def compute_vanishing_over_coset(domain8: Domain, n: int):
    """(g * w8^i)^n - 1 for i in 0..8n (preprocess.rs:498-520)."""
    g_n = pow(FR_GENERATOR, n, M)
    w_n = pow(domain8.omega, n, M)  # 8th root of unity
    out = []
    acc = g_n
    for i in range(domain8.n):
        out.append((acc - 1) % M)
        acc = acc * w_n % M
    return out


def seed_transcript(transcript: TranscriptProtocol, vk: VerifierKey):
    for name, label in SEED_ORDER:
        transcript.append_g1(label, vk.commitments[name])
    transcript.circuit_domain_sep(vk.n)


def combine_split(t_col, f_col):
    """MultiSet::combine_split (lookup/multiset.rs:117-174): bucket in order
    of first appearance in t, split into even/odd halves."""
    counters = {}
    for e in t_col:
        counters[e] = counters.get(e, 0) + 1
    for e in f_col:
        if e not in counters:
            raise ValueError("element of f not in t")
        counters[e] += 1
    evens, odds = [], []
    parity = 0
    for elem, count in counters.items():
        half = count // 2
        evens.extend([elem] * half)
        odds.extend([elem] * half)
        if count % 2 == 1:
            if parity == 1:
                odds.append(elem)
                parity = 0
            else:
                evens.append(elem)
                parity = 1
    return evens, odds


def prove(cs, pk: ProverKey, srs, transcript: TranscriptProtocol, pc=None):
    from .pc import KzgPC
    pc = pc or KzgPC(srs)
    # Clone of `Prover::prove_with_preprocessed` (prover.rs:171-660)
    n = pk.n
    domain = Domain(n)
    t = transcript

    t.append_pi(b"pi", cs.public_inputs)

    # ------------------------------------------------------------- round 1
    val = cs.variables
    w_l_scalar = [val[v] for v in cs.w_l] + [0] * (n - len(cs.w_l))
    w_r_scalar = [val[v] for v in cs.w_r] + [0] * (n - len(cs.w_r))
    w_o_scalar = [val[v] for v in cs.w_o] + [0] * (n - len(cs.w_o))
    w_4_scalar = [val[v] for v in cs.w_4] + [0] * (n - len(cs.w_4))

    w_l_poly = domain.ifft(w_l_scalar)
    w_r_poly = domain.ifft(w_r_scalar)
    w_o_poly = domain.ifft(w_o_scalar)
    w_4_poly = domain.ifft(w_4_scalar)

    a_comm = pc.commit(w_l_poly)
    b_comm = pc.commit(w_r_poly)
    c_comm = pc.commit(w_o_poly)
    d_comm = pc.commit(w_4_poly)
    t.append_g1(b"w_l", a_comm)
    t.append_g1(b"w_r", b_comm)
    t.append_g1(b"w_o", c_comm)
    t.append_g1(b"w_4", d_comm)

    # ------------------------------------------------------------- round 2
    zeta = t.challenge_scalar(b"zeta")
    t.append_fr(b"zeta", zeta)

    compressed_t = [lc([pk.table_columns[0][i], pk.table_columns[1][i],
                        pk.table_columns[2][i], pk.table_columns[3][i]], zeta)
                    for i in range(n)]
    table_poly = domain.ifft(compressed_t)

    q_lookup_col = [x % M for x in cs.q_lookup] + [0] * (n - len(cs.q_lookup))
    f_cols = [[], [], [], []]
    for i in range(n):
        if q_lookup_col[i] == 0:
            f_cols[0].append(compressed_t[0])
            f_cols[1].append(0)
            f_cols[2].append(0)
            f_cols[3].append(0)
        else:
            f_cols[0].append(w_l_scalar[i])
            f_cols[1].append(w_r_scalar[i])
            f_cols[2].append(w_o_scalar[i])
            f_cols[3].append(w_4_scalar[i])
    compressed_f = [lc([f_cols[0][i], f_cols[1][i], f_cols[2][i],
                        f_cols[3][i]], zeta) for i in range(n)]
    f_poly = domain.ifft(compressed_f)
    f_comm = pc.commit(f_poly)
    t.append_g1(b"f", f_comm)

    h_1, h_2 = combine_split(compressed_t, compressed_f)
    h_1_poly = domain.ifft(h_1)
    h_2_poly = domain.ifft(h_2)
    h_1_comm = pc.commit(h_1_poly)
    h_2_comm = pc.commit(h_2_poly)
    t.append_g1(b"h1", h_1_comm)
    t.append_g1(b"h2", h_2_comm)

    # ------------------------------------------------------------- round 3
    beta = t.challenge_scalar(b"beta")
    t.append_fr(b"beta", beta)
    gamma = t.challenge_scalar(b"gamma")
    t.append_fr(b"gamma", gamma)
    delta_ch = t.challenge_scalar(b"delta")
    t.append_fr(b"delta", delta_ch)
    epsilon = t.challenge_scalar(b"epsilon")
    t.append_fr(b"epsilon", epsilon)
    assert len({beta, gamma, delta_ch, epsilon}) == 4, "challenges must differ"

    z_evals = compute_permutation_poly_evals(
        domain, (w_l_scalar, w_r_scalar, w_o_scalar, w_4_scalar),
        beta, gamma, pk.sigma_evals_n)
    z_poly = domain.ifft(z_evals)
    z_comm = pc.commit(z_poly)
    t.append_g1(b"z", z_comm)

    z2_evals = compute_lookup_permutation_poly_evals(
        compressed_f, compressed_t, h_1, h_2, delta_ch, epsilon)
    z_2_poly = domain.ifft(z2_evals)
    z_2_comm = pc.commit(z_2_poly)

    # PI poly
    pi_evals = [0] * n
    for pos, v in cs.public_inputs.items():
        pi_evals[pos] = v
    pi_poly = domain.ifft(pi_evals)

    # ------------------------------------------------------------- round 4
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

    t_poly = compute_quotient(
        domain, pk, z_poly, z_2_poly, w_l_poly, w_r_poly, w_o_poly, w_4_poly,
        pi_poly, f_poly, table_poly, h_1_poly, h_2_poly,
        alpha, beta, gamma, delta_ch, epsilon, zeta,
        range_sep, logic_sep, fbsm_sep, ca_sep, lookup_sep)

    t_i_polys = split_tx_poly(n, t_poly)
    t_comms = [pc.commit(p) for p in t_i_polys]
    for i in range(8):
        t.append_g1(b"t_" + str(i + 1).encode(), t_comms[i])

    # ------------------------------------------------------------- round 5
    z_challenge = t.challenge_scalar(b"z")
    t.append_fr(b"z", z_challenge)

    lin_poly, evaluations = compute_linearisation(
        domain, pk, alpha, beta, gamma, delta_ch, epsilon, zeta,
        range_sep, logic_sep, fbsm_sep, ca_sep, lookup_sep, z_challenge,
        w_l_poly, w_r_poly, w_o_poly, w_4_poly, t_i_polys,
        z_poly, z_2_poly, f_poly, h_1_poly, h_2_poly, table_poly)

    ev = evaluations
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

    # ------------------------------------------------------------ openings
    aw_challenge = t.challenge_scalar(b"aggregate_witness")
    aw_polys = [lin_poly, pk.sigma_polys[0], pk.sigma_polys[1],
                pk.sigma_polys[2], f_poly, h_2_poly, table_poly,
                w_l_poly, w_r_poly, w_o_poly, w_4_poly]
    aw_opening = pc.open_aggregate(aw_polys, z_challenge, aw_challenge)

    saw_challenge = t.challenge_scalar(b"aggregate_witness")
    shifted = z_challenge * domain.element(1) % M
    saw_polys = [z_poly, w_l_poly, w_r_poly, w_4_poly, h_1_poly, z_2_poly,
                 table_poly]
    saw_opening = pc.open_aggregate(saw_polys, shifted, saw_challenge)

    return Proof(
        a_comm=a_comm, b_comm=b_comm, c_comm=c_comm, d_comm=d_comm,
        z_comm=z_comm, f_comm=f_comm, h_1_comm=h_1_comm, h_2_comm=h_2_comm,
        z_2_comm=z_2_comm, t_comms=t_comms,
        aw_opening=aw_opening, saw_opening=saw_opening,
        evaluations=evaluations)


def compute_permutation_poly_evals(domain, wires, beta, gamma, sigma_evals):
    """permutation/mod.rs compute_permutation_poly (evaluation form)."""
    n = domain.n
    ks = (1, K1, K2, K3)
    ratios = []
    denoms = []
    nums = []
    root = 1
    for i in range(n):
        num = 1
        den = 1
        for w in range(4):
            num = num * ((wires[w][i] + beta * ks[w] % M * root + gamma) % M) % M
            den = den * ((wires[w][i] + beta * sigma_evals[w][i] + gamma) % M) % M
        nums.append(num)
        denoms.append(den)
        root = root * domain.omega % M
    dinv = fr_batch_inv(denoms)
    ratios = [a * b % M for a, b in zip(nums, dinv)]
    z = [1]
    state = 1
    for s in ratios[:-1]:
        state = state * s % M
        z.append(state)
    return z


def compute_lookup_permutation_poly_evals(f, tcol, h1, h2, delta_ch, epsilon):
    """permutation/mod.rs compute_lookup_permutation_poly (element-wise roll,
    NOT the reference GPU's 8-byte roll quirk — SURVEY.md §5 note 1)."""
    n = len(f)
    one_plus_delta = (delta_ch + 1) % M
    eps_opd = epsilon * one_plus_delta % M
    t_next = tcol[1:] + [tcol[0]]
    h1_next = h1[1:] + [h1[0]]
    denoms = []
    nums = []
    for i in range(n):
        num = one_plus_delta * ((epsilon + f[i]) % M) % M \
            * ((eps_opd + tcol[i] + delta_ch * t_next[i]) % M) % M
        den = ((eps_opd + h1[i] + h2[i] * delta_ch) % M) \
            * ((eps_opd + h2[i] + h1_next[i] * delta_ch) % M) % M
        nums.append(num)
        denoms.append(den)
    dinv = fr_batch_inv(denoms)
    ratios = [a * b % M for a, b in zip(nums, dinv)]
    p = [1]
    state = 1
    for s in ratios[:-1]:
        state = state * s % M
        p.append(state)
    return p


def split_tx_poly(n, t_poly):
    """8-way split (prover.rs:113-131)."""
    buf = list(t_poly) + [0] * (8 * n - len(t_poly))
    return [buf[i * n:(i + 1) * n] for i in range(8)]


def _wrap8(evals):
    return evals + evals[:8]


def compute_quotient(domain, pk, z_poly, z2_poly, wl_poly, wr_poly, wo_poly,
                     w4_poly, pi_poly, f_poly, table_poly, h1_poly, h2_poly,
                     alpha, beta, gamma, delta_ch, epsilon, zeta,
                     range_sep, logic_sep, fbsm_sep, ca_sep, lookup_sep):
    """quotient_poly.rs compute() — evaluated over the 8n coset."""
    n = domain.n
    domain8 = Domain(8 * n)
    n8 = domain8.n

    l1_coeffs = [domain.n_inv] * n  # ifft of [1,0,...,0]
    l1_8n = domain8.coset_fft(l1_coeffs)
    alpha2 = alpha * alpha % M
    l1_alpha_sq_8n = domain8.coset_fft([c * alpha2 % M for c in l1_coeffs])

    z8 = _wrap8(domain8.coset_fft(z_poly))
    wl8 = _wrap8(domain8.coset_fft(wl_poly))
    wr8 = _wrap8(domain8.coset_fft(wr_poly))
    wo8 = domain8.coset_fft(wo_poly)
    w48 = _wrap8(domain8.coset_fft(w4_poly))
    z28 = _wrap8(domain8.coset_fft(z2_poly))
    f8 = domain8.coset_fft(f_poly)
    t8 = _wrap8(domain8.coset_fft(table_poly))
    h18 = _wrap8(domain8.coset_fft(h1_poly))
    h28 = domain8.coset_fft(h2_poly)
    pi8 = domain8.coset_fft(pi_poly)

    sel = pk.selector_8n
    quotient = []
    vh_inv = fr_batch_inv([v for v in pk.v_h_coset_8n[:8]])
    for i in range(n8):
        a, b, c, d = wl8[i], wr8[i], wo8[i], w48[i]
        a_next, b_next, d_next = wl8[i + 8], wr8[i + 8], w48[i + 8]
        arith = arithmetic_constraint(
            sel["q_arith"][i], sel["q_m"][i], sel["q_l"][i], sel["q_r"][i],
            sel["q_o"][i], sel["q_4"][i], sel["q_c"][i], sel["q_hl"][i],
            sel["q_hr"][i], sel["q_h4"][i], a, b, c, d)
        rng = sel["q_range"][i] * range_constraint(range_sep, a, b, c, d, d_next) % M
        lgc = sel["q_logic"][i] * logic_constraint(
            logic_sep, a, b, c, d, a_next, b_next, d_next, sel["q_c"][i]) % M
        fbsm = sel["q_fixed_group_add"][i] * fbsm_constraint(
            fbsm_sep, a, b, c, d, a_next, b_next, d_next,
            sel["q_l"][i], sel["q_r"][i], sel["q_c"][i]) % M
        ca = sel["q_variable_group_add"][i] * ca_constraint(
            ca_sep, a, b, c, d, a_next, b_next, d_next) % M
        gate = (arith + pi8[i] + rng + lgc + fbsm + ca) % M

        perm = permutation_quotient_term(
            pk.linear_8n[i], pk.sigma_8n[0][i], pk.sigma_8n[1][i],
            pk.sigma_8n[2][i], pk.sigma_8n[3][i], a, b, c, d,
            z8[i], z8[i + 8], alpha, l1_alpha_sq_8n[i], beta, gamma)

        lkp = lookup_quotient_term(
            sel["q_lookup"][i], a, b, c, d, f8[i], t8[i], t8[i + 8],
            h18[i], h18[i + 8], h28[i], z28[i], z28[i + 8], l1_8n[i],
            delta_ch, epsilon, zeta, lookup_sep)

        numerator = (gate + perm + lkp) % M
        quotient.append(numerator * vh_inv[i % 8] % M)

    return domain8.coset_ifft(quotient)


def _poly_scale(p, s):
    return [c * s % M for c in p]


def _poly_add(a, b):
    if len(a) < len(b):
        a, b = b, a
    out = list(a)
    for i, c in enumerate(b):
        out[i] = (out[i] + c) % M
    return out


def compute_linearisation(domain, pk, alpha, beta, gamma, delta_ch, epsilon,
                          zeta, range_sep, logic_sep, fbsm_sep, ca_sep,
                          lookup_sep, z_ch, wl_poly, wr_poly, wo_poly,
                          w4_poly, t_i_polys, z_poly, z2_poly, f_poly,
                          h1_poly, h2_poly, table_poly):
    """linearisation_poly.rs compute()."""
    n = domain.n
    omega = domain.omega
    shifted_z = z_ch * omega % M

    a_eval = poly_eval(wl_poly, z_ch)
    b_eval = poly_eval(wr_poly, z_ch)
    c_eval = poly_eval(wo_poly, z_ch)
    d_eval = poly_eval(w4_poly, z_ch)
    left_sigma_eval = poly_eval(pk.sigma_polys[0], z_ch)
    right_sigma_eval = poly_eval(pk.sigma_polys[1], z_ch)
    out_sigma_eval = poly_eval(pk.sigma_polys[2], z_ch)
    permutation_eval = poly_eval(z_poly, shifted_z)
    q_arith_eval = poly_eval(pk.selector_polys["q_arith"], z_ch)
    q_lookup_eval = poly_eval(pk.selector_polys["q_lookup"], z_ch)
    q_c_eval = poly_eval(pk.selector_polys["q_c"], z_ch)
    q_l_eval = poly_eval(pk.selector_polys["q_l"], z_ch)
    q_r_eval = poly_eval(pk.selector_polys["q_r"], z_ch)
    a_next_eval = poly_eval(wl_poly, shifted_z)
    b_next_eval = poly_eval(wr_poly, shifted_z)
    d_next_eval = poly_eval(w4_poly, shifted_z)
    q_hl_eval = poly_eval(pk.selector_polys["q_hl"], z_ch)
    q_hr_eval = poly_eval(pk.selector_polys["q_hr"], z_ch)
    q_h4_eval = poly_eval(pk.selector_polys["q_h4"], z_ch)
    z2_next_eval = poly_eval(z2_poly, shifted_z)
    h1_eval = poly_eval(h1_poly, z_ch)
    h1_next_eval = poly_eval(h1_poly, shifted_z)
    h2_eval = poly_eval(h2_poly, z_ch)
    f_eval = poly_eval(f_poly, z_ch)
    table_eval = poly_eval(table_poly, z_ch)
    table_next_eval = poly_eval(table_poly, shifted_z)

    vanishing_eval = domain.evaluate_vanishing_polynomial(z_ch)
    z_ch_to_n = (vanishing_eval + 1) % M
    l1_eval = vanishing_eval * pow(n * ((z_ch - 1) % M) % M, -1, M) % M

    evaluations = Evaluations(
        a_eval=a_eval, b_eval=b_eval, c_eval=c_eval, d_eval=d_eval,
        left_sigma_eval=left_sigma_eval, right_sigma_eval=right_sigma_eval,
        out_sigma_eval=out_sigma_eval, permutation_eval=permutation_eval,
        q_lookup_eval=q_lookup_eval, z2_next_eval=z2_next_eval,
        h1_eval=h1_eval, h1_next_eval=h1_next_eval, h2_eval=h2_eval,
        f_eval=f_eval, table_eval=table_eval, table_next_eval=table_next_eval,
        custom_evals=[
            ("q_arith_eval", q_arith_eval), ("q_c_eval", q_c_eval),
            ("q_l_eval", q_l_eval), ("q_r_eval", q_r_eval),
            ("q_hl_eval", q_hl_eval), ("q_hr_eval", q_hr_eval),
            ("q_h4_eval", q_h4_eval), ("a_next_eval", a_next_eval),
            ("b_next_eval", b_next_eval), ("d_next_eval", d_next_eval),
        ])

    # gate constraints portion
    sp = pk.selector_polys
    ab = a_eval * b_eval % M
    gate = _poly_scale(sp["q_m"], ab)
    gate = _poly_add(gate, _poly_scale(sp["q_l"], a_eval))
    gate = _poly_add(gate, _poly_scale(sp["q_r"], b_eval))
    gate = _poly_add(gate, _poly_scale(sp["q_o"], c_eval))
    gate = _poly_add(gate, _poly_scale(sp["q_4"], d_eval))
    gate = _poly_add(gate, _poly_scale(sp["q_hl"], pow(a_eval, 5, M)))
    gate = _poly_add(gate, _poly_scale(sp["q_hr"], pow(b_eval, 5, M)))
    gate = _poly_add(gate, _poly_scale(sp["q_h4"], pow(d_eval, 5, M)))
    gate = _poly_add(gate, sp["q_c"])
    gate = _poly_scale(gate, q_arith_eval)

    gate = _poly_add(gate, _poly_scale(sp["q_range"], range_constraint(
        range_sep, a_eval, b_eval, c_eval, d_eval, d_next_eval)))
    gate = _poly_add(gate, _poly_scale(sp["q_logic"], logic_constraint(
        logic_sep, a_eval, b_eval, c_eval, d_eval,
        a_next_eval, b_next_eval, d_next_eval, q_c_eval)))
    gate = _poly_add(gate, _poly_scale(sp["q_fixed_group_add"],
                                       fbsm_constraint(
        fbsm_sep, a_eval, b_eval, c_eval, d_eval, a_next_eval, b_next_eval,
        d_next_eval, q_l_eval, q_r_eval, q_c_eval)))
    gate = _poly_add(gate, _poly_scale(sp["q_variable_group_add"],
                                       ca_constraint(
        ca_sep, a_eval, b_eval, c_eval, d_eval, a_next_eval, b_next_eval,
        d_next_eval)))

    # lookup portion (widget/lookup.rs compute_linearisation)
    ls2 = lookup_sep * lookup_sep % M
    ls3 = ls2 * lookup_sep % M
    one_plus_delta = (delta_ch + 1) % M
    eps_opd = epsilon * one_plus_delta % M
    compressed = lc([a_eval, b_eval, c_eval, d_eval], zeta)
    lkp = _poly_scale(sp["q_lookup"],
                      (compressed - f_eval) % M * lookup_sep % M)
    b0 = (epsilon + f_eval) % M
    b1 = (eps_opd + table_eval + delta_ch * table_next_eval) % M
    b2 = l1_eval * ls3 % M
    lkp = _poly_add(lkp, _poly_scale(
        z2_poly, (one_plus_delta * b0 % M * b1 % M * ls2 + b2) % M))
    c0 = (-z2_next_eval) % M * ls2 % M
    c1 = (eps_opd + h2_eval + delta_ch * h1_next_eval) % M
    lkp = _poly_add(lkp, _poly_scale(h1_poly, c0 * c1 % M))

    # permutation portion (proof_system/permutation.rs compute_linearisation)
    beta_z = beta * z_ch % M
    a0 = (a_eval + beta_z + gamma) % M
    a1 = (b_eval + K1 * beta_z + gamma) % M
    a2 = (c_eval + K2 * beta_z + gamma) % M
    a3 = (d_eval + K3 * beta_z + gamma) % M
    ident = a0 * a1 % M * a2 % M * a3 % M * alpha % M
    perm = _poly_scale(z_poly, ident)
    s0 = (a_eval + beta * left_sigma_eval + gamma) % M
    s1 = (b_eval + beta * right_sigma_eval + gamma) % M
    s2 = (c_eval + beta * out_sigma_eval + gamma) % M
    copy = s0 * s1 % M * s2 % M * beta % M * permutation_eval % M * alpha % M
    perm = _poly_add(perm, _poly_scale(pk.sigma_polys[3], (-copy) % M))
    perm = _poly_add(perm, _poly_scale(
        z_poly, l1_eval * (alpha * alpha % M) % M))

    # quotient fold (t_8 ... t_1 Horner in z^n), scaled by Z_H(z)
    quot = t_i_polys[7]
    for idx in range(6, -1, -1):
        quot = _poly_add(_poly_scale(quot, z_ch_to_n), t_i_polys[idx])
    neg_quot = _poly_scale(quot, (-vanishing_eval) % M)

    lin = _poly_add(_poly_add(_poly_add(gate, perm), lkp), neg_quot)
    return lin, evaluations
