"""Per-gate satisfiability oracle — role of `check_circuit_satisfied`
(`constraint_system/composer.rs:698+`): evaluates every gate equation
directly against the witness, independent of the prover pipeline."""

from ..params import R_MOD, JUBJUB_A, JUBJUB_D


def _delta(f):
    return f * (f - 1) % R_MOD * ((f - 2) % R_MOD) % R_MOD * ((f - 3) % R_MOD) % R_MOD


def check_circuit_satisfied(cs):
    n = cs.n
    val = cs.variables
    for i in range(n):
        a = val[cs.w_l[i]]
        b = val[cs.w_r[i]]
        c = val[cs.w_o[i]]
        d = val[cs.w_4[i]]
        nxt = (i + 1) % n
        a_next = val[cs.w_l[nxt]]
        b_next = val[cs.w_r[nxt]]
        d_next = val[cs.w_4[nxt]]
        pi = cs.public_inputs.get(i, 0)

        arith = (cs.q_arith[i] * (
            cs.q_m[i] * a * b + cs.q_l[i] * a + cs.q_r[i] * b
            + cs.q_o[i] * c + cs.q_4[i] * d
            + cs.q_hl[i] * pow(a, 5, R_MOD)
            + cs.q_hr[i] * pow(b, 5, R_MOD)
            + cs.q_h4[i] * pow(d, 5, R_MOD)
            + cs.q_c[i]) + pi) % R_MOD
        assert arith == 0, f"arith gate {i} unsatisfied"

        if cs.q_range[i] % R_MOD != 0:
            for f in (c - 4 * d, b - 4 * c, a - 4 * b, d_next - 4 * a):
                assert _delta(f % R_MOD) == 0, f"range gate {i} unsatisfied"

        if cs.q_logic[i] % R_MOD != 0:
            qa = (a_next - 4 * a) % R_MOD
            qb = (b_next - 4 * b) % R_MOD
            qd = (d_next - 4 * d) % R_MOD
            assert _delta(qa) == 0 and _delta(qb) == 0 and _delta(qd) == 0, \
                f"logic gate {i} quad decomposition unsatisfied"
            w = c
            assert (w - qa * qb) % R_MOD == 0, f"logic gate {i} product"
            F_ = w * (w * (4 * w - 18 * (qa + qb) + 81)
                      + 18 * (qa * qa + qb * qb) - 81 * (qa + qb) + 83) % R_MOD
            E = (3 * (qa + qb + qd) - 2 * F_) % R_MOD
            B = cs.q_c[i] * (9 * qd - 3 * (qa + qb)) % R_MOD
            assert (B + E) % R_MOD == 0, f"logic gate {i} xor/and unsatisfied"

        if cs.q_fixed_group_add[i] % R_MOD != 0:
            bit = (d_next - 2 * d) % R_MOD
            assert bit * ((bit - 1) % R_MOD) % R_MOD * ((bit + 1) % R_MOD) % R_MOD == 0
            x_beta, y_beta = cs.q_l[i], cs.q_r[i]
            y_alpha = (bit * bit % R_MOD * ((y_beta - 1) % R_MOD) + 1) % R_MOD
            x_alpha = x_beta * bit % R_MOD
            xy_alpha = c
            assert (bit * cs.q_c[i] - xy_alpha) % R_MOD == 0
            x3, y3 = a_next, b_next
            lhs = (x3 + x3 * xy_alpha % R_MOD * a % R_MOD * b % R_MOD * JUBJUB_D) % R_MOD
            rhs = (x_alpha * b + y_alpha * a) % R_MOD
            assert lhs == rhs, f"fbsm gate {i} x unsatisfied"
            lhs = (y3 - y3 * xy_alpha % R_MOD * a % R_MOD * b % R_MOD * JUBJUB_D) % R_MOD
            rhs = (y_alpha * b - JUBJUB_A * x_alpha % R_MOD * a) % R_MOD
            assert lhs == rhs, f"fbsm gate {i} y unsatisfied"

        if cs.q_variable_group_add[i] % R_MOD != 0:
            x1, y1, x2, y2 = a, b, c, d
            x3, y3, x1y2 = a_next, b_next, d_next
            assert (x1 * y2 - x1y2) % R_MOD == 0
            y1x2 = y1 * x2 % R_MOD
            lhs = (x1y2 + y1x2) % R_MOD
            rhs = (x3 + x3 * JUBJUB_D % R_MOD * x1y2 % R_MOD * y1x2) % R_MOD
            assert lhs == rhs, f"ca gate {i} x unsatisfied"
            lhs = (y1 * y2 - JUBJUB_A * x1 % R_MOD * x2) % R_MOD
            rhs = (y3 - y3 * JUBJUB_D % R_MOD * x1y2 % R_MOD * y1x2) % R_MOD
            assert lhs == rhs, f"ca gate {i} y unsatisfied"

        if cs.q_lookup[i] % R_MOD != 0:
            row = (a, b, c, d)
            assert row in set(cs.lookup_table.rows), f"lookup gate {i}: row not in table"
