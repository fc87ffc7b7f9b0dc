"""Extended gate library: logic (XOR/AND), conditional selects, and the
embedded-curve (JubJub) gadgets — behavioral clones of
`constraint_system/{logic.rs, composer.rs, ecc/*}`.

Implemented as methods attached to StandardComposer (imported for side
effects by `zprize_tpu.circuit`)."""

from ..params import R_MOD
from ..curve import jubjub
from .composer import (StandardComposer, SELECTOR_NAMES, WIRE_LEFT,
                       WIRE_RIGHT, WIRE_OUT, WIRE_FOURTH)

M = R_MOD


class Point:
    """Circuit point (pair of variables), `ecc/mod.rs` Point."""

    def __init__(self, x, y):
        self.x = x
        self.y = y

    @staticmethod
    def identity(cs):
        one = cs.add_witness_to_circuit_description(1)
        return Point(cs.zero_var, one)


def add_witness_to_circuit_description(cs, value):
    var = cs.add_input(value)
    cs.constrain_to_constant(var, value)
    return var


def logic_gate(cs, a, b, num_bits, is_xor):
    """`logic.rs logic_gate`: (num_bits/2)+1 gates; returns the output-accum
    variable. Wire layout staggers w_o one gate behind."""
    assert num_bits % 2 == 0
    num_quads = num_bits >> 1
    av = cs.variables[a]
    bv = cs.variables[b]
    a_bits = [(av >> (num_bits - 1 - i)) & 1 for i in range(num_bits)]
    b_bits = [(bv >> (num_bits - 1 - i)) & 1 for i in range(num_bits)]

    # first row: w_l = w_r = w_4 = zero (w_o filled next iteration)
    cs._map_wire(cs.zero_var, WIRE_LEFT, cs.n)
    cs._map_wire(cs.zero_var, WIRE_RIGHT, cs.n)
    cs._map_wire(cs.zero_var, WIRE_FOURTH, cs.n)
    cs.w_l.append(cs.zero_var)
    cs.w_r.append(cs.zero_var)
    cs.w_4.append(cs.zero_var)
    cs.n += 1

    left_acc = right_acc = out_acc = 0
    last_out_var = cs.zero_var
    for i in range(num_quads):
        lq = (a_bits[2 * i] << 1) + a_bits[2 * i + 1]
        rq = (b_bits[2 * i] << 1) + b_bits[2 * i + 1]
        oq = (lq ^ rq) if is_xor else (lq & rq)
        pq = lq * rq
        left_acc = (4 * left_acc + lq) % M
        right_acc = (4 * right_acc + rq) % M
        out_acc = (4 * out_acc + oq) % M
        va = cs.add_input(left_acc)
        vb = cs.add_input(right_acc)
        vc = cs.add_input(pq)
        v4 = cs.add_input(out_acc)
        cs._map_wire(va, WIRE_LEFT, cs.n)
        cs._map_wire(vb, WIRE_RIGHT, cs.n)
        cs._map_wire(v4, WIRE_FOURTH, cs.n)
        cs._map_wire(vc, WIRE_OUT, cs.n - 1)
        cs.w_l.append(va)
        cs.w_r.append(vb)
        cs.w_o.append(vc)
        cs.w_4.append(v4)
        cs.n += 1
        last_out_var = v4

    cs._map_wire(cs.zero_var, WIRE_OUT, cs.n - 1)
    cs.w_o.append(cs.zero_var)

    qc_ql = (M - 1) if is_xor else 1
    for _ in range(num_quads):
        for name in SELECTOR_NAMES:
            if name in ("q_c", "q_logic"):
                getattr(cs, name).append(qc_ql)
            else:
                getattr(cs, name).append(0)
    for name in SELECTOR_NAMES:
        getattr(cs, name).append(0)
    return last_out_var


def xor_gate(cs, a, b, num_bits):
    return logic_gate(cs, a, b, num_bits, True)


def and_gate(cs, a, b, num_bits):
    return logic_gate(cs, a, b, num_bits, False)


def conditional_select(cs, bit, choice_a, choice_b):
    bit_times_a = cs.arithmetic_gate(q_m=1, w_l=bit, w_r=choice_a)
    one_min_bit = cs.arithmetic_gate(q_l=M - 1, q_r=0, w_l=bit,
                                     w_r=cs.zero_var, q_c=1)
    omb_b = cs.arithmetic_gate(q_m=1, w_l=one_min_bit, w_r=choice_b)
    return cs.arithmetic_gate(q_l=1, q_r=1, w_l=omb_b, w_r=bit_times_a)


def conditional_select_zero(cs, bit, value):
    return cs.arithmetic_gate(q_m=1, w_l=bit, w_r=value)


def conditional_select_one(cs, bit, value):
    bv = cs.variables[bit]
    vv = cs.variables[value]
    f_x = (1 - bv + bv * vv) % M
    f_var = cs.add_input(f_x)
    cs.poly_gate(bit, value, f_var, 1, M - 1, 0, M - 1, 1)
    return f_var


def point_addition_gate(cs, pa: Point, pb: Point) -> Point:
    """`variable_base_gate.rs point_addition_gate`: 2 gates."""
    x1, y1, x2, y2 = pa.x, pa.y, pb.x, pb.y
    p1 = (cs.variables[x1], cs.variables[y1])
    p2 = (cs.variables[x2], cs.variables[y2])
    x3v, y3v = jubjub.add(p1, p2)
    x1y2 = cs.add_input(p1[0] * p2[1] % M)
    x3 = cs.add_input(x3v)
    y3 = cs.add_input(y3v)
    cs._append_gate(x1, y1, x2, y2, q_variable_group_add=1)
    cs._append_gate(x3, y3, cs.zero_var, x1y2)
    return Point(x3, y3)


def fixed_group_add(cs, acc_x, acc_y, accumulated_bit, xy_alpha,
                    x_beta, y_beta, xy_beta):
    """`fixed_base_gate.rs fixed_group_add`."""
    cs._append_gate(acc_x, acc_y, xy_alpha, accumulated_bit,
                    q_l=x_beta, q_r=y_beta, q_c=xy_beta,
                    q_fixed_group_add=1)


def fixed_base_scalar_mul(cs, scalar_var, base_point=None) -> Point:
    """`scalar_mul/fixed_base.rs fixed_base_scalar_mul` (wNAF rounds over
    precomputed doublings of the base)."""
    base_point = base_point or jubjub.GENERATOR
    num_bits = 255  # MODULUS_BITS
    multiples = [base_point]
    for _ in range(1, num_bits):
        multiples.append(jubjub.double(multiples[-1]))
    multiples.reverse()

    scalar_value = cs.variables[scalar_var]
    wnaf = jubjub.wnaf2(scalar_value)
    assert len(wnaf) <= num_bits
    n_trailing = num_bits - len(wnaf)

    scalar_acc = [0] * (n_trailing + 1)
    point_acc = [jubjub.IDENTITY] * (n_trailing + 1)
    xy_alphas = [0] * n_trailing
    for i, entry in enumerate(reversed(wnaf)):
        index = i + n_trailing
        if entry == 0:
            s_add, p_add = 0, jubjub.IDENTITY
        elif entry == -1:
            s_add, p_add = M - 1, jubjub.neg(multiples[index])
        else:
            s_add, p_add = 1, multiples[index]
        scalar_acc.append((2 * scalar_acc[index] + s_add) % M)
        point_acc.append(jubjub.add(point_acc[index], p_add))
        xy_alphas.append(p_add[0] * p_add[1] % M)

    for i in range(num_bits):
        acc_x = cs.add_input(point_acc[i][0])
        acc_y = cs.add_input(point_acc[i][1])
        acc_bit = cs.add_input(scalar_acc[i])
        if i == 0:
            cs.constrain_to_constant(acc_x, 0)
            cs.constrain_to_constant(acc_y, 1)
            cs.constrain_to_constant(acc_bit, 0)
        x_beta, y_beta = multiples[i]
        xy_alpha = cs.add_input(xy_alphas[i])
        fixed_group_add(cs, acc_x, acc_y, acc_bit, xy_alpha,
                        x_beta, y_beta, x_beta * y_beta % M)

    acc_x = cs.add_input(point_acc[num_bits][0])
    acc_y = cs.add_input(point_acc[num_bits][1])
    last_bit = cs.add_input(scalar_acc[num_bits])
    cs.arithmetic_gate(q_o=0, q_4=0, w_l=acc_x, w_r=acc_y,
                       w_o=cs.zero_var, w_4=last_bit)
    cs.assert_equal(last_bit, scalar_var)
    return Point(acc_x, acc_y)


def scalar_decomposition(cs, witness_var):
    """variable_base.rs scalar_decomposition."""
    v = cs.variables[witness_var]
    bits = [(v >> i) & 1 for i in range(255)]
    bit_vars = [cs.add_input(b) for b in bits]
    acc_var = cs.zero_var
    for power, bv in enumerate(bit_vars):
        cs.boolean_gate(bv)
        two_pow = pow(2, power, M)
        acc_var = cs.arithmetic_gate(q_l=two_pow, q_r=1, w_l=bv, w_r=acc_var)
    cs.assert_equal(acc_var, witness_var)
    return bit_vars


def variable_base_scalar_mul(cs, scalar_var, point: Point) -> Point:
    bits = scalar_decomposition(cs, scalar_var)
    result = Point.identity(cs)
    for bit in reversed(bits):
        result = point_addition_gate(cs, result, result)
        to_add = conditional_select_identity(cs, bit, point)
        result = point_addition_gate(cs, result, to_add)
    return result


def conditional_point_select(cs, point_1: Point, point_0: Point, bit) -> Point:
    return Point(conditional_select(cs, bit, point_1.x, point_0.x),
                 conditional_select(cs, bit, point_1.y, point_0.y))


def conditional_select_identity(cs, bit, point: Point) -> Point:
    return Point(conditional_select_zero(cs, bit, point.x),
                 conditional_select_one(cs, bit, point.y))


# attach to StandardComposer
for _name, _fn in [
    ("add_witness_to_circuit_description", add_witness_to_circuit_description),
    ("logic_gate", logic_gate), ("xor_gate", xor_gate),
    ("and_gate", and_gate), ("conditional_select", conditional_select),
    ("conditional_select_zero", conditional_select_zero),
    ("conditional_select_one", conditional_select_one),
    ("point_addition_gate", point_addition_gate),
    ("fixed_base_scalar_mul", fixed_base_scalar_mul),
    ("variable_base_scalar_mul", variable_base_scalar_mul),
    ("conditional_point_select", conditional_point_select),
    ("conditional_select_identity", conditional_select_identity),
    ("scalar_decomposition", scalar_decomposition),
]:
    setattr(StandardComposer, _name, _fn)
