"""The inputs of the toy general circuit, a system that only the tests
add: witness k is a pair (a, b) of 2-bit values from the stream
(seed, 0, k), and `build` lays out its circuit."""

from .. import inputs

LABEL = b"circuit toy"


def values(seed, witnesses):
    """Each witness's (a, b)."""
    return [tuple(int(x) for x in inputs.rng(seed, 0, k).integers(0, 4, 2))
            for k in range(witnesses)]


def build(cs, a, b):
    """The circuit of witness (a, b) on the composer `cs` (the port's, or
    the reference's copy of the spec's: they have the same gates): c = a
    xor b by a lookup in the 2-bit XOR table, a below 4 by a range gate,
    and a + b and c public. Its layout does not depend on a and b."""
    r = inputs.R_MOD
    cs.lookup_table.insert_multiple_xor(0, 4)
    va, vb, vc = cs.add_input(a), cs.add_input(b), cs.add_input(a ^ b)
    cs.lookup_gate(va, vb, vc)
    cs.range_gate(va, 2)
    cs.arithmetic_gate(q_l=1, q_r=1, w_l=va, w_r=vb, q_o=0,
                       w_o=cs.zero_var, pi=-(a + b) % r)
    cs.arithmetic_gate(q_l=1, w_l=vc, w_r=cs.zero_var, q_o=0,
                       w_o=cs.zero_var, pi=-(a ^ b) % r)
    return cs
