"""StandardComposer — PLONK circuit builder.

Behavioral clone of ZK-Garage's composer as used by the reference
(`plonk-core/src/constraint_system/composer.rs`): 15 selector columns, 4 wire
columns, reserved zero variable, blinding rows, sparse public inputs, and the
same gate-emission order (so sigma permutations and selector polynomials are
identical given the same gadget calls).

Variables are integer indices into `self.variables` (list of Fr ints).

In addition to the per-gate API, `append_gates_batch` appends whole columns at
once — the hook used by the vectorized Poseidon/Merkle gadget so witness
synthesis is array-shaped instead of per-gate Python (the reference's gadget
costs 9.3 s on a 64-core CPU; see SURVEY.md §3.1).
"""

import random

from ..params import R_MOD

WIRE_LEFT = 0
WIRE_RIGHT = 1
WIRE_OUT = 2
WIRE_FOURTH = 3

SELECTOR_NAMES = [
    "q_m", "q_l", "q_r", "q_o", "q_4", "q_c", "q_hl", "q_hr", "q_h4",
    "q_arith", "q_range", "q_logic", "q_lookup", "q_fixed_group_add",
    "q_variable_group_add",
]


class LookupTable:
    """4-column public lookup table (`plonk-core/src/lookup/lookup_table.rs`)."""

    def __init__(self):
        self.rows = []  # list of 4-tuples of Fr ints

    def size(self):
        return len(self.rows)

    def insert_row(self, a, b, c, d):
        self.rows.append((a % R_MOD, b % R_MOD, c % R_MOD, d % R_MOD))

    def insert_xor_row(self, a: int, b: int, upper_bound: int):
        self.insert_row(a, b, a ^ b, 0)

    def insert_and_row(self, a: int, b: int, upper_bound: int):
        self.insert_row(a, b, a & b, 0)

    def insert_add_row(self, a: int, b: int, upper_bound: int):
        self.insert_row(a, b, (a + b) % upper_bound, 0)

    def insert_mul_row(self, a: int, b: int, upper_bound: int):
        self.insert_row(a, b, (a * b) % upper_bound, 0)

    def insert_multiple_xor(self, lower, upper):
        for a in range(lower, upper):
            for b in range(lower, upper):
                self.insert_xor_row(a, b, upper)

    def columns(self):
        """Return the 4 columns as lists (vec_to_multiset)."""
        if not self.rows:
            return [[], [], [], []]
        return [list(col) for col in zip(*self.rows)]


class StandardComposer:
    def __init__(self, seed=0):
        self.n = 0
        for name in SELECTOR_NAMES:
            setattr(self, name, [])
        self.w_l = []
        self.w_r = []
        self.w_o = []
        self.w_4 = []
        self.variables = []  # index -> value
        # var -> ordered list of (wire_type, gate_index); insertion order
        # defines each variable's copy cycle (permutation/mod.rs:70-97)
        self.var_map = {}
        self.public_inputs = {}  # pos -> value (sparse, non-zero only)
        self.intended_pi_pos = []
        self.lookup_table = LookupTable()

        # Reserve variable 0 == zero and constrain it (composer.rs:241-243)
        self.zero_var = self.add_input(0)
        self.constrain_to_constant(self.zero_var, 0)

        # Blinding rows (composer.rs:604-685). Deterministic seed by default
        # so proofs are reproducible; the reference uses OsRng but hiding is
        # disabled throughout (SURVEY.md §5 note 3), so this only randomizes
        # wire padding rows.
        rng = random.Random(seed)
        self._add_blinding_factors(rng)

    # ------------------------------------------------------------------
    # variables & PI
    # ------------------------------------------------------------------
    def add_input(self, value: int) -> int:
        idx = len(self.variables)
        self.variables.append(value % R_MOD)
        self.var_map[idx] = []
        return idx

    def _map_wire(self, var, wire_type, gate_index):
        self.var_map[var].append((wire_type, gate_index))

    def value_of_var(self, var: int) -> int:
        return self.variables[var]

    def add_pi(self, pos: int, value: int):
        if pos in self.public_inputs:
            raise ValueError(f"PI position {pos} already occupied")
        v = value % R_MOD
        if v != 0:
            self.public_inputs[pos] = v
        self.intended_pi_pos.append(pos)

    def total_size(self):
        return max(self.n, self.lookup_table.size())

    def circuit_bound(self):
        return 1 << (self.total_size() - 1).bit_length() if self.total_size() > 1 else 1

    # ------------------------------------------------------------------
    # low-level gate append
    # ------------------------------------------------------------------
    def _append_gate(self, wl, wr, wo, w4, **selectors):
        self.w_l.append(wl)
        self.w_r.append(wr)
        self.w_o.append(wo)
        self.w_4.append(w4)
        for name in SELECTOR_NAMES:
            getattr(self, name).append(selectors.get(name, 0) % R_MOD)
        g = self.n
        self._map_wire(wl, WIRE_LEFT, g)
        self._map_wire(wr, WIRE_RIGHT, g)
        self._map_wire(wo, WIRE_OUT, g)
        self._map_wire(w4, WIRE_FOURTH, g)
        self.n += 1

    def append_gates_batch(self, wl, wr, wo, w4, selectors):
        """Append many gates at once (lists per column). `selectors` maps
        selector name -> list; omitted selectors are zero. Wire->permutation
        mapping follows the same (L,R,O,4) per-gate order as `_append_gate`."""
        m = len(wl)
        assert len(wr) == len(wo) == len(w4) == m
        self.w_l.extend(wl)
        self.w_r.extend(wr)
        self.w_o.extend(wo)
        self.w_4.extend(w4)
        zeros = None
        for name in SELECTOR_NAMES:
            col = selectors.get(name)
            if col is None:
                if zeros is None:
                    zeros = [0] * m
                getattr(self, name).extend(zeros)
            else:
                assert len(col) == m
                getattr(self, name).extend(col)
        vm = self.var_map
        g0 = self.n
        for k in range(m):
            g = g0 + k
            vm[wl[k]].append((WIRE_LEFT, g))
            vm[wr[k]].append((WIRE_RIGHT, g))
            vm[wo[k]].append((WIRE_OUT, g))
            vm[w4[k]].append((WIRE_FOURTH, g))
        self.n += m

    # ------------------------------------------------------------------
    # gate library (subset matching the reference's usage + generic gates)
    # ------------------------------------------------------------------
    def poly_gate(self, a, b, c, q_m, q_l, q_r, q_o, q_c, pi=None):
        """(a*b)q_m + a q_l + b q_r + q_c + PI + c q_o = 0
        (composer.rs:280-330)."""
        if pi is not None:
            self.add_pi(self.n, pi)
        self._append_gate(a, b, c, self.zero_var,
                          q_m=q_m, q_l=q_l, q_r=q_r, q_o=q_o, q_c=q_c,
                          q_arith=1)
        return (a, b, c)

    def constrain_to_constant(self, a, constant, pi=None):
        self.poly_gate(a, a, a, 0, 1, 0, 0, -constant % R_MOD, pi)

    def assert_equal(self, a, b):
        self.poly_gate(a, b, self.zero_var, 0, 1, R_MOD - 1, 0, 0)

    def arithmetic_gate(self, q_m=0, q_l=0, q_r=0, q_o=None, q_c=0, q_4=0,
                        w_l=None, w_r=None, w_o=None, w_4=None, pi=None):
        """General fan-in-3 arithmetic gate (constraint_system/arithmetic.rs).
        If w_o is None it is computed so the gate is satisfied."""
        q_o = -1 % R_MOD if q_o is None else q_o % R_MOD
        w_4 = self.zero_var if w_4 is None else w_4
        assert w_l is not None and w_r is not None
        if w_o is None:
            # w_o = -(rest)/q_o
            rest = (q_m * self.variables[w_l] * self.variables[w_r]
                    + q_l * self.variables[w_l]
                    + q_r * self.variables[w_r]
                    + q_c + q_4 * self.variables[w_4]
                    + (pi or 0)) % R_MOD
            w_o_val = rest * (-pow(q_o, -1, R_MOD)) % R_MOD
            w_o = self.add_input(w_o_val)
        if pi is not None:
            self.add_pi(self.n, pi)
        self._append_gate(w_l, w_r, w_o, w_4,
                          q_m=q_m, q_l=q_l, q_r=q_r, q_o=q_o, q_c=q_c,
                          q_4=q_4, q_arith=1)
        return w_o

    def add(self, a, b):
        return self.arithmetic_gate(q_l=1, q_r=1, w_l=a, w_r=b)

    def mul(self, a, b):
        return self.arithmetic_gate(q_m=1, w_l=a, w_r=b)

    def boolean_gate(self, a):
        """Constrain a*a = a (constraint_system/boolean.rs)."""
        self._append_gate(a, a, a, self.zero_var,
                          q_m=1, q_o=R_MOD - 1, q_arith=1)
        return a

    def full_affine_transform_gate(self, vars3, selectors5):
        """Poseidon full-round gate: q1 w1^5 + q2 w2^5 + q3 w3^5 + qc + qo w4
        = 0, wires (w1,w2,w4out,w3) (constraint_system/hash.rs:21-65)."""
        q1, q2, q3, qc, qo = [s % R_MOD for s in selectors5]
        v = [self.variables[x] for x in vars3]
        w4_val = ((q1 * pow(v[0], 5, R_MOD) + q2 * pow(v[1], 5, R_MOD)
                   + q3 * pow(v[2], 5, R_MOD) + qc)
                  * (-pow(qo, -1, R_MOD))) % R_MOD
        w4_var = self.add_input(w4_val)
        self._append_gate(vars3[0], vars3[1], w4_var, vars3[2],
                          q_hl=q1, q_hr=q2, q_h4=q3, q_c=qc, q_o=qo,
                          q_arith=1)
        return w4_var

    def partial_affine_transform_gate(self, vars3, selectors5):
        """Poseidon partial-round gate: q1 w1^5 + q2 w2 + q3 w3 + qc + qo w4
        = 0 (constraint_system/hash.rs:67-118)."""
        q1, q2, q3, qc, qo = [s % R_MOD for s in selectors5]
        v = [self.variables[x] for x in vars3]
        w4_val = ((q1 * pow(v[0], 5, R_MOD) + q2 * v[1] + q3 * v[2] + qc)
                  * (-pow(qo, -1, R_MOD))) % R_MOD
        w4_var = self.add_input(w4_val)
        self._append_gate(vars3[0], vars3[1], w4_var, vars3[2],
                          q_hl=q1, q_r=q2, q_4=q3, q_c=qc, q_o=qo,
                          q_arith=1)
        return w4_var

    def range_gate(self, var, num_bits):
        """Range constraint via 2-bit quad accumulators — exact clone of
        `constraint_system/range.rs:27-202` (same gate count, wire layout,
        and padding rules)."""
        assert num_bits % 2 == 0 and num_bits > 0
        value = self.variables[var]
        num_gates = num_bits >> 3
        if num_bits % 8 != 0:
            num_gates += 1
        num_quads = num_gates * 4
        pad = 1 + (((num_quads << 1) - num_bits) >> 1)
        used_gates = num_gates + 1

        # wires are appended in slots (w4, wo, wr, wl) cycling per gate
        cols = {0: (self.w_4, WIRE_FOURTH), 1: (self.w_o, WIRE_OUT),
                2: (self.w_r, WIRE_RIGHT), 3: (self.w_l, WIRE_LEFT)}
        base_gate = self.n

        def add_wire(i, variable):
            col, wt = cols[i % 4]
            col.append(variable)
            self._map_wire(variable, wt, base_gate + i // 4)

        for i in range(pad):
            add_wire(i, self.zero_var)

        accumulators = []
        acc = 0
        bits = [(value >> k) & 1 for k in range(num_bits)] + [0] * (2 * num_quads)
        for i in range(pad, num_quads + 1):
            bit_index = (num_quads - i) << 1
            quad = bits[bit_index] + 2 * bits[bit_index + 1]
            acc = (4 * acc + quad) % R_MOD
            acc_var = self.add_input(acc)
            accumulators.append(acc_var)
            add_wire(i, acc_var)

        for name in SELECTOR_NAMES:
            if name == "q_range":
                getattr(self, name).extend([1] * (used_gates - 1) + [0])
            else:
                getattr(self, name).extend([0] * used_gates)
        self.n += used_gates

        # last gate holds only the final accumulator in w4
        self.w_l.append(self.zero_var)
        self.w_r.append(self.zero_var)
        self.w_o.append(self.zero_var)

        self.assert_equal(accumulators[-1], var)
        return accumulators[-1]

    def lookup_gate(self, a, b, c, d=None, pi=None):
        """Plookup gate: (a,b,c,d) must be a row of the lookup table
        (constraint_system/lookup.rs)."""
        d = self.zero_var if d is None else d
        if pi is not None:
            self.add_pi(self.n, pi)
        self._append_gate(a, b, c, d, q_lookup=1)
        return c

    # ------------------------------------------------------------------
    # blinding rows (composer.rs:604-685)
    # ------------------------------------------------------------------
    def _add_blinding_factors(self, rng):
        rv1 = rv2 = self.zero_var
        for _ in range(2):
            rv1 = self.add_input(rng.randrange(R_MOD))
            rv2 = self.add_input(rng.randrange(R_MOD))
            rv3 = self.add_input(rng.randrange(R_MOD))
            rv4 = self.add_input(rng.randrange(R_MOD))
            self._append_gate(rv1, rv2, rv3, rv4)
        self._append_gate(rv1, rv2, self.zero_var, self.zero_var)

    # ------------------------------------------------------------------
    # padding (proof_system/preprocess.rs:64-98)
    # ------------------------------------------------------------------
    def pad_to(self, size: int):
        diff = size - self.n
        assert diff >= 0
        if diff == 0:
            return
        for name in SELECTOR_NAMES:
            getattr(self, name).extend([0] * diff)
        self.w_l.extend([self.zero_var] * diff)
        self.w_r.extend([self.zero_var] * diff)
        self.w_o.extend([self.zero_var] * diff)
        self.w_4.extend([self.zero_var] * diff)
        self.n += diff
