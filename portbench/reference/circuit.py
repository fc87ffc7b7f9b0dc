"""The Merkle membership circuit's structure, worked out by the reference:
gate order, selector values, wire variables and the copy-constraint
permutation of a height-h Poseidon Merkle tree.

Copied from the numpy half of `zprize_tpu_torch/merkle/layout.py`
(`GadgetTemplate`, `MerkleLayout.__init__`'s wire columns and
`MerkleLayout.sigma_flat`), on the frozen spec composer and Poseidon
gadget in `spec/`. The device witness half of that file is the program's
work and is not copied: the reference derives the public input (the
root) from the leaves with the spec's `hash2`.

Gate order: 4 prologue gates | 193 per gadget, bottom level first |
1 root gate (q_l = 1, q_o = -1, PI = -root) | zero padding to n."""

import numpy as np

from .spec.params import R_MOD
from .spec.circuit.composer import StandardComposer, SELECTOR_NAMES
from .spec.poseidon.constants import PoseidonConstants
from .spec.poseidon.gadget import assert_hash_constraints
from .spec.poseidon.ref import hash2

M = R_MOD
GADGET_GATES = 193
GADGET_VARS = 193
PROLOGUE_GATES = 4
PROLOGUE_VARS = 9

K_ZERO, K_LEFT, K_RIGHT, K_OUT, K_LOCAL = 0, 1, 2, 3, 4


def poseidon():
    return PoseidonConstants.generate(3)


def merkle_root(leaves, param=None):
    """The root of the tree over `leaves` (a power of two of them): each
    level hashes its pairs in order, as the circuit's gadgets do."""
    param = param or poseidon()
    level = [x % M for x in leaves]
    while len(level) > 1:
        level = [hash2(param, level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
    return level[0]


class GadgetTemplate:
    """Selectors and wire pattern of one 193-gate Poseidon gadget, and the
    composer's prologue, from one run of the spec composer."""

    def __init__(self):
        param = poseidon()
        cs = StandardComposer()
        left = cs.add_input(123)
        right = cs.add_input(456)
        out = cs.add_input(hash2(param, 123, 456))
        base_gate = cs.n
        base_var = len(cs.variables)
        assert_hash_constraints(cs, param, left, right, out)
        if cs.n - base_gate != GADGET_GATES or \
                len(cs.variables) - base_var != GADGET_VARS:
            raise ValueError("the Poseidon gadget is not 193 gates and vars")
        self.selectors = {
            name: [getattr(cs, name)[base_gate + i] % M
                   for i in range(GADGET_GATES)]
            for name in SELECTOR_NAMES}
        kinds = np.zeros((GADGET_GATES, 4), dtype=np.int64)
        offs = np.zeros((GADGET_GATES, 4), dtype=np.int64)
        for gi in range(GADGET_GATES):
            for slot, col in enumerate((cs.w_l, cs.w_r, cs.w_o, cs.w_4)):
                v = col[base_gate + gi]
                if v == cs.zero_var:
                    kinds[gi, slot] = K_ZERO
                elif v == left:
                    kinds[gi, slot] = K_LEFT
                elif v == right:
                    kinds[gi, slot] = K_RIGHT
                elif v == out:
                    kinds[gi, slot] = K_OUT
                else:
                    if v < base_var:
                        raise ValueError("unexpected foreign variable")
                    kinds[gi, slot] = K_LOCAL
                    offs[gi, slot] = v - base_var
        self.kinds, self.offs = kinds, offs
        pcs = StandardComposer()
        self.prologue_selectors = {
            name: [getattr(pcs, name)[i] % M for i in range(PROLOGUE_GATES)]
            for name in SELECTOR_NAMES}
        self.prologue_wires = np.array(
            [[pcs.w_l[i], pcs.w_r[i], pcs.w_o[i], pcs.w_4[i]]
             for i in range(PROLOGUE_GATES)], dtype=np.int64)


class MerkleCircuit:
    """The structure of the height-`height` circuit (no witness)."""

    def __init__(self, height, template=None):
        t = template or GadgetTemplate()
        self.template = t
        self.height = height
        self.m_leaves = 1 << (height - 1)
        self.m_nodes = self.m_leaves - 1
        g = self.n_gadgets = self.m_nodes
        self.n_real = PROLOGUE_GATES + GADGET_GATES * g + 1
        self.n = 1 << (self.n_real - 1).bit_length()
        self.n_vars = (PROLOGUE_VARS + self.m_leaves + self.m_nodes
                       + GADGET_VARS * g)
        self.gadget_start = PROLOGUE_GATES
        self.root_gate_pos = PROLOGUE_GATES + GADGET_GATES * g

        # gadget emission order: bottom internal level first, then upward;
        # node i's children are 2i + 1 and 2i + 2 (level order, root 0)
        level_starts, idx = [], 0
        for _ in range(height - 1):
            level_starts.append(idx)
            idx = 2 * idx + 1
        node_order, lefts, rights = [], [], []
        bottom = level_starts[-1]
        upper = 2 * bottom + 1
        for cur in range(bottom, upper):
            node_order.append(cur)
            lefts.append(("leaf", 2 * cur + 1 - upper))
            rights.append(("leaf", 2 * cur + 2 - upper))
        for start in reversed(level_starts[:-1]):
            for cur in range(start, 2 * start + 1):
                node_order.append(cur)
                lefts.append(("node", 2 * cur + 1))
                rights.append(("node", 2 * cur + 2))
        node_order = np.asarray(node_order, dtype=np.int64)
        leaf_base = PROLOGUE_VARS
        node_base = PROLOGUE_VARS + self.m_leaves
        local_base = node_base + self.m_nodes

        def var(ref):
            kind, i = ref
            return leaf_base + i if kind == "leaf" else node_base + i

        left_vars = np.asarray([var(r) for r in lefts], dtype=np.int64)
        right_vars = np.asarray([var(r) for r in rights], dtype=np.int64)
        out_vars = node_base + node_order
        kinds, offs = t.kinds[None], t.offs[None]
        bases = local_base + GADGET_VARS * np.arange(g, dtype=np.int64)
        wires_g = np.where(
            kinds == K_ZERO, 0,
            np.where(kinds == K_LEFT, left_vars[:, None, None],
                     np.where(kinds == K_RIGHT, right_vars[:, None, None],
                              np.where(kinds == K_OUT, out_vars[:, None, None],
                                       bases[:, None, None] + offs))))
        root_gate = np.asarray([[node_base, 0, 0, 0]], dtype=np.int64)
        pad = np.zeros((self.n - self.n_real, 4), dtype=np.int64)
        self.wire_index = np.concatenate(
            [t.prologue_wires, wires_g.reshape(g * GADGET_GATES, 4),
             root_gate, pad], axis=0)                          # (n, 4)

    def root_selectors(self):
        """The root gate's selector values: q_l * root + q_o * 0 + PI = 0
        with the arithmetic gate's default q_o = -1."""
        return {"q_l": 1, "q_arith": 1, "q_o": M - 1}

    def sigma_flat(self):
        """(4n,) copy-constraint permutation: flat position 4 * gate + slot
        (slots L, R, O, 4) maps to its cycle successor's flat position.
        Padding wires map to themselves."""
        n = self.n
        flat_vars = self.wire_index.reshape(-1)
        total = 4 * n
        pos = np.arange(total, dtype=np.int64)
        fake = np.where(pos < 4 * self.n_real, flat_vars,
                        self.n_vars + pos)
        order = np.argsort(fake, kind="stable")
        sv = fake[order]
        starts = np.r_[0, np.flatnonzero(sv[1:] != sv[:-1]) + 1]
        group_of = np.zeros(total, dtype=np.int64)
        group_of[starts] = 1
        group_of = np.cumsum(group_of) - 1
        nxt = np.arange(1, total + 1)
        ends = np.r_[starts[1:] - 1, total - 1]
        nxt[ends] = starts[group_of[ends]]
        sigma = np.empty(total, dtype=np.int64)
        sigma[order] = order[nxt]
        return sigma
