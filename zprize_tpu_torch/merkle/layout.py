"""Vectorized Merkle-tree circuit layout + device witness synthesis — the
port of `zprize_tpu/merkle/layout.py`.

The circuit STRUCTURE (selectors, wire indices, copy-constraint sigmas) is
built once by tiling a 193-gate Poseidon-gadget template; the per-proof
WITNESS is computed on the device with batched Poseidon round loops + one
gather. Gate order, variable numbering and selector values match the
`StandardComposer` + `gen_constraints` path, so sigmas and proofs are
identical.

Variable numbering:
  [0..9)                          composer prologue (zero var + blinding)
  [9 .. 9+m)                      leaf vars (m = 2^(h-1))
  [9+m .. 9+2m-1)                 internal node vars (level order, root first)
  then per gadget g (in emission order): 193 locals
      [tag, s0(3), s1(3), ..., s63(3)]
Gate order:
  4 prologue gates | 193 * (m-1) gadget gates | 1 root PI gate | padding
"""

import numpy as np
import torch

from ..params import R_MOD, K1, K2, K3
from ..device import resolve
from ..circuit.composer import StandardComposer, SELECTOR_NAMES
from ..poseidon.constants import PoseidonConstants
from ..poseidon.gadget import assert_hash_constraints
from ..poseidon import vectorized as pvec
from ..fields import mont
from ..fields.mont import FR
from ..ops import ntt as tntt
from ..ops import poly as tpoly
from .tree import left_child_index, right_child_index

M = R_MOD

GADGET_GATES = 193
GADGET_VARS = 193
PROLOGUE_GATES = 4
PROLOGUE_VARS = 9

# wire-pattern kinds
K_ZERO, K_LEFT, K_RIGHT, K_OUT, K_LOCAL = 0, 1, 2, 3, 4


class GadgetTemplate:
    """Extracted from one scratch-composer gadget run."""

    def __init__(self):
        param = PoseidonConstants.generate(3)
        cs = StandardComposer()
        left = cs.add_input(123)
        right = cs.add_input(456)
        from ..poseidon.ref import hash2
        out = cs.add_input(hash2(param, 123, 456))
        base_gate = cs.n
        base_var = len(cs.variables)
        assert_hash_constraints(cs, param, left, right, out)
        assert cs.n - base_gate == GADGET_GATES
        assert len(cs.variables) - base_var == GADGET_VARS

        # selector template (as ints)
        self.selectors = {
            name: [getattr(cs, name)[base_gate + i] % M
                   for i in range(GADGET_GATES)]
            for name in SELECTOR_NAMES
        }
        # wire patterns
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
                    assert v >= base_var, "unexpected foreign variable"
                    kinds[gi, slot] = K_LOCAL
                    offs[gi, slot] = v - base_var
        self.kinds = kinds
        self.offs = offs
        # prologue (from a fresh composer with the same deterministic seed)
        pcs = StandardComposer()
        self.prologue_selectors = {
            name: [getattr(pcs, name)[i] % M for i in range(PROLOGUE_GATES)]
            for name in SELECTOR_NAMES
        }
        self.prologue_wires = np.array(
            [[pcs.w_l[i], pcs.w_r[i], pcs.w_o[i], pcs.w_4[i]]
             for i in range(PROLOGUE_GATES)], dtype=np.int64)
        self.prologue_values = [pcs.variables[i] for i in range(PROLOGUE_VARS)]


_TEMPLATE = None


def get_template() -> GadgetTemplate:
    global _TEMPLATE
    if _TEMPLATE is None:
        _TEMPLATE = GadgetTemplate()
    return _TEMPLATE


class MerkleLayout:
    """Circuit structure for a height-h Poseidon Merkle tree. Selector
    columns and sigma evals live on `device` (CUDA unless "cpu")."""

    def __init__(self, height: int, device=None):
        self.device = dev = resolve(device)
        self.height = height
        self.m_leaves = 1 << (height - 1)
        self.m_nodes = self.m_leaves - 1          # internal nodes
        self.n_gadgets = self.m_nodes
        self.n_real = PROLOGUE_GATES + GADGET_GATES * self.n_gadgets + 1
        self.n = 1 << (self.n_real - 1).bit_length()
        self.n_vars = (PROLOGUE_VARS + self.m_leaves + self.m_nodes
                       + GADGET_VARS * self.n_gadgets)
        t = get_template()

        # ---- gadget emission order and input/output node vars ----
        # gen_constraints: bottom internal level first, then upward
        level_starts = []
        idx = 0
        for _ in range(height - 1):
            level_starts.append(idx)
            idx = left_child_index(idx)
        node_order = []      # node index per gadget, in emission order
        lefts, rights = [], []
        bottom = level_starts[-1]
        upper = left_child_index(bottom)
        for cur in range(bottom, upper):
            node_order.append(cur)
            lefts.append(("leaf", left_child_index(cur) - upper))
            rights.append(("leaf", right_child_index(cur) - upper))
        for start in reversed(level_starts[:-1]):
            upper2 = left_child_index(start)
            for cur in range(start, upper2):
                node_order.append(cur)
                lefts.append(("node", left_child_index(cur)))
                rights.append(("node", right_child_index(cur)))
        self.node_order = np.asarray(node_order, dtype=np.int64)

        leaf_base = PROLOGUE_VARS
        node_base = PROLOGUE_VARS + self.m_leaves
        local_base = node_base + self.m_nodes

        def _var(ref):
            kind, i = ref
            return leaf_base + i if kind == "leaf" else node_base + i

        left_vars = np.asarray([_var(r) for r in lefts], dtype=np.int64)
        right_vars = np.asarray([_var(r) for r in rights], dtype=np.int64)
        out_vars = node_base + self.node_order

        # ---- wire index columns (4, n) ----
        g = self.n_gadgets
        kinds = t.kinds[None]                      # (1, 193, 4)
        offs = t.offs[None]
        gadget_bases = (local_base
                        + GADGET_VARS * np.arange(g, dtype=np.int64))
        wires_g = np.where(
            kinds == K_ZERO, 0,
            np.where(kinds == K_LEFT, left_vars[:, None, None],
                     np.where(kinds == K_RIGHT, right_vars[:, None, None],
                              np.where(kinds == K_OUT, out_vars[:, None, None],
                                       gadget_bases[:, None, None] + offs))))
        wires_g = wires_g.reshape(g * GADGET_GATES, 4)
        root_gate = np.asarray([[node_base, 0, 0, 0]], dtype=np.int64)
        pad_rows = np.zeros((self.n - self.n_real, 4), dtype=np.int64)
        self.wire_index = np.concatenate(
            [t.prologue_wires, wires_g, root_gate, pad_rows], axis=0)  # (n,4)
        self.root_gate_pos = PROLOGUE_GATES + GADGET_GATES * g

        self._selector_limbs = self._tile_selectors()

    @property
    def selector_limbs(self):
        """{selector name: (L, n) Montgomery limb tensor} on the device
        (15 x (L, 2^22) int32 is 4 GiB at height 15). `preprocess_layout`
        releases them once the key holds their polynomials; a later read
        tiles them again."""
        if self._selector_limbs is None:
            self._selector_limbs = self._tile_selectors()
        return self._selector_limbs

    def release_selector_limbs(self):
        """Drop the tiled selector columns (see `selector_limbs`)."""
        self._selector_limbs = None

    def _tile_selectors(self):
        """The selector columns, tiled from the gadget template."""
        t = get_template()
        dev = self.device
        out = {}
        for name in SELECTOR_NAMES:
            tmpl = torch.from_numpy(FR.to_mont_host(t.selectors[name]).astype(
                np.int32)).to(dev)                                 # (L, 193)
            pro = torch.from_numpy(FR.to_mont_host(
                t.prologue_selectors[name]).astype(np.int32)).to(dev)
            # root gate: q_l*root + q_o*zero + PI = 0 with q_o = -1 (the
            # arithmetic_gate default out selector)
            if name in ("q_l", "q_arith"):
                root_val = 1
            elif name == "q_o":
                root_val = M - 1
            else:
                root_val = 0
            root_sel = FR.tensor([root_val], dev)
            padz = torch.zeros((FR.L, self.n - self.n_real), dtype=torch.int32,
                               device=dev)
            out[name] = torch.cat(
                [pro, tmpl.repeat(1, self.n_gadgets), root_sel, padz], dim=1)
        return out

    # ------------------------------------------------------------------
    # sigma permutation (vectorized; matches composer cycle semantics)
    # ------------------------------------------------------------------
    def sigma_flat(self):
        """Returns (4n,) flat sigma: position p = 4*gate + slot maps to its
        cycle successor's flat position. Padding gates (beyond n_real) keep
        identity (not part of any cycle), matching `pad` semantics."""
        n = self.n
        flat_vars = self.wire_index.reshape(-1)          # (4n,) order L,R,O,4
        total = 4 * n
        pos = np.arange(total, dtype=np.int64)
        real_mask = pos < 4 * self.n_real
        # padding wires map to themselves: give them unique fake var ids
        fake = np.where(real_mask, flat_vars,
                        self.n_vars + np.arange(total, dtype=np.int64))
        order = np.argsort(fake, kind="stable")
        sv = fake[order]
        starts = np.r_[0, np.flatnonzero(sv[1:] != sv[:-1]) + 1]
        group_of = np.zeros(total, dtype=np.int64)
        group_of[starts] = 1
        group_of = np.cumsum(group_of) - 1
        nxt_in_sorted = np.arange(1, total + 1)
        ends = np.r_[starts[1:] - 1, total - 1]
        nxt_in_sorted[ends] = starts[group_of[ends]]
        sigma = np.empty(total, dtype=np.int64)
        sigma[order] = order[nxt_in_sorted]
        return sigma

    def sigma_evals_device(self):
        """4 device tensors (L, n): K_{slot(target)} * omega^{gate(target)}."""
        dev = self.device
        plan = tntt.get_plan(self.n.bit_length() - 1, dev)
        sigma = torch.from_numpy(self.sigma_flat().reshape(self.n, 4)).to(dev)
        roots = tpoly.powers(FR, FR.scalar(plan.omega, dev), self.n)
        ks = FR.tensor([1, K1, K2, K3], dev)                      # (L, 4)
        out = []
        for slot in range(4):
            tgt = sigma[:, slot]
            vals = mont.mont_mul(FR, roots.index_select(1, tgt // 4),
                                 ks.index_select(1, tgt % 4))
            out.append(vals)
        return out

    # ------------------------------------------------------------------
    # per-proof witness (device)
    # ------------------------------------------------------------------
    def witness(self, leaf_values_mont):
        """leaf_values_mont: (L, m_leaves) Montgomery tensor on the
        layout's device. Returns (wire value columns [4 x (L, n)], root
        value (host int), node values (L, m_nodes))."""
        t = get_template()
        dev = leaf_values_mont.device
        level_inputs = leaf_values_mont
        node_vals_levels = []    # bottom-up: list of (L, m_level)
        locals_blocks = []       # in gadget-emission order (bottom first)
        tag = FR.scalar(PoseidonConstants.generate(3).domain_tag, dev)
        while level_inputs.shape[1] > 1:
            left = level_inputs[:, 0::2].contiguous()
            right = level_inputs[:, 1::2].contiguous()
            b = left.shape[1]
            states = pvec.poseidon_states(left, right)     # (64, L, b, 3)
            outs = states[-1][..., 1]                      # (L, b)
            # locals: [tag, s0(3), ..., s63(3)] per gadget
            tags = tag[:, None, None].expand(FR.L, b, 1)
            st = states.permute(1, 2, 0, 3).reshape(FR.L, b, 192)
            locals_blocks.append(torch.cat([tags, st], dim=2).reshape(
                FR.L, -1))
            node_vals_levels.append(outs)
            level_inputs = outs
            del states, st

        node_vals = torch.cat(list(reversed(node_vals_levels)), dim=1)
        prologue = FR.tensor(t.prologue_values, dev)
        flat = torch.cat([prologue, leaf_values_mont, node_vals]
                         + locals_blocks, dim=1)
        assert flat.shape[1] == self.n_vars
        widx = torch.from_numpy(self.wire_index).to(dev)
        wires = [flat.index_select(1, widx[:, s]) for s in range(4)]
        root_val = FR.from_mont_host(node_vals[:, :1])[0]
        return wires, root_val, node_vals
