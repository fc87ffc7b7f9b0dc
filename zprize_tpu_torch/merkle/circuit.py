"""Merkle-tree circuit — clone of `merkle-tree/src/{constraints,circuit}.rs`:
one Poseidon gadget per internal node asserting parent = H(left, right), plus
a public-input gate binding the root."""

from ..params import R_MOD
from ..poseidon.gadget import assert_hash_constraints
from .tree import MerkleTree, left_child_index, right_child_index

M = R_MOD


def gen_constraints(tree: MerkleTree, cs, hash_param):
    """merkle-tree/src/constraints.rs:20-107."""
    leaf_vars = [cs.add_input(v) for v in tree.leaf_nodes]
    non_leaf_vars = [cs.add_input(v) for v in tree.non_leaf_nodes]
    root_var = non_leaf_vars[0]
    height = tree.height

    level_indices = []
    index = 0
    for _ in range(height - 1):
        level_indices.append(index)
        index = left_child_index(index)

    start_index = level_indices.pop()
    upper_bound = left_child_index(start_index)
    for cur in range(start_index, upper_bound):
        li = left_child_index(cur) - upper_bound
        ri = right_child_index(cur) - upper_bound
        assert_hash_constraints(cs, hash_param, leaf_vars[li], leaf_vars[ri],
                                non_leaf_vars[cur])

    for start_index in reversed(level_indices):
        upper_bound = left_child_index(start_index)
        for cur in range(start_index, upper_bound):
            assert_hash_constraints(
                cs, hash_param, non_leaf_vars[left_child_index(cur)],
                non_leaf_vars[right_child_index(cur)], non_leaf_vars[cur])

    # bind root to the public input: q_l*root + PI = 0 with PI = -root
    zero = cs.zero_var
    cs.arithmetic_gate(q_l=1, q_r=0, w_l=root_var, w_r=zero, w_o=zero,
                       pi=(-tree.root()) % M)


class MerkleTreeCircuit:
    """merkle-tree/src/circuit.rs MerkleTreeCircuit."""

    def __init__(self, param, tree: MerkleTree):
        self.param = param
        self.merkle_tree = tree

    def gadget(self, cs):
        gen_constraints(self.merkle_tree, cs, self.param)

    def padded_circuit_size(self):
        return 1 << (self.merkle_tree.height + 9)
