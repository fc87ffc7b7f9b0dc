"""Poseidon Merkle tree — clone of `merkle-tree/src/tree.rs` (level-order
array layout; root at index 0; node i's children at 2i+1, 2i+2)."""

from ..poseidon.constants import PoseidonConstants
from ..poseidon.ref import hash2


def left_child_index(i):
    return 2 * i + 1


def right_child_index(i):
    return 2 * i + 2


def parent_index(i):
    return None if i == 0 else (i - 1) // 2


def sibling_index(i):
    if i == 0:
        return None
    return i + 1 if i % 2 == 1 else i - 1


def is_left_child(i):
    return i % 2 == 1


def convert_index_to_last_level(index, height):
    return index + (1 << (height - 1)) - 1


class MerkleTree:
    def __init__(self, param: PoseidonConstants, leaf_nodes, height):
        """new_with_leaf_nodes (tree.rs:64-139)."""
        assert len(leaf_nodes) == 1 << (height - 1), "incorrect leaf size"
        self.height = height
        self.param = param
        self.leaf_nodes = list(leaf_nodes)
        n_internal = (1 << (height - 1)) - 1
        non_leaf = [0] * n_internal

        level_indices = []
        index = 0
        for _ in range(height - 1):
            level_indices.append(index)
            index = left_child_index(index)

        # bottom internal level hashes the leaves
        start_index = level_indices.pop()
        upper_bound = left_child_index(start_index)
        for cur in range(start_index, upper_bound):
            li = left_child_index(cur) - upper_bound
            ri = right_child_index(cur) - upper_bound
            non_leaf[cur] = hash2(param, leaf_nodes[li], leaf_nodes[ri])

        for start_index in reversed(level_indices):
            upper_bound = left_child_index(start_index)
            for cur in range(start_index, upper_bound):
                non_leaf[cur] = hash2(param, non_leaf[left_child_index(cur)],
                                      non_leaf[right_child_index(cur)])
        self.non_leaf_nodes = non_leaf

    def root(self):
        return self.non_leaf_nodes[0]

    def gen_proof(self, index):
        """Membership path (tree.rs:146-181)."""
        leaf_index_in_tree = convert_index_to_last_level(index, self.height)
        nodes = []
        if index % 2 == 0:
            nodes.append((self.leaf_nodes[index], self.leaf_nodes[index + 1]))
        else:
            nodes.append((self.leaf_nodes[index - 1], self.leaf_nodes[index]))
        current = parent_index(leaf_index_in_tree)
        while current != 0:
            sib = sibling_index(current)
            if is_left_child(current):
                nodes.append((self.non_leaf_nodes[current],
                              self.non_leaf_nodes[sib]))
            else:
                nodes.append((self.non_leaf_nodes[sib],
                              self.non_leaf_nodes[current]))
            current = parent_index(current)
        nodes.reverse()
        return Path(index, nodes, self.height)


class Path:
    """Membership proof (merkle-tree/src/path.rs)."""

    def __init__(self, index, nodes, height):
        self.index = index
        self.nodes = nodes
        self.height = height

    def verify(self, param, root):
        # each level's pair must hash to a member of the level above
        for i in range(len(self.nodes) - 1):
            left, right = self.nodes[i + 1]
            h = hash2(param, left, right)
            if h not in self.nodes[i]:
                return False
        top = hash2(param, *self.nodes[0])
        return top == root
