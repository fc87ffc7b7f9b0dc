from .tree import MerkleTree
