"""PoseidonConstants — clone of
`plonk-hashing/src/poseidon/constants.rs::generate` for arbitrary WIDTH.
(The ZPrize path uses WIDTH=3 raw round constants + dense MDS; the
compressed/sparse optimization artifacts are generated for parity.)"""

from dataclasses import dataclass, field
from typing import List

from ..params import R_MOD
from .round_numbers import calc_round_numbers
from .grain import generate_constants
from .mds import new_mds, factor_to_sparse_matrixes, MdsMatrices, SparseMatrix
from . import matrix as mx

M = R_MOD


@dataclass
class PoseidonConstants:
    mds_matrices: MdsMatrices
    round_constants: List[int]
    compressed_round_constants: List[int]
    pre_sparse_matrix: list
    sparse_matrixes: List[SparseMatrix]
    domain_tag: int
    full_rounds: int
    half_full_rounds: int
    partial_rounds: int
    width: int

    _CACHE = {}

    @classmethod
    def generate(cls, width):
        if width in cls._CACHE:
            return cls._CACHE[width]
        arity = width - 1
        mds = new_mds(width)
        rf, rp = calc_round_numbers(width, True)
        assert rf % 2 == 0
        round_constants = generate_constants(1, 1, 255, width, rf, rp)
        domain_tag = (1 << arity) - 1
        compressed = compress_round_constants(width, rf, rp, round_constants,
                                              mds)
        pre_sparse, sparse = factor_to_sparse_matrixes(mds.m, rp)
        out = cls(mds_matrices=mds, round_constants=round_constants,
                  compressed_round_constants=compressed,
                  pre_sparse_matrix=pre_sparse, sparse_matrixes=sparse,
                  domain_tag=domain_tag, full_rounds=rf,
                  half_full_rounds=rf // 2, partial_rounds=rp, width=width)
        cls._CACHE[width] = out
        return out


def compress_round_constants(width, rf, rp, round_constants, mds):
    """Clone of `plonk-hashing/src/poseidon/preprocessing.rs`
    compress_round_constants: fold partial-round constants through the
    inverse MDS so only one constant per partial round is needed."""
    inv = mds.m_inv
    half = rf // 2

    def round_keys(r):
        return round_constants[r * width:(r + 1) * width]

    def right_apply(m, v):
        return mx.mul_row_vec_at_left(m, v)

    res = list(round_keys(0))
    for i in range(half - 1):
        res.extend(right_apply(inv, round_keys(i + 1)))

    partial_keys = []
    final_round = half + rp
    acc = list(round_keys(final_round))
    for i in range(rp):
        inverted = right_apply(inv, acc)
        partial_keys.append(inverted[0])
        inverted[0] = 0
        prev = round_keys(final_round - i - 1)
        acc = [(a + b) % M for a, b in zip(prev, inverted)]

    res.extend(right_apply(inv, acc))
    while partial_keys:
        res.append(partial_keys.pop())

    for i in range(1, half):
        res.extend(right_apply(inv, round_keys(i + half + rp)))
    return res
