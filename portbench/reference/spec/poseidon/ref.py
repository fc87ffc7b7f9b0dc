"""Native (field-valued) Poseidon — clone of
`plonk-hashing/src/poseidon/poseidon_ref.rs` NativeSpecRef: un-optimized
round structure with raw round constants and dense MDS product."""

from ..params import R_MOD
from .constants import PoseidonConstants

M = R_MOD


def _sbox(x):
    return pow(x, 5, M)


def _product_mds(constants, state):
    m = constants.mds_matrices.m
    width = constants.width
    # result[j] = sum_i m[i][j] * state[i]  (poseidon_ref.rs product_mds)
    return [sum(m[i][j] * state[i] for i in range(width)) % M
            for j in range(width)]


def _full_round(constants, offset, state):
    keys = constants.round_constants
    state = [_sbox((s + keys[offset + i]) % M) for i, s in enumerate(state)]
    return _product_mds(constants, state), offset + constants.width


def _partial_round(constants, offset, state):
    keys = constants.round_constants
    state = [(s + keys[offset + i]) % M for i, s in enumerate(state)]
    state[0] = _sbox(state[0])
    return _product_mds(constants, state), offset + constants.width


def poseidon_output(constants: PoseidonConstants, inputs):
    """Run the permutation on [domain_tag, *inputs] and return elements[1]."""
    width = constants.width
    state = [constants.domain_tag] + [x % M for x in inputs]
    state += [0] * (width - len(state))
    offset = 0
    for _ in range(constants.half_full_rounds):
        state, offset = _full_round(constants, offset, state)
    for _ in range(constants.partial_rounds):
        state, offset = _partial_round(constants, offset, state)
    for _ in range(constants.half_full_rounds):
        state, offset = _full_round(constants, offset, state)
    return state[1]


def hash2(constants: PoseidonConstants, left: int, right: int) -> int:
    """Width-3 two-input hash (merkle-tree/src/lib.rs:25-39; the third
    `input` call in the reference overflows the buffer and is a no-op)."""
    assert constants.width == 3
    return poseidon_output(constants, [left, right])
