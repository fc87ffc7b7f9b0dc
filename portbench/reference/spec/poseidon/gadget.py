"""Poseidon circuit gadget — clone of the ZPrize constraint path
(`plonk-hashing/src/poseidon/zprize_constraints.rs` PlonkSpecZZ/PoseidonZZRef):
one affine-transform gate per state element per round, with round keys fused
into the gate constants (keys of round r+1 appear in round r's gates)."""

from ..params import R_MOD
from .constants import PoseidonConstants

M = R_MOD
NEG_ONE = M - 1


def gadget_full_round(cs, constants, offset, state_vars):
    keys = constants.round_constants
    width = constants.width
    mat = constants.mds_matrices.m
    res = list(state_vars)
    if offset == 0:
        # first round: pre-add keys [0..width) via addi gates
        res = [cs.arithmetic_gate(q_l=1, q_r=0, w_l=v, w_r=cs.zero_var,
                                  q_c=keys[i])
               for i, v in enumerate(res)]
    remaining = len(keys) - offset
    if remaining == width:
        next_keys = [0] * width
    else:
        next_keys = keys[offset + width:offset + 2 * width]
    out = []
    for i in range(width):
        out.append(cs.full_affine_transform_gate(
            res, [mat[i][0], mat[i][1], mat[i][2], next_keys[i], NEG_ONE]))
    return out, offset + width


def gadget_partial_round(cs, constants, offset, state_vars):
    keys = constants.round_constants
    width = constants.width
    mat = constants.mds_matrices.m
    res = list(state_vars)
    next_keys = keys[offset + width:offset + 2 * width]
    out = []
    for i in range(width):
        out.append(cs.partial_affine_transform_gate(
            res, [mat[i][0], mat[i][1], mat[i][2], next_keys[i], NEG_ONE]))
    return out, offset + width


def poseidon_gadget(cs, constants: PoseidonConstants, input_vars):
    """Emit gates computing the Poseidon output of [tag, *inputs]; returns the
    output variable (state element 1)."""
    width = constants.width
    assert len(input_vars) <= width - 1
    tag_var = cs.add_input(constants.domain_tag)
    state = [tag_var] + list(input_vars)
    state += [cs.zero_var] * (width - len(state))
    offset = 0
    for _ in range(constants.half_full_rounds):
        state, offset = gadget_full_round(cs, constants, offset, state)
    for _ in range(constants.partial_rounds):
        state, offset = gadget_partial_round(cs, constants, offset, state)
    for _ in range(constants.half_full_rounds):
        state, offset = gadget_full_round(cs, constants, offset, state)
    return state[1]


def assert_hash_constraints(cs, constants, left_var, right_var, output_var):
    """merkle-tree/src/lib.rs:41-59."""
    out = poseidon_gadget(cs, constants, [left_var, right_var])
    cs.assert_equal(output_var, out)
