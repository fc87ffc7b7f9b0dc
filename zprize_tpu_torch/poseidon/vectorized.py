"""Batched Poseidon on the device — the port of
`zprize_tpu/poseidon/vectorized.py`: for m hash gadgets at once, every
intermediate round state over limbs-leading (L, m) tensors.

    s_0 = [tag + k0, left + k1, right + k2]
    s_{r+1} = M . sbox_r(s_r) + k_{r+1}   (k beyond the last round = 0)

Gadget locals per hash = [tag, s_0 (3), ..., s_63 (3)]; the hash is
s_63[1] (`hash2_batch`). The 63 rounds run as a Python loop of whole-batch
field ops.
"""

from functools import lru_cache

import numpy as np
import torch

from ..fields import mont
from ..fields.mont import FR
from .constants import PoseidonConstants


@lru_cache(maxsize=None)
def _host_tables(width=3):
    c = PoseidonConstants.generate(width)
    rounds = c.full_rounds + c.partial_rounds  # 63
    keys = c.round_constants
    pre = FR.to_mont_host(keys[0:width])                       # (L, 3)
    nxt = []
    for r in range(rounds):
        base = (r + 1) * width
        if base >= len(keys):
            nxt.append(FR.to_mont_host([0] * width))
        else:
            nxt.append(FR.to_mont_host(keys[base:base + width]))
    next_keys = np.stack(nxt)                                  # (63, L, 3)
    mat = np.stack([FR.to_mont_host(row) for row in c.mds_matrices.m],
                   axis=1)                                     # (L, 3i, 3j)
    is_full = ([True] * c.half_full_rounds + [False] * c.partial_rounds
               + [True] * c.half_full_rounds)
    tag = FR.to_mont_host([c.domain_tag])[:, 0]
    return pre, next_keys, mat, is_full, tag


@lru_cache(maxsize=None)
def _tables(device_str):
    pre, next_keys, mat, is_full, tag = _host_tables()
    dev = torch.device(device_str)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(
            dev)

    return t(pre), t(next_keys), t(mat), is_full, t(tag)


def _pow5(x):
    s4 = mont.mont_sqr(FR, mont.mont_sqr(FR, x))
    return mont.mont_mul(FR, s4, x)


def poseidon_states(left, right):
    """left/right: (L, m) Montgomery. Returns states (64, L, m, 3):
    states[0] = s_0, states[r+1] = s_{r+1}."""
    pre, next_keys, mat, is_full, tag = _tables(str(left.device))
    s = torch.stack([
        mont.add(FR, tag[:, None].expand_as(left), pre[:, 0:1]),
        mont.add(FR, left, pre[:, 1:2]),
        mont.add(FR, right, pre[:, 2:3]),
    ], dim=2)                                                  # (L, m, 3)
    states = [s]
    for r in range(next_keys.shape[0]):
        if is_full[r]:
            sb = _pow5(s)
        else:
            sb = torch.cat([_pow5(s[..., :1]), s[..., 1:]], dim=-1)
        # out[j] = sum_i mat[i][j] * sb[i]  (column-indexed product_mds)
        prods = mont.mont_mul(FR, sb[..., None], mat[:, None])  # (L,m,3,3)
        acc = mont.add(FR, mont.add(FR, prods[:, :, 0], prods[:, :, 1]),
                       prods[:, :, 2])
        s = mont.add(FR, acc, next_keys[r][:, None, :])
        states.append(s)
    return torch.stack(states, dim=0)


def hash2_batch(left, right):
    """(L, m) x (L, m) -> (L, m) Poseidon hashes."""
    return poseidon_states(left, right)[-1][..., 1]
