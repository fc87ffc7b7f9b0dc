"""The forward step on the flagship workload — the port of
`__graft_entry__.entry`: one batched Poseidon Merkle level (witness
synthesis) feeding a 2^7 INTT (round-1 wire polynomial construction).

    step, (left, right) = entry()          # on the card
    out = step(left, right)                # (16, 128) Montgomery limbs

The 128 input pairs come from `np.random.default_rng(0)` by the JAX
package's recipe, so both packages feed the step the same field elements.
The step runs the multiplication and addition kernels (Poseidon rounds)
and the butterfly kernel (INTT stages).
"""

import numpy as np

from .device import resolve
from .fields.mont import FR
from .ops import ntt
from .poseidon.vectorized import hash2_batch

M = 128
LOG_N = 7


def _rand_fr(rng, m, device):
    """(L, m) random field elements below 2^62, Montgomery limbs."""
    return FR.tensor([rng.integers(0, 1 << 62).item() for _ in range(m)],
                     device)


def entry(device=None):
    """Returns (step, (left, right)) on `device` (CUDA unless "cpu" is
    asked for)."""
    dev = resolve(device)
    plan = ntt.get_plan(LOG_N, dev)

    def step(left, right):
        return ntt.intt(plan, hash2_batch(left, right))

    rng = np.random.default_rng(0)
    left = _rand_fr(rng, M, dev)
    right = _rand_fr(rng, M, dev)
    return step, (left, right)
