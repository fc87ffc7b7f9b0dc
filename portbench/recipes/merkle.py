"""The Merkle system's inputs, made from the run's seed:

  * witness k's leaves: m values of 31 random bytes each (below 2^248, so
    every leaf is a canonical Fr element), drawn leaf by leaf as
    `zprize_tpu_torch/tools/merkle_setup.seeded_leaves` draws them, from
    the stream (seed, 0, k);
  * the transcript's label, which the key's transcript starts from."""

from .. import inputs

LEAF_BYTES = 31
LABEL = b"Merkle tree"


def leaf_sets(seed, witnesses, m):
    """`witnesses` lists of m leaves (Python ints)."""
    out = []
    for k in range(witnesses):
        rng = inputs.rng(seed, 0, k)
        out.append([int.from_bytes(rng.bytes(LEAF_BYTES), "little")
                    for _ in range(m)])
    return out
