"""The reference of the Merkle configurations (see `check.py`): the
circuit of the configuration's height (`circuit.py`), its verifier key
under tau by the template path of `vk.py`, and each witness's root, the
spec's Poseidon over the leaves of `recipes/merkle.py`, whose negation is
the public input at the root gate.

Run: python3 -m portbench.reference.merkle < job.json"""

import os
import time

from .. import inputs
from ..recipes import merkle as recipe
from . import check
from .circuit import MerkleCircuit, merkle_root, poseidon
from .vk import verifier_key

# the harness's limit on one judging: it takes 10-14 s at height 15 on
# the host of an H100 machine (8 cores a card)
TIMEOUT_S = 240


def _subtree(block):
    return merkle_root(block, check.CTX["param"])


def roots_of(leaf_sets, pool, workers):
    """Each leaf set's root; the subtrees of `workers` (a power of two)
    contiguous blocks in parallel, then the top levels here."""
    out = []
    for leaves in leaf_sets:
        parts = min(workers, len(leaves))
        size = len(leaves) // parts
        tops = pool.map(_subtree, [leaves[i:i + size]
                                   for i in range(0, len(leaves), size)])
        out.append(merkle_root(tops, check.CTX["param"]) if len(tops) > 1
                   else tops[0])
    return out


def judge(job, workers=None):
    """The verdict on `job`'s proofs (see `check.py`)."""
    t0 = time.monotonic()
    workers = workers or min(16, os.cpu_count() or 1)
    circuit = MerkleCircuit(job["config"]["height"])
    tau = inputs.tau(job["seed"])
    vk = verifier_key(circuit, tau, workers)
    t_vk = time.monotonic() - t0
    leaf_sets = recipe.leaf_sets(job["seed"], job["witnesses"],
                                 circuit.m_leaves)
    pow2 = 1 << (max(1, workers).bit_length() - 1)
    with check.pool(workers, param=poseidon(), vk=vk, tau=tau,
                    label=recipe.LABEL) as pool:
        roots = roots_of(leaf_sets, pool, pow2)
        ok, distinct, reasons = check.verify_all(
            pool, job["proofs"],
            [{circuit.root_gate_pos: (-r) % check.M} for r in roots])
    return check.verdict(job, ok, distinct, reasons, circuit.n, t_vk, t0)


if __name__ == "__main__":
    check.main(judge)
