"""The reference's verdict on the proofs a run produced.

Given the run's seed and cell, it makes the inputs again with the same
recipe the run handed the program (`portbench/inputs.py`: the leaves of
each witness and tau), works out the circuit (`circuit.py`), its verifier
key under tau (`vk.py`) and each witness's root (the spec's Poseidon over
the leaves), and verifies every distinct proof the window produced with
the frozen spec verifier (`spec/ref/verifier.py`). The verifier's two
KZG pairing checks e(W, [tau - z]_2) = e(C - v G, H) are checked as the
equal statement in G1, (tau - z) W = C - v G, since tau is known here.

Nothing the program made is read but the proofs' bytes: not its key, its
commitments, its root or its tables.

Run: python3 -m portbench.reference.check < job.json, where the job is
{"height", "seed", "witnesses", "proofs": [[witness, hex bytes], ...]};
prints one JSON line: {"rejected", "ok" (a verdict a proof, in order),
"proofs", "distinct", "seconds", ...}.
Start it with OPENBLAS_NUM_THREADS=1 (and no threaded library loaded):
its workers are forked."""

import json
import multiprocessing
import os
import sys
import time

from .. import inputs
from .spec.params import R_MOD
from .spec.ref.curve import G1_GEN, g1_add, g1_mul, g1_neg
from .spec.ref.verifier import verify
from .spec.protocol.serde import deserialize_proof
from .spec.protocol.transcript_protocol import TranscriptProtocol
from .circuit import MerkleCircuit, merkle_root, poseidon
from .vk import seed_transcript, verifier_key

M = R_MOD
LABEL = b"Merkle tree"


class KnownTauPC:
    """The KZG batch check of the port's `ref/kzg.check` with tau known: the
    pairing equation holds exactly when (tau - z) W = sum chi^i C_i -
    (sum chi^i v_i) G in G1."""

    def __init__(self, tau):
        self.tau = tau

    def check(self, commitments, point, evals, proof_w, challenge):
        c_comb, v_comb, chi = None, 0, 1
        for c, v in zip(commitments, evals):
            if c is not None:
                c_comb = g1_add(c_comb, g1_mul(c, chi))
            v_comb = (v_comb + chi * v) % M
            chi = chi * challenge % M
        rhs = g1_add(c_comb, g1_neg(g1_mul(G1_GEN, v_comb)))
        return g1_mul(proof_w, (self.tau - point) % M) == rhs


_CTX = {}


def _subtree(block):
    return merkle_root(block, _CTX["param"])


def _verify_one(item):
    pi, blob = item
    try:
        proof = deserialize_proof(blob)
    except (ValueError, AssertionError, IndexError, UnicodeDecodeError,
            OverflowError) as e:
        return False, f"malformed: {type(e).__name__}: {e}"
    t = TranscriptProtocol(LABEL)
    seed_transcript(t, _CTX["vk"])
    ok = verify(_CTX["vk"], proof, pi, t, KnownTauPC(_CTX["tau"]))
    return bool(ok), "" if ok else "does not verify"


def roots_of(leaf_sets, pool, workers):
    """Each leaf set's root; the subtrees of `workers` (a power of two)
    contiguous blocks in parallel, then the top levels here."""
    out = []
    for leaves in leaf_sets:
        parts = min(workers, len(leaves))
        size = len(leaves) // parts
        tops = pool.map(_subtree, [leaves[i:i + size]
                                   for i in range(0, len(leaves), size)])
        out.append(merkle_root(tops, _CTX["param"]) if len(tops) > 1
                   else tops[0])
    return out


def judge(job, workers=None):
    """The verdict on `job`'s proofs (see the module docstring)."""
    t0 = time.monotonic()
    workers = workers or min(16, os.cpu_count() or 1)
    circuit = MerkleCircuit(job["height"])
    tau = inputs.tau(job["seed"])
    vk, _ = verifier_key(circuit, tau, workers)
    t_vk = time.monotonic() - t0
    leaf_sets = inputs.leaf_sets(job["seed"], job["witnesses"],
                                 circuit.m_leaves)
    _CTX.update(param=poseidon(), vk=vk, tau=tau)
    pow2 = 1 << (max(1, workers).bit_length() - 1)
    distinct = dict.fromkeys((w, h) for w, h in job["proofs"])
    with multiprocessing.get_context("fork").Pool(workers) as pool:
        roots = roots_of(leaf_sets, pool, pow2)
        keys = list(distinct)
        items = [({circuit.root_gate_pos: (-roots[w]) % M},
                  bytes.fromhex(h)) for w, h in keys]
        verdicts = pool.map(_verify_one, items)
    _CTX.clear()
    good = dict(zip(keys, (ok for ok, _ in verdicts)))
    ok = [good[(w, h)] for w, h in job["proofs"]]
    return {"rejected": ok.count(False), "ok": ok,
            "proofs": len(job["proofs"]), "distinct": len(keys),
            "n": circuit.n, "witnesses": job["witnesses"], "vk_s": t_vk,
            "seconds": time.monotonic() - t0,
            "reasons": sorted({why for ok, why in verdicts if not ok})}

if __name__ == "__main__":
    print(json.dumps(judge(json.load(sys.stdin))), flush=True)
