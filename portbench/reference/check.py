"""What every system's reference shares: the verification of a window's
proofs with tau known, in forked workers, the verdict, and the job read
from standard input.

A system's reference is `reference/<system>.py`, named by the
configuration file's "system" key. It defines `TIMEOUT_S`, the seconds
the harness gives it, and `judge(job)`, and runs as

    python3 -m portbench.reference.<system> < job.json

where the job is {"config" (the configuration file's contents), "seed",
"witnesses", "proofs": [[witness, hex bytes], ...]}; it prints one JSON
line, the verdict: {"rejected", "ok" (a verdict a proof, in order),
"proofs", "distinct", "n", "witnesses", "vk_s", "seconds", "reasons"}.
It makes the inputs again from the seed with its system's recipe
(`recipes/<system>.py`) and `inputs.tau`, works out the circuit and its
verifier key under tau (`vk.py`) and each witness's public inputs, and
verifies every distinct proof the window produced with the frozen spec
verifier (`spec/ref/verifier.py`). The verifier's two KZG pairing checks
e(W, [tau - z]_2) = e(C - v G, H) are checked as the equal statement in
G1, (tau - z) W = C - v G, since tau is known here. Nothing the program
made is read but the proofs' bytes: not its key, its commitments, its
public inputs or its tables.

Start it with OPENBLAS_NUM_THREADS=1 (and no threaded library loaded):
its workers are forked."""

import json
import multiprocessing
import sys
import time

from .spec.params import R_MOD
from .spec.ref.curve import G1_GEN, g1_add, g1_mul, g1_neg
from .spec.ref.verifier import verify
from .spec.protocol.serde import deserialize_proof
from .spec.protocol.transcript_protocol import TranscriptProtocol
from .vk import seed_transcript

M = R_MOD


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


# read by the forked workers (set before the pool starts)
CTX = {}


def pool(workers, **ctx):
    """`workers` forked processes that see `ctx` in `CTX`: "vk", "label"
    and "tau" for `verify_all`, and what the system's own tasks read."""
    CTX.clear()
    CTX.update(ctx)
    return multiprocessing.get_context("fork").Pool(workers)


def _verify_one(item):
    pi, blob = item
    try:
        proof = deserialize_proof(blob)
    except (ValueError, AssertionError, IndexError, UnicodeDecodeError,
            OverflowError) as e:
        return False, f"malformed: {type(e).__name__}: {e}"
    t = TranscriptProtocol(CTX["label"])
    seed_transcript(t, CTX["vk"])
    ok = verify(CTX["vk"], proof, pi, t, KnownTauPC(CTX["tau"]))
    return bool(ok), "" if ok else "does not verify"


def verify_all(pool, proofs, public_inputs):
    """Verify each distinct [witness, hex] of `proofs` in `pool` against
    `public_inputs[witness]` ({gate: value}); returns (ok a proof, in
    order, the number of distinct proofs, the reasons for rejecting)."""
    keys = list(dict.fromkeys((w, h) for w, h in proofs))
    items = [(public_inputs[w], bytes.fromhex(h)) for w, h in keys]
    verdicts = pool.map(_verify_one, items)
    good = dict(zip(keys, (ok for ok, _ in verdicts)))
    return ([good[(w, h)] for w, h in proofs], len(keys),
            sorted({why for ok, why in verdicts if not ok}))


def verdict(job, ok, distinct, reasons, n, vk_s, t0):
    """The verdict line's contents (see the module docstring)."""
    return {"rejected": ok.count(False), "ok": ok,
            "proofs": len(job["proofs"]), "distinct": distinct,
            "n": n, "witnesses": job["witnesses"], "vk_s": vk_s,
            "seconds": time.monotonic() - t0, "reasons": reasons}


def main(judge):
    """Judge the job on standard input and print the verdict."""
    print(json.dumps(judge(json.load(sys.stdin))), flush=True)
