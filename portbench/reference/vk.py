"""The verifier key of the Merkle circuit under an SRS of known tau, worked
out by the reference from the circuit alone: for every selector and
sigma polynomial p, given by its values p_r over the domain H = <w> of
size n, the commitment [p(tau)]_1 = p(tau) * G, where

    p(tau) = c * sum_r p_r * w^r / (tau - w^r),   c = (tau^n - 1) / n

(the Lagrange basis at tau). Python integers throughout: the n values
w^r / (tau - w^r) by rows in parallel processes (one inversion a chunk,
Montgomery's trick), then

  * a selector is a sum over the gadget's 193 positions: the gadget rows
    repeat one template, so its rows add into 193 buckets first;
  * a sigma is a sum over the targets of the permutation: the target
    (gate g, slot t) contributes K_t * w^g * L(source row) to the sigma
    of the source slot.

Run it in a process that has imported no threaded library: the workers
are forked (`check.py` starts one so)."""

import multiprocessing
import os

import numpy as np

from .spec.params import R_MOD, K1, K2, K3
from .spec.ref.curve import G1_GEN, g1_mul
from .spec.ref.field import root_of_unity
from .spec.circuit.composer import SELECTOR_NAMES
from .circuit import GADGET_GATES, PROLOGUE_GATES

M = R_MOD

# transcript seeding order of the verifier key (copied from
# `zprize_tpu_torch/ref/prover.py` SEED_ORDER and `seed_transcript`)
SEED_ORDER = [
    "q_m", "q_l", "q_r", "q_o", "q_c", "q_4", "q_hl", "q_hr", "q_h4",
    "q_arith", "q_range", "q_logic", "q_variable_group_add",
    "q_fixed_group_add", "left_sigma", "right_sigma", "out_sigma",
    "fourth_sigma"]
SIGMA_NAMES = ["left_sigma", "right_sigma", "out_sigma", "fourth_sigma"]

# rows a worker task takes
CHUNK = 1 << 16

# read by the forked workers (set before the pool starts)
_JOB = {}


class VerifierKey:
    def __init__(self, n, commitments, table_commitments):
        self.n = n
        self.commitments = commitments
        self.table_commitments = table_commitments


def seed_transcript(transcript, vk):
    for name in SEED_ORDER:
        transcript.append_g1(name.encode(), vk.commitments[name])
    transcript.circuit_domain_sep(vk.n)


def _lagrange_chunk(a):
    """Rows [a, a + CHUNK): the bytes of w^r / (tau - w^r) (32 each, little
    endian), and the gadget-row sums by position in the gadget."""
    job = _JOB
    tau, omega = job["tau"], job["omega"]
    b = min(a + CHUNK, job["n"])
    w = pow(omega, a, M)
    ws, ds = [], []
    for _ in range(a, b):
        ws.append(w)
        ds.append((tau - w) % M)
        w = w * omega % M
    pref, acc = [], 1
    for d in ds:
        pref.append(acc)
        acc = acc * d % M
    inv = pow(acc, -1, M)
    lp = [0] * len(ds)
    for i in range(len(ds) - 1, -1, -1):
        lp[i] = ws[i] * (pref[i] * inv % M) % M
        inv = inv * ds[i] % M
    buckets = [0] * GADGET_GATES
    g0, g1 = job["gadget_rows"]
    for r in range(max(a, g0), min(b, g1)):
        buckets[(r - g0) % GADGET_GATES] += lp[r - a]
    return a, b"".join(x.to_bytes(32, "little") for x in lp), buckets


def _sigma_chunk(a):
    """Targets of gates [a, a + CHUNK): sums of w^g * L'(source row) by
    (source slot, target slot)."""
    job = _JOB
    omega, lps = job["omega"], job["lp"]
    src = job["sigma_inv"]
    b = min(a + CHUNK, job["n"])
    acc = [0] * 16
    frm = int.from_bytes
    w = pow(omega, a, M)
    flat = src[4 * a:4 * b].tolist()
    for i in range(b - a):
        for t in range(4):
            s = flat[4 * i + t]
            r = s >> 2
            acc[(s & 3) * 4 + t] += w * frm(lps[32 * r:32 * r + 32], "little")
        w = w * omega % M
    return acc


def _pool(workers):
    return multiprocessing.get_context("fork").Pool(workers)


def poly_values_at(circuit, tau, workers=None):
    """{selector or sigma name: p(tau)} for `circuit` (a MerkleCircuit)."""
    n = circuit.n
    omega = root_of_unity(n.bit_length() - 1)
    if pow(tau, n, M) == 1:
        raise ValueError("tau lies in the domain")
    c = (pow(tau, n, M) - 1) * pow(n, -1, M) % M
    workers = workers or min(16, os.cpu_count() or 1)
    g0 = circuit.gadget_start
    g1 = g0 + GADGET_GATES * circuit.n_gadgets
    _JOB.clear()
    _JOB.update(tau=tau, omega=omega, n=n, gadget_rows=(g0, g1))
    lp = bytearray(32 * n)
    buckets = [0] * GADGET_GATES
    with _pool(workers) as pool:
        for a, blob, bk in pool.imap_unordered(_lagrange_chunk,
                                               range(0, n, CHUNK)):
            lp[32 * a:32 * a + len(blob)] = blob
            buckets = [x + y for x, y in zip(buckets, bk)]

    def L(r):
        return int.from_bytes(lp[32 * r:32 * r + 32], "little")

    t = circuit.template
    out = {}
    root = circuit.root_selectors()
    for name in SELECTOR_NAMES:
        v = sum(q * bk for q, bk in zip(t.selectors[name], buckets))
        v += sum(q * L(r) for r, q in
                 zip(range(PROLOGUE_GATES), t.prologue_selectors[name]))
        v += root.get(name, 0) * L(circuit.root_gate_pos)
        out[name] = v * c % M

    sigma = circuit.sigma_flat()
    sigma_inv = np.empty_like(sigma)
    sigma_inv[sigma] = np.arange(sigma.size, dtype=sigma.dtype)
    del sigma
    _JOB.update(lp=bytes(lp), sigma_inv=sigma_inv)
    del lp
    acc = [0] * 16
    with _pool(workers) as pool:
        for part in pool.imap_unordered(_sigma_chunk, range(0, n, CHUNK)):
            acc = [x + y for x, y in zip(acc, part)]
    _JOB.clear()
    ks = [1, K1, K2, K3]
    for s, name in enumerate(SIGMA_NAMES):
        out[name] = sum(ks[t] * acc[s * 4 + t] for t in range(4)) * c % M
    return out


def verifier_key(circuit, tau, workers=None):
    """The VerifierKey of `circuit` under powers of `tau`: every
    commitment p(tau) * G (None, the identity, where p(tau) = 0). The
    lookup table is empty, so its four commitments are the identity."""
    vals = poly_values_at(circuit, tau, workers)
    comms = {k: (g1_mul(G1_GEN, v) if v else None) for k, v in vals.items()}
    return VerifierKey(circuit.n, comms, [None] * 4), vals
