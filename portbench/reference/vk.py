"""The verifier key of a circuit under an SRS of known tau, worked out by
the reference from the circuit alone: for every selector, sigma and
lookup-table polynomial p, given by its values p_r over the domain
H = <w> of size n, the commitment [p(tau)]_1 = p(tau) * G, where

    p(tau) = c * sum_r p_r * w^r / (tau - w^r),   c = (tau^n - 1) / n

(the Lagrange basis at tau). Python integers throughout: the n values
w^r / (tau - w^r) by rows in parallel processes (one inversion a chunk,
Montgomery's trick), each chunk's rows summed into the selectors as it is
made; then

  * a sigma is a sum over the targets of the permutation: the target
    (gate g, slot t) contributes K_t * w^g * L(source row) to the sigma
    of the source slot.

Two paths take a selector's sum:

  * `columns_verifier_key`, any circuit given as columns: every selector
    and every lookup-table column row by row, the table padded as the
    spec pads it (`MultiSet::pad`);
  * `verifier_key`, the Merkle circuit (`circuit.py`): the gadget rows
    repeat one template, so its rows add into 193 buckets first, and the
    table is empty (its four commitments the identity).

Run it in a process that has imported no threaded library: the workers
are forked (`check.py` starts one so). To time the columns path on
random columns (no two rows alike, a full table):

    python3 -m portbench.reference.vk <log2 n> <workers>"""

import math
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
    endian), and the job's sums over these rows (`_JOB["sums"]`)."""
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
    return (a, b"".join(x.to_bytes(32, "little") for x in lp),
            job["sums"](a, b, lp))


def _template_sums(a, b, lp):
    """The gadget-row sums by position in the gadget, then w^r / (tau - w^r)
    at each row of `_JOB["rows"]` (0 where the row is not in [a, b))."""
    buckets = [0] * GADGET_GATES
    g0, g1 = _JOB["gadget_rows"]
    for r in range(max(a, g0), min(b, g1)):
        buckets[(r - g0) % GADGET_GATES] += lp[r - a]
    return buckets + [lp[r - a] if a <= r < b else 0 for r in _JOB["rows"]]


def _column_sums(a, b, lp):
    """Each column's sum of q_r * w^r / (tau - w^r) over the rows."""
    return [math.sumprod(col[a:b], lp) for col in _JOB["columns"]]


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


def _row_pass(n, tau, workers, sums, **job):
    """(c, the bytes of w^r / (tau - w^r) for every row, the sums of `sums`
    over every row): the rows in `workers` forked processes, where `sums`
    reads `job`."""
    if pow(tau, n, M) == 1:
        raise ValueError("tau lies in the domain")
    c = (pow(tau, n, M) - 1) * pow(n, -1, M) % M
    _JOB.clear()
    _JOB.update(job, tau=tau, omega=root_of_unity(n.bit_length() - 1), n=n,
                sums=sums)
    lp = bytearray(32 * n)
    total = None
    with _pool(workers) as pool:
        for a, blob, part in pool.imap_unordered(_lagrange_chunk,
                                                 range(0, n, CHUNK)):
            lp[32 * a:32 * a + len(blob)] = blob
            total = part if total is None else [
                x + y for x, y in zip(total, part)]
    _JOB.clear()
    return c, bytes(lp), total


def _sigma_pass(n, c, lp, sigma, workers):
    """{sigma name: sigma(tau)} of the permutation `sigma` ((4n,) flat
    positions 4 * row + slot, each to its cycle successor's), from the
    row pass's c and bytes, in `workers` forked processes."""
    sigma_inv = np.empty_like(sigma)
    sigma_inv[sigma] = np.arange(sigma.size, dtype=sigma.dtype)
    _JOB.clear()
    _JOB.update(omega=root_of_unity(n.bit_length() - 1), n=n, lp=lp,
                sigma_inv=sigma_inv)
    acc = [0] * 16
    with _pool(workers) as pool:
        for part in pool.imap_unordered(_sigma_chunk, range(0, n, CHUNK)):
            acc = [x + y for x, y in zip(acc, part)]
    _JOB.clear()
    ks = [1, K1, K2, K3]
    return {name: sum(ks[t] * acc[s * 4 + t] for t in range(4)) * c % M
            for s, name in enumerate(SIGMA_NAMES)}


def poly_values_at(circuit, tau, workers):
    """{selector or sigma name: p(tau)} for `circuit` (a MerkleCircuit)."""
    g0 = circuit.gadget_start
    c, lp, sums = _row_pass(
        circuit.n, tau, workers, _template_sums,
        gadget_rows=(g0, g0 + GADGET_GATES * circuit.n_gadgets),
        rows=list(range(PROLOGUE_GATES)) + [circuit.root_gate_pos])
    buckets, prologue = sums[:GADGET_GATES], sums[GADGET_GATES:-1]
    t = circuit.template
    root = circuit.root_selectors()
    out = {}
    for name in SELECTOR_NAMES:
        v = sum(q * bk for q, bk in zip(t.selectors[name], buckets))
        v += sum(q * x for q, x in zip(t.prologue_selectors[name], prologue))
        v += root.get(name, 0) * sums[-1]
        out[name] = v * c % M
    out.update(_sigma_pass(circuit.n, c, lp, circuit.sigma_flat(), workers))
    return out


def verifier_key(circuit, tau, workers):
    """The VerifierKey of `circuit` (a MerkleCircuit) under powers of
    `tau`: every commitment p(tau) * G (None, the identity, where
    p(tau) = 0). The lookup table is empty, so its four commitments are
    the identity."""
    values = poly_values_at(circuit, tau, workers)
    return VerifierKey(circuit.n, _commit(values), [None] * 4)


def pad_table(col, n):
    """A lookup-table column padded to n rows as the spec pads it
    (`MultiSet::pad`): with its first value, or with zeros when empty."""
    col = list(col) or [0]
    return col + [col[0]] * (n - len(col))


def columns_verifier_key(n, selectors, sigma, table, tau, workers):
    """The VerifierKey of the circuit of n rows given as columns, under
    powers of `tau`: `selectors` {name: n values} for every name of
    SELECTOR_NAMES, `sigma` the (4n,) permutation of the copy constraints
    (`sigma_of_cycles`), `table` the lookup table's four columns of at
    most n values (unpadded)."""
    columns = [selectors[name] for name in SELECTOR_NAMES]
    columns += [pad_table(col, n) for col in table]
    if any(len(col) != n for col in columns):
        raise ValueError(f"every column must have n = {n} rows")
    c, lp, sums = _row_pass(n, tau, workers, _column_sums, columns=columns)
    vals = {name: s * c % M for name, s in zip(SELECTOR_NAMES, sums)}
    vals.update(_sigma_pass(n, c, lp, np.asarray(sigma, dtype=np.int64),
                            workers))
    tables = _commit({i: s * c % M for i, s in
                      enumerate(sums[len(SELECTOR_NAMES):])})
    return VerifierKey(n, _commit(vals), list(tables.values()))


def _commit(vals):
    return {k: (g1_mul(G1_GEN, v) if v else None) for k, v in vals.items()}


def sigma_of_cycles(cycles, n):
    """The (4n,) permutation of the copy constraints as the spec builds it
    (`permutation/mod.rs`): `cycles` holds each variable's wires
    [(slot, row), ...] in the order the composer placed them (its
    `var_map.values()`); each wire maps to the next of its variable's,
    the last to the first, as flat positions 4 * row + slot."""
    sigma = np.arange(4 * n, dtype=np.int64)
    for wires in cycles:
        for (t, g), (t2, g2) in zip(wires, wires[1:] + wires[:1]):
            if g < n:
                sigma[4 * g + t] = 4 * g2 + t2
    return sigma


def _time_columns(log_n, workers, seed=1):
    """Seconds of `columns_verifier_key` at n = 2^log_n on random columns:
    every selector and table value, and the permutation, random."""
    import random
    import time
    rng = random.Random(seed)
    n = 1 << log_n
    selectors = {name: [rng.randrange(M) for _ in range(n)]
                 for name in SELECTOR_NAMES}
    table = [[rng.randrange(M) for _ in range(n)] for _ in range(4)]
    sigma = np.random.default_rng(seed).permutation(4 * n)
    tau = rng.randrange(1, M)
    t0 = time.monotonic()
    columns_verifier_key(n, selectors, sigma, table, tau, workers)
    return time.monotonic() - t0


if __name__ == "__main__":
    import json
    import sys
    log_n, workers = (int(x) for x in sys.argv[1:3])
    print(json.dumps({"log_n": log_n, "workers": workers,
                      "seconds": _time_columns(log_n, workers),
                      "cpus": os.cpu_count()}), flush=True)
