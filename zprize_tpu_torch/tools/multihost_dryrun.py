"""Multi-process dry run of the meshed prover — the port of
`tools/multihost_dryrun.py`, on `torch.distributed` with gloo on the CPU.

    python3 -m zprize_tpu_torch.tools.multihost_dryrun

`parallel.mesh.spawn_cpu` starts NPROC ranks as processes with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR=127.0.0.1 and a
free MASTER_PORT); each joins with init_method="env://", as it would under
torchrun, and:
  1. runs the four-step NTT at n = 256 (its all_to_all transpose crosses
     the process boundary) and checks it against the host oracle
     (`parallel.mesh.reference_four_step_check`);
  2. runs one sharded MSM window (32 points, 4-bit digits: per-rank bucket
     sums, the window points joined by an all_gather) and checks it
     against the Python-int curve sum;
  3. proves a five-gate circuit (a sum with a public input, a product
     held to a constant, a range gate: `entry.dryrun_circuit`) with
     `ProverConfig(mesh=...)` across the process boundary and checks that
     the proof's bytes equal the executable spec's (`ref.prover.prove`,
     same SRS `SRS.setup(8 * circuit_bound + 8, tau=123456789)`, same
     transcript label b"multihost", 4-bit device-MSM windows) and that it
     verifies. At two ranks n = 16 (a 4 x 4 plan) splits, so every rank
     holds n/2 columns (the sharded layout). The JAX tool makes this
     stage opt-in (MULTIHOST_FULL=1) because its meshed XLA:CPU compiles
     take 10-20 minutes; here nothing compiles and the three stages take
     about half a minute on a CPU, so this one always runs.
Prints "MULTIHOST: PASS" and exits 0 when every rank passed; a rank that
fails or is still running after MULTIHOST_TIMEOUT seconds (default 900)
makes it print "MULTIHOST: FAIL" and exit 1.
"""

import os
import random
import sys

from ..parallel import mesh as pmesh

NPROC = 2
PASS = "MULTIHOST DRYRUN PASS"
# the full prover stage's SRS and transcript, as in the JAX tool
TAU = 123456789
LABEL = b"multihost"


def worker(mesh):
    """One rank: the three checks; raises on a mismatch. Returns every
    rank's proof bytes, in rank order (on every rank)."""
    import numpy as np
    import torch
    from ..params import R_MOD
    from ..fields.mont import FR
    from ..curve import g1
    from ..ref.curve import G1_GEN, g1_add, g1_mul

    rank = mesh.rank
    # ---- 1. four-step NTT, the transpose across processes ----
    rng = random.Random(77)
    fsp = pmesh.FourStepPlan(4, 4, "cpu")                   # n = 256
    rows = [[rng.randrange(R_MOD) for _ in range(fsp.n2)]
            for _ in range(fsp.n1)]
    flat = [rows[i1][i2] for i1 in range(fsp.n1)
            for i2 in range(fsp.n2)]
    x = FR.tensor(flat, "cpu").reshape(FR.L, fsp.n1, fsp.n2)
    out = pmesh.four_step_ntt(fsp, mesh, x)
    got = [FR.from_mont_host(out[:, i, :]) for i in range(fsp.n1)]
    if got != pmesh.reference_four_step_check(fsp, rows):
        raise AssertionError("four-step NTT mismatch across processes")
    print(f"[proc {rank}] four-step NTT over {mesh.size}-process "
          f"mesh: OK", flush=True)

    # ---- 2. sharded MSM window across the process boundary ----
    n = 32
    pts = [g1_mul(G1_GEN, rng.randrange(1, 500)) for _ in range(n)]
    digs = [rng.randrange(16) for _ in range(n)]
    xs, ys, _ = g1.affine_points_to_device(pts, "cpu")
    d = torch.from_numpy(np.asarray(digs, dtype=np.int64))
    part = pmesh.sharded_msm_window_partials(mesh, xs, ys, d,
                                             window_bits=4)
    expect = None
    for p, k in zip(pts, digs):
        expect = g1_add(expect, g1_mul(p, k))
    if g1.xyzz_to_affine_host(part[:, None])[0] != expect:
        raise AssertionError("sharded MSM mismatch across processes")
    print(f"[proc {rank}] sharded MSM window over {mesh.size}-process "
          f"mesh: OK", flush=True)

    # ---- 3. the full prover across the process boundary ----
    import torch.distributed as dist
    from ..circuit import StandardComposer
    from ..entry import dryrun_circuit
    from ..protocol import prover_torch as pt
    from ..protocol.serde import serialize_proof
    from ..protocol.transcript_protocol import TranscriptProtocol
    from ..ref import prover as rp
    from ..ref.kzg import SRS
    from ..ref.verifier import verify

    cs = dryrun_circuit(StandardComposer())
    srs = SRS.setup(8 * cs.circuit_bound() + 8, tau=TAU)
    tr = TranscriptProtocol(LABEL)
    pk, vk = rp.preprocess(cs, srs, tr)
    spec_bytes = serialize_proof(rp.prove(cs, pk, srs, tr.clone()))
    cfg = pt.ProverConfig(device="cpu", mesh=mesh, msm_window_bits=4)
    proof = pt.prove_torch(pt.ProverWitness.from_composer(cs, pk.n, "cpu"),
                           pt.DevProverKey.from_ref(pk, "cpu"),
                           pt.DevSRS.from_ref(srs, "cpu"), tr.clone(), cfg)
    got = serialize_proof(proof)
    if got != spec_bytes:
        raise AssertionError("meshed multihost proof != spec proof")
    vtr = TranscriptProtocol(LABEL)
    rp.seed_transcript(vtr, vk)
    if not verify(vk, srs, proof, cs.public_inputs, vtr):
        raise AssertionError("meshed multihost proof does not verify")
    cols = pmesh.Columns(pk.n.bit_length() - 1, "cpu", mesh)
    print(f"[proc {rank}] FULL meshed proof across {mesh.size} processes "
          f"(n = {pk.n}, {cols.coef.layout.width} columns a rank): "
          f"byte-equal to spec + verified", flush=True)
    print(f"[proc {rank}] {PASS}", flush=True)
    every = [None] * mesh.size
    dist.all_gather_object(every, got, group=mesh.group)
    return every


def run(nproc=NPROC, timeout_s=None):
    """The three checks on `nproc` ranks with torchrun's environment;
    returns every rank's proof bytes, in rank order. Raises naming the
    rank that failed or did not finish."""
    if timeout_s is None:
        timeout_s = int(os.environ.get("MULTIHOST_TIMEOUT", "900"))
    return pmesh.spawn_cpu(worker, nproc, timeout_s=timeout_s,
                           torchrun_env=True)


def main():
    try:
        run()
    except (RuntimeError, TimeoutError) as e:
        print(f"[parent] {e}", flush=True)
        print("MULTIHOST: FAIL", flush=True)
        sys.exit(1)
    print("MULTIHOST: PASS", flush=True)


if __name__ == "__main__":
    main()
