"""Multi-process dry run of the meshed prover's primitives — the port of
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
     against the Python-int curve sum.
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


def worker(mesh):
    """One rank: both checks; raises on a mismatch."""
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
    print(f"[proc {rank}] {PASS}", flush=True)


def run(nproc=NPROC, timeout_s=None):
    """Both checks on `nproc` ranks with torchrun's environment; raises
    naming the rank that failed or did not finish."""
    if timeout_s is None:
        timeout_s = int(os.environ.get("MULTIHOST_TIMEOUT", "900"))
    pmesh.spawn_cpu(worker, nproc, timeout_s=timeout_s, torchrun_env=True)


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
