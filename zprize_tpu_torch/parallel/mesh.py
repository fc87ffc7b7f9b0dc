"""Multi-rank proving over `torch.distributed` — the port of
`zprize_tpu/parallel/mesh.py`.

PyTorch has no SPMD partitioner, so a mesh here is a process group (one
rank per process and card: NCCL on the card, gloo on the CPU) and every
sharded step says by hand what each rank computes and which collective
joins the parts:
  * four-step NTT: each rank transforms its block of rows, applies the
    twiddles of those rows, and one `all_to_all_single` transposes the
    blocks, so each rank then transforms its block of columns;
  * MSM: the points are split over the ranks (data parallel), each rank
    sorts and sums its own block into window points, and the window
    points are all-gathered and added in rank order (a point sum is no
    all-reduce);
  * Poseidon: each rank hashes its block of the batch.

Tensors are limbs-leading (L, ..., m), as everywhere in the port. A
function below takes its operands whole on every rank, works on this
rank's block and returns the whole result on every rank: the rest of the
prover stays whole on every rank (see `protocol/prover_torch.py`).

`spawn_cpu` runs a function on several gloo ranks of this machine, one
process each: the tests, `entry.dryrun_multichip` and
`tools/multihost_dryrun` use it where the JAX package used eight virtual
CPU devices in one process.
"""

import multiprocessing as mp
import os
import pickle
import queue
import socket
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import resolve
from ..fields import mont
from ..fields.mont import FR
from ..ref.domain import Domain
from ..ops import msm, ntt
from ..curve import g1
from ..poseidon.vectorized import hash2_batch

# seconds a collective, or a spawned rank, may take before it fails
TIMEOUT_S = 600


class Mesh:
    """One axis of ranks: the process group, this process's rank, the
    number of ranks (`size`) and this rank's device."""

    def __init__(self, group, rank, size, device):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device

    def close(self):
        """Destroy the process group (every rank calls it once)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _env_int(name):
    v = os.environ.get(name)
    if v is None:
        raise ValueError(f"{name} is not set: pass rank and world_size, or "
                         f"start the process with torchrun's environment")
    return int(v)


def make_mesh(device=None, init_method=None, rank=None, world_size=None,
              timeout_s=TIMEOUT_S):
    """Join a process group and return its Mesh.

    device: this rank's device, CUDA unless "cpu" is asked for; a bare
    "cuda" takes card LOCAL_RANK (else `rank`) modulo the cards present.
    The backend follows the device: NCCL on a card, gloo on the CPU.
    init_method, rank, world_size: default to torchrun's environment
    ("env://" with MASTER_ADDR and MASTER_PORT, RANK, WORLD_SIZE).
    Every collective of the group fails after `timeout_s` seconds."""
    dev = resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None \
        else world_size
    kw = {}
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s), **kw)
    return Mesh(dist.group.WORLD, rank, world_size, dev)


def shard_last(mesh, t):
    """This rank's contiguous block of the last axis of `t`, or `t` itself
    when the axis does not split evenly over the ranks (the counterpart
    of `mesh_put` / `ProverConfig.shard_last`, which replicate then)."""
    m = t.shape[-1]
    if m % mesh.size:
        return t
    b = m // mesh.size
    return t[..., mesh.rank * b:(mesh.rank + 1) * b].contiguous()


def _all_gather(mesh, t):
    """Every rank's `t` (equal shapes), in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return parts


def gather_last(mesh, t):
    """Inverse of `shard_last` on an even split: every rank's block of the
    last axis, concatenated in rank order."""
    return torch.cat(_all_gather(mesh, t), dim=-1)


def _require_split(mesh, m, what):
    if m % mesh.size:
        raise ValueError(f"{what}: {m} does not split evenly over "
                         f"{mesh.size} ranks")


def _sum_over_ranks(mesh, p):
    """xyzz points (4L, ...) of every rank, added in rank order by a tree
    of K7 additions; the same words on every rank."""
    return g1.xyzz_tree_sum(torch.stack(_all_gather(mesh, p), dim=-1))


# ---------------------------------------------------------------------------
# spawned CPU ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, init_method, env, args, timeout_s, results):
    torch.set_num_threads(1)
    mesh = None
    try:
        if env is None:
            mesh = make_mesh("cpu", init_method=init_method, rank=rank,
                             world_size=world, timeout_s=timeout_s)
        else:
            # torchrun's environment: make_mesh reads it all
            os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
            mesh = make_mesh("cpu", timeout_s=timeout_s)
        msg = (rank, True, pickle.dumps(fn(mesh, *args)))
    except BaseException:
        msg = (rank, False, traceback.format_exc())
    # the message is in the pipe before the group goes down, so a rank
    # that raised is reported before the peers that lose their connection
    results.put(msg)
    results.close()
    results.join_thread()
    if mesh is not None:
        mesh.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_cpu(fn, world, *args, timeout_s=TIMEOUT_S, torchrun_env=False):
    """Run `fn(mesh, *args)` on `world` gloo ranks, one spawned process
    each, and return rank 0's result. `fn`, `args` and the result must
    pickle. The ranks meet by a `file://` rendezvous in a temporary
    directory or, with `torchrun_env`, as torchrun starts them: RANK,
    LOCAL_RANK, WORLD_SIZE, MASTER_ADDR=127.0.0.1 and a free MASTER_PORT
    in each rank's environment, and init_method "env://".

    Raises RuntimeError naming the rank if a rank raises or dies, and
    TimeoutError naming the ranks still running after `timeout_s`
    seconds; every process is killed before it returns or raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="zk-mesh-") as d:
        init = "file://" + os.path.join(d, "rendezvous")
        env = None
        if torchrun_env:
            env = {"WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(_free_port())}
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, init, env, args,
                                   timeout_s, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    late = [r for r in range(world) if r not in out]
                    raise TimeoutError(
                        f"spawn_cpu: rank(s) {late} still running after "
                        f"{timeout_s} s; killed")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead and results.empty():
                        # one more look: its last message may be in flight
                        time.sleep(1.0)
                        if results.empty():
                            raise RuntimeError(
                                f"spawn_cpu: rank {dead[0]} exited with "
                                f"code {procs[dead[0]].exitcode} without "
                                f"a result")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn_cpu: rank {rank} raised:\n"
                                       f"{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
            results.close()
    return pickle.loads(out[0])


# ---------------------------------------------------------------------------
# four-step NTT (sequence parallel over the evaluation domain)
# ---------------------------------------------------------------------------

class FourStepPlan:
    """n = n1 * n2; input x[i1 + n1*i2] laid out as rows (L, n1, n2), row
    i1 at [:, i1, :]. Output R[k1][k2] = X[k2 + n2*k1] as (L, n1, n2): in
    row-major order the natural evaluations. Each rank holds n1/D rows
    before the transpose and n2/D columns after it. The plan holds only
    the radix-2 plans (cached per card by `ops/ntt`) of sizes n1, n2 and
    n; its twiddles are gathered from the last one's tables per call."""

    def __init__(self, log_n1, log_n2, device=None):
        self.log_n1, self.log_n2 = log_n1, log_n2
        self.n1, self.n2 = 1 << log_n1, 1 << log_n2
        self.n = self.n1 * self.n2
        self.device = resolve(device)
        self.plan1 = ntt.get_plan(log_n1, self.device)
        self.plan2 = ntt.get_plan(log_n2, self.device)
        self.plan = ntt.get_plan(log_n1 + log_n2, self.device)

    def fits(self, mesh):
        """Whether the rows and the columns both split over the ranks."""
        return self.n1 % mesh.size == 0 and self.n2 % mesh.size == 0

    def twiddles(self, mesh, invert):
        """w^(i1 k2) (or w^-(i1 k2)) for this rank's rows i1 only, (L,
        n1/D, n2). i1 k2 < n, and the radix-2 plan of size n holds w^k
        for k < n/2, so w^(k + n/2) = -w^k: one K4 pass and a gather, and
        nothing stays resident after the call. Not scaled by 1/n: the
        inverse scales by 1/n2 and 1/n1 in its two transforms."""
        rows = self.n1 // mesh.size
        i1 = torch.arange(mesh.rank * rows, (mesh.rank + 1) * rows,
                          dtype=torch.int64, device=self.device)
        k2 = torch.arange(self.n2, dtype=torch.int64, device=self.device)
        half = self.plan.itw if invert else self.plan.tw
        full = torch.cat([half, mont.neg(FR, half)], dim=1)     # (L, n)
        return full[:, (i1[:, None] * k2[None, :]).reshape(-1)].reshape(
            FR.L, rows, self.n2)


def four_step_plan(log_n, device):
    """The square-as-can-be plan of size 2^log_n (n1 <= n2)."""
    return FourStepPlan(log_n // 2, log_n - log_n // 2, device)


def _four_step(fsp, mesh, rows, invert):
    """This rank's rows (L, B, n1/D, n2) -> its block of R, (L, B, n1,
    n2/D)."""
    if not fsp.fits(mesh):
        raise ValueError(f"a {fsp.n1} x {fsp.n2} four-step plan does not "
                         f"split over {mesh.size} ranks")
    L, B = rows.shape[:2]
    D, r, c = mesh.size, fsp.n1 // mesh.size, fsp.n2 // mesh.size
    tw = fsp.twiddles(mesh, invert)
    # 1. length-n2 transforms along each local row (K5 per stage); the
    #    inverse folds in 1/n2 here
    b = ntt.transform_last(fsp.plan2, rows, invert)
    # 2. twiddles of these rows (K1)
    b = mont.mont_mul(FR, b, tw[:, None])
    # 3. transpose across ranks: column block d of every row goes to rank
    #    d; afterwards stage[s] holds rank s's rows of this rank's columns
    stage = b.reshape(L, B, r, D, c).permute(3, 0, 1, 2, 4).contiguous()
    recv = torch.empty_like(stage)
    dist.all_to_all_single(recv, stage, group=mesh.group)
    # (D, L, B, r, c) -> (L, B, c, n1), row i1 = s*r + local row
    t = recv.permute(1, 2, 4, 0, 3).reshape(L, B, c, fsp.n1)
    # 4. length-n1 transforms along i1 for each local column (1/n1)
    return ntt.transform_last(fsp.plan1, t, invert).transpose(-1, -2)


def _rows_of(fsp, mesh, x_rows):
    """This rank's rows of a whole (L, ..., n1, n2) tensor, as (L, B,
    n1/D, n2)."""
    r = fsp.n1 // mesh.size
    rows = x_rows.reshape(FR.L, -1, fsp.n1, fsp.n2)
    return rows[:, :, mesh.rank * r:(mesh.rank + 1) * r]


def four_step_ntt(fsp, mesh, x_rows):
    """x_rows: (L, ..., n1, n2) with x[i1 + n1*i2] at [..., i1, i2], whole
    on every rank. Returns (L, ..., n1, n2) R with R[..., k1, k2] =
    X[k2 + n2*k1], whole on every rank (each rank computes its n2/D
    columns; one all-gather joins them)."""
    out = _four_step(fsp, mesh, _rows_of(fsp, mesh, x_rows), False)
    return gather_last(mesh, out).reshape(x_rows.shape)


def four_step_intt_natural(fsp, mesh, evals):
    """Inverse transform with NATURAL order in and out: evals (L, ..., n)
    -> coefficients (L, ..., n), whole on every rank; the same words as
    `ops/ntt.intt`."""
    n1, n2 = fsp.n1, fsp.n2
    # rows[i1, i2] = evals[i1 + n1*i2]
    r = n1 // mesh.size
    rows = evals.reshape(FR.L, -1, n2, n1)[
        ..., mesh.rank * r:(mesh.rank + 1) * r].transpose(-1, -2)
    out = _four_step(fsp, mesh, rows, True)
    return gather_last(mesh, out).reshape(evals.shape)


def reference_four_step_check(fsp, coeffs):
    """Host oracle: coeffs[i1][i2] (Python ints) -> R[k1][k2] through the
    spec domain's natural-order NTT."""
    n = fsp.n1 * fsp.n2
    d = Domain(n)
    # x[i1 + n1*i2] = rows[i1][i2]
    flat = [0] * n
    for i1 in range(fsp.n1):
        for i2 in range(fsp.n2):
            flat[i1 + fsp.n1 * i2] = coeffs[i1][i2]
    X = d.fft(flat)
    R = [[X[k2 + fsp.n2 * k1] for k2 in range(fsp.n2)]
         for k1 in range(fsp.n1)]
    return R


# ---------------------------------------------------------------------------
# sharded MSM and point sums
# ---------------------------------------------------------------------------

def sharded_msm_window_partials(mesh, x_mont, y_mont, digits_w,
                                window_bits):
    """One MSM window, sum_i d_i P_i, with the points split over the
    ranks: x_mont, y_mont (L, n) affine Fq (identity (0, 0)), digits_w
    (n,) digits below 2^window_bits, whole on every rank. The digits are
    scalars below 2^16 (window_bits divides 16), so this is
    `sharded_msm_windows` of those scalars, whose first window is the sum
    (the others have no digit). Returns the xyzz point (4L,) on every
    rank.

    No capacity and no overflow count: the JAX grid gives every bucket a
    fixed number of slots per shard, and its overflow (ADVICE.md on
    `mesh.py:201`) is a slot that had no room. Here the bucket kernel cuts
    each bucket's run into chunks of at most `msm.CHUNK` members and sums
    the chunks' partials level by level until one point per bucket is
    left, so a bucket of any size, on any rank, is summed in full."""
    n = x_mont.shape[-1]
    raw = torch.zeros((16, 1, n), dtype=torch.int32, device=x_mont.device)
    raw[0, 0] = digits_w.to(torch.int32)
    return sharded_msm_windows(mesh, g1.pack_affine(x_mont, y_mont), raw,
                               window_bits)[:, 0, 0]


def sharded_msm_windows(mesh, pts, raw_scalar_limbs, window_bits):
    """The window points of B MSMs over the same points, split over the
    ranks: pts (N, 24) point-major (`g1.pack_affine`), raw canonical
    scalar limbs (16, B, n), n <= N and split evenly. Each rank runs
    `msm.msm_windows` on its block of points and scalars; the (4L, B, W)
    window points are all-gathered and added in rank order (the
    counterpart of `prover_tpu._commit_batch_mesh_jit`)."""
    n = raw_scalar_limbs.shape[-1]
    _require_split(mesh, n, "sharded_msm_windows")
    b = n // mesh.size
    block = pts[mesh.rank * b:(mesh.rank + 1) * b]
    raw = shard_last(mesh, raw_scalar_limbs)
    wpts = torch.stack([msm.msm_windows(block, raw[:, i], window_bits)
                        for i in range(raw.shape[1])], dim=1)
    return _sum_over_ranks(mesh, wpts)


def sharded_point_sum(mesh, x_mont, y_mont):
    """Sum of the affine points (L, n), split over the ranks: each rank
    tree-sums its block (K7), the rank sums are all-gathered and added.
    Returns the xyzz point (4L,) on every rank."""
    _require_split(mesh, x_mont.shape[-1], "sharded_point_sum")
    pts = g1.xyzz_from_affine(shard_last(mesh, x_mont),
                              shard_last(mesh, y_mont))
    return _sum_over_ranks(mesh, g1.xyzz_tree_sum(pts))


# ---------------------------------------------------------------------------
# data-parallel witness synthesis
# ---------------------------------------------------------------------------

def sharded_poseidon_hashes(mesh, left, right):
    """Poseidon hash2 of (L, m) pairs, each rank hashing its block; the
    (L, m) hashes on every rank."""
    _require_split(mesh, left.shape[-1], "sharded_poseidon_hashes")
    return gather_last(mesh, hash2_batch(shard_last(mesh, left),
                                         shard_last(mesh, right)))
