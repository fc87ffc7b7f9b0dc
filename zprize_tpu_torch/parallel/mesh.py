"""Multi-rank proving over `torch.distributed` — the port of
`zprize_tpu/parallel/mesh.py` and of the sharded branch of
`zprize_tpu/protocol/prover_tpu.py` (`ProverConfig.shard_last`).

PyTorch has no SPMD partitioner, so a mesh here is a process group (one
rank per process and card: NCCL on the card, gloo on the CPU) and every
sharded step says by hand what each rank computes and which collective
joins the parts.

Which columns a rank holds. A prover of size n = n1 * n2 (n1 = 2^floor(
log n / 2) <= n2, the four-step plan's sides) splits every n-length axis
over its D ranks by column (`Columns`):
  * coefficient form, `Layout(n, n1, D, r)`: rank r holds the columns g
    with (g mod n1) in block r of n1 (n1/D wide), ordered by g;
  * evaluation form, `Layout(n, n2, D, r)`: the same with n2.
These are the input and output sides of the four-step transform, so a
forward NTT (n1 x n2) goes from the coefficient layout to the evaluation
layout, and an inverse (n2 x n1) back, each with one `all_to_all_single`
and no gather. When log n is even the two layouts are one; when it is
odd they differ, and no step mixes the two forms. Every table follows
the form it meets: the SRS points and the shift powers the coefficient
layout, the roots and the sigma and lookup columns the evaluation one.
When a side does not split over D, every step runs whole on every rank
(the JAX package replicates then).

The collectives, each named where it is used:
  * four-step NTT / INTT: one `all_to_all_single` (the transpose);
  * the next gate (`Split.shift`): an `all_gather` of one edge column;
  * prefix products and synthetic division (`Split.prefix_product`,
    `Split.divide`): an `all_gather` of each rank's block totals, whose
    scan in natural block order gives each block its carry (`ops/poly`'s
    carry-in forms);
  * evaluations (`Split.sum`): an `all_gather` of the partial sums, added
    in rank order (a modular sum is no NCCL reduction);
  * MSM: each rank sums its own points and scalars into window points,
    which are all-gathered and added in rank order by K7;
  * the plookup `combine_split` (host code): the compressed columns are
    gathered whole, the one gathered step;
  * Poseidon: each rank hashes its block of the batch.

`spawn_cpu` and `spawn_cuda` run a function on several ranks of this
machine, one process each (gloo on the CPU, NCCL one card a rank): the
tests, `entry.dryrun_multichip` and `tools/multihost_dryrun` use them where
the JAX package used eight virtual CPU devices in one process. Their
process handling, `run_processes` (deadlines, failures named, every
process killed), also carries `protocol/batch.prove_many`'s one process
a card.
"""

import gc
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
import torch.multiprocessing

from ..params import R_MOD
from ..device import resolve
from ..fields import mont
from ..fields.mont import FR
from ..ref.domain import Domain
from ..ref.field import root_of_unity
from ..ops import msm, ntt, poly
from ..ops.poly import Layout
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
# spawned processes, and spawned ranks
# ---------------------------------------------------------------------------

def put_result(results, msg):
    """Put a spawned process's message (k, ok, payload) in `results` and
    wait until it is in the pipe, so that it arrives even if the process
    dies right after."""
    results.put(msg)
    results.close()
    results.join_thread()


# seconds a process that has put its result may take to end by itself
EXIT_GRACE_S = 30


def _process_main(target, k, box, results):
    # the arguments come in a list that this process empties, so that
    # they are dropped when `target` returns (and a CUDA IPC handle is
    # released before the process ends), not held by the process object
    target(k, *box.pop(), results)
    gc.collect()


def run_processes(name, target, args, timeout_s, what="rank", where=None):
    """Start one spawned process for each tuple in `args` and return
    their results in order. Process k runs `target(k, *args[k], results)`,
    which ends by putting (k, True, pickled result) or (k, False,
    traceback) in `results` with `put_result`. The processes come from
    `torch.multiprocessing`, so tensors in `args` pass as shared memory
    on the CPU and as IPC handles on a card; the caller keeps them alive
    until the call returns.

    Raises RuntimeError naming `what` k (and `where[k]`, when given) if
    process k raises or dies without a result, and TimeoutError naming
    those still running after `timeout_s` seconds. Every process is ended
    before it returns or raises: when all have put their results each
    gets EXIT_GRACE_S seconds to end by itself, else it is killed."""
    count = len(args)

    def who(k):
        return f"{what} {k}" + (f" on {where[k]}" if where else "")

    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out = {}
    procs = [ctx.Process(target=_process_main, daemon=True,
                         args=(target, k, [tuple(a)], results))
             for k, a in enumerate(args)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < count:
            left = deadline - time.monotonic()
            if left <= 0:
                late = [k for k in range(count) if k not in out]
                raise TimeoutError(
                    f"{name}: {what}(s) {late} still running after "
                    f"{timeout_s} s; killed" + (
                        f" ({', '.join(str(where[k]) for k in late)})"
                        if where else ""))
            try:
                k, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [k for k, p in enumerate(procs)
                        if k not in out and p.exitcode is not None]
                if dead and results.empty():
                    # one more look: its last message may be in flight
                    time.sleep(1.0)
                    if results.empty():
                        raise RuntimeError(
                            f"{name}: {who(dead[0])} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"{name}: {who(k)} raised:\n{payload}")
            out[k] = payload
    finally:
        started = [p for p in procs if p.pid is not None]
        if len(out) == count:
            until = time.monotonic() + EXIT_GRACE_S
            for p in started:
                p.join(timeout=max(0.0, until - time.monotonic()))
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=30)
        results.close()
    return [pickle.loads(out[k]) for k in range(count)]


def _rank_main(rank, fn, world, kind, init_method, env, args, timeout_s,
               results):
    if kind == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank)
    mesh = None
    try:
        if env is None:
            mesh = make_mesh(dev, init_method=init_method, rank=rank,
                             world_size=world, timeout_s=timeout_s)
        else:
            # torchrun's environment: make_mesh reads it all
            os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
            mesh = make_mesh(dev, timeout_s=timeout_s)
        msg = (rank, True, pickle.dumps(fn(mesh, *args)))
    except BaseException:
        msg = (rank, False, traceback.format_exc())
    # the message is in the pipe before the group goes down, so a rank
    # that raised is reported before the peers that lose their connection
    put_result(results, msg)
    if mesh is not None:
        mesh.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(name, kind, fn, world, args, timeout_s, torchrun_env):
    """Every rank's result, in rank order (see `spawn_cpu`)."""
    with tempfile.TemporaryDirectory(prefix="zk-mesh-") as d:
        init = "file://" + os.path.join(d, "rendezvous")
        env = None
        if torchrun_env:
            env = {"WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(_free_port())}
        return run_processes(
            name, _rank_main,
            [(fn, world, kind, init, env, args, timeout_s)] * world,
            timeout_s)


def spawn_cpu(fn, world, *args, timeout_s=TIMEOUT_S, torchrun_env=False):
    """Run `fn(mesh, *args)` on `world` gloo ranks, one spawned process
    each, and return rank 0's result. `fn`, `args` and the results must
    pickle. The ranks
    meet by a `file://` rendezvous in a temporary directory or, with
    `torchrun_env`, as torchrun starts them: RANK, LOCAL_RANK, WORLD_SIZE,
    MASTER_ADDR=127.0.0.1 and a free MASTER_PORT in each rank's
    environment, and init_method "env://".

    Raises RuntimeError naming the rank if a rank raises or dies, and
    TimeoutError naming the ranks still running after `timeout_s`
    seconds; every process is killed before it returns or raises."""
    return _spawn("spawn_cpu", "cpu", fn, world, args, timeout_s,
                  torchrun_env)[0]


def spawn_cuda(fn, world, *args, timeout_s=TIMEOUT_S):
    """`spawn_cpu` on the cards: rank r is a process on card r of an NCCL
    group (`make_mesh` sets the card before the group starts), with the
    same deadlines and the same failures. Returns every rank's result, in
    rank order. Needs `world` cards."""
    have = torch.cuda.device_count()
    if world > have:
        raise ValueError(f"spawn_cuda: {world} ranks need {world} cards; "
                         f"this machine has {have}")
    return _spawn("spawn_cuda", "cuda", fn, world, args, timeout_s, False)


# ---------------------------------------------------------------------------
# a rank's columns and the collectives over them
# ---------------------------------------------------------------------------

class Split:
    """The columns `layout` (a `poly.Layout`) of this rank of `mesh`, and
    the steps whose result on them needs the other ranks' columns. With
    mesh None the layout is the whole axis and every step is the whole
    one, with no collective."""

    def __init__(self, layout, mesh=None):
        self.layout = layout
        self.mesh = mesh

    def take(self, t):
        """This rank's columns of the whole (..., n) tensor t."""
        return self.layout.take(t)

    def gather(self, t):
        """The whole (..., n) tensor from every rank's columns t (...,
        n/D), in natural order on every rank (one all_gather)."""
        if self.mesh is None:
            return t
        lay = self.layout
        s = t.shape[:-1]
        parts = torch.stack(_all_gather(self.mesh, t), dim=-2)
        return parts.reshape(s + (lay.size, lay.rows, lay.c)).transpose(
            -3, -2).reshape(s + (lay.n,))

    def shift(self, t, k):
        """The rank's columns g of whole[(g + k) mod n], k = 1 (the next
        gate) or -1: each row block takes its one missing column from the
        neighbouring rank's edge (one all_gather of an edge column), the
        last rank's from the first rank's next row, and the first rank's
        from the last rank's previous row."""
        if self.mesh is None:
            return torch.roll(t, -k, dims=-1)
        lay = self.layout
        s = t.shape[:-1]
        t3 = t.reshape(s + (lay.rows, lay.c))
        D, r = lay.size, lay.rank
        if k == 1:
            parts = _all_gather(self.mesh, t3[..., 0])
            halo = parts[r + 1] if r + 1 < D else parts[0].roll(-1, -1)
            out = torch.cat([t3[..., 1:], halo[..., None]], dim=-1)
        elif k == -1:
            parts = _all_gather(self.mesh, t3[..., -1])
            halo = parts[r - 1] if r > 0 else parts[D - 1].roll(1, -1)
            out = torch.cat([halo[..., None], t3[..., :-1]], dim=-1)
        else:
            raise ValueError(f"shift by {k}: only 1 and -1")
        return out.reshape(s + (lay.width,))

    def sum(self, cfg, a):
        """sum_last of the whole axis: the rank's partial sums (L, ...),
        all-gathered and added in rank order; the same words on every
        rank."""
        part = poly.sum_last(cfg, a)
        if self.mesh is None:
            return part
        return poly.sum_last(cfg, torch.stack(_all_gather(self.mesh, part),
                                              dim=-1))

    def powers(self, cfg, x):
        """x^g for the rank's columns g, (L, n/D); no collective."""
        return self.layout.powers(cfg, x)

    def _carries(self, totals, chain):
        """Each of this rank's row blocks' carry: the block totals (L,
        ..., rows) of every rank, all-gathered, put in natural block order
        (block r of row q is number q*D + r), scanned by `chain` (a scan
        whose element b is the carry of block b) and cut back to this
        rank's blocks."""
        lay = self.layout
        seq = torch.stack(_all_gather(self.mesh, totals), dim=-1)
        s = seq.shape[:-2]
        out = chain(seq.reshape(s + (lay.rows * lay.size,)))
        return out.reshape(s + (lay.rows, lay.size))[..., lay.rank]

    def prefix_product(self, cfg, a):
        """poly.prefix_product(a, shift_one=True) of the whole axis: each
        row block carries in the product of the blocks before it."""
        if self.mesh is None:
            return poly.prefix_product(cfg, a, shift_one=True)
        lay = self.layout
        s = a.shape[:-1]
        a3 = a.reshape(s + (lay.rows, lay.c))
        carry = self._carries(poly.prod_last(cfg, a3), lambda seq:
                              poly.prefix_product(cfg, seq, shift_one=True))
        return poly.prefix_product(cfg, a3, shift_one=True,
                                   carry=carry).reshape(s + (lay.width,))

    def divide(self, cfg, coeffs, z):
        """The quotient of the whole polynomial by (X - z), padded with a
        zero to n coefficients; z is (L,). Each row block carries in the
        remainder of the coefficients above it: the blocks' values at z,
        chained by a synthetic division by (X - z^c) over the blocks."""
        if self.mesh is None:
            q, _ = poly.divide_linear(cfg, coeffs, z)
            return torch.cat([q, torch.zeros_like(q[..., :1])], dim=-1)
        lay = self.layout
        s = coeffs.shape[:-1]
        c3 = coeffs.reshape(s + (lay.rows, lay.c))
        zp = poly.powers(cfg, z, lay.c + 1)                # z^0 .. z^c
        values = poly.sum_last(cfg, mont.mont_mul(
            cfg, c3, zp[:, :-1].reshape((cfg.L,) + (1,) * (c3.dim() - 2)
                                        + (lay.c,))))
        zc = zp[:, -1]
        carry = self._carries(values, lambda seq: poly.divide_linear(
            cfg, seq, zc, carry=torch.zeros_like(seq[..., 0]))[0])
        q, _ = poly.divide_linear(cfg, c3, z, carry=carry)
        return q.reshape(s + (lay.width,))


# ---------------------------------------------------------------------------
# four-step NTT (sequence parallel over the evaluation domain)
# ---------------------------------------------------------------------------

class FourStepPlan:
    """n = n1 * n2; input x[i1 + n1*i2] laid out as rows (L, n1, n2), row
    i1 at [:, i1, :]. Output R[k1][k2] = X[k2 + n2*k1] as (L, n1, n2): in
    row-major order the natural evaluations. Each rank holds n1/D rows
    before the transpose and n2/D columns after it: its columns of
    `Layout(n, n1)` in, of `Layout(n, n2)` out. The plan holds the
    `ops/ntt` plans (cached per card) of sizes n1 and n2, and the
    rank's twiddles once they are asked for: they go with the plan (the
    prover makes its plans per prove, so nothing stays after it)."""

    def __init__(self, log_n1, log_n2, device=None):
        self.log_n1, self.log_n2 = log_n1, log_n2
        self.n1, self.n2 = 1 << log_n1, 1 << log_n2
        self.n = self.n1 * self.n2
        self.device = resolve(device)
        self.plan1 = ntt.get_plan(log_n1, self.device)
        self.plan2 = ntt.get_plan(log_n2, self.device)
        self._tw = {}

    def fits(self, mesh):
        """Whether the rows and the columns both split over the ranks."""
        return self.n1 % mesh.size == 0 and self.n2 % mesh.size == 0

    def twiddles(self, mesh, invert):
        """w^(i1 k2) (or w^-(i1 k2)) for this rank's rows i1 only, (L,
        n1/D, n2): the powers of each w^i1. Made at the first call and
        kept (n/D words a direction). Not scaled by 1/n: the inverse
        scales by 1/n2 and 1/n1 in its two transforms."""
        key = (mesh.rank, mesh.size, invert)
        if key not in self._tw:
            rows = self.n1 // mesh.size
            w = root_of_unity(self.log_n1 + self.log_n2)
            if invert:
                w = pow(w, -1, R_MOD)
            first = pow(w, mesh.rank * rows, R_MOD)
            w_i1 = poly.powers(FR, FR.scalar(w, self.device), rows,
                               start=FR.scalar(first, self.device))
            self._tw[key] = poly.powers(FR, w_i1, self.n2)
        return self._tw[key]


def four_step_plan(log_n, device, swap=False):
    """The square-as-can-be plan of size 2^log_n (n1 <= n2; n1 >= n2 with
    `swap`)."""
    a, b = log_n // 2, log_n - log_n // 2
    return FourStepPlan(b, a, device) if swap else FourStepPlan(a, b, device)


def _four_step(fsp, mesh, x, invert):
    """This rank's columns (L, ..., n/D) of x in `Layout(n, n1)` -> its
    columns of the transform in `Layout(n, n2)`."""
    if not fsp.fits(mesh):
        raise ValueError(f"a {fsp.n1} x {fsp.n2} four-step plan does not "
                         f"split over {mesh.size} ranks")
    L, batch = x.shape[0], x.shape[1:-1]
    D, r, c = mesh.size, fsp.n1 // mesh.size, fsp.n2 // mesh.size
    # local column i2*r + (i1 - rank*r) -> rows [i1, i2]
    rows = x.reshape(L, -1, fsp.n2, r).transpose(-1, -2)
    # 1. length-n2 transforms along each local row (K5 per stage); the
    #    inverse folds in 1/n2 here
    b = ntt.transform_last(fsp.plan2, rows, invert)
    # 2. twiddles of these rows (K1)
    b = mont.mont_mul(FR, b, fsp.twiddles(mesh, invert)[:, None])
    # 3. transpose across ranks: column block d of every row goes to rank
    #    d; afterwards stage[s] holds rank s's rows of this rank's columns
    stage = b.reshape(L, -1, r, D, c).permute(3, 0, 1, 2, 4).contiguous()
    del b
    recv = torch.empty_like(stage)
    dist.all_to_all_single(recv, stage, group=mesh.group)
    del stage
    # (D, L, B, r, c) -> (L, B, c, n1), row i1 = s*r + local row
    t = recv.permute(1, 2, 4, 0, 3).reshape(L, -1, c, fsp.n1)
    del recv
    # 4. length-n1 transforms along i1 for each local column (1/n1)
    out = ntt.transform_last(fsp.plan1, t, invert)
    # [k2 - rank*c, k1] -> local column k1*c + (k2 - rank*c)
    return out.transpose(-1, -2).reshape((L,) + batch + (fsp.n1 * c,))


def _layouts(fsp, mesh):
    return (Layout(fsp.n, fsp.n1, mesh.size, mesh.rank),
            Layout(fsp.n, fsp.n2, mesh.size, mesh.rank))


def four_step_ntt_sharded(fsp, mesh, x):
    """NTT of this rank's columns x (L, ..., n/D) of `Layout(n, n1)`
    (coefficients) -> its columns of `Layout(n, n2)` (evaluations); one
    all_to_all_single, no gather."""
    return _four_step(fsp, mesh, x, False)


def four_step_intt_sharded(fsp, mesh, x):
    """INTT, `Layout(n, n1)` (evaluations) -> `Layout(n, n2)`
    (coefficients): the prover takes the plan with n1 and n2 swapped."""
    return _four_step(fsp, mesh, x, True)


def four_step_ntt(fsp, mesh, x_rows):
    """x_rows: (L, ..., n1, n2) with x[i1 + n1*i2] at [..., i1, i2], whole
    on every rank. Returns (L, ..., n1, n2) R with R[..., k1, k2] =
    X[k2 + n2*k1], whole on every rank (each rank computes its columns;
    one all-gather joins them)."""
    r = fsp.n1 // mesh.size
    x = x_rows.reshape((FR.L, -1, fsp.n1, fsp.n2))[
        :, :, mesh.rank * r:(mesh.rank + 1) * r].transpose(-1, -2)
    out = four_step_ntt_sharded(fsp, mesh,
                                x.reshape(FR.L, -1, fsp.n // mesh.size))
    return Split(_layouts(fsp, mesh)[1], mesh).gather(out).reshape(
        x_rows.shape)


def four_step_intt_natural(fsp, mesh, evals):
    """Inverse transform with NATURAL order in and out: evals (L, ..., n)
    -> coefficients (L, ..., n), whole on every rank; the same words as
    `ops/ntt.intt`."""
    lay1, lay2 = _layouts(fsp, mesh)
    out = four_step_intt_sharded(fsp, mesh, lay1.take(evals))
    return Split(lay2, mesh).gather(out)


class Columns:
    """The columns of a prover of size 2^log_n that this rank of `mesh`
    holds: `coef` and `evals`, the `Split`s of the coefficient and the
    evaluation layout (see the header), and the transforms between them.
    `sharded` is False with no mesh, or when a four-step side does not
    split over its ranks: then both are the whole axis and the transforms
    are `ops/ntt`'s."""

    def __init__(self, log_n, device, mesh=None):
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.device = device
        fwd = four_step_plan(log_n, device) if mesh is not None else None
        self.sharded = fwd is not None and fwd.fits(mesh)
        self.mesh = mesh if self.sharded else None
        if self.sharded:
            self._fwd = fwd
            # a square plan is its own swap: one set of twiddles
            self._inv = fwd if fwd.n1 == fwd.n2 else \
                four_step_plan(log_n, device, swap=True)
            lay1, lay2 = _layouts(fwd, mesh)
            self.coef, self.evals = Split(lay1, mesh), Split(lay2, mesh)
            self.omega = root_of_unity(log_n)
            self.n_inv = FR.scalar(pow(n, -1, R_MOD), device)
        else:
            self.plan = ntt.get_plan(log_n, device)
            self.coef = self.evals = Split(Layout(n, n, 1, 0))
            self.omega, self.n_inv = self.plan.omega, self.plan.n_inv

    @property
    def key(self):
        """(n, size, rank): which columns these are; None when whole."""
        return (self.n, self.mesh.size, self.mesh.rank) if self.sharded \
            else None

    def ntt(self, x):
        """Coefficients (coef columns) -> evaluations (evals columns)."""
        if not self.sharded:
            return ntt.ntt(self.plan, x)
        return four_step_ntt_sharded(self._fwd, self.mesh, x)

    def intt(self, x):
        """Evaluations (evals columns) -> coefficients (coef columns)."""
        if not self.sharded:
            return ntt.intt(self.plan, x)
        return four_step_intt_sharded(self._inv, self.mesh, x)

    def subcoset_tables(self):
        """`ops/ntt.SubcosetTables` of this rank's columns (whole when not
        sharded), cached per card."""
        if not self.sharded:
            return ntt.get_subcoset_tables(self.log_n, self.device)
        return ntt.get_subcoset_tables(self.log_n, self.device,
                                       self.coef.layout, self.evals.layout)


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
    return msm_windows_over_ranks(
        mesh, pts[mesh.rank * b:(mesh.rank + 1) * b],
        shard_last(mesh, raw_scalar_limbs), window_bits)


def msm_windows_over_ranks(mesh, pts, raw_scalar_limbs, window_bits):
    """The window points (4L, B, W) of B MSMs whose points and scalars are
    split over the ranks: this rank's points pts (m, 24) and its raw
    scalar limbs (16, B, m) of the same columns. `msm.msm_windows` on the
    rank's share; the window points are all-gathered and added in rank
    order, the same words on every rank."""
    wpts = torch.stack([msm.msm_windows(pts, raw_scalar_limbs[:, i],
                                        window_bits)
                        for i in range(raw_scalar_limbs.shape[1])], dim=1)
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
