"""The system under test for the Merkle configurations: the port's
`prove_torch` on one card, or on `ranks` cards as a sharded prover
(`ProverConfig(mesh=...)`, one spawned NCCL rank a card).

Each device (or rank) builds the seeded set-up through the port's entry
points (`MerkleLayout`, `device_srs` with the run's tau,
`preprocess_layout`, `MerkleLayout.witness` of each witness's leaves);
ranks then keep only their columns (`shard`) and drop the whole. One
untimed proof of each witness warms every shape the window uses (NTT
plans, sub-coset tables). Then the window (`inputs.drive`): after a
synchronize (and a barrier of all ranks) requests run one at a time, each
witness in the mix's order and at its arrival (in a closed loop, at
once), each proof from a clone of the key's seeded transcript, while the
mix says so (by default until `seconds` have passed; the proof in flight
finishes). A proof is done when its bytes are on the host. Ranks stop
together: before each proof rank 0's answer decides for all. In a traced
window each proof lies between a "proof" and a "proof_end" mark
(`trace.py`), so the harness's own barriers and broadcasts fall outside
every proof.

`run` returns plain data: every rank's proofs, rank 0's requests with
their times, the window's wall and clock marks, the memory readings,
the forbidden modules each rank had loaded once its window closed and,
when traced, rank 0's `TraceData` and every rank's busy and traced
seconds."""

import functools
import gc
import time

from .. import inputs

LABEL = b"Merkle tree"
# seconds a spawned rank may take in all before it is killed
RANK_TIMEOUT_S = 330


def run(config, traffic, seed, seconds, trace, device, hook=None):
    """Run the cell; `traffic` is its `inputs.Mix`, `device` "cuda" (or
    "cpu" for a rehearsal). `hook`,
    when given, is called in every proving process as hook("setup")
    before its set-up and hook("window") right before its window (the
    control and the tests break the timed path with it); what it returns
    is called after the window to undo it."""
    ranks = config["ranks"]
    if ranks == 1:
        return _gather(None, _session(None, config, traffic, seed, seconds,
                                      trace, device, hook))
    from zprize_tpu_torch.parallel import mesh as pmesh
    spawn = pmesh.spawn_cuda if device == "cuda" else pmesh.spawn_cpu
    out = spawn(_rank, ranks, config, traffic, seed, seconds, trace, hook,
                timeout_s=RANK_TIMEOUT_S)
    return out[0] if isinstance(out, list) else out


def _rank(mesh, config, traffic, seed, seconds, trace, hook):
    return _gather(mesh, _session(mesh, config, traffic, seed, seconds,
                                  trace, mesh.device.type, hook))


def _gather(mesh, mine):
    """Rank 0's result with every rank's proofs, memory, busy and traced
    seconds, and the forbidden modules each had loaded."""
    trace = mine.pop("trace")
    mine["busy_s"] = trace.busy_s if trace else None
    mine["traced_s"] = trace.window_s if trace else None
    every = [mine]
    if mesh is not None:
        import torch.distributed as dist
        every = [None] * mesh.size
        dist.all_gather_object(every, mine)
        if mesh.rank:
            return None
    out = {key: [r[key] for r in every]
           for key in ("proofs", "peak_bytes", "resident_bytes", "busy_s",
                       "traced_s", "forbidden")}
    out.update(ranks=len(every), window_s=mine["window_s"],
               window_t0=mine["window_t0"], requests=mine["requests"],
               trace=trace)
    return out


def _session(mesh, config, traffic, seed, seconds, trace, device, hook):
    import torch
    dev = mesh.device if mesh is not None else torch.device(device)
    undo = []
    try:
        return _prove_window(mesh, config, traffic, seed, seconds, trace,
                             dev, hook, undo)
    finally:
        for fn in undo:
            if fn is not None:
                fn()


def _prove_window(mesh, config, traffic, seed, seconds, trace, dev, hook,
                  undo):
    import torch
    from zprize_tpu_torch.params import R_MOD
    from zprize_tpu_torch.fields.mont import FR
    from zprize_tpu_torch.merkle.layout import MerkleLayout
    from zprize_tpu_torch.merkle.preprocess import preprocess_layout
    from zprize_tpu_torch.ops import ntt
    from zprize_tpu_torch.protocol import prover_torch as pt
    from zprize_tpu_torch.protocol.serde import serialize_proof
    from zprize_tpu_torch.protocol.srs import device_srs
    from zprize_tpu_torch.protocol.transcript_protocol import \
        TranscriptProtocol

    cuda = dev.type == "cuda"
    if hook is not None:
        undo.append(hook("setup"))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    lay = MerkleLayout(config["height"], device=dev)
    pts, lite, _ = device_srs(lay.n + 8, tau=inputs.tau(seed), device=dev)
    dev_srs = pt.DevSRS(pts, lite)
    del pts
    base = TranscriptProtocol(LABEL)
    pk, _vk = preprocess_layout(lay, dev_srs, base, pt.ProverConfig(
        device=dev))
    witnesses = []
    for leaves in inputs.leaf_sets(seed, traffic["witnesses"],
                                   lay.m_leaves):
        wires, root, _ = lay.witness(FR.tensor(leaves, dev))
        witnesses.append(pt.ProverWitness(
            wires, {lay.root_gate_pos: (-root) % R_MOD}))
        del wires
    n = lay.n
    del lay
    if mesh is not None:
        pk = pk.shard(mesh)
        dev_srs = dev_srs.shard(mesh, n)
        witnesses = [w.shard(mesh) for w in witnesses]
        ntt.clear_caches()
        cfg = pt.ProverConfig(mesh=mesh)
    else:
        cfg = pt.ProverConfig(device=dev)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    def prove(k):
        return serialize_proof(pt.prove_torch(witnesses[k], pk, dev_srs,
                                              base.clone(), cfg))

    for k in range(len(witnesses)):
        prove(k)
    tracer = None
    if trace:
        from ..trace import Tracer
        tracer = Tracer()
        tracer.find_marker_name()
    if hook is not None:
        undo.append(hook("window"))
    sync()
    resident = torch.cuda.memory_allocated(dev) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    prof = None
    if tracer:
        tracer.install()
        prof = tracer.profiler()
        prof.__enter__()

    def serve(k):
        if tracer:
            tracer.mark("proof")
        answer = prove(k).hex()
        if tracer:
            tracer.mark("proof_end")
        return answer

    try:
        sync()
        if mesh is not None:
            _barrier(mesh)
        t0, requests = inputs.drive(
            traffic, seed, seconds, serve,
            None if mesh is None else functools.partial(_agree, mesh))
        sync()
        if mesh is not None:
            _barrier(mesh)
        t1 = time.monotonic()
    finally:
        if tracer:
            prof.__exit__(None, None, None)
            tracer.uninstall()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    data = tracer.reduce(prof, t1 - t0, len(requests)) if tracer else None
    del prof, witnesses, pk, dev_srs, base
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from ..harness import forbidden_modules
    return {"proofs": [(r[0], r[4]) for r in requests],
            "requests": [r[:4] for r in requests],
            "window_s": t1 - t0, "window_t0": t0, "peak_bytes": peak,
            "resident_bytes": resident, "trace": data,
            "forbidden": forbidden_modules()}


def _barrier(mesh):
    import torch
    import torch.distributed as dist
    dist.barrier()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _agree(mesh, go):
    """Rank 0's `go`, on every rank."""
    import torch
    import torch.distributed as dist
    flag = torch.tensor([1 if go else 0], dtype=torch.int32,
                        device=mesh.device)
    dist.broadcast(flag, 0)
    return bool(flag.item())
