"""The measured window, the same for every system: on one device, or on
`ranks` devices as one spawned process a rank (`zprize_tpu_torch`'s
`parallel/mesh.spawn_cuda`, one NCCL rank a card).

Each process (or rank) first runs the set-up of the configuration's
system, `systems/<system>.py`: `setup(config, traffic, seed, dev, mesh)`
builds the seeded key, witnesses and SRS (on ranks, each rank's share of
them) and returns `prove(k)`, the bytes of a proof of witness k, which
holds what it needs and nothing else. One untimed proof of each witness
warms every shape the window uses (NTT plans, sub-coset tables). Then the
window (`inputs.drive`): after a synchronize (and a barrier of all ranks)
requests run one at a time, each witness in the mix's order and at its
arrival (in a closed loop, at once), while the mix says so (by default
until `seconds` have passed; the proof in flight finishes). A proof is
done when its bytes are on the host. Ranks stop together: before each
proof rank 0's answer decides for all. In a traced window each proof lies
between a "proof" and a "proof_end" mark (`trace.py`), so the harness's
own barriers and broadcasts fall outside every proof. Once the window has
closed, `prove` is dropped, and with it the key, witnesses and SRS.

`run` returns plain data: every rank's proofs, rank 0's requests with
their times, the window's wall and clock marks, the memory readings,
the forbidden modules each rank had loaded once its window closed and,
when traced, rank 0's `TraceData` and every rank's busy and traced
seconds."""

import functools
import gc
import importlib
import time

from . import inputs

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

    cuda = dev.type == "cuda"
    if hook is not None:
        undo.append(hook("setup"))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    system = importlib.import_module("portbench.systems." + config["system"])
    prove = system.setup(config, traffic, seed, dev, mesh)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    for k in range(traffic["witnesses"]):
        prove(k)
    tracer = None
    if trace:
        from .trace import Tracer
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
    del prof, prove
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from .harness import forbidden_modules
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
