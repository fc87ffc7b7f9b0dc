"""Batch proving — the port of `zprize_tpu/protocol/batch.py`: many
witnesses of one preprocessed circuit, sequentially on one device or
spread over several, one process a device.

The JAX package proves on several devices from one thread a device: JAX
dispatch is asynchronous and releases the interpreter lock, so the
devices' programs overlap. The port first copied that design, and it did
not keep that promise: a proof here drives ~18k kernel launches through
Python code that holds the interpreter lock. With four threads over four
H100s, each thread spent over a third of its proving time off the CPU,
waiting for the lock, and a proof took twice the host CPU seconds it
takes alone; the cards were not the limit (`PERF.md`). So with several
devices, device k gets a spawned process of its own
(`parallel.mesh.run_processes`), which copies the key, the SRS and its
witnesses to its device, proves the witnesses i = k (mod len(devices))
in order and hands back their bytes. On a card the tensors pass as IPC
handles, so each process copies them from the caller's card to its own;
on the CPU they pass as shared memory. Proofs are byte-identical to
sequential ones: only placement differs.
"""

import copy
import math
import pickle
import time
import traceback

import torch

from ..device import canonical, resolve
from ..fields import kernels
from ..parallel import mesh as pmesh
from .prover_torch import ProverConfig, prove_torch
from .serde import deserialize_proof, serialize_proof


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def _replica(obj, device):
    """Shallow copy of a key, SRS or witness with every tensor on
    `device` (tensors already there are shared, not copied)."""
    r = copy.copy(obj)
    r.__dict__.update({k: _to(v, device) for k, v in obj.__dict__.items()})
    return r


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prove_on(device, witnesses, dev_pk, dev_srs, base_transcript, cfg,
              t0):
    """Every proof of `witnesses`, in order, on `device`, against a
    replica of the key and SRS there (each witness is copied there when
    its proof starts). Returns the proofs and this device's numbers:
    seconds from t0 (time.time()) until the replicas are in place, then
    each proof's wall and host CPU seconds."""
    pk, srs = _replica(dev_pk, device), _replica(dev_srs, device)
    if cfg is None:
        cfg = ProverConfig(device=device)
    else:
        cfg = copy.copy(cfg)
        cfg.device = device
    _sync(device)
    stats = {"device": str(device), "start_s": time.time() - t0,
             "prove_s": [], "cpu_s": []}
    proofs = []
    for w in witnesses:
        t, c = time.time(), time.thread_time()
        proofs.append(prove_torch(_replica(w, device), pk, srs,
                                  base_transcript.clone(), cfg))
        _sync(device)
        stats["prove_s"].append(time.time() - t)
        stats["cpu_s"].append(time.thread_time() - c)
    return proofs, stats


def _worker(k, device, witnesses, dev_pk, dev_srs, base_transcript, cfg,
            t0, results):
    """Process k of `prove_many`: its proofs' bytes, its numbers and its
    kernel launches, or its traceback."""
    try:
        if device.type == "cuda":
            try:
                torch.cuda.set_device(device)
            except RuntimeError as e:
                raise RuntimeError(f"prove_many: worker {k} cannot reach "
                                   f"card {device}") from e
        else:
            # one thread a process, as the ranks of parallel.mesh
            torch.set_num_threads(1)
        kernels.reset_counts()
        proofs, stats = _prove_on(device, witnesses, dev_pk, dev_srs,
                                  base_transcript, cfg, t0)
        stats["launches"] = dict(kernels.COUNTS)
        msg = (k, True, pickle.dumps(
            ([serialize_proof(p) for p in proofs], stats)))
    except Exception:
        msg = (k, False, traceback.format_exc())
    pmesh.put_result(results, msg)


def _devices(devices):
    """The devices asked for, each CUDA one with its card number; raises
    naming a card this machine does not have."""
    devs = [torch.device(d) for d in devices]
    have = torch.cuda.device_count()
    for d in devs:
        if d.type == "cuda" and (d.index or 0) >= have:
            raise ValueError(f"prove_many: device {d} is not on this "
                             f"machine, which has {have} cards")
    return [canonical(resolve(d)) for d in devs]


def prove_many(witnesses, dev_pk, dev_srs, base_transcript, cfg=None,
               devices=None, stats=None):
    """Prove a batch of witnesses against one preprocessed circuit; each
    proof starts from `base_transcript.clone()`.

    devices: None proves in this process with `cfg` (the reference's
    repeat loop), as does a list of one device, on it. With several
    devices, device k proves witnesses k, k + D, ... (D = len(devices))
    in a spawned process of its own, against its own replica of the key
    and SRS: `witnesses`, the key, the SRS, the transcript and `cfg` must
    pickle, and `cfg` takes no mesh. A process that raises, dies or is
    still running after `mesh.TIMEOUT_S` seconds for its start and as
    much again for each of its proofs is named in the error; every
    process is ended before this returns or raises.
    stats: an optional list; it receives one dict a device (one in all
    without `devices`): "device", "start_s" (seconds from the call's
    start until the replicas are in place), the "prove_s" and "cpu_s"
    (host CPU seconds of the proving thread) of each proof, and, from a
    spawned process, its kernel "launches".

    Returns (proofs, wall_seconds, proofs_per_second)."""
    t0 = time.time()
    if devices is not None and len(devices) > 1:
        if cfg is not None and cfg.mesh is not None:
            raise ValueError("prove_many over devices takes no mesh")
        devs = _devices(devices)
        D = len(devs)
        cards = any(d.type == "cuda" for d in devs)
        if cards:
            # the card of this process is shared with a worker: hand back
            # what the allocator caches, and let the copies read finished
            # tensors
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        # the key, SRS and witnesses stay referenced here until every
        # process has ended
        outs = pmesh.run_processes(
            "prove_many", _worker,
            [(d, witnesses[k::D], dev_pk, dev_srs, base_transcript, cfg, t0)
             for k, d in enumerate(devs)],
            pmesh.TIMEOUT_S * (1 + math.ceil(len(witnesses) / D)),
            what="worker", where=[str(d) for d in devs])
        if cards:
            # free what the processes have released
            torch.cuda.ipc_collect()
        proofs = [None] * len(witnesses)
        for k, (blobs, _) in enumerate(outs):
            proofs[k::D] = [deserialize_proof(b) for b in blobs]
        per_device = [one for _, one in outs]
    else:
        if devices:
            device = canonical(resolve(devices[0]))
        else:
            device = cfg.device if cfg is not None else resolve(None)
        proofs, one = _prove_on(device, witnesses, dev_pk, dev_srs,
                                base_transcript, cfg, t0)
        per_device = [one]
    if stats is not None:
        stats.extend(per_device)
    wall = time.time() - t0
    return proofs, wall, len(witnesses) / wall if wall > 0 else float("inf")
