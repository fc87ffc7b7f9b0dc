"""Batch proving — the port of `zprize_tpu/protocol/batch.py`: many
witnesses of one preprocessed circuit, sequentially on one device or one
proof per device at a time across several.

With `devices`, proof i runs on devices[i % len(devices)] in that device's
own thread, against its own replica of the key and SRS. Kernel launches
release the interpreter lock, so the devices' work overlaps while the host
runs the transcript of each proof in turn. Proofs are byte-identical to
sequential ones: only placement differs.
"""

import copy
import contextlib
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .prover_torch import ProverConfig, prove_torch


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


def _on(device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def prove_many(witnesses, dev_pk, dev_srs, base_transcript, cfg=None,
               devices=None):
    """Prove a batch of witnesses against one preprocessed circuit; each
    proof starts from `base_transcript.clone()`.

    devices: None proves sequentially with `cfg` (the reference's repeat
    loop); a list of devices places proof i on devices[i % len(devices)],
    with one thread and one key/SRS replica per device.

    Returns (proofs, wall_seconds, proofs_per_second)."""
    proofs = [None] * len(witnesses)
    t0 = time.time()
    if not devices:
        for i, w in enumerate(witnesses):
            proofs[i] = prove_torch(w, dev_pk, dev_srs,
                                    base_transcript.clone(), cfg)
    else:
        cfg = cfg or ProverConfig()
        devs = [torch.device(d) for d in devices]
        pks = [_replica(dev_pk, d) for d in devs]
        srss = [_replica(dev_srs, d) for d in devs]
        cfgs = []
        for d in devs:
            c = copy.copy(cfg)
            c.device = d
            cfgs.append(c)

        def run(k):
            # the proofs of device k, in order, in this device's thread
            with _on(devs[k]):
                for i in range(k, len(witnesses), len(devs)):
                    proofs[i] = prove_torch(
                        _replica(witnesses[i], devs[k]), pks[k], srss[k],
                        base_transcript.clone(), cfgs[k])

        with ThreadPoolExecutor(max_workers=len(devs)) as ex:
            for f in [ex.submit(run, k) for k in range(len(devs))]:
                f.result()
    wall = time.time() - t0
    return proofs, wall, len(witnesses) / wall if wall > 0 else float("inf")
