"""Which tensors make up the device memory peak of one prove.

Around one prove of the Merkle circuit, `torch.cuda.memory` records
every allocation and free of the caching allocator
(`_record_memory_history`, no stacks), while a `TorchDispatchMode`
notes each operator's new output storages: address, shape, dtype, the
round it ran in (the rounds `prover_torch._round_marker` names) and the
line of the prover that called it. Replaying the allocator's trace gives
the peak and the blocks live at it; each block is matched by address to
the output that owns it. What was resident before the prove (SRS, key,
witness, NTT tables) is counted apart, by object where the set-up names
it. The snapshot stays in memory: no file is written. Prints one JSON
line.

Run: python3 -m zprize_tpu_torch.tools.mem_attr [--height 15]
"""

import argparse
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import ntt
from .cudatime import card, emit, require_cuda
from .merkle_setup import MerkleSetup

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROVER = os.path.join(PKG, "protocol", "prover_torch.py")
TOP = 16            # live blocks listed, largest first


def _site():
    """'file:line function' of the innermost frame of the prover module
    on the stack, else of the package (outside this tool)."""
    f = sys._getframe(2)
    inner = None
    while f is not None:
        fn = f.f_code.co_filename
        if fn == PROVER:
            return f"protocol/prover_torch.py:{f.f_lineno} {f.f_code.co_name}"
        if inner is None and fn.startswith(PKG) and fn != __file__:
            inner = (f"{os.path.relpath(fn, PKG)}:{f.f_lineno} "
                     f"{f.f_code.co_name}")
        f = f.f_back
    return inner


class _Outputs(TorchDispatchMode):
    """Per CUDA storage address, the outputs of the operators that
    allocated there: (op index, shape, dtype, round, site); and the op
    after which the most memory was allocated."""

    def __init__(self):
        super().__init__()
        self.round = 0
        self.labels = []
        self.n_ops = 0
        self.by_addr = {}
        self.most, self.peak_op = -1, 0

    def log(self, line):
        self.labels.append(line[len("prove "):].rsplit(":", 1)[0])
        self.round += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False) or func._schema.is_mutable:
            return out
        self.n_ops += 1
        site = None
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                site = site or _site()
                self.by_addr.setdefault(
                    t.untyped_storage().data_ptr(), []).append(
                    (self.n_ops, tuple(t.shape), str(t.dtype), self.round,
                     site))
        now = torch.cuda.memory_allocated()
        if now > self.most:
            self.most, self.peak_op = now, self.n_ops
        return out

    def owner(self, addr):
        """The output that held `addr` at the peak: the last one put there
        by the peak's op or the one after it (the trace's peak may fall
        inside that op)."""
        found = None
        for entry in self.by_addr.get(addr, ()):
            if entry[0] > self.peak_op + 1:
                break
            found = entry
        return found


def _resident(setup):
    """Bytes of the set-up's tensors on the device, by object; a storage
    counts once, in the first object that holds it."""
    seen = set()

    def size(ts):
        tot = 0
        for t in ts:
            s = t.untyped_storage()
            if s.data_ptr() not in seen:
                seen.add(s.data_ptr())
                tot += s.nbytes()
        return tot

    def tensors(obj):
        for v in vars(obj).values():
            for t in (v.values() if isinstance(v, dict) else
                      v if isinstance(v, (list, tuple)) else (v,)):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    yield t
    pk, srs = setup.pk, setup.dev_srs
    plan = ntt.get_plan(pk.log_n, setup.lay.device)
    # a four-step plan's sub-plans hold their own radix-2 tables
    plans = [plan] if plan.p1 is None else [plan, plan.p1, plan.p2]
    sct = ntt.get_subcoset_tables(pk.log_n, setup.lay.device)
    return {
        "layout": size(tensors(setup.lay)),
        "srs_points": size(list(srs.points[:2]) + [srs.packed]),
        "key_selectors": size(pk.sel_poly.values()),
        "key_sigmas": size(pk.sigma_poly + pk.sigma_evals_n),
        "key_tables": size(pk.table_cols),
        "witness": size(setup.witness.wires_dev),
        "ntt_tables": size([t for p in plans for t in tensors(p)]
                           + list(tensors(sct))),
    }


def _replay(trace):
    """Allocator trace -> (peak bytes above the start, blocks live at the
    peak {addr: size}, the trace index of the peak)."""
    live, cur, peak, at, best = {}, 0, 0, -1, {}
    for i, e in enumerate(trace):
        act = e["action"]
        if act == "alloc":
            live[e["addr"]] = e["size"]
            cur += e["size"]
            if cur > peak:
                peak, at = cur, i
                best = None
        elif act in ("free_requested", "free_completed"):
            size = live.pop(e["addr"], None)
            if size is not None:
                if best is None:
                    best = dict(live)
                    best[e["addr"]] = size
                cur -= size
    if best is None:
        best = dict(live)
    return peak, best, at


def measure(setup):
    """The peak of one prove of `setup` and the largest blocks live at it
    -> dict. The process should have proved once already, so the NTT and
    sub-coset tables count as resident."""
    require_cuda()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    outs = _Outputs()
    torch.cuda.memory._record_memory_history(enabled="all", context=None,
                                             stacks="python")
    try:
        with outs:
            setup.prove(log=outs.log)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    peak, live, _ = _replay(trace)
    rows = []
    for addr, size in live.items():
        owner = outs.owner(addr)
        row = {"bytes": size}
        if owner is not None:
            _, shape, dtype, rnd, site = owner
            row.update(shape=list(shape), dtype=dtype,
                       round=(outs.labels[rnd] if rnd < len(outs.labels)
                              else "after the last round"),
                       site=site)
        rows.append(row)
    rows.sort(key=lambda r: -r["bytes"])
    by_round = {}
    for r in rows:
        k = r.get("round", "unmatched")
        by_round[k] = by_round.get(k, 0) + r["bytes"]
    resident = _resident(setup)
    resident["other"] = base - sum(resident.values())
    return {"card": card(), "height": setup.lay.height, "n": setup.lay.n,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "resident_before_prove": base, "resident": resident,
            "peak_from_trace": base + peak, "live_at_peak": len(rows),
            "live_bytes_by_round": by_round, "largest": rows[:TOP],
            "trace_entries": len(trace)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=15)
    args = ap.parse_args()
    require_cuda()
    setup = MerkleSetup.build(args.height)
    setup.prove()
    emit({"mem_attr": measure(setup)})
