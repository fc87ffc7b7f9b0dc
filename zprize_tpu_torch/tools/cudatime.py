"""CUDA-event timing shared by the tools and `chip_smoke.py`, and the card
a number was taken on. Every function here needs a CUDA device; none
falls back to the CPU."""

import json
import subprocess

import torch


def require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the measuring tools "
                           "time the card and have no CPU mode")


def card():
    """`nvidia-smi --query-gpu=name,power.limit` of card 0 (name and power
    limit, as every kept number must carry)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi gave no answer"


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps):
    """(ms per call over `reps` calls, the output of a first call). A
    second untimed call lets the allocator cache the block that the timed
    calls reuse while the first output is held."""
    out = fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def stage(times, name, fn):
    """Run `fn` between two CUDA events, synchronize, and append its ms to
    times[name]; returns its output."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    times.setdefault(name, []).append(a.elapsed_time(b))
    return out


def median(xs):
    return sorted(xs)[len(xs) // 2]
