"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU. Without a card and without an explicit "cpu" they raise;
they never carry on quietly on the CPU."""

import torch


def resolve(device=None) -> torch.device:
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d


def canonical(device) -> torch.device:
    """`device` with its CUDA index filled in (a bare "cuda" is the
    current card), so a cache keyed by it holds one entry per card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d
