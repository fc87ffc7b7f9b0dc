"""peak_mem_gib: `torch.cuda.max_memory_allocated` over the window (reset
at its start), in GiB, on the fullest card. It sets the largest circuit a
card can prove."""

UNIT = "GiB"


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2.0 ** 30
