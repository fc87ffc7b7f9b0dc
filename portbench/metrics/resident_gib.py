"""resident_gib: `torch.cuda.memory_allocated` at the window's start, in
GiB, on the fullest card: the key, both witnesses, the SRS and the NTT
and sub-coset tables that every proof reads. Layer: device memory."""

UNIT, LAYER, MOVES = "GiB", "device memory", "peak_mem_gib"


def read(run):
    if run.resident_bytes is None:
        return None
    return run.resident_bytes / 2.0 ** 30
