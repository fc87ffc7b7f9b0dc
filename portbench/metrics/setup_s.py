"""setup_s: from the process's start (the first line of `run.py`) to the
window's start: imports, the kernel library's load (its nvcc build in a
fresh checkout), the SRS, layout, key and witnesses, sharding, and one
warm-up proof of each witness. For ranks, to rank 0's window start."""

UNIT = "s"


def read(run):
    return run.setup_s
