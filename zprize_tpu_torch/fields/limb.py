"""Host-side conversions between Python ints and 16-bit limb arrays.

The TPU representation: uint32 arrays of shape (..., L) holding 16-bit limbs
little-endian (L=16 for Fr/256b, L=24 for Fq/384b). 16-bit limbs make every
limb product exact in uint32 and keep column sums far below 2^32 — the TPU
counterpart of the reference's 32-bit-limb CUDA `mont_t` (`mont_t.cuh:31`).
"""

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, L: int) -> np.ndarray:
    out = np.zeros(L, dtype=np.uint32)
    for i in range(L):
        out[i] = (x >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def ints_to_limbs(xs, L: int) -> np.ndarray:
    """int-list -> (n, L) uint32 via LE byte packing (no per-limb Python)."""
    n = len(xs)
    nbytes = 2 * L
    buf = b"".join(x.to_bytes(nbytes, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u2").reshape(n, L).astype(np.uint32)


def limbs_to_int(limbs) -> int:
    limbs = np.asarray(limbs)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))


def limbs_to_ints(arr) -> list:
    """(n, L) uint32 16-bit limbs -> list of ints via LE byte packing."""
    arr = np.asarray(arr)
    assert arr.ndim == 2
    n, L = arr.shape
    buf = arr.astype("<u2").tobytes()
    w = 2 * L
    return [int.from_bytes(buf[i * w:(i + 1) * w], "little")
            for i in range(n)]
