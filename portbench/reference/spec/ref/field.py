"""Scalar-field helpers over Python ints (mod-r and mod-q arithmetic).

Oracle counterpart of the CUDA Montgomery field layer
(`lib/PLONK/utils/mont/cuda/ff/mont_t.cuh`) and the blst CPU fallback.
Values are canonical Python ints in [0, mod).
"""

from ..params import R_MOD, Q_MOD, FR_GENERATOR, FR_TWO_ADICITY, FR_TWO_ADIC_ROOT


def fr_add(a, b):
    return (a + b) % R_MOD


def fr_sub(a, b):
    return (a - b) % R_MOD


def fr_mul(a, b):
    return (a * b) % R_MOD


def fr_neg(a):
    return (-a) % R_MOD


def fr_inv(a):
    return pow(a, -1, R_MOD)


def fr_pow(a, e):
    return pow(a, e, R_MOD)


def fr_batch_inv(xs):
    """Montgomery batched inversion: one field inversion for the whole list."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % R_MOD
    inv_all = pow(prefix[n], -1, R_MOD)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R_MOD
        inv_all = inv_all * xs[i] % R_MOD
    return out


def root_of_unity(log_n: int) -> int:
    """2^log_n-th primitive root of unity in Fr."""
    assert log_n <= FR_TWO_ADICITY
    w = FR_TWO_ADIC_ROOT
    for _ in range(FR_TWO_ADICITY - log_n):
        w = w * w % R_MOD
    return w


def fq_add(a, b):
    return (a + b) % Q_MOD


def fq_mul(a, b):
    return (a * b) % Q_MOD


def fq_inv(a):
    return pow(a, -1, Q_MOD)
