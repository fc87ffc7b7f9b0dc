"""MDS matrix generation and sparse factorization — clone of
`plonk-hashing/src/poseidon/mds.rs` (neptune-derived Cauchy matrix)."""

from dataclasses import dataclass
from typing import List

from ..params import R_MOD
from . import matrix as mx

M = R_MOD


@dataclass
class MdsMatrices:
    m: list
    m_inv: list
    m_hat: list
    m_hat_inv: list
    m_prime: list
    m_double_prime: list


def generate_mds(t):
    xs = list(range(t))
    ys = list(range(t, 2 * t))
    return [[pow((x + y) % M, -1, M) for y in ys] for x in xs]


def _make_prime(m):
    t = len(m)
    out = []
    for i, row in enumerate(m):
        if i == 0:
            new_row = [0] * t
            new_row[0] = 1
        else:
            new_row = [0] + row[1:]
        out.append(new_row)
    return out


def _make_v_w(m):
    v = m[0][1:]
    w = [row[0] for row in m[1:]]
    return v, w


def _make_double_prime(m, m_hat_inv):
    t = len(m)
    v, w = _make_v_w(m)
    w_hat = mx.mul_row_vec_at_left(m_hat_inv, w)
    out = []
    for i, row in enumerate(m):
        if i == 0:
            out.append([row[0]] + v)
        else:
            new_row = [0] * t
            new_row[0] = w_hat[i - 1]
            new_row[i] = 1
            out.append(new_row)
    return out


def derive_mds_matrices(m):
    m_inv = mx.invert(m)
    m_hat = mx.minor(m, 0, 0)
    m_hat_inv = mx.invert(m_hat)
    m_prime = _make_prime(m)
    m_double_prime = _make_double_prime(m, m_hat_inv)
    return MdsMatrices(m, m_inv, m_hat, m_hat_inv, m_prime, m_double_prime)


def new_mds(t):
    return derive_mds_matrices(generate_mds(t))


@dataclass
class SparseMatrix:
    w_hat: List[int]   # first column of M''
    v_rest: List[int]  # first row of M'' sans first entry


def factor_to_sparse_matrixes(base_matrix, n):
    curr = [row[:] for row in base_matrix]
    sparse = []
    for _ in range(n):
        derived = derive_mds_matrices(curr)
        sparse.append(derived.m_double_prime)
        curr = mx.matmul(base_matrix, derived.m_prime)
    pre_sparse = curr
    sparse.reverse()
    out = [SparseMatrix(w_hat=[r[0] for r in s], v_rest=s[0][1:])
           for s in sparse]
    return pre_sparse, out
