"""Dense matrix algebra over Fr — clone of
`plonk-hashing/src/poseidon/matrix.rs` (rows of Python-int lists)."""

from ..params import R_MOD

M = R_MOD


def identity(n):
    return [[1 if i == j else 0 for j in range(n)] for i in range(n)]


def transpose(m):
    return [list(col) for col in zip(*m)]


def matmul(a, b):
    bt = transpose(b)
    return [[sum(x * y for x, y in zip(row, col)) % M for col in bt]
            for row in a]


def mul_col_vec(m, v):
    """(M v)_i = sum_j M[i][j] v[j]."""
    return [sum(mij * vj for mij, vj in zip(row, v)) % M for row in m]


def mul_row_vec_at_left(m, v):
    """(v M)_j = sum_i v[i] M[i][j] — matrix.rs `mul_row_vec_at_left` /
    `right_apply`."""
    n = len(m)
    return [sum(v[i] * m[i][j] for i in range(n)) % M for j in range(len(m[0]))]


def minor(m, i, j):
    return [[m[r][c] for c in range(len(m)) if c != j]
            for r in range(len(m)) if r != i]


def invert(m):
    """Gauss-Jordan inverse mod r; returns None if singular."""
    n = len(m)
    a = [row[:] + ident_row for row, ident_row in zip(
        [r[:] for r in m], identity(n))]
    col = 0
    for col in range(n):
        pivot = None
        for r in range(col, n):
            if a[r][col] != 0:
                pivot = r
                break
        if pivot is None:
            return None
        a[col], a[pivot] = a[pivot], a[col]
        inv_p = pow(a[col][col], -1, M)
        a[col] = [x * inv_p % M for x in a[col]]
        for r in range(n):
            if r != col and a[r][col] != 0:
                f = a[r][col]
                a[r] = [(x - f * y) % M for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def is_identity(m):
    return m == identity(len(m))


def is_sparse(m):
    """First row and column dense, interior identity (matrix.rs:107)."""
    return is_identity(minor(m, 0, 0))
