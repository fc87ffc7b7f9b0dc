"""The port's field layer (`zprize_tpu_torch.fields`) against the JAX
package: the plain PyTorch versions of the kernels vs
`zprize_tpu.fields.mont` (XLA path on the CPU) and vs the Pallas kernels of
`zprize_tpu.fields.pkern` in interpret mode, and the powers, inversions
and selects built on them vs the JAX ones. Inputs come from a numpy
seed; every comparison is exact (integer field arithmetic)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_threads  # noqa: F401  (one torch thread)

from zprize_tpu.fields import mont as jmont
from zprize_tpu.fields import pkern
from zprize_tpu.fields.mont import FR as JFR, FQ as JFQ
from zprize_tpu_torch.fields import kernels, mont
from zprize_tpu_torch.fields.mont import FR, FQ

FIELDS = {"fr": (FR, JFR), "fq": (FQ, JFQ)}
N = 67          # ragged: not a multiple of any block width


def _ints(C, n, seed):
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(2 * C.L), "little") % C.mod
          for _ in range(n - 4)]
    return [0, 1, C.mod - 1, C.R % C.mod] + xs


def _pair(C, JC, seed):
    xs, ys = _ints(C, N, seed), _ints(C, N, seed + 1)
    ys[:4] = [C.mod - 1, 0, C.mod - 1, 1]
    a_np, b_np = JC.to_mont_host(xs), JC.to_mont_host(ys)
    return (xs, ys, a_np, b_np, torch.from_numpy(a_np.astype(np.int32)),
            torch.from_numpy(b_np.astype(np.int32)))


def _eq(t, j):
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_host_conversions_match(field):
    C, JC = FIELDS[field]
    xs = _ints(C, N, 3)
    assert np.array_equal(C.to_mont_host(xs), JC.to_mont_host(xs))
    assert C.from_mont_host(JC.to_mont_host(xs)) == xs
    assert np.array_equal(C.scalar_mont(xs[7]), JC.scalar_mont(xs[7]))
    t = C.tensor(xs, "cpu")
    assert t.dtype == torch.int32 and _eq(t, JC.to_mont_host(xs))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_plain_ops_match_jax_xla(field):
    C, JC = FIELDS[field]
    xs, ys, a_np, b_np, a, b = _pair(C, JC, 10)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    assert _eq(mont.mont_mul(C, a, b), jmont.mont_mul(JC, ja, jb))
    assert _eq(mont.add(C, a, b), jmont.add(JC, ja, jb))
    assert _eq(mont.sub(C, a, b), jmont.sub(JC, ja, jb))
    assert _eq(mont.neg(C, a), jmont.neg(JC, ja))
    assert _eq(mont.to_mont(C, a), jmont.to_mont(JC, ja))
    assert _eq(mont.from_mont(C, a), jmont.from_mont(JC, ja))
    M = C.mod
    assert C.from_mont_host(mont.mont_mul(C, a, b)) == \
        [x * y % M for x, y in zip(xs, ys)]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_plain_ops_match_pallas_interpret(field):
    C, JC = FIELDS[field]
    _, _, a_np, b_np, a, b = _pair(C, JC, 20)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    assert _eq(kernels.mul(C.P, a, b), pkern.mul(JC.K, ja, jb,
                                                 interpret=True))
    assert _eq(kernels.add(C.P, a, b), pkern.add(JC.K, ja, jb,
                                                 interpret=True))
    assert _eq(kernels.sub(C.P, a, b), pkern.sub(JC.K, ja, jb,
                                                 interpret=True))
    assert _eq(kernels.neg(C.P, a), pkern.neg(JC.K, ja, interpret=True))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mul3_matches_pallas_interpret(field):
    """K6's plain version against pkern.mul3 (both Montgomery reductions
    fused), with the edge values 0, 1, p - 1, R mod p in every operand."""
    C, JC = FIELDS[field]
    xs, ys, a_np, b_np, a, b = _pair(C, JC, 70)
    zs = _ints(C, N, 72)[::-1]
    c_np = JC.to_mont_host(zs)
    c = torch.from_numpy(c_np.astype(np.int32))
    got = kernels.mul3(C.P, a, b, c)
    assert _eq(got, pkern.mul3(JC.K, jnp.asarray(a_np), jnp.asarray(b_np),
                               jnp.asarray(c_np), interpret=True))
    assert C.from_mont_host(got) == [x * y * z % C.mod
                                     for x, y, z in zip(xs, ys, zs)]
    s = c[:, 5:6].contiguous()          # broadcast operand, period 1
    assert torch.equal(kernels.mul3(C.P, a, b, s),
                       kernels.mul(C.P, kernels.mul(C.P, a, b),
                                   s.expand_as(a).contiguous()))


def test_butterfly_stage_matches_pallas_mul_add_sub():
    """K5's plain version on one block (half = n: u = first half, v =
    second, w at step 1) equals pkern.mul_add_sub(u, v, w)."""
    _, _, u_np, v_np, u, v = _pair(FR, JFR, 30)
    _, _, w_np, _, w, _ = _pair(FR, JFR, 40)
    out = kernels.butterfly_stage(FR.P, torch.cat([u, v], dim=1), w, N, 1)
    hi, lo = pkern.mul_add_sub(JFR.K, jnp.asarray(u_np), jnp.asarray(v_np),
                               jnp.asarray(w_np), interpret=True)
    assert _eq(out[:, :N], hi) and _eq(out[:, N:], lo)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_broadcasting_matches_jax(field):
    C, JC = FIELDS[field]
    _, _, a_np, b_np, a, b = _pair(C, JC, 50)
    a3 = a[:, :60].reshape(C.L, 3, 20)
    b1 = b[:, :20].reshape(C.L, 1, 20)
    s = b[:, 5]
    ja3 = jnp.asarray(a_np[:, :60].reshape(C.L, 3, 20))
    jb1 = jnp.asarray(b_np[:, :20].reshape(C.L, 1, 20))
    assert _eq(mont.mont_mul(C, a3, b1), jmont.mont_mul(JC, ja3, jb1))
    assert _eq(mont.add(C, a3, s), jmont.add(JC, ja3, jnp.asarray(
        b_np[:, 5])))
    col = b[:, :3].reshape(C.L, 3, 1)
    assert _eq(mont.sub(C, a3, col), jmont.sub(
        JC, ja3, jnp.asarray(b_np[:, :3].reshape(C.L, 3, 1))))


@pytest.mark.parametrize("s,t", [
    ((), ()), ((3,), ()), ((), (1, 4)), ((3, 1), (1, 4)), ((2, 1, 5), (5,)),
    ((1,), (7,)), ((4, 3), (2, 3)), ((3,), (4,)), ((2, 1), (2, 3, 1))])
def test_broadcast_shapes_follows_torch(s, t):
    """`mont.broadcast_shapes` (which keeps a new process from importing
    torch.fx's symbolic shapes) gives torch.broadcast_shapes's shape, and
    refuses the shapes it refuses."""
    try:
        want = tuple(torch.broadcast_shapes(s, t))
    except RuntimeError:
        with pytest.raises(ValueError, match="do not broadcast"):
            mont.broadcast_shapes(s, t)
    else:
        assert mont.broadcast_shapes(s, t) == want


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_batch_inv_and_product_tree(field):
    C, JC = FIELDS[field]
    xs, _, a_np, _, a, _ = _pair(C, JC, 60)
    inv = mont.batch_inv(C, a)
    assert _eq(inv, jmont.batch_inv(JC, jnp.asarray(a_np)))
    assert C.from_mont_host(inv) == [pow(x, -1, C.mod) if x else 0
                                     for x in xs]
    nz = a[:, 1:]
    tot = mont.prod_tree_total(C, nz)
    assert _eq(tot, jmont.prod_tree_total(JC, jnp.asarray(a_np[:, 1:])))


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_counts()
    a = FR.tensor([1, 2, 3], "cpu")
    mont.mont_mul(FR, a, a)
    mont.neg(FR, a)
    assert not kernels.use_kernel(a)
    assert all(v == 0 for v in kernels.COUNTS.values())



def _eight(C, JC, seed):
    """Width-8 operands (0 in column 0, p - 1 in column 1) as port tensors
    and JAX arrays, with their ints."""
    xs = _ints(C, 12, seed)[4:]
    xs[0], xs[1] = 0, C.mod - 1
    a_np = JC.to_mont_host(xs)
    return xs, torch.from_numpy(a_np.astype(np.int32)), jnp.asarray(a_np)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_pow_fixed_matches_jax(field):
    C, JC = FIELDS[field]
    xs, a, ja = _eight(C, JC, 80)
    e = 0xB5_F00D_1234_5679
    bits = [e >> i & 1 for i in range(e.bit_length())]
    got = mont.mont_pow_fixed(C, a, bits)
    assert _eq(got, jmont.mont_pow_fixed(JC, ja, bits))
    assert C.from_mont_host(got) == [pow(x, e, C.mod) for x in xs]
    assert C.inv_exp_bits == JC.inv_exp_bits


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_inv_in_graph_matches_jax(field):
    """Units only: the device inversion spoils the batch on a zero, as the
    JAX one does."""
    C, JC = FIELDS[field]
    xs, a, ja = _eight(C, JC, 90)
    a, ja, xs = a[:, 1:], ja[:, 1:], xs[1:]
    got = mont.inv_in_graph(C, a)
    assert _eq(got, jmont.inv_in_graph(JC, ja))
    assert C.from_mont_host(got) == [pow(x, -1, C.mod) for x in xs]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_inv_select_eq_match_jax(field):
    C, JC = FIELDS[field]
    xs, a, ja = _eight(C, JC, 100)
    ys, b, jb = _eight(C, JC, 101)
    b[:, 3], jb = a[:, 3], jb.at[:, 3].set(ja[:, 3])
    got = mont.inv(C, a)
    assert _eq(got, jmont.inv(JC, ja))
    assert C.from_mont_host(got) == [pow(x, -1, C.mod) if x else 0
                                     for x in xs]
    assert _eq(mont.inv(C, a[:, 2]), jmont.inv(JC, ja[:, 2]))
    assert _eq(mont.inv(C, a[:, 0]), jmont.inv(JC, ja[:, 0]))
    mask = mont.eq(a, b)
    jmask = jmont.eq(ja, jb)
    assert mask.tolist() == np.asarray(jmask).tolist()
    assert mask.tolist() == [i in (0, 1, 3) for i in range(8)]
    assert _eq(mont.select(mask, a, b), jmont.select(jmask, ja, jb))
