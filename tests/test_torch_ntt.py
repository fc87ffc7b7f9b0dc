"""The port's NTT and polynomial layer (`zprize_tpu_torch.ops.ntt`,
`ops.poly`) against the JAX package: transforms at every size 2^4..2^13
against the executable spec's domain (`zprize_tpu.ref.domain`, which the
JAX NTT is pinned to; the sizes cross the JAX package's four-step threshold
`FOUR_STEP_MIN_LOG` = 13), against `zprize_tpu.ops.ntt` itself, and the
sub-coset tables array for array. Exact comparisons."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from zprize_tpu.fields.mont import FR as JFR
from zprize_tpu.ops import ntt as jntt
from zprize_tpu.ops import poly as jpoly
from zprize_tpu.ref.domain import Domain, poly_divide_linear, poly_eval
from zprize_tpu_torch.fields.mont import FR
from zprize_tpu_torch.ops import ntt, poly

M = FR.mod


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % M for _ in range(n)]


def _eq(t, j):
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


@pytest.mark.parametrize("log_n", range(4, 14))
def test_ntt_matches_spec_domain(log_n):
    n = 1 << log_n
    xs = _ints(n, log_n)
    d = Domain(n)
    plan = ntt.get_plan(log_n, "cpu")
    a = FR.tensor(xs, "cpu")
    ev = ntt.ntt(plan, a)
    assert FR.from_mont_host(ev) == d.fft(xs)
    assert FR.from_mont_host(ntt.intt(plan, ev)) == xs
    assert FR.from_mont_host(ntt.coset_ntt(plan, a)) == d.coset_fft(xs)
    back = ntt.coset_intt(plan, ntt.coset_ntt(plan, a))
    assert FR.from_mont_host(back) == xs


def test_ntt_matches_jax_ntt():
    """Against zprize_tpu.ops.ntt itself on a small batch. (Its four-step
    sizes, 2^13 and up, take over a minute to compile on a CPU; they are
    pinned to the same spec domain as the test above.)"""
    log_n = 5
    xs = _ints(3 << log_n, 113)
    a_np = JFR.to_mont_host(xs).reshape(JFR.L, 3, 1 << log_n)
    want = jntt.ntt(jntt.get_plan(log_n), jnp.asarray(a_np))
    got = ntt.ntt(ntt.get_plan(log_n, "cpu"),
                  torch.from_numpy(a_np.astype(np.int32)))
    assert _eq(got, want)


def test_subcoset_tables_match_jax():
    j = jntt.get_subcoset_tables(4)
    t = ntt.get_subcoset_tables(4, "cpu")
    assert t.shifts == j.shifts
    for k in ("shift_pows", "shift_inv_pows", "roots", "vh_inv",
              "combine_c"):
        assert _eq(getattr(t, k), getattr(j, k)), k


def test_powers_match_jax():
    x = 0x1234567890ABCDEF
    want = jpoly.powers(JFR, jnp.asarray(JFR.scalar_mont(x)), 37)
    assert _eq(poly.powers(FR, FR.scalar(x, "cpu"), 37), want)


@pytest.mark.parametrize("n", [5, 1024, 3001])
def test_prefix_product_and_eval(n):
    """Blocked scan (one block, and several blocks with a ragged tail)."""
    xs = _ints(n, n)
    a = FR.tensor(xs, "cpu")
    got = FR.from_mont_host(poly.prefix_product(FR, a, shift_one=True))
    want, acc = [], 1
    for x in xs:
        want.append(acc)
        acc = acc * x % M
    assert got == want
    z = xs[-1]
    pows = poly.powers(FR, FR.scalar(z, "cpu"), n)
    assert FR.from_mont_host(poly.poly_eval(FR, a, pows)[:, None]) == \
        [poly_eval(xs, z)]


@pytest.mark.parametrize("n", [7, 2500])
def test_divide_linear_matches_spec(n):
    cs = _ints(n, 7 * n)
    z = cs[3]
    q, r = poly.divide_linear(FR, FR.tensor(cs, "cpu"), FR.scalar(z, "cpu"))
    assert FR.from_mont_host(q) == poly_divide_linear(cs, z)
    assert FR.from_mont_host(r[:, None]) == [poly_eval(cs, z)]
