"""The port's NTT and polynomial layer (`zprize_tpu_torch.ops.ntt`,
`ops.poly`) against the JAX package: transforms at every size 2^4..2^15
against the executable spec's domain (`zprize_tpu.ref.domain`, which the
JAX NTT is pinned to; from 2^13, `FOUR_STEP_MIN_LOG`, both packages run
the four-step, at 2^14 on a square split and at 2^15 on an unequal one),
against `zprize_tpu.ops.ntt` itself, the sub-coset tables array for
array, the four-step plan's mid twiddles, K5's plain version with a lane
stride, and the fused NTT pass's plain version against the chain of K5
stages, gather, twiddle product and transpose it replaces. With the
port's threshold lowered to 2^3 (`low_threshold`) the four-step and
nested-split branches run at sizes where the JAX package runs radix-2
and compiles in seconds; there they are held to the JAX transforms, and
the port's proof of the dry-run circuit (n = 16, every transform
four-step) to the spec's bytes. Exact comparisons."""


import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_threads  # noqa: F401  (one torch thread)

from zprize_tpu.circuit.composer import StandardComposer as JaxComposer
from zprize_tpu.fields.mont import FR as JFR
from zprize_tpu.ops import ntt as jntt
from zprize_tpu.ops import poly as jpoly
from zprize_tpu.protocol.serde import deserialize_proof, \
    serialize_proof as jax_serialize
from zprize_tpu.protocol.transcript_protocol import TranscriptProtocol
from zprize_tpu.ref import prover as rp
from zprize_tpu.ref.domain import Domain, poly_divide_linear, poly_eval
from zprize_tpu.ref.field import root_of_unity
from zprize_tpu.ref.verifier import verify
from zprize_tpu_torch.circuit import StandardComposer
from zprize_tpu_torch.entry import dryrun_circuit
from zprize_tpu_torch.fields import kernels, mont
from zprize_tpu_torch.fields.mont import FR
from zprize_tpu_torch.ops import ntt, poly
from zprize_tpu_torch.params import FR_GENERATOR
from zprize_tpu_torch.protocol import prover_torch as pt
from zprize_tpu_torch.protocol.serde import serialize_proof
from zprize_tpu_torch.protocol.transcript_protocol import \
    TranscriptProtocol as PortTranscript
from zprize_tpu_torch.ref import prover as port_rp

M = FR.mod


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % M for _ in range(n)]


def _eq(t, j):
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


@pytest.mark.parametrize("log_n", list(range(4, 16)))
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


# ---------------------------------------------------------------------------
# the four-step plan and K5 with a lane stride
# ---------------------------------------------------------------------------

@pytest.fixture
def low_threshold(monkeypatch):
    """The port's four-step threshold at 2^3: from n = 8 every plan is
    four-step, and from n = 32 the n2 side is too (the nested split).
    Plans are rebuilt before and after."""
    ntt.clear_caches()
    monkeypatch.setattr(ntt, "FOUR_STEP_MIN_LOG", 3)
    yield
    monkeypatch.undo()
    ntt.clear_caches()


def _times_powers(xs, g, n):
    """x * g^i mod r along the last of (..., n) Python ints, flattened."""
    return [x * pow(g, i % n, M) % M for i, x in enumerate(xs)]


def _jax_inverse_plan(jplan):
    """The JAX plan with its forward and inverse stage twiddles swapped:
    its `ntt` runs the JAX INTT's stages (`_core` on `stage_inv_pows`)
    through the program already compiled for the forward transform, so
    only the INTT's closing 1/n product is left (each compile of a JAX
    transform takes 5-10 s on a CPU)."""
    p = copy.copy(jplan)
    p.stage_pows, p.stage_inv_pows = jplan.stage_inv_pows, jplan.stage_pows
    return p


@pytest.mark.parametrize("log_n", range(4, 9))
def test_four_step_branches_match_jax_ntt(low_threshold, log_n):
    """ntt, intt, coset_ntt and coset_intt of a seeded (L, 3, n) batch
    through the four-step (and from 2^5 the nested split) against the JAX
    package's radix-2 transforms of the same input: `jntt.ntt`, and the
    JAX INTT as `jntt.ntt` on the swapped plan times 1/n (at 2^4 also
    held to `jntt.intt`). The coset variants are held to the JAX NTT of x
    * g^i and to the JAX INTT times g^-i. Every product outside the JAX
    transforms is taken with Python ints."""
    n = 1 << log_n
    plan = ntt.get_plan(log_n, "cpu")
    assert plan.p1 is not None and plan.tw is None
    assert (plan.p2.p1 is not None) == (log_n >= 5)
    jplan = jntt.get_plan(log_n)
    xs = _ints(3 * n, 300 + log_n)
    a = FR.tensor(xs, "cpu").reshape(FR.L, 3, n)

    def jax_ntt(p, ints):
        x = JFR.to_mont_host(ints).reshape(JFR.L, 3, n)
        return JFR.from_mont_host(
            np.asarray(jntt.ntt(p, jnp.asarray(x))).reshape(JFR.L, -1))

    def port(t):
        return FR.from_mont_host(t.reshape(FR.L, -1))

    g, n_inv = FR_GENERATOR, pow(n, -1, M)
    want_intt = [v * n_inv % M
                 for v in jax_ntt(_jax_inverse_plan(jplan), xs)]
    if log_n == 4:
        # the swapped plan's INTT is the JAX package's `intt` itself
        x = JFR.to_mont_host(xs).reshape(JFR.L, 3, n)
        assert want_intt == JFR.from_mont_host(np.asarray(
            jntt.intt(jplan, jnp.asarray(x))).reshape(JFR.L, -1))
    assert port(ntt.ntt(plan, a)) == jax_ntt(jplan, xs)
    assert port(ntt.intt(plan, a)) == want_intt
    assert port(ntt.coset_ntt(plan, a)) == \
        jax_ntt(jplan, _times_powers(xs, g, n))
    assert port(ntt.coset_intt(plan, a)) == \
        _times_powers(want_intt, pow(g, -1, M), n)


def test_four_step_mid_twiddles_are_powers():
    """At 2^13 (n1 = 2^6, n2 = 2^7) the plan holds w^(+-i1*k2) at [i1,
    k2], the inverse times 1/n, and no radix-2 table."""
    plan = ntt.get_plan(13, "cpu")
    n, n1, n2 = 1 << 13, 1 << 6, 1 << 7
    assert (plan.p1.n, plan.p2.n) == (n1, n2)
    assert plan.tw is None and plan.itw is None
    assert plan.tw_f.shape == plan.tw_i.shape == (FR.L, n1, n2)
    w = root_of_unity(13)
    w_inv, n_inv = pow(w, -1, M), pow(n, -1, M)
    assert FR.from_mont_host(plan.tw_f.reshape(FR.L, -1)) == \
        [pow(w, i1 * k2, M) for i1 in range(n1) for k2 in range(n2)]
    assert FR.from_mont_host(plan.tw_i.reshape(FR.L, -1)) == \
        [pow(w_inv, i1 * k2, M) * n_inv % M
         for i1 in range(n1) for k2 in range(n2)]


@pytest.mark.parametrize("half,lanes,tw_step", [(1, 4, 3), (4, 8, 1),
                                                 (8, 2, 2), (2, 32, 1)])
def test_butterfly_stage_with_lanes(half, lanes, tw_step):
    """K5's plain version along axis -2 of (L, 3, 16, lanes): u = row
    blk*2h + j, v = u + h, w = tw[j * tw_step] for every lane, against a
    Python-int butterfly on each (row pair, lane); and equal to the flat
    stage (lanes = 1) on the transposed input."""
    rows, batch = 16, 3
    xs = _ints(batch * rows * lanes, 7 * half + lanes)
    ts = _ints(half * tw_step, 11 + half)
    a = FR.tensor(xs, "cpu")
    tw = FR.tensor(ts, "cpu")
    got = kernels.butterfly_stage(FR.P, a, tw, half, tw_step, lanes)
    want = list(xs)
    for b in range(batch):
        for blk in range(rows // (2 * half)):
            for j in range(half):
                for lane in range(lanes):
                    iu = (b * rows + blk * 2 * half + j) * lanes + lane
                    iv = iu + half * lanes
                    vw = xs[iv] * ts[j * tw_step] % M
                    want[iu] = (xs[iu] + vw) % M
                    want[iv] = (xs[iu] - vw) % M
    assert FR.from_mont_host(got) == want
    t = a.reshape(FR.L, batch, rows, lanes).transpose(-1, -2)
    flat = kernels.butterfly_stage(FR.P, t.reshape(FR.L, -1), tw, half,
                                   tw_step)
    assert torch.equal(flat.reshape(t.shape).transpose(-1, -2)
                       .reshape(FR.L, -1), got)


def _bit_reverse(log_n):
    idx = np.arange(1 << log_n)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return torch.from_numpy(rev)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("lanes", [1, 4, 32])
@pytest.mark.parametrize("log_rows", range(1, 9))
def test_ntt_pass_is_the_stage_chain(log_rows, lanes, invert):
    """The fused pass (`kernels.ntt_pass`, its plain version here) against
    the chain it replaces: the product by a scalar (1/n) or by an (R,
    lanes) table (the mid twiddles, `mont_mul`), the bit-reversal row
    gather (`index_select`), K5's stages one by one and the transposing
    copy;
    with and without the gather, forward and inverse, split into passes
    as `ntt_pass_plan` splits it and at every other two-pass split, packed
    between passes as `ops/ntt` runs them."""
    L, R = FR.L, 1 << log_rows
    batch = 3 if lanes < 32 else 1
    a = FR.tensor(_ints(batch * R * lanes, 40 + log_rows), "cpu")
    sub = ntt.get_plan(log_rows, "cpu")
    tw = sub.itw if invert else sub.tw
    table = FR.tensor(_ints(R * lanes, 80 + log_rows), "cpu")
    plan = kernels.ntt_pass_plan(log_rows, lanes)
    assert [s for s0, s1 in plan for s in range(s0 + 1, s1 + 1)] == \
        list(range(1, log_rows + 1))
    splits = [plan] + [[(0, k), (k, log_rows)] for k in range(1, log_rows)]
    for bitrev in (False, True):
        for mul, transpose in ((None, False), (sub.n_inv[:, None], False),
                               (table, lanes > 1)):
            want = a.reshape(L, batch, R * lanes)
            if mul is not None:
                want = mont.mont_mul(FR, want, mul[:, None, :])
            want = want.reshape(L, batch, R, lanes)
            if bitrev:
                want = want.index_select(2, _bit_reverse(log_rows))
            want = want.reshape(L, -1)
            for s in range(1, log_rows + 1):
                want = kernels.butterfly_stage(FR.P, want, tw, 1 << (s - 1),
                                               R >> s, lanes)
            want = want.reshape(L, batch, R, lanes)
            if transpose:
                want = want.transpose(-1, -2)
            want = want.reshape(L, -1)
            for split in splits:
                x = a
                for k, (s0, s1) in enumerate(split):
                    last = k == len(split) - 1
                    x = kernels.ntt_pass(
                        FR.P, x, tw, log_rows, lanes, s0, s1,
                        bitrev and k == 0, mul if k == 0 else None,
                        transpose and last, packed_in=k > 0,
                        packed_out=not last)
                    assert x.shape[0] == (L if last else L // 2)
                assert torch.equal(x, want), (bitrev, split)


def test_dryrun_proof_through_four_step_equals_spec(low_threshold, srs_1k):
    """The port's proof of the dry-run circuit (`entry.dryrun_circuit`, n
    = 16) with every transform on the four-step (4 x 4) is the spec's
    (`zprize_tpu.ref.prover.prove`) byte for byte, and verifies."""
    label = b"dryrun"
    jcs = dryrun_circuit(JaxComposer())
    tr = TranscriptProtocol(label)
    pk, vk = rp.preprocess(jcs, srs_1k, tr)
    spec = jax_serialize(rp.prove(jcs, pk, srs_1k, tr.clone()))
    cs = dryrun_circuit(StandardComposer())
    ptr = PortTranscript(label)
    dpk = pt.DevProverKey.from_ref(port_rp.preprocess(cs, srs_1k, ptr)[0],
                                   "cpu")
    assert dpk.n == 16 and ntt.get_plan(dpk.log_n, "cpu").p1 is not None
    # a 2-bit window: the fewest plain point additions at n = 16
    proof = pt.prove_torch(pt.ProverWitness.from_composer(cs, dpk.n, "cpu"),
                           dpk, pt.DevSRS.from_ref(srs_1k, "cpu"),
                           ptr.clone(),
                           pt.ProverConfig(device="cpu", msm_window_bits=2))
    got = serialize_proof(proof)
    assert got == spec
    vtr = TranscriptProtocol(label)
    rp.seed_transcript(vtr, vk)
    assert verify(vk, srs_1k, deserialize_proof(got), jcs.public_inputs, vtr)
