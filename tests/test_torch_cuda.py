"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped without one (the kernels have no CPU mode). This file
imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py"""

import numpy as np
import pytest
import torch

from zprize_tpu_torch.curve import g1
from zprize_tpu_torch.fields import kernels, mont
from zprize_tpu_torch.fields.mont import FR, FQ
from zprize_tpu_torch.ops import msm, ntt
from zprize_tpu_torch.ref.curve import G1_GEN, g1_mul, g1_neg

N = 4099        # ragged: not a multiple of a thread block


def plain(fn, *args):
    """fn(*args) through the plain PyTorch versions."""
    with kernels.impl("plain"):
        return fn(*args)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _field(C, n, seed, device):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(C.L, n), dtype=np.int64)
    a[-1] = rng.integers(0, int(C.mod_limbs[-1]), size=n)
    for i, v in enumerate([0, 1, C.mod - 1, C.R]):
        a[:, i] = [(v >> (16 * k)) & 0xFFFF for k in range(C.L)]
    return torch.from_numpy(a.astype(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_field_kernels_match_plain(card, field):
    C = FR if field == "fr" else FQ
    a, b = _field(C, N, 1, card), _field(C, N, 2, card)
    b[:, :4] = a[:, :4].flip(1)
    for name in ("mul", "add", "sub"):
        fn = getattr(kernels, name)
        assert torch.equal(fn(C.P, a, b), plain(fn, C.P, a, b)), name
        s = b[:, :1].contiguous()       # broadcast operand, period 1
        assert torch.equal(fn(C.P, a, s), plain(fn, C.P, a, s)), name
    assert torch.equal(kernels.neg(C.P, a), plain(kernels.neg, C.P, a))
    c = _field(C, N, 5, card)
    for x in (c, c[:, :1].contiguous()):
        assert torch.equal(kernels.mul3(C.P, a, b, x),
                           plain(kernels.mul3, C.P, a, b, x)), "mul3"


@pytest.mark.cuda
def test_butterfly_stage_matches_plain(card):
    plan = ntt.get_plan(10, card)
    x = _field(FR, 3 * 1024, 3, card)
    for s in range(1, 11):
        half = 1 << (s - 1)
        got = kernels.butterfly_stage(FR.P, x, plan.tw, half, 1024 >> s)
        want = plain(kernels.butterfly_stage, FR.P, x, plan.tw, half,
                     1024 >> s)
        assert torch.equal(got, want), s


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,half", [(8, 1), (8, 16), (64, 4)])
def test_butterfly_stage_with_lanes_matches_plain(card, lanes, half):
    """K5 along axis -2 of (L, 3, 64, lanes)."""
    plan = ntt.get_plan(10, card)
    x = _field(FR, 3 * 64 * lanes, 6, card)
    step = 512 // half
    got = kernels.butterfly_stage(FR.P, x, plan.tw, half, step, lanes)
    want = plain(kernels.butterfly_stage, FR.P, x, plan.tw, half, step,
                 lanes)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("log_rows,lanes,batch", [
    (11, 1 << 11, 1),       # either side of the h15 four-step
    (11, 1, 3), (12, 1, 2),  # flat: a sharded rank's sub-transforms, n <= 2^12
    (3, 1, 37), (7, 1, 5)])  # flat and batched (2^7: the entry step's INTT)
def test_ntt_pass_matches_plain(card, log_rows, lanes, batch, invert):
    """The fused pass against its plain version at every pass of
    `ntt_pass_plan`, with the layouts `ops/ntt` gives it: the first with
    the bit-reversed gather, packed between passes; flat, the inverse
    times 1/n; along axis -2, as the four-step's first side (the last
    pass transposed, packed out) and its second (packed in, the first
    pass times the mid twiddles)."""
    sub = ntt.get_plan(log_rows, card)
    tw = sub.itw if invert else sub.tw
    x = _field(FR, batch * lanes << log_rows, 8 + log_rows, card)
    if lanes > 1:
        big = ntt.get_plan(2 * log_rows, card)
        mid = (big.tw_i if invert else big.tw_f).reshape(FR.L, -1)
        sides = [(None, True, False, True), (mid, False, True, False)]
    else:
        sides = [(sub.n_inv[:, None] if invert else None, False, False,
                  False)]
    passes = kernels.ntt_pass_plan(log_rows, lanes)
    for mul, trans, packed_in, packed_out in sides:
        for k, (s0, s1) in enumerate(passes):
            last = k == len(passes) - 1
            p_in = packed_in or k > 0
            args = (FR.P, kernels.pack_words(x) if p_in else x, tw,
                    log_rows, lanes, s0, s1, k == 0, mul if k == 0 else None,
                    trans and last, p_in, packed_out or not last)
            assert torch.equal(kernels.ntt_pass(*args),
                               plain(kernels.ntt_pass, *args)), (s0, s1)


@pytest.mark.cuda
def test_four_step_transforms_match_plain(card):
    """The 2^13 plan is four-step (2^7 rows x 2^6 lanes, then 2^6 x
    2^7)."""
    plan = ntt.get_plan(13, card)
    assert plan.p1 is not None
    x = _field(FR, 2 * 8192, 7, card).reshape(FR.L, 2, 8192)
    for fn in (ntt.ntt, ntt.intt):
        assert torch.equal(fn(plan, x), plain(fn, plan, x)), fn.__name__


@pytest.mark.cuda
def test_point_kernels_match_plain(card):
    rng = np.random.default_rng(4)
    pool = [g1_mul(G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, 16)]
    px, py, _ = g1.affine_points_to_device(pool, card)
    idx = [torch.from_numpy(rng.integers(0, 16, N)).to(card)
           for _ in range(2)]
    ax, ay = px[:, idx[0]].contiguous(), py[:, idx[0]].contiguous()
    bx, by = px[:, idx[1]].contiguous(), py[:, idx[1]].contiguous()
    ax[:, 0] = 0
    ay[:, 0] = 0
    bx[:, 1], by[:, 1] = ax[:, 1], ay[:, 1]
    got = g1.xyzz_add_affine2(ax, ay, bx, by)
    assert torch.equal(got, plain(g1.xyzz_add_affine2, ax, ay, bx, by))
    q = plain(g1.xyzz_add_affine2, bx, by, ax, ay)
    q[:, 2] = g1.xyzz_neg(got[:, 2:3].contiguous())[:, 0]
    assert torch.equal(g1.xyzz_add(got, q), plain(g1.xyzz_add, got, q))
    assert torch.equal(g1.xyzz_add(got, got), plain(g1.xyzz_add, got, got))
    # K8: got (ZZ != 1) + affine b, with P = O, Q = O, P == lift(Q) and
    # P == -lift(Q) in the first columns
    qx, qy = bx.clone(), by.clone()
    p = got.clone()
    p[:, 0] = 0
    qx[:, 1] = qy[:, 1] = 0
    x, y = plain(g1.xyzz_to_affine_device, got[:, 2:4].contiguous())
    qx[:, 2:4] = x
    qy[:, 2] = y[:, 0]
    qy[:, 3] = plain(mont.neg, FQ, y[:, 1:2].contiguous())[:, 0]
    assert torch.equal(g1.xyzz_add_mixed(p, qx, qy),
                       plain(g1.xyzz_add_mixed, p, qx, qy))


@pytest.mark.cuda
def test_ntt_tables_are_cached_once_per_card(card):
    """A bare "cuda" and "cuda:<current>" share one plan and one set of
    sub-coset tables (prove_many places proofs on indexed devices)."""
    idx = torch.device("cuda", torch.cuda.current_device())
    assert ntt.get_plan(4, "cuda") is ntt.get_plan(4, idx)
    assert ntt.get_subcoset_tables(4, "cuda") is \
        ntt.get_subcoset_tables(4, idx)


@pytest.mark.cuda
def test_xyzz_add_pairs_matches_elementwise(card):
    """The tree-level K7 against K7 on the strided halves, with an odd
    tail, over several rows."""
    rng = np.random.default_rng(6)
    pool = [g1_mul(G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, 8)]
    px, py, _ = g1.affine_points_to_device(pool, card)
    i = [torch.from_numpy(rng.integers(0, 8, 3 * 1001)).to(card)
         for _ in range(2)]
    p = g1.xyzz_add_affine2(px[:, i[0]].contiguous(), py[:, i[0]].contiguous(),
                            px[:, i[1]].contiguous(), py[:, i[1]].contiguous())
    p = p.reshape(96, 3, 1001)
    got = g1.xyzz_add_pairs(p)
    want = g1.xyzz_add(p[..., 0:1000:2], p[..., 1:1000:2])
    assert torch.equal(got[..., :500], want)
    assert torch.equal(got[..., 500], p[..., 1000])
    assert torch.equal(got, plain(g1.xyzz_add_pairs, p))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "skewed", "equal"])
def test_bucket_kernels_match_plain(card, case):
    """Both bucket kernels bit for bit against their plain versions on
    every level of one MSM's chunk list (8-bit windows over 2^12 points,
    with identity, equal and opposite points among them)."""
    rng = np.random.default_rng(7)
    n = 1 << 12
    pool = [g1_mul(G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, 64)]
    pool[3] = None
    pool[5] = g1_neg(pool[4])
    px, py, _ = g1.affine_points_to_device(pool, card)
    i = torch.from_numpy(rng.integers(0, 64, n)).to(card)
    pts = g1.pack_affine(px[:, i], py[:, i])
    if case == "random":
        digits = rng.integers(0, 256, (2, n))
    elif case == "skewed":
        digits = rng.integers(0, 256, (2, n))
        digits[:, : 3 * n // 4] = 77
    else:
        digits = np.full((2, n), 200)
    idx, starts, lens = msm.sort_members(
        torch.from_numpy(digits).to(card), 8)
    chunks = msm.chunk_list(starts, lens)
    nb = starts.shape[0]
    part = msm.first_level(pts, idx, chunks, nb)
    assert torch.equal(part, plain(msm.first_level, pts, idx, chunks, nb))
    while not chunks.final:
        nxt, nchunks = msm.next_level(part, chunks, nb)
        assert torch.equal(nxt, plain(msm.next_level, part, chunks, nb)[0])
        part, chunks = nxt, nchunks
