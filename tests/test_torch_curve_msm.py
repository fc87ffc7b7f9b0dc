"""The port's curve and MSM layer (`zprize_tpu_torch.curve.g1`,
`ops.msm`) against the JAX package: the plain versions of the point
kernels K7/K9 vs `zprize_tpu.curve.g1` (XLA path) coordinate for
coordinate and K8 vs `zprize_tpu.fields.pkern` in interpret mode, the
chunked bucket MSM (plain versions of its kernels) vs the oracle
`zprize_tpu.ref.curve.g1_msm` that `zprize_tpu.ops.msm` is pinned to (its
full window grid takes minutes to compile on a CPU) on random, skewed,
equal and zero scalars and special points, and its digit helpers vs
`zprize_tpu.ops.msm` directly; the device window fold vs the Python-int
host fold and `prover_tpu._fold_windows`, `commit_batch` vs the host MSM,
and the batched-affine additions vs `zprize_tpu.curve.g1`. Exact
comparisons."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_threads  # noqa: F401  (one torch thread)

from zprize_tpu.curve import g1 as jg1
from zprize_tpu.ops import msm as jmsm
from zprize_tpu.params import R_MOD, Q_MOD
from zprize_tpu.ref.curve import G1_GEN, g1_add, g1_mul, g1_msm, g1_neg
from zprize_tpu_torch.curve import g1
from zprize_tpu_torch.fields.limb import ints_to_limbs
from zprize_tpu_torch.fields.mont import FQ
from zprize_tpu_torch.ops import msm

COORDS = ("X", "Y", "ZZ", "ZZZ")


def _pairs():
    P, Q = g1_mul(G1_GEN, 5), g1_mul(G1_GEN, 9)
    rng = random.Random(3)
    pts = [g1_mul(G1_GEN, rng.randrange(1, 1 << 20)) for _ in range(6)]
    return ([(P, Q), (P, P), (P, g1_neg(P)), (None, Q), (P, None),
             (None, None)] + list(zip(pts[:3], pts[3:])))


def _jstack(d):
    return np.concatenate([np.asarray(d[k]) for k in COORDS], axis=0)


def _eq(t, j):
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


def test_xyzz_add_affine2_matches_jax_and_oracle():
    pairs = _pairs()
    ax, ay, _ = g1.affine_points_to_device([a for a, _ in pairs], "cpu")
    bx, by, _ = g1.affine_points_to_device([b for _, b in pairs], "cpu")
    got = g1.xyzz_add_affine2(ax, ay, bx, by)
    jx, jy, _ = jg1.affine_points_to_device([a for a, _ in pairs])
    kx, ky, _ = jg1.affine_points_to_device([b for _, b in pairs])
    assert _eq(got, _jstack(jg1.xyzz_add_affine2(jx, jy, kx, ky)))
    assert g1.xyzz_to_affine_host(got) == [g1_add(a, b) for a, b in pairs]


@pytest.mark.parametrize("plain", ["ints", "limbs"])
def test_xyzz_add_and_double_match_jax(monkeypatch, plain):
    """K7 on xyzz operands with non-trivial Z, including P == Q written
    with two different coordinate sets, P == -Q and the identity; its plain
    version on Python ints (a small batch) and on limb arrays."""
    if plain == "limbs":
        monkeypatch.setattr(g1, "INT_BATCH", 0)
    pairs = _pairs()
    ax, ay, _ = g1.affine_points_to_device([a for a, _ in pairs], "cpu")
    bx, by, _ = g1.affine_points_to_device([b for _, b in pairs], "cpu")
    p = g1.xyzz_add_affine2(ax, ay, bx, by)         # a + b
    q = g1.xyzz_add_affine2(bx, by, ax, ay)         # b + a, other coords
    q[:, 2] = g1.xyzz_neg(p[:, 2:3].contiguous())[:, 0]
    got = g1.xyzz_add(p, q)
    jp = {k: jnp.asarray(v.numpy().astype(np.uint32))
          for k, v in zip(COORDS, p.split(24))}
    jq = {k: jnp.asarray(v.numpy().astype(np.uint32))
          for k, v in zip(COORDS, q.split(24))}
    assert _eq(got, _jstack(jg1.xyzz_add(jp, jq)))
    # 2P: the same coordinates where P is finite; the identity (P - P in
    # column 2) stays an identity (ZZ = 0) whatever its X, Y
    dbl = g1.xyzz_double(p)
    jdbl = _jstack(jg1.xyzz_double(jp))
    fin = [i for i in range(p.shape[1]) if i != 2]
    assert _eq(dbl[:, fin], jdbl[:, fin])
    assert not dbl[48:72, 2].any() and not jdbl[48:72, 2].any()
    sums = [g1_add(a, b) for a, b in pairs]
    want = [g1_add(s, s) for s in sums]
    want[2] = None                                    # (P - P) = O
    assert g1.xyzz_to_affine_host(got) == want


def test_xyzz_add_mixed_matches_pallas_interpret():
    """K8's plain version against pkern.xyzz_add_mixed (interpret mode).
    Columns: P == lift(Q) with P's ZZ != 1; P == -lift(Q), ZZ != 1; P = O
    (ZZ = 0, X and Y not 0); Q = O; P == lift(Q) with ZZ = 1; both O;
    random pairs."""
    from zprize_tpu.fields import pkern
    from zprize_tpu.fields.mont import FQ as JFQ
    pairs = _pairs()
    ax, ay, _ = g1.affine_points_to_device([a for a, _ in pairs], "cpu")
    bx, by, _ = g1.affine_points_to_device([b for _, b in pairs], "cpu")
    p = g1.xyzz_add_affine2(ax, ay, bx, by)
    sums = [g1_add(a, b) for a, b in pairs]
    rng = random.Random(5)
    qs = [sums[0], g1_neg(sums[1]), g1_mul(G1_GEN, 77), None, sums[4],
          None] + [g1_mul(G1_GEN, rng.randrange(1, 1 << 20))
                   for _ in pairs[6:]]
    one = torch.tensor(FQ.one_mont, dtype=torch.int32)
    assert not torch.equal(p[48:72, 0], one)
    assert not torch.equal(p[48:72, 1], one)
    assert torch.equal(p[48:72, 4], one)
    assert not p[48:72, 2].any() and p[:48, 2].any()
    assert sums[5] is None and not p[:, 5].any()
    qx, qy, _ = g1.affine_points_to_device(qs, "cpu")
    got = g1.xyzz_add_mixed(p, qx, qy)
    want = pkern.xyzz_add_mixed(
        JFQ.K, jnp.asarray(p.numpy().astype(np.uint32)),
        jnp.asarray(qx.numpy().astype(np.uint32)),
        jnp.asarray(qy.numpy().astype(np.uint32)), interpret=True)
    assert _eq(got, want)
    assert g1.xyzz_to_affine_host(got) == [g1_add(a, q)
                                           for a, q in zip(sums, qs)]


def test_tree_sum_and_device_affine():
    rng = random.Random(4)
    pts = [g1_mul(G1_GEN, rng.randrange(1, 1 << 30)) for _ in range(7)]
    pts[2] = None
    x, y, _ = g1.affine_points_to_device(pts, "cpu")
    tot = g1.xyzz_tree_sum(g1.xyzz_from_affine(x, y))
    acc = None
    for p in pts:
        acc = g1_add(acc, p)
    assert g1.xyzz_to_affine_host(tot[:, None]) == [acc]
    xa, ya = g1.xyzz_to_affine_device(g1.xyzz_from_affine(x, y))
    assert torch.equal(xa, x) and torch.equal(ya, y)


def _raw(scalars):
    return torch.from_numpy(
        ints_to_limbs([s % (1 << 256) for s in scalars], 16).T.copy()
        .astype(np.int32))


def _skewed():
    """One scalar repeated for 48 of 64 points: its digit fills the same
    bucket in every window."""
    rng = random.Random(7)
    n = 64
    pts = [g1_mul(G1_GEN, rng.randrange(1, 1000)) for _ in range(n)]
    s_rep = rng.randrange(R_MOD)
    scalars = [s_rep] * 48 + [rng.randrange(R_MOD) for _ in range(n - 48)]
    return pts, scalars


def _msm_case(case):
    rng = random.Random(5)
    n = 64
    pts = [g1_mul(G1_GEN, rng.randrange(1, 1000)) for _ in range(n)]
    scalars = [rng.randrange(R_MOD) for _ in range(n)]
    if case == "skewed":
        return _skewed()
    if case == "equal":
        return pts, [scalars[0]] * n
    if case == "zero":
        return pts, [0] * n
    if case == "specials":
        # identity points, equal points and P, -P in one bucket
        pts[7] = None
        pts[10] = pts[11]
        pts[12] = g1_neg(pts[13])
        for i in (7, 10, 11, 12, 13):
            scalars[i] = 0xABCDEF
        scalars[3] = 0
        scalars[5] = 1
    return pts, scalars


# (case, window bits, CHUNK): CHUNK = 8 makes the skewed bucket (48 members
# in every window) take three levels; 5 and 3 divide no bucket size there
@pytest.mark.parametrize("case, window_bits, chunk", [
    ("random", 4, 32), ("random", 8, 32), ("skewed", 4, 8),
    ("equal", 4, 5), ("zero", 8, 32), ("specials", 4, 3),
    ("specials", 8, 32)])
def test_msm_matches_oracle(monkeypatch, case, window_bits, chunk):
    monkeypatch.setattr(msm, "CHUNK", chunk)
    pts, scalars = _msm_case(case)
    x, y, _ = g1.affine_points_to_device(pts, "cpu")
    packed = g1.pack_affine(x, y)
    assert msm.msm(packed, _raw(scalars), window_bits) == \
        g1_msm(pts, scalars)


def test_chunk_list_splits_runs_evenly(monkeypatch):
    """Each run cut into ceil(len / CHUNK) chunks of sizes that differ by
    at most one, covering the run in order; `final` once every bucket has
    at most one chunk."""
    monkeypatch.setattr(msm, "CHUNK", 4)
    lens = torch.tensor([0, 1, 4, 5, 9, 0, 13])
    starts = torch.cumsum(lens, 0) - lens
    ch = msm.chunk_list(starts, lens)
    assert ch.counts.tolist() == [0, 1, 1, 2, 3, 0, 4]
    assert not ch.final
    got = {}
    for s, e, b in zip(ch.start.tolist(), ch.end.tolist(),
                       ch.bucket.tolist()):
        got.setdefault(b, []).append((s, e))
    for b, runs in got.items():
        assert runs[0][0] == starts[b] and runs[-1][1] == starts[b] + lens[b]
        assert all(r[1] == q[0] for r, q in zip(runs, runs[1:]))
        sizes = [e - s for s, e in runs]
        assert max(sizes) <= 4 and max(sizes) - min(sizes) <= 1
    nxt = msm.chunk_list(ch.offsets, ch.counts)
    assert nxt.final and nxt.bucket.tolist() == [1, 2, 3, 4, 6]


def test_msm_helpers_match_jax():
    for n in (1, 100, 1 << 9, 1 << 13, 1 << 19, 1 << 22):
        assert msm.auto_window_bits(n) == jmsm.auto_window_bits(n)
    scalars = [random.Random(6).randrange(R_MOD) for _ in range(33)]
    raw = _raw(scalars)
    for wb in (2, 4, 8, 16):
        want = jmsm.limbs16_to_digits(jnp.asarray(
            raw.numpy().astype(np.uint32)), wb)
        got = msm.limbs16_to_digits(raw, wb)
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_affine_identity_encoding():
    x, y, inf = g1.affine_points_to_device([None, G1_GEN], "cpu")
    assert inf.tolist() == [True, False]
    assert g1.is_identity(g1.xyzz_from_affine(x, y)).tolist() == \
        [True, False]
    assert g1.xyzz_to_affine_host(g1.xyzz_from_affine(x, y)) == \
        [None, (G1_GEN[0] % Q_MOD, G1_GEN[1])]


def test_device_srs_matches_spec_setup():
    """The windowed fixed-base SRS equals the spec's powers of tau."""
    from zprize_tpu.ref.kzg import SRS
    from zprize_tpu_torch.protocol.srs import device_srs
    (x, y, inf), lite, tau = device_srs(20, tau=123456789, device="cpu")
    ref = SRS.setup(20, tau=123456789)
    assert g1.xyzz_to_affine_host(g1.xyzz_from_affine(x, y)) == \
        ref.powers_of_g
    assert not inf.any()
    assert (lite.h, lite.beta_h) == (ref.h, ref.beta_h)


def _windows(W, B, rng):
    """Window points (4L, B, W), LSB window first, and their affine values
    [b][w]. Columns: random windows; every window the identity; one
    nonzero window at the top; one at the bottom; P and -P in the top two
    windows. Each point is (P + R) + (-R), so its ZZ is not 1 and an
    identity has X, Y != 0."""
    pool = [g1_mul(G1_GEN, rng.randrange(1, 1 << 30)) for _ in range(4)]
    cols = [[g1_mul(G1_GEN, rng.randrange(1, 1 << 30)) for _ in range(W)],
            [None] * W,
            [None] * (W - 1) + [pool[0]],
            [pool[1]] + [None] * (W - 1),
            ([None] * W + [pool[2], g1_neg(pool[2])])[-W:]][:B]
    flat = [p for col in cols for p in col]
    x, y, _ = g1.affine_points_to_device(flat, "cpu")
    rx, ry, _ = g1.affine_points_to_device([pool[3]] * len(flat), "cpu")
    nx, ny, _ = g1.affine_points_to_device([g1_neg(pool[3])] * len(flat),
                                           "cpu")
    p = g1.xyzz_add_mixed(g1.xyzz_add_affine2(x, y, rx, ry), nx, ny)
    assert g1.xyzz_to_affine_host(p) == flat
    return p.reshape(4 * FQ.L, len(cols), W), cols


@pytest.mark.parametrize("wb, W", [(2, 1), (2, 3), (2, 4), (4, 1), (4, 3),
                                   (4, 4)])
def test_fold_windows_matches_host_fold(wb, W):
    wpts, cols = _windows(W, 5, random.Random(10 * wb + W))
    got = g1.xyzz_to_affine_host(msm.fold_windows(wpts, wb))
    assert got == [msm.fold_windows_host(col, wb) for col in cols]
    assert got[1] is None


def test_fold_windows_matches_jax_fold_windows():
    """Against `prover_tpu._fold_windows` (XLA on the CPU) as points: the
    two packages double an identity to different coordinates."""
    from zprize_tpu.protocol import prover_tpu as tp
    wpts, cols = _windows(3, 2, random.Random(11))
    j = {k: jnp.asarray(v.numpy().astype(np.uint32))
         for k, v in zip(COORDS, wpts.split(24))}
    want = jg1.xyzz_to_affine_host(tp._fold_windows(j, 2))
    assert g1.xyzz_to_affine_host(msm.fold_windows(wpts, 2)) == want
    assert want == [msm.fold_windows_host(col, 2) for col in cols]


def test_commit_batch_device_fold_matches_host_msm():
    """Three 2^6 polys (one of them zero) through the device MSM and its
    window fold, against the spec's Python MSM; `commit` of one poly."""
    from zprize_tpu.ref.kzg import SRS
    from zprize_tpu_torch.fields.mont import FR
    from zprize_tpu_torch.protocol import prover_torch as pt
    n = 64
    rng = random.Random(12)
    srs = SRS.setup(n + 8, tau=0xABC)
    polys = [[rng.randrange(R_MOD) for _ in range(n)], [0] * n,
             [rng.randrange(1 << 8) for _ in range(n)]]
    stack = torch.stack([FR.tensor(p, "cpu") for p in polys], dim=1)
    dev_srs = pt.DevSRS.from_ref(srs, "cpu")
    got = pt.commit_batch(dev_srs, stack, pt.ProverConfig(device="cpu"))
    host = pt.commit_batch(dev_srs, stack, pt.ProverConfig(
        device="cpu", msm_backend="host"))
    assert got == host and got[1] is None
    assert pt.commit(dev_srs, stack[:, 2], pt.ProverConfig(
        device="cpu", msm_window_bits=4)) == host[2]


def _affine_pairs():
    """The cases of test_msm_jax's affine_add_batched test, then generic
    pairs."""
    P, Q = g1_mul(G1_GEN, 5), g1_mul(G1_GEN, 9)
    rng = random.Random(13)
    more = [g1_mul(G1_GEN, rng.randrange(1, 1 << 20)) for _ in range(4)]
    return [(P, Q), (P, P), (P, g1_neg(P)), (None, Q), (P, None),
            (None, None), (more[0], more[1]), (more[2], more[3])]


def _jax_affine(x, y):
    return (jnp.asarray(x.numpy().astype(np.uint32)),
            jnp.asarray(y.numpy().astype(np.uint32)))


def _host_affine(x, y):
    X, Y = FQ.from_mont_host(x), FQ.from_mont_host(y)
    return [None if (a, b) == (0, 0) else (a, b) for a, b in zip(X, Y)]


def test_affine_add_batched_matches_jax_and_oracle():
    pairs = _affine_pairs()
    ax, ay, _ = g1.affine_points_to_device([a for a, _ in pairs], "cpu")
    bx, by, _ = g1.affine_points_to_device([b for _, b in pairs], "cpu")
    rx, ry = g1.affine_add_batched(ax, ay, bx, by)
    jx, jy = jg1.affine_add_batched(*_jax_affine(ax, ay),
                                    *_jax_affine(bx, by))
    assert _eq(rx, jx) and _eq(ry, jy)
    assert _host_affine(rx, ry) == [g1_add(a, b) for a, b in pairs]


def test_affine_tree_sum_matches_jax_and_oracle():
    """Two rows of 5 points (an odd axis), with the identity, a repeated
    point and a point with its negation in them."""
    rng = random.Random(14)
    pts = [g1_mul(G1_GEN, rng.randrange(1, 1 << 20)) for _ in range(6)]
    rows = [[pts[0], None, pts[1], pts[1], pts[2]],
            [pts[3], g1_neg(pts[3]), pts[4], pts[5], None]]
    x, y, _ = g1.affine_points_to_device(rows[0] + rows[1], "cpu")
    x, y = x.reshape(FQ.L, 2, 5), y.reshape(FQ.L, 2, 5)
    sx, sy = g1.affine_tree_sum(x, y)
    jx, jy = jg1.affine_tree_sum(*_jax_affine(x, y))
    assert _eq(sx, jx) and _eq(sy, jy)
    want = []
    for row in rows:
        acc = None
        for p in row:
            acc = g1_add(acc, p)
        want.append(acc)
    assert _host_affine(sx, sy) == want


def test_xyzz_zero_index_and_select():
    x, y, _ = g1.affine_points_to_device(
        [g1_mul(G1_GEN, k) for k in (3, 4, 5)], "cpu")
    p = g1.xyzz_from_affine(x, y)
    z = g1.xyzz_zero((3,), "cpu")
    assert z.shape == p.shape and g1.is_identity(z).all()
    idx = torch.tensor([2, 0])
    assert torch.equal(g1.xyzz_index(p, idx), p[:, [2, 0]])
    mask = torch.tensor([True, False, True])
    sel = g1.xyzz_select(mask, p, z)
    assert g1.xyzz_to_affine_host(sel) == [
        g1_mul(G1_GEN, 3), None, g1_mul(G1_GEN, 5)]
