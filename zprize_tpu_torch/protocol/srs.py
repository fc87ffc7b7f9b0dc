"""SRS (powers of tau) generation on the device — the port of
`zprize_tpu/protocol/srs.py`, without any disk cache: the 8-bit window
table T[j][d] = d * 2^(8j) * G (32 x 256 points) is built once per process
in memory with host Python ints, and P_i = sum_j T[j][digit_j(tau^i)] is
computed on the device in chunks: one gather, a first tree level of
affine pairs (K9), four xyzz levels (K7), one batched inversion.

A test/bench SRS with known tau, like the reference's `KZG10::setup`.
"""

import random
from functools import lru_cache

import numpy as np
import torch

from ..params import R_MOD
from ..device import resolve
from ..fields import mont
from ..fields.mont import FR, FQ
from ..ops import poly as tpoly
from ..curve import g1
from ..ref.curve import G1_GEN, G2_GEN, g1_add, g1_double, g2_mul
from ..ref.kzg import SRS

WB = 8                  # window bits of the fixed-base table
NW = 32                 # 256 / 8 windows
CHUNK = 1 << 18         # points per device step


@lru_cache(maxsize=None)
def _window_table():
    """Host table (L, NW * 256) x and y limbs; identity entries (0, 0)."""
    xs, ys = [], []
    base = G1_GEN
    for _ in range(NW):
        acc = None
        for _ in range(1 << WB):
            xs.append(0 if acc is None else acc[0])
            ys.append(0 if acc is None else acc[1])
            acc = g1_add(acc, base)
        for _ in range(WB):
            base = g1_double(base)
    return FQ.to_mont_host(xs).astype(np.int32), \
        FQ.to_mont_host(ys).astype(np.int32)


def device_srs(max_degree: int, tau: int = None, seed: int = 42,
               device=None, chunk: int = CHUNK):
    """SRS of max_degree + 1 G1 powers on the device. Returns (points,
    SRS-lite, tau): points = (x (L, n), y (L, n), inf (n,)) with identity
    (0, 0); the SRS-lite carries h and beta_h for the verifier."""
    dev = resolve(device)
    if tau is None:
        tau = random.Random(seed).randrange(1, R_MOD)
    n = max_degree + 1
    tx, ty = _window_table()
    xs_t = torch.from_numpy(tx).to(dev)
    ys_t = torch.from_numpy(ty).to(dev)
    pows = tpoly.powers(FR, FR.scalar(tau, dev), n)
    raw = mont.from_mont(FR, pows).to(torch.int64)            # (16, n)
    digits = torch.stack([raw & 0xFF, raw >> 8], dim=1).reshape(NW, n)
    offs = (torch.arange(NW, device=dev) * 256)[:, None]
    out_x = torch.empty((FQ.L, n), dtype=torch.int32, device=dev)
    out_y = torch.empty_like(out_x)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        idx = (digits[:, s:e] + offs).t().reshape(-1)        # (m * NW,)
        sx = xs_t.index_select(1, idx).reshape(FQ.L, e - s, NW)
        sy = ys_t.index_select(1, idx).reshape(FQ.L, e - s, NW)
        acc = g1.xyzz_add_affine2(sx[..., 0::2], sy[..., 0::2],
                                  sx[..., 1::2], sy[..., 1::2])
        acc = g1.xyzz_tree_sum(acc)
        out_x[:, s:e], out_y[:, s:e] = g1.xyzz_to_affine_device(acc)
        del sx, sy, acc
    inf = mont.is_zero(out_x) & mont.is_zero(out_y)
    lite = SRS.__new__(SRS)
    lite.powers_of_g = None
    lite.h = G2_GEN
    lite.beta_h = g2_mul(G2_GEN, tau)
    return (out_x, out_y, inf), lite, tau


def host_srs(points, lite):
    """`device_srs`'s points and SRS-lite -> the spec's SRS with
    Python-int points (what `ref.prover.preprocess`, `DevSRS.from_ref` and
    the host MSM read)."""
    x, y, inf = points
    xs, ys = FQ.from_mont_host(x), FQ.from_mont_host(y)
    pts = [None if i else (a, b) for a, b, i in zip(xs, ys, inf.tolist())]
    return SRS(pts, lite.h, lite.beta_h)
