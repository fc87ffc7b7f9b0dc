"""Pippenger MSM on the device — the port of `zprize_tpu/ops/msm.py`.

Per window, points are sorted by digit (`torch.sort`), bucket runs are
found with `torch.searchsorted`, and ONE gather (`index_select`) places
each bucket's members into a (buckets, capacity) slot grid. A bucket is
summed by a pairwise tree over its slots: the first level adds affine
pairs (K9, `xyzz_add_affine2`), the rest add xyzz points (K7). The
weighted sum over buckets is `weighted_bucket_fold`, and the window
points go to the host, which folds them with Python ints (the reference's
`msmcollect.cpp` step, as `zprize_tpu.ops.msm.msm_device` does).

Capacity is Poisson-sized for pseudorandom digits. A bucket with more
members than one pass holds is drained by further passes over slots
[off, off + C) of the buckets that still have members (`off` is the pass
offset of the JAX package); only those buckets are gathered again, so a
skewed digit distribution costs passes over its few large buckets, not
over every bucket. After the last pass no member may be left; the MSM
raises if one is.
"""

import math

import torch

from ..fields.mont import FQ
from ..curve import g1
from ..ref.curve import g1_add as host_g1_add, g1_double as host_g1_double

L = FQ.L
# slots gathered per window group (each slot is 2 x 96 B of affine point)
GROUP_SLOTS = 1 << 24


def auto_window_bits(n):
    if n >= (1 << 19):
        return 16
    if n >= (1 << 9):
        return 8
    return 4


def bucket_capacity(n, window_bits):
    """Static per-bucket slot count: mu + 8*sqrt(mu) + 16 (Poisson tail
    ~e^-50 for random digits), rounded up to a multiple of 8."""
    B = 1 << window_bits
    mu = max(1.0, n / B)
    c = int(math.ceil(mu + 8.0 * math.sqrt(mu) + 16.0))
    c = min(n, c)
    return -(-c // 8) * 8


def limbs16_to_digits(raw_limbs, window_bits):
    """(16, n) 16-bit limbs -> (num_windows, n) int64 digits of
    `window_bits` bits, limb 0's low bits first. window_bits divides 16."""
    assert 16 % window_bits == 0
    raw = raw_limbs.to(torch.int64)
    if window_bits == 16:
        return raw
    per = 16 // window_bits
    mask = (1 << window_bits) - 1
    parts = [(raw >> (window_bits * i)) & mask for i in range(per)]
    return torch.stack(parts, dim=1).reshape(-1, raw.shape[1])


def _suffix_weighted_small(S):
    """S: xyzz (4L, ..., B). Returns sum_{b>=1} b * S_b: inclusive suffix
    scan (Hillis-Steele) + tree sum of the suffixes."""
    B = S.shape[-1]
    rev = S.flip(-1)
    d = 1
    while d < B:
        shifted = torch.cat([torch.zeros_like(rev[..., :d]),
                             rev[..., :B - d]], dim=-1)
        rev = g1.xyzz_add(rev, shifted)
        d *= 2
    return g1.xyzz_tree_sum(rev[..., :B - 1].contiguous())


def _double_k(p, k):
    for _ in range(k):
        p = g1.xyzz_double(p)
    return p


def weighted_bucket_fold(S):
    """sum_b b * S_b over the last axis of an xyzz tensor (4L, ..., B).
    For B > 16, b = b2*B1 + b1 with B1 ~ sqrt(B):
        B1 * sum_b2 b2*R_b2 + sum_b1 b1*C_b1,
    R = row sums, C = column sums of S as a (B2, B1) grid, each weighted
    sum folded the same way — about 2B point additions where a suffix
    scan over all B buckets takes B log B. (The JAX package splits only
    above B = 512, into 256-wide rows; the sum is the same point.)"""
    B = S.shape[-1]
    if B <= 16:
        return _suffix_weighted_small(S)
    log_b1 = B.bit_length() // 2
    B1 = 1 << log_b1
    G = S.reshape(S.shape[:-1] + (B // B1, B1))
    rows = g1.xyzz_tree_sum(G)
    cols = g1.xyzz_tree_sum(G.transpose(-1, -2).contiguous())
    hi = weighted_bucket_fold(rows)
    lo = weighted_bucket_fold(cols)
    return g1.xyzz_add(_double_k(hi, log_b1), lo)


def _slot_sums(x, y, src, valid):
    """Sum each row of a (K, C) slot grid of point indices -> xyzz
    (4L, K). Invalid slots read as the identity (0, 0)."""
    K, C = src.shape
    gx = x.index_select(1, src.reshape(-1)).reshape(L, K, C)
    gy = y.index_select(1, src.reshape(-1)).reshape(L, K, C)
    gx = gx.masked_fill(~valid[None], 0)
    gy = gy.masked_fill(~valid[None], 0)
    if C == 1:
        return g1.xyzz_from_affine(gx[..., 0], gy[..., 0])
    p = g1.xyzz_add_affine2(gx[..., 0::2], gy[..., 0::2],
                            gx[..., 1::2], gy[..., 1::2])
    return g1.xyzz_tree_sum(p)


def msm_window_grid(x, y, digits_gw, window_bits, capacity, stats=None,
                    max_passes=None):
    """G Pippenger windows at once. x, y: (L, n) Montgomery affine with
    (0, 0) identity; digits_gw: (G, n) int64. Returns the window points
    (4L, G) = sum_b b * (bucket b's sum), drained to the last member.
    At most `max_passes` passes run (default ceil(n / capacity), enough
    for any digits); a member left after them raises."""
    G, n = digits_gw.shape
    B = 1 << window_bits
    C = capacity
    d_s, order = torch.sort(digits_gw, dim=-1)
    targets = torch.arange(B + 1, device=x.device).expand(G, B + 1)
    bounds = torch.searchsorted(d_s.contiguous(), targets.contiguous())
    starts = bounds[:, :B].reshape(-1)                 # (G*B,)
    ends = bounds[:, 1:].reshape(-1)
    ends = torch.where(torch.arange(G * B, device=x.device) % B == 0,
                       starts, ends)                   # digit 0: no bucket
    order_flat = order.reshape(-1)
    row_base = (torch.arange(G, device=x.device) * n).repeat_interleave(B)
    ar = torch.arange(C, device=x.device)

    def grid(rows, off):
        slot = starts[rows, None] + off + ar[None, :]
        valid = slot < ends[rows, None]
        src = order_flat.index_select(
            0, (row_base[rows, None] + slot.clamp(max=n - 1)).reshape(-1))
        return _slot_sums(x, y, src.reshape(slot.shape), valid)

    if max_passes is None:
        max_passes = -(-n // C)
    all_rows = torch.arange(G * B, device=x.device)
    S = grid(all_rows, 0)                              # (4L, G*B)
    off = C
    passes = 1
    left = ends - starts - off
    while passes < max_passes:
        rows = (left > 0).nonzero()[:, 0]
        if rows.numel() == 0:
            break
        part = grid(rows, off)
        S[:, rows] = g1.xyzz_add(S[:, rows], part)
        off += C
        passes += 1
        left = ends - starts - off
    overflow = int(left.clamp(min=0).sum())
    if overflow:
        raise RuntimeError(
            f"MSM bucket overflow not drained: {overflow} members left "
            f"after {passes} passes")
    if stats is not None:
        stats["passes"] = max(stats.get("passes", 0), passes)
    return weighted_bucket_fold(S.reshape(4 * L, G, B))


def window_group_size(n, window_bits):
    B = 1 << window_bits
    C = bucket_capacity(n, window_bits)
    return max(1, GROUP_SLOTS // (B * C))


def msm_windows(x, y, raw_scalar_limbs, window_bits, capacity=None,
                stats=None):
    """All windows of one MSM: raw (canonical) scalar limbs (16, n) ->
    window points (4L, W), LSB window first."""
    n = x.shape[1]
    digits = limbs16_to_digits(raw_scalar_limbs, window_bits)
    W = digits.shape[0]
    cap = capacity or bucket_capacity(n, window_bits)
    G = window_group_size(n, window_bits)
    outs = [msm_window_grid(x, y, digits[s:s + G], window_bits, cap, stats)
            for s in range(0, W, G)]
    return torch.cat(outs, dim=1)


def fold_windows_host(wins, window_bits):
    """Host Horner fold of affine window points (LSB first)."""
    acc = None
    for wp in reversed(wins):
        for _ in range(window_bits):
            acc = host_g1_double(acc)
        acc = host_g1_add(acc, wp)
    return acc


def msm(points_dev, raw_scalar_limbs, window_bits=None, capacity=None,
        stats=None):
    """points_dev = (x, y[, inf]) with identity (0, 0); raw scalar limbs
    (16, n) of canonical scalars. Returns an affine Python point or None."""
    x, y = points_dev[0], points_dev[1]
    wb = window_bits or auto_window_bits(x.shape[1])
    wpts = msm_windows(x, y, raw_scalar_limbs, wb, capacity, stats)
    return fold_windows_host(g1.xyzz_to_affine_host(wpts), wb)

