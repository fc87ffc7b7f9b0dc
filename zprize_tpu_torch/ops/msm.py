"""Pippenger MSM on the device — the port of `zprize_tpu/ops/msm.py`.

All windows of one MSM run together. The points are sorted by digit
(`torch.sort`, one row per window) and the bucket runs found with
`torch.searchsorted`; digit 0 has no bucket. Each bucket's run is cut into
chunks of at most CHUNK members, of equal size (a cumsum of
ceil(len / CHUNK)), and one thread of the bucket kernel sums one chunk:
it gathers its members from the point-major SRS copy (`g1.pack_affine`),
adds the first two with K9's body (affine + affine) and each later one
with K8's (xyzz + affine, 8M + 2S), and writes one xyzz partial. Further
levels of the same chunking sum each bucket's partials with K7's body
until one point per bucket is left, so a bucket of any size (all n members
when every scalar is equal) costs log_CHUNK(n) levels, and no slot grid
is padded for the largest bucket. The weighted sum over buckets is
`weighted_bucket_fold` over (4L, windows, buckets) in one pass for all
windows, and `fold_windows` folds the window points on the device (a
Horner fold of K7 doublings and additions, as `prover_tpu._fold_windows`
does), so one point per MSM goes to the host. `fold_windows_host`, the
same fold in Python ints, is the oracle of the tests.

Bound: ~n mixed additions per window, each 10 Fq products of 576 32-bit
multiply-adds, against the card's integer multiply-add rate; the gathers
move 96 B per member.

The plain version of each bucket kernel (`bucket_acc_plain`,
`bucket_sum_plain`) walks the same chunk list in the same order with the
plain K9 / K8 / K7 versions, so its partials are bit-identical to the
kernel's. A different summation order gives other (X, Y, ZZ, ZZZ) for the
same point: compare across orders as points, never as words.
"""

from collections import namedtuple

import torch

from ..fields import kernels
from ..fields.mont import FQ
from ..curve import g1
from ..ref.curve import g1_add as host_g1_add, g1_double as host_g1_double

L = FQ.L
# most members one thread of the bucket kernel sums
CHUNK = 32


def auto_window_bits(n):
    if n >= (1 << 19):
        return 16
    if n >= (1 << 9):
        return 8
    return 4


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


def sort_members(digits, window_bits):
    """(W, n) digits -> (idx, starts, lens): idx (W*n,) int32 point numbers
    sorted by digit within each window; bucket w*B + d holds idx[starts :
    starts + lens] (positions in idx), bucket d = 0 of every window is
    empty."""
    W, n = digits.shape
    B = 1 << window_bits
    dev = digits.device
    d_s, order = torch.sort(digits.to(torch.int32), dim=-1, stable=True)
    targets = torch.arange(B + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(d_s, targets.expand(W, B + 1).contiguous())
    starts = bounds[:, :B] + (torch.arange(W, device=dev) * n)[:, None]
    lens = bounds[:, 1:] - bounds[:, :B]
    lens[:, 0] = 0
    return (order.to(torch.int32).reshape(-1), starts.reshape(-1),
            lens.reshape(-1))


Chunks = namedtuple("Chunks", "start end bucket counts offsets final")


def chunk_list(starts, lens):
    """Cut run b = [starts[b], starts[b] + lens[b]) into counts[b] =
    ceil(lens[b] / CHUNK) chunks of equal size (+-1), in bucket order. Chunk
    c is [start[c], end[c]) of bucket[c] (int32); bucket b's chunks are
    offsets[b] .. offsets[b] + counts[b] - 1. `final`: every bucket has at
    most one chunk (the next level's partials are the bucket sums)."""
    counts = (lens + CHUNK - 1) // CHUNK
    cum = torch.cumsum(counts, 0)
    total, busy = torch.stack([cum[-1], (counts > 0).sum()]).tolist()
    dev = starts.device
    bucket = torch.repeat_interleave(
        torch.arange(starts.shape[0], device=dev), counts, output_size=total)
    offsets = cum - counts
    j = torch.arange(total, device=dev) - offsets[bucket]
    k, ln, s0 = counts[bucket], lens[bucket], starts[bucket]
    start = s0 + j * ln // k
    end = s0 + (j + 1) * ln // k
    return Chunks(start.to(torch.int32), end.to(torch.int32),
                  bucket.to(torch.int32), counts, offsets, total == busy)


def _check_index(t, n, device):
    if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"index operand must be a contiguous int32 ({n},) "
                         f"tensor on {device}; got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def _check_chunks(start, end, col, out, device):
    for t in (start, end, col):
        _check_index(t, start.shape[0], device)
    kernels.check_operand(out, 4 * L, device)


def bucket_acc_plain(pts, idx, start, end, col, out):
    """Plain version of the bucket kernel: every chunk advanced one member
    a step, the first pair by plain K9, each later member by plain K8; a
    chunk that has ended adds the identity (0, 0), which leaves it as it
    is."""
    start, end = start.long(), end.long()
    lens = end - start
    idx = idx.long()

    def member(k):
        live = lens > k
        rows = pts[idx[torch.where(live, start + k, start)]]
        x, y = g1.unpack_affine(rows * live[:, None])
        return x, y

    x0, y0 = member(0)
    acc = g1.xyzz_add_affine2_plain(x0, y0, *member(1))
    for k in range(2, int(lens.max())):
        acc = g1.xyzz_add_mixed_plain(acc, *member(k))
    out[:, col.long()] = acc
    return out


def bucket_acc(pts, idx, start, end, col, out):
    """Bucket kernel, first level: chunk c sums the points pts[idx[k]] for
    k in [start[c], end[c]) into column col[c] of out (4L, out_n). pts is
    the (N, 24) point-major copy; idx, start, end, col are int32."""
    if not kernels.use_kernel(pts):
        return bucket_acc_plain(pts, idx, start, end, col, out)
    dev = pts.device
    if pts.dtype != torch.int32 or pts.dim() != 2 or pts.shape[1] != 24 \
            or not pts.is_contiguous():
        raise ValueError("pts must be a contiguous int32 (N, 24) tensor")
    _check_index(idx, idx.shape[0], dev)
    _check_chunks(start, end, col, out, dev)
    rc = kernels.load_library().zk_bucket_acc(
        pts.data_ptr(), idx.data_ptr(), start.data_ptr(), end.data_ptr(),
        col.data_ptr(), out.data_ptr(), out.shape[1], start.shape[0],
        kernels.stream())
    kernels.check(rc, "bucket_acc")
    kernels.count("bucket_acc")
    return out


def bucket_sum_plain(part, start, end, col, out):
    """Plain version of the partial-level kernel: acc = part[:, k] + acc
    (plain K7) for k = start + 1 .. end - 1, one step for every chunk at
    once; a chunk that has ended keeps its sum."""
    start, end = start.long(), end.long()
    lens = end - start
    acc = part[:, start]
    for k in range(1, int(lens.max())):
        live = lens > k
        q = part[:, torch.where(live, start + k, start)]
        acc = torch.where(live[None], g1.xyzz_add_plain(q, acc), acc)
    out[:, col.long()] = acc
    return out


def bucket_sum(part, start, end, col, out):
    """Bucket kernel, later levels: chunk c sums the xyzz partials in
    columns [start[c], end[c]) of part (4L, m) into column col[c] of
    out."""
    if not kernels.use_kernel(part):
        return bucket_sum_plain(part, start, end, col, out)
    dev = part.device
    kernels.check_operand(part, 4 * L, dev)
    _check_chunks(start, end, col, out, dev)
    rc = kernels.load_library().zk_bucket_sum(
        part.data_ptr(), part.shape[1], start.data_ptr(), end.data_ptr(),
        col.data_ptr(), out.data_ptr(), out.shape[1], start.shape[0],
        kernels.stream())
    kernels.check(rc, "bucket_sum")
    kernels.count("bucket_sum")
    return out


def _level(fn, src, chunks, n_buckets, device):
    """One level: the partials of `chunks`, or on the final level the
    bucket sums (4L, n_buckets), empty buckets the identity."""
    if chunks.final:
        out = torch.zeros((4 * L, n_buckets), dtype=torch.int32,
                          device=device)
        col = chunks.bucket
    else:
        m = chunks.start.shape[0]
        out = torch.empty((4 * L, m), dtype=torch.int32, device=device)
        col = torch.arange(m, dtype=torch.int32, device=device)
    return fn(*src, chunks.start, chunks.end, col, out)


def first_level(pts, idx, chunks, n_buckets):
    """The bucket kernel over the members' chunks."""
    return _level(bucket_acc, (pts, idx), chunks, n_buckets, pts.device)


def next_level(part, chunks, n_buckets):
    """The partial level after `chunks`' level: (its partials, its chunk
    list)."""
    chunks = chunk_list(chunks.offsets, chunks.counts)
    return _level(bucket_sum, (part,), chunks, n_buckets,
                  part.device), chunks


def sum_levels(part, chunks, n_buckets):
    """Partial levels after `chunks`' level until one point per bucket:
    (4L, n_buckets)."""
    while not chunks.final:
        part, chunks = next_level(part, chunks, n_buckets)
    return part


def bucket_sums(pts, idx, starts, lens):
    """Sum of each bucket's points -> xyzz (4L, buckets)."""
    nb = starts.shape[0]
    if not bool((lens > 0).any()):
        return torch.zeros((4 * L, nb), dtype=torch.int32, device=pts.device)
    chunks = chunk_list(starts, lens)
    return sum_levels(first_level(pts, idx, chunks, nb), chunks, nb)


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
    return g1.xyzz_tree_sum(rev[..., :B - 1])


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


def msm_windows(pts, raw_scalar_limbs, window_bits):
    """All windows of one MSM at once: the point-major points pts (N, 24)
    (the first n are used) and raw (canonical) scalar limbs (16, n) ->
    window points (4L, W), LSB window first."""
    digits = limbs16_to_digits(raw_scalar_limbs, window_bits)
    W = digits.shape[0]
    idx, starts, lens = sort_members(digits, window_bits)
    S = bucket_sums(pts, idx, starts, lens)
    return weighted_bucket_fold(S.reshape(4 * L, W, 1 << window_bits))


def fold_windows(wpts, window_bits):
    """Window points xyzz (4L, ..., W), LSB window first -> (4L, ...):
    sum_w 2^(window_bits * w) P_w by Horner from the top window, each step
    `window_bits` doublings and one addition (K7 at the batch width)."""
    wins = wpts.movedim(-1, 0).contiguous()        # (W, 4L, ...)
    acc = wins[-1]
    for w in range(wins.shape[0] - 2, -1, -1):
        acc = g1.xyzz_add(_double_k(acc, window_bits), wins[w])
    return acc


def fold_windows_host(wins, window_bits):
    """Host Horner fold of affine window points (LSB first): the oracle of
    `fold_windows`."""
    acc = None
    for wp in reversed(wins):
        for _ in range(window_bits):
            acc = host_g1_double(acc)
        acc = host_g1_add(acc, wp)
    return acc


def msm(pts, raw_scalar_limbs, window_bits=None):
    """pts: (N, 24) point-major affine points (`g1.pack_affine`), identity
    (0, 0); raw scalar limbs (16, n) of canonical scalars, n <= N. Returns
    an affine Python point or None."""
    wb = window_bits or auto_window_bits(raw_scalar_limbs.shape[1])
    wpts = msm_windows(pts, raw_scalar_limbs, wb)
    return g1.xyzz_to_affine_host(fold_windows(wpts, wb)[:, None])[0]
