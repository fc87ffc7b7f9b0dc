"""Micro-benchmarks of the port's layers on the card — the counterpart of
`tools/tpu_micro.py`, `tools/attr_micro.py` and the MSM part of
`tools/repro_2e20_msm.py`:

  * NTT and INTT of one Fr column at n = 2^13, 2^18, 2^22;
  * Fr and Fq Montgomery products per second (K1 at n = 2^22);
  * point additions per second (K7, xyzz + xyzz, at n = 2^22);
  * one MSM at n = 2^17 and one at n = 2^20 over a seeded SRS, stage by
    stage (`msm_stages`, the split `chip_smoke.py` times at the h15
    shape), its result held to (sum s_i tau^i) G.

Every time is CUDA events after an untimed call. Prints one JSON line.

Run: python3 -m zprize_tpu_torch.tools.micro
"""

import numpy as np
import torch

from ..curve import g1
from ..fields import kernels
from ..fields.limb import limbs_to_ints
from ..fields.mont import FR, FQ
from ..ops import msm, ntt
from ..params import R_MOD
from ..protocol.srs import device_srs
from ..ref.curve import G1_GEN, g1_mul
from .cudatime import card, emit, median, require_cuda, stage, time_ms

NTT_LOGS = (13, 18, 22)
RATE_LOG_N = 22
MSM_LOGS = (17, 20)
SEED = 20261019


def scalars(n, seed):
    """Seeded canonical scalars as raw (16, n) int32 limbs (numpy)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    raw[15] = rng.integers(0, 0x73ed, size=n)          # below r
    return raw.astype(np.int32)


def msm_stages(pts, raw, wb, times):
    """One MSM (`msm.msm_windows`, `msm.fold_windows`, one copy to the
    host) through its stages, each between CUDA events into times[stage];
    returns (affine result, intermediates)."""
    L = FQ.L

    def sort():
        d = msm.limbs16_to_digits(raw, wb)
        return d.shape[0], msm.sort_members(d, wb)
    W, (idx, starts, lens) = stage(times, "sort_bounds", sort)
    nb = starts.shape[0]
    chunks = stage(times, "chunk_list", lambda: msm.chunk_list(starts, lens))
    part = stage(times, "bucket_kernel",
                 lambda: msm.first_level(pts, idx, chunks, nb))
    S = stage(times, "partial_levels",
              lambda: msm.sum_levels(part, chunks, nb))
    wp = stage(times, "fold", lambda: msm.weighted_bucket_fold(
        S.reshape(4 * L, W, 1 << wb)))
    acc = stage(times, "window_fold", lambda: msm.fold_windows(wp, wb))
    res = stage(times, "to_host",
                lambda: g1.xyzz_to_affine_host(acc[:, None])[0])
    return res, {"idx": idx, "starts": starts, "lens": lens,
                 "chunks": chunks, "part": part, "S": S, "W": W, "wp": wp}


def sum_s_tau_g(raw, tau):
    """(sum_i s_i tau^i) G, the MSM of `raw` over the SRS powers of tau."""
    e = 0
    for s in reversed(limbs_to_ints(raw.cpu().numpy().astype(np.uint32).T)):
        e = (e * tau + s) % R_MOD
    return g1_mul(G1_GEN, e)


def _field(C, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(C.L, n), dtype=np.int64)
    a[-1] = rng.integers(0, int(C.mod_limbs[-1]), size=n)
    return torch.from_numpy(a.astype(np.int32)).cuda()


def _points(n):
    """(4L, n) xyzz points with random Z, and the same points shifted by
    one column: every column adds two distinct points."""
    (x, y, _), _, _ = device_srs(4095, device="cuda")
    p = g1.xyzz_add_affine2(x, y, x.roll(1, 1), y.roll(1, 1))
    p = p.repeat(1, n // p.shape[1]).contiguous()
    return p, p.roll(1, 1).contiguous()


def ntt_times():
    out = {"ntt_ms": {}, "intt_ms": {}}
    for log_n in NTT_LOGS:
        plan = ntt.get_plan(log_n, "cuda")
        a = _field(FR, 1 << log_n, SEED + log_n)
        reps = 50 if log_n < 20 else 5
        out["ntt_ms"][str(log_n)] = time_ms(lambda: ntt.ntt(plan, a),
                                            reps)[0]
        out["intt_ms"][str(log_n)] = time_ms(lambda: ntt.intt(plan, a),
                                             reps)[0]
    return out


def rates():
    n = 1 << RATE_LOG_N
    out = {"n": n}
    for C in (FR, FQ):
        a, b = _field(C, n, SEED), _field(C, n, SEED + 1)
        ms = time_ms(lambda: kernels.mul(C.P, a, b), 10)[0]
        out[f"{C.name}_mul_per_s"] = n / (ms * 1e-3)
        out[f"{C.name}_mul_ms"] = ms
        del a, b
    p, q = _points(n)
    ms = time_ms(lambda: g1.xyzz_add(p, q), 5)[0]
    out["xyzz_add_per_s"] = n / (ms * 1e-3)
    out["xyzz_add_ms"] = ms
    return out


def msm_times():
    out = {}
    for log_n in MSM_LOGS:
        n = 1 << log_n
        wb = msm.auto_window_bits(n)
        (x, y, _), _, tau = device_srs(n - 1, device="cuda")
        pts = g1.pack_affine(x, y)
        del x, y
        raw = torch.from_numpy(scalars(n, SEED + log_n)).cuda()
        times = {}
        msm_stages(pts, raw, wb, {})                  # untimed
        for _ in range(3):
            res, mid = msm_stages(pts, raw, wb, times)
        if res != sum_s_tau_g(raw, tau):
            raise AssertionError(f"2^{log_n} MSM != (sum s_i tau^i) G")
        stage_ms = {k: median(v) for k, v in times.items()}
        out[str(log_n)] = {"window_bits": wb, "windows": mid["W"],
                           "stage_ms": stage_ms,
                           "total_ms": sum(stage_ms.values()),
                           "result_equals_sum_s_tau_G": True}
        del pts, raw, mid
        torch.cuda.empty_cache()
    return out


def run():
    """All the micro-benchmarks -> one dict."""
    require_cuda()
    out = {"card": card(), "device": torch.cuda.get_device_name(0)}
    out.update(ntt_times())
    out.update(rates())
    out["msm"] = msm_times()
    return out


if __name__ == "__main__":
    emit({"micro": run()})
