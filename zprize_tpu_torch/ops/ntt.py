"""NTT / INTT / coset variants over Fr on limbs-leading (L, ..., n)
tensors — the port of `zprize_tpu/ops/ntt.py`.

Natural order in and out, as in the JAX package. The JAX version runs
four-step transforms along axis -2 to keep the TPU's 128 lanes full; on
the GPU every radix-2 stage is one launch of the butterfly kernel (K5)
over the whole flattened batch — stage s pairs column blk*2h + j with
blk*2h + h + j (h = 2^(s-1)), so neighbouring threads touch neighbouring
words of every limb row. The input is bit-reversed once by a gather.
One twiddle table w^j (j < n/2) serves every stage (stride n / 2h).
"""

from functools import lru_cache

import numpy as np
import torch

from ..params import R_MOD, FR_GENERATOR
from ..device import canonical
from ..ref.field import root_of_unity
from ..fields import mont, kernels
from ..fields.mont import FR
from . import poly


def _bit_reverse_indices(n):
    log_n = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


class NttPlan:
    """Per-domain twiddles and the bit-reversal permutation."""

    def __init__(self, log_n: int, device):
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.device = device
        self.omega = root_of_unity(log_n)
        self.omega_inv = pow(self.omega, -1, R_MOD)
        self.n_inv = FR.scalar(pow(n, -1, R_MOD), device)
        half = max(n // 2, 1)
        self.tw = poly.powers(FR, FR.scalar(self.omega, device), half)
        self.itw = poly.powers(FR, FR.scalar(self.omega_inv, device), half)
        self.bitrev = torch.from_numpy(_bit_reverse_indices(n)).to(device)
        self._coset = None

    @property
    def coset_tables(self):
        """(coset_pows, coset_inv_pows): powers of g and g^-1 over [0, n)."""
        if self._coset is None:
            g = FR_GENERATOR
            self._coset = (
                poly.powers(FR, FR.scalar(g, self.device), self.n),
                poly.powers(FR, FR.scalar(pow(g, -1, R_MOD), self.device),
                            self.n))
        return self._coset


@lru_cache(maxsize=None)
def _plan(log_n, device_str):
    return NttPlan(log_n, torch.device(device_str))


def get_plan(log_n: int, device) -> NttPlan:
    return _plan(log_n, str(canonical(device)))


def transform_last(plan: NttPlan, a, invert: bool):
    """Length-plan.n transform along the LAST axis of (L, ..., n); natural
    order in and out; invert folds in 1/n."""
    L = a.shape[0]
    n = plan.n
    assert a.shape[-1] == n
    x = a.index_select(a.dim() - 1, plan.bitrev).reshape(L, -1)
    tw = plan.itw if invert else plan.tw
    for s in range(1, plan.log_n + 1):
        half = 1 << (s - 1)
        x = kernels.butterfly_stage(FR.P, x, tw, half, n >> s)
    out = x.reshape(a.shape)
    if invert:
        out = mont.mont_mul(FR, out, plan.n_inv)
    return out


def ntt(plan: NttPlan, a):
    """coeffs -> evals (natural order both sides), (L, ..., n)."""
    return transform_last(plan, a, False)


def intt(plan: NttPlan, a):
    return transform_last(plan, a, True)


def coset_ntt(plan: NttPlan, a):
    """Evaluate over g*H (ark coset_fft semantics)."""
    cp, _ = plan.coset_tables
    return ntt(plan, mont.mont_mul(FR, a, cp))


def coset_intt(plan: NttPlan, a):
    _, cip = plan.coset_tables
    return mont.mont_mul(FR, intt(plan, a), cip)


class SubcosetTables:
    """Tables for processing the 8n coset domain as 8 independent n-cosets
    g·w8n^j·H_n (j = 0..7): index map m = 8p + j; the quotient's next gate
    (m + 8) is roll(-1) along p within one sub-coset. Coefficients come
    back from the per-sub-coset INTTs D_j as
        t_{k+nq} = sum_j combine_c[q, j] · D_j[k],
        combine_c[q, j] = z^{-jq} · inv(8 u^q),  u = g^n, z = w8n^n.
    Same tables as the JAX package's SubcosetTables.

    coef, evals: `poly.Layout`s of one rank of a sharded prover; then
    shift_pows and shift_inv_pows hold only the columns of `coef` (they
    meet coefficients) and roots those of `evals` (they meet evaluations).
    Without them every table is whole."""

    def __init__(self, log_n: int, device, coef=None, evals=None):
        self.log_n = log_n
        n = 1 << log_n
        self.n = n
        g = FR_GENERATOR
        w8n = root_of_unity(log_n + 3)
        omega = root_of_unity(log_n)
        u = pow(g, n, R_MOD)
        zeta = pow(w8n, n, R_MOD)

        def pows(layout, x):
            x = FR.scalar(x, device)
            return poly.powers(FR, x, n) if layout is None \
                else layout.powers(FR, x)

        self.shifts = [g * pow(w8n, j, R_MOD) % R_MOD for j in range(8)]
        self.shift_scalars = FR.tensor(self.shifts, device)      # (L, 8)
        self.shift_pows = torch.stack(
            [pows(coef, s) for s in self.shifts], dim=1)          # (L, 8, n)
        self.shift_inv_pows = torch.stack(
            [pows(coef, pow(s, -1, R_MOD)) for s in self.shifts], dim=1)
        self.roots = pows(evals, omega)
        vh = [(u * pow(zeta, j, R_MOD) - 1) % R_MOD for j in range(8)]
        self.vh_inv = FR.tensor([pow(v, -1, R_MOD) for v in vh], device)
        inv8 = pow(8, -1, R_MOD)
        cc = [[pow(zeta, (-j * q) % 8, R_MOD) * inv8 * pow(u, -q, R_MOD)
               % R_MOD for j in range(8)] for q in range(8)]
        self.combine_c = FR.tensor(
            [cc[q][j] for q in range(8) for j in range(8)],
            device).reshape(FR.L, 8, 8)


@lru_cache(maxsize=None)
def _sct(log_n, device_str, coef, evals):
    return SubcosetTables(log_n, torch.device(device_str), coef, evals)


def get_subcoset_tables(log_n: int, device, coef=None,
                        evals=None) -> SubcosetTables:
    return _sct(log_n, str(canonical(device)), coef, evals)


def clear_caches():
    """Drop every cached plan and sub-coset table (all devices): a rank of
    a sharded prover calls it once its set-up is sharded, so no whole
    table stays resident."""
    _plan.cache_clear()
    _sct.cache_clear()


def coset_ntt_shifted(plan: NttPlan, a, shift_pows):
    """NTT over the coset shift*H given a (L, n) powers-of-shift table."""
    return ntt(plan, mont.mont_mul(FR, a, shift_pows))


def coset_intt_shifted(plan: NttPlan, a, shift_inv_pows):
    return mont.mont_mul(FR, intt(plan, a), shift_inv_pows)
