"""NTT / INTT / coset variants over Fr on limbs-leading (L, ..., n)
tensors — the port of `zprize_tpu/ops/ntt.py`, with its algorithm and its
threshold. Natural order in and out. `transform_last` takes the JAX
package's three branches, and runs every radix-2 transform in them as a
few fused passes (`kernels.ntt_pass`, `_sub_transform`): each pass runs
several consecutive stages of the radix-2 DIT schedule on a tile held in
shared memory, where K5 (`kernels.butterfly_stage`) took one launch over
device memory a stage. Stage s pairs row blk*2h + j with blk*2h + h + j
(h = 2^(s-1)); one twiddle table w^j (j < n/2) serves every stage
(stride n / 2h).

  * log n < FOUR_STEP_MIN_LOG (13): radix-2 over the last axis (JAX's
    `_core`) of the whole flattened batch: the first pass multiplies the
    inverse's input by 1/n and gathers the bit-reversed columns; one pass
    up to 2^11, two at 2^12.
  * four-step, n = n1 * n2 with n1 = 2^floor(log n / 2) (JAX
    `transform_last`'s last branch): input index i = i1 + n1*i2, viewed
    as (L, ..., n2, n1) [i2, i1]; a radix-2 transform of size n2 along
    axis -2 with n1 lanes (JAX's `_core_axis2`), whose last pass stores
    [k2, i1] transposed -> [i1, k2]; a size-n1 transform along axis -2
    with n2 lanes, whose first pass multiplies [i1, k2] by the mid
    twiddles w^(i1*k2) as it reads them (the inverse table also holds
    1/n, so no other 1/n product runs) -> [k1, k2], which read row-major
    is X[k2 + n2*k1], natural order. At n = 2^22 that is two passes a
    side, four over device memory.
  * nested split, log n2 >= 13 (log n >= 26; the prover's largest n is
    2^22): transposes and recursive `transform_last` calls, as in JAX.
    Its inverse multiplies by n once, since both the sub-transforms and
    the twiddles fold 1/n.
"""

from functools import lru_cache

import torch

from ..params import R_MOD, FR_GENERATOR
from ..device import canonical
from ..ref.field import root_of_unity
from ..fields import mont, kernels
from ..fields.mont import FR
from . import poly

# from this log n up a plan is four-step, as in the JAX package
FOUR_STEP_MIN_LOG = 13


class NttPlan:
    """Per-domain tables. Below FOUR_STEP_MIN_LOG: the radix-2 twiddles
    `tw` / `itw` (w^j, w^-j for j < n/2).
    From it up: the sub-plans `p1` (n1) and `p2` (n2) and the mid
    twiddles `tw_f` / `tw_i`, each (L, n1, n2) with w^(+-i1*k2) at [i1,
    k2], `tw_i` times 1/n (the words of JAX's `_build_four_step`,
    transposed); no radix-2 table. Both kinds keep omega, omega_inv and
    n_inv, and build the coset tables when first asked. Every table is
    built here, so a plan needs no `warm` as the JAX one does before a
    jit."""

    def __init__(self, log_n: int, device):
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.device = device
        self.omega = root_of_unity(log_n)
        self.omega_inv = pow(self.omega, -1, R_MOD)
        self.n_inv = FR.scalar(pow(n, -1, R_MOD), device)
        self.log_n1 = log_n // 2
        self.log_n2 = log_n - self.log_n1
        self.tw = self.itw = None
        self.p1 = self.p2 = self.tw_f = self.tw_i = None
        if log_n < FOUR_STEP_MIN_LOG:
            half = max(n // 2, 1)
            self.tw = poly.powers(FR, FR.scalar(self.omega, device), half)
            self.itw = poly.powers(FR, FR.scalar(self.omega_inv, device),
                                   half)
        else:
            self.p1 = get_plan(self.log_n1, device)
            self.p2 = get_plan(self.log_n2, device)
            self.tw_f = self._mid_twiddles(self.omega, None)
            self.tw_i = self._mid_twiddles(self.omega_inv, self.n_inv)
        self._coset = None

    def _mid_twiddles(self, w, scale):
        """(L, n1, n2) with scale * w^(i1*k2) at [i1, k2] (scale None: 1):
        the powers of each w^i1, made from powers (no n-long table and no
        gather)."""
        n1, n2 = 1 << self.log_n1, 1 << self.log_n2
        w_i1 = poly.powers(FR, FR.scalar(w, self.device), n1)   # (L, n1)
        start = None if scale is None else \
            scale[:, None].expand(FR.L, n1)
        return poly.powers(FR, w_i1, n2, start=start)

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


def _sub_transform(sub: NttPlan, x, invert, lanes, mul=None,
                   transpose=False, packed_in=False, packed_out=False):
    """The radix-2 transform of size sub.n (sub a radix-2 plan) along the
    rows of x, (L, N) the flattened (L, ..., sub.n, lanes), natural order
    in and out, in the fused passes of `kernels.ntt_pass_plan`: the first
    pass multiplies x by `mul` ((L, 1) or (L, sub.n * lanes)) and gathers
    the bit-reversed rows, the last, with `transpose`, stores (L, ...,
    lanes, sub.n). Between two passes, and where `packed_in` /
    `packed_out` say so at the ends, the array is (8, N) packed words
    (`kernels.pack_words`)."""
    tw = sub.itw if invert else sub.tw
    passes = kernels.ntt_pass_plan(sub.log_n, lanes)
    for k, (s0, s1) in enumerate(passes):
        last = k == len(passes) - 1
        x = kernels.ntt_pass(FR.P, x, tw, sub.log_n, lanes, s0, s1,
                             bitrev=k == 0, mul=mul if k == 0 else None,
                             transpose=transpose and last,
                             packed_in=packed_in or k > 0,
                             packed_out=packed_out or not last)
    return x


def transform_last(plan: NttPlan, a, invert: bool):
    """Length-plan.n transform along the LAST axis of (L, ..., n); natural
    order in and out; invert folds in 1/n. The branch is the plan's:
    radix-2 below FOUR_STEP_MIN_LOG, else four-step, nested when the n2
    sub-plan is itself four-step (see the module docstring)."""
    L, n = a.shape[0], plan.n
    assert a.shape[-1] == n
    if plan.p1 is None:
        # JAX's `_core`, 1/n at the first pass's load
        x = a.reshape(L, -1).contiguous()
        return _sub_transform(plan, x, invert, 1,
                              plan.n_inv[:, None] if invert else None
                              ).reshape(a.shape)
    n1, n2 = 1 << plan.log_n1, 1 << plan.log_n2
    tw = plan.tw_i if invert else plan.tw_f                 # (L, n1, n2)
    if plan.p2.p1 is not None:
        # [..., i1, i2] -> [..., i1, k2] -> [..., k2, i1] -> [..., k2, k1]
        b = transform_last(plan.p2, a.unflatten(-1, (n2, n1))
                           .transpose(-1, -2), invert)
        c = mont.mont_mul(FR, b, tw).transpose(-1, -2).contiguous()
        del b
        r = transform_last(plan.p1, c, invert)
        del c
        out = r.transpose(-1, -2).reshape(a.shape)
        del r
        # tw_i folds 1/n, and the sub-transforms 1/n2 * 1/n1 = 1/n again
        return mont.mont_mul(FR, out, FR.scalar(n, a.device)) if invert \
            else out
    # JAX's `_core_axis2` on [..., i2, i1] (size n2, n1 lanes), its last
    # pass storing [..., k2, i1] transposed as [..., i1, k2]; then, times
    # the mid twiddles w^(i1*k2) as it is read, on that (size n1, n2
    # lanes) -> [..., k1, k2]. At most `a`, the current and the next
    # n-sized tensor are alive, and all but `a` and the result are packed
    # (half the size).
    x = a.reshape(L, -1).contiguous()                       # [i2, i1]
    x = _sub_transform(plan.p2, x, invert, n1, transpose=True,
                       packed_out=True)
    x = _sub_transform(plan.p1, x, invert, n2, tw.reshape(L, -1),
                       packed_in=True)                      # [k1, k2]
    return x.reshape(a.shape)                               # X[k2 + n2*k1]


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
