"""The 5-round PLONK prover on limbs-leading (L, n) torch tensors — the
port of `zprize_tpu/protocol/prover_tpu.py`, round for round and
transcript byte for byte, so its proofs equal the executable spec's
(`ref/prover.py` of the JAX package).

The quotient round processes the 8n coset domain as 8 sub-cosets of size n
(`ops/ntt.SubcosetTables`): every selector's evaluations are recomputed per
sub-coset from coefficient form, so no (L, 8, n) table is kept. The host
keeps Fiat-Shamir, two 64-byte inversions, the linearisation scalars, the
affine conversion of the commitments and the plookup `combine_split`
(native C, `native/`).

Both lookup branches are here: a key whose q_lookup and table are all zero
(the Merkle circuit) takes the degenerate shortcut (f = t = h1 = h2 = 0,
identity commitments); any other key runs the real plookup rounds.
General circuits enter through `DevProverKey.from_ref` (a spec
`ref/prover.preprocess` key) and `ProverWitness.from_composer`.

With a mesh (`ProverConfig.mesh`) every rank holds only its columns of
each n-length tensor (`parallel/mesh.Columns`) and runs every round on
them; each step that needs the other ranks' columns names its collective
there. The key, witness and SRS are sharded by their `shard` methods, by
the caller (who then frees the whole) or on entry to `prove_torch`.
"""

import copy
import time

import numpy as np
import torch

from ..params import R_MOD, K1, K2, K3, JUBJUB_A, JUBJUB_D
from ..device import canonical, resolve
from ..fields import mont, kernels
from .. import native
from ..fields.mont import FR
from ..fields.frvec import FV
from ..ops import poly as tpoly
from ..ops import msm as tmsm
from ..curve import g1
from ..parallel import mesh as pmesh
from .proof import Proof, Evaluations
from . import widgets_torch as W
from .widgets import (range_constraint, logic_constraint, fbsm_constraint,
                      ca_constraint, lc)
from ..ref import kzg as ref_kzg

M = R_MOD

SELECTOR_NAMES = [
    "q_m", "q_l", "q_r", "q_o", "q_4", "q_c", "q_hl", "q_hr", "q_h4",
    "q_arith", "q_range", "q_logic", "q_lookup", "q_fixed_group_add",
    "q_variable_group_add",
]


class ProverConfig:
    """device: where the prover runs (CUDA unless "cpu" is given).
    impl: "kernel" (default) or "plain" — run the CUDA tensors through the
    plain PyTorch versions instead of the kernels (comparison runs only).
    msm_backend: "device" (the Pippenger MSM of `ops/msm.py`) or "host"
    (the spec's Python MSM over `DevSRS.ref.powers_of_g`; for differential
    checks of everything but the MSM).
    msm_window_bits: window of the device MSM (a divisor of 16); None picks
    `msm.auto_window_bits(n)`.
    log: optional callable; when set, every round ends by pulling one
    element to the host and logs its seconds (an attributable breakdown,
    at the cost of one sync per round).
    mesh: optional `parallel.mesh.Mesh`; every rank of it calls
    `prove_torch` with the same inputs, whole or sharded by their `shard`
    methods. The device is the rank's. When both sides of n's four-step
    plan split over the ranks, each rank holds n/D columns of the key, the
    witness, the SRS, the tables and every intermediate of rounds 1-5 (the
    layouts: `parallel/mesh.py`'s header): the transforms are four-step
    ones with one all_to_all each, the MSMs run on the rank's points, and
    the scans, the next gate and the evaluations join the ranks by small
    all-gathers. The proof is the same bytes on every rank and equals the
    unmeshed one. Otherwise every rank proves whole, each MSM split over
    the ranks by points when n splits evenly (the JAX package's
    replicated case, `prover_tpu.py:109-115`)."""

    def __init__(self, device=None, impl="kernel", log=None,
                 msm_backend="device", msm_window_bits=None, mesh=None):
        if msm_backend not in ("device", "host"):
            raise ValueError(f"msm_backend must be 'device' or 'host', "
                             f"not {msm_backend!r}")
        if msm_window_bits is not None and msm_window_bits not in \
                (1, 2, 4, 8, 16):
            raise ValueError("msm_window_bits must divide 16")
        if mesh is not None:
            if device is not None and \
                    canonical(resolve(device)) != canonical(mesh.device):
                raise ValueError(f"device {device} is not the mesh rank's "
                                 f"device {mesh.device}")
            device = mesh.device
        self.device = resolve(device)
        self.mesh = mesh
        self.impl = impl
        self.log = log
        self.msm_backend = msm_backend
        self.msm_window_bits = msm_window_bits


class DevSRS:
    """SRS points on the device: (x (L, N), y (L, N), inf (N,)), identity
    (0, 0), and `packed`, their point-major copy (N, 24) that the MSM's
    bucket kernel gathers from (`g1.pack_affine`, built once here); `ref`
    carries h / beta_h for the verifier (and powers_of_g when built by
    `from_ref`, which the host MSM backend reads)."""

    shard_of = None

    def __init__(self, points, ref):
        self.points = points
        self.packed = g1.pack_affine(points[0], points[1])
        self.ref = ref
        self.size = points[0].shape[1]

    def shard(self, mesh, n):
        """This rank's share of the first n points for a prover of size n:
        the points its coefficient columns meet (`Columns.coef`), and
        their point-major copy. Returns self when n does not split over
        the mesh."""
        cols = pmesh.Columns(n.bit_length() - 1, mesh.device, mesh)
        if not cols.sharded:
            return self
        out = DevSRS(tuple(cols.coef.take(p[..., :n]) for p in self.points),
                     self.ref)
        out.shard_of = cols.key
        return out

    @classmethod
    def from_ref(cls, srs, device=None):
        """From a spec `ref.kzg.SRS` (Python-int points)."""
        dev = resolve(device)
        return cls(g1.affine_points_to_device(srs.powers_of_g, dev), srs)


def _is_zero_col(values, n, device):
    """(n,) bool: which of `values`, padded with zeros to n, are 0 mod r."""
    col = torch.zeros(n, dtype=torch.bool)
    col[:len(values)] = torch.tensor([x % M != 0 for x in values],
                                     dtype=torch.bool)
    return (~col).to(device)


class DevProverKey:
    """Selector/sigma COEFFICIENT polys plus the sigma n-domain evals and
    the four padded lookup table columns (evaluation form), all (L, n)
    int32 on the device."""

    lookup_degenerate = False
    # `parallel.mesh.Columns.key` of the columns held; None when whole
    shard_of = None

    @classmethod
    def from_ref(cls, pk, device=None):
        """From the spec's `ref.prover.ProverKey` (int lists)."""
        dev = resolve(device)
        self = cls()
        self.n = pk.n
        self.log_n = pk.n.bit_length() - 1
        self.sel_poly = {k: FR.tensor(v, dev)
                         for k, v in pk.selector_polys.items()}
        self.sigma_poly = [FR.tensor(v, dev) for v in pk.sigma_polys]
        self.sigma_evals_n = [FR.tensor(v, dev) for v in pk.sigma_evals_n]
        self.table_cols = [FR.tensor(c, dev) for c in pk.table_columns]
        self.lookup_degenerate = (
            all(v == 0 for v in pk.selector_polys.get("q_lookup", []))
            and all(all(x == 0 for x in c) for c in pk.table_columns))
        return self

    def q_lookup_zero_mask(self, cs, n):
        return _is_zero_col(cs.q_lookup, n, self.sel_poly["q_m"].device)

    def shard(self, mesh):
        """A key holding this rank's columns of every tensor: the
        coefficient layout for the selector and sigma polys, the
        evaluation layout for the sigma evaluations and the table columns
        (`parallel/mesh.Columns`). Returns self when n does not split."""
        cols = pmesh.Columns(self.log_n, mesh.device, mesh)
        if not cols.sharded:
            return self
        taken = {}

        def take(split, t):
            # a tensor the key holds twice (the zero table column) is
            # cut once
            if id(t) not in taken:
                taken[id(t)] = split.take(t)
            return taken[id(t)]

        out = copy.copy(self)
        out.sel_poly = {k: take(cols.coef, v)
                        for k, v in self.sel_poly.items()}
        out.sigma_poly = [take(cols.coef, v) for v in self.sigma_poly]
        out.sigma_evals_n = [take(cols.evals, v) for v in self.sigma_evals_n]
        out.table_cols = [take(cols.evals, v) for v in self.table_cols]
        out.shard_of = cols.key
        return out


class ProverWitness:
    """Wire value columns in evaluation form ((L, n) Montgomery tensors),
    sparse public inputs {gate: value}, and the (n,) q_lookup == 0 mask
    (needed by keys with a real lookup table)."""

    shard_of = None

    def __init__(self, wires_dev, public_inputs, q_lookup_zero_mask=None):
        self.wires_dev = wires_dev
        self.public_inputs = public_inputs
        self.q_lookup_zero_mask = q_lookup_zero_mask

    def shard(self, mesh):
        """This rank's columns (`Columns.evals`) of the wires and the mask;
        the public inputs stay as they are (gate numbers). Returns self
        when n does not split."""
        n = self.wires_dev[0].shape[-1]
        cols = pmesh.Columns(n.bit_length() - 1, mesh.device, mesh)
        if not cols.sharded:
            return self
        mask = self.q_lookup_zero_mask
        out = ProverWitness([cols.evals.take(w) for w in self.wires_dev],
                            self.public_inputs,
                            None if mask is None else cols.evals.take(mask))
        out.shard_of = cols.key
        return out

    @classmethod
    def from_composer(cls, cs, n, device=None):
        """From a `circuit.composer.StandardComposer`: its wires padded
        with the value 0 to n gates."""
        dev = resolve(device)
        val = cs.variables
        wires_dev = [FR.tensor([val[v] for v in wires]
                             + [0] * (n - len(wires)), dev)
                     for wires in (cs.w_l, cs.w_r, cs.w_o, cs.w_4)]
        return cls(wires_dev, dict(cs.public_inputs),
                   _is_zero_col(cs.q_lookup, n, dev))


# ---------------------------------------------------------------------------
# commitments
# ---------------------------------------------------------------------------

def commit_batch(dev_srs, polys, cfg):
    """KZG-commit (L, B, n) Montgomery coefficient polys -> B host affine
    points. The window points of all B polys are folded together on the
    device, and the B commitments come to the host in one copy.

    With a sharded SRS (`DevSRS.shard`) the polys are this rank's columns
    (L, B, n/D) and the points those they meet: each rank sums its own
    share into window points, which are all-gathered and added in rank
    order. With a whole SRS and a mesh whose size divides n, each rank
    takes its block of the points and of the whole polys' scalars (the
    JAX package's `_commit_batch_mesh_jit`)."""
    sharded = dev_srs.shard_of is not None
    n = polys.shape[2] * (cfg.mesh.size if sharded else 1)
    if cfg.msm_backend == "host":
        if sharded:
            polys = pmesh.Columns(n.bit_length() - 1, cfg.device,
                                  cfg.mesh).coef.gather(polys)
        return [ref_kzg.commit(dev_srs.ref, FR.from_mont_host(polys[:, b]))
                for b in range(polys.shape[1])]
    wb = cfg.msm_window_bits or tmsm.auto_window_bits(n)
    raw = mont.from_mont(FR, polys)
    if sharded:
        wpts = pmesh.msm_windows_over_ranks(cfg.mesh, dev_srs.packed, raw,
                                            wb)
    elif cfg.mesh is not None and n % cfg.mesh.size == 0:
        wpts = pmesh.sharded_msm_windows(cfg.mesh, dev_srs.packed, raw, wb)
    else:
        wpts = torch.stack([tmsm.msm_windows(dev_srs.packed, raw[:, b], wb)
                            for b in range(polys.shape[1])], dim=1)
    return g1.xyzz_to_affine_host(tmsm.fold_windows(wpts, wb))


def commit(dev_srs, poly_mont, cfg):
    """KZG-commit one (L, n) Montgomery coefficient poly -> a host affine
    point (or None)."""
    return commit_batch(dev_srs, poly_mont[:, None, :], cfg)[0]


# ---------------------------------------------------------------------------
# round programs
# ---------------------------------------------------------------------------

def _z_parts(cols, roots, wires, sigma_evals, f, tcol, h1, h2, beta, gamma,
             delta, eps):
    """Numerators/denominators + denominator totals of the two grand
    products on this rank's evaluation columns; f, tcol, h1, h2 are the
    lookup columns in evaluation form (all zero for a degenerate lookup).
    The totals are of this rank's columns: the inverse of each is all
    that `mont.inv_apply` needs here."""
    betaF, gammaF = FV(beta[:, None]), FV(gamma[:, None])
    rootsF = FV(roots)
    ks = [FV.const(k) for k in (1, K1, K2, K3)]
    numv = denv = None
    for w in range(4):
        wv = FV(wires[:, w])
        sv = FV(sigma_evals[:, w])
        nterm = wv + betaF * ks[w] * rootsF + gammaF
        dterm = wv + betaF * sv + gammaF
        numv = nterm if numv is None else numv * nterm
        denv = dterm if denv is None else denv * dterm

    one = FV.one()
    opd = FV(delta[:, None]) + one
    epsF = FV(eps[:, None])
    eps_opd = epsF * opd
    fv, tv, h1v, h2v = FV(f), FV(tcol), FV(h1), FV(h2)
    deltaF = FV(delta[:, None])
    # the next gate: element i of t_next is t[i + 1]
    t_next = FV(cols.evals.shift(tcol, 1))
    h1_next = FV(cols.evals.shift(h1, 1))
    num2 = opd * (epsF + fv) * (eps_opd + tv + deltaF * t_next)
    den2 = (eps_opd + h1v + h2v * deltaF) * \
        (eps_opd + h2v + h1_next * deltaF)
    tot_z = mont.prod_tree_total(FR, denv.v)
    tot_2 = mont.prod_tree_total(FR, den2.v)
    return numv.v, denv.v, tot_z, num2.v, den2.v, tot_2


def _z_finish(cols, num, den, inv_total):
    """ratios -> shifted prefix product -> INTT (z / z2 polynomial)."""
    dinv = mont.inv_apply(FR, den, inv_total)
    ratios = mont.mont_mul(FR, num, dinv)
    return cols.intt(cols.evals.prefix_product(FR, ratios))


def _quotient(cols, sct, pk, wl, wr, wo, w4, z, z2, pi, lookup, ch):
    """quotient_poly.rs compute(), one sub-coset at a time, on this rank's
    columns. All inputs are coefficient-form (L, n); lookup is (f, t, h1,
    h2), None for a degenerate lookup; ch maps names to (L,) challenges.
    Returns the 8 quotient chunk polys (L, 8, n)."""
    n = wl.shape[-1]
    L = FR.L
    dev = wl.device
    l1c = cols.n_inv[:, None].expand(L, n)
    base = [wl, wr, wo, w4, z, z2, pi, l1c]
    if lookup is not None:
        base += list(lookup)
    base_st = torch.stack(base, dim=1)
    arith_names = ["q_arith", "q_m", "q_l", "q_r", "q_o", "q_4", "q_c",
                   "q_hl", "q_hr", "q_h4"]
    other_names = ["q_range", "q_logic", "q_lookup", "q_fixed_group_add",
                   "q_variable_group_add"]
    arith_st = torch.stack([pk.sel_poly[k] for k in arith_names], dim=1)
    other_st = torch.stack([pk.sel_poly[k] for k in other_names], dim=1)
    sigma_st = torch.stack(pk.sigma_poly, dim=1)
    roots = sct.roots

    def c(name):
        return FV(ch[name][:, None])

    acc = torch.zeros((L, 8, n), dtype=torch.int32, device=dev)
    for j in range(8):
        shift = sct.shift_pows[:, j]
        shift_inv = sct.shift_inv_pows[:, j]

        def evals(st):
            return cols.ntt(mont.mont_mul(FR, st, shift[:, None, :]))

        E = evals(base_st)

        def ev(i):
            return FV(E[:, i])

        def nxt(i):
            # the next gate
            return FV(cols.evals.shift(E[:, i], 1))

        a, b, cw, d = ev(0), ev(1), ev(2), ev(3)
        a_n, b_n, d_n = nxt(0), nxt(1), nxt(3)
        zF, z_n = ev(4), nxt(4)
        z2F, z2_n = ev(5), nxt(5)
        piF = ev(6)
        l1F = ev(7)

        Ea = evals(arith_st)
        sel_a = {k: FV(Ea[:, i]) for i, k in enumerate(arith_names)}
        arith = W.arithmetic_constraint(
            sel_a["q_arith"], sel_a["q_m"], sel_a["q_l"], sel_a["q_r"],
            sel_a["q_o"], sel_a["q_4"], sel_a["q_c"], sel_a["q_hl"],
            sel_a["q_hr"], sel_a["q_h4"], a, b, cw, d)
        q_l, q_r, q_c = sel_a["q_l"], sel_a["q_r"], sel_a["q_c"]
        del Ea, sel_a

        Eo = evals(other_st)
        sel_o = {k: FV(Eo[:, i]) for i, k in enumerate(other_names)}
        rng = sel_o["q_range"] * W.range_constraint(
            c("range"), a, b, cw, d, d_n)
        lgc = sel_o["q_logic"] * W.logic_constraint(
            c("logic"), a, b, cw, d, a_n, b_n, d_n, q_c)
        fbsm = sel_o["q_fixed_group_add"] * W.fbsm_constraint(
            c("fbsm"), a, b, cw, d, a_n, b_n, d_n, q_l, q_r,
            q_c, FV.const(JUBJUB_A), FV.const(JUBJUB_D))
        ca = sel_o["q_variable_group_add"] * W.ca_constraint(
            c("ca"), a, b, cw, d, a_n, b_n, d_n,
            FV.const(JUBJUB_A), FV.const(JUBJUB_D))
        gate = arith + piF + rng + lgc + fbsm + ca
        q_lookup = sel_o["q_lookup"]
        del Eo, sel_o, rng, lgc, fbsm, ca, arith

        Eg = evals(sigma_st)
        sig = [FV(Eg[:, i]) for i in range(4)]
        xF = FV(mont.mont_mul(FR, sct.shift_scalars[:, j:j + 1], roots))
        alpha = c("alpha")
        l1_alpha_sq = l1F * alpha * alpha
        perm = W.permutation_quotient_term(
            xF, sig[0], sig[1], sig[2], sig[3], a, b, cw, d,
            zF, z_n, alpha, l1_alpha_sq, c("beta"), c("gamma"),
            FV.const(K1), FV.const(K2), FV.const(K3))
        del Eg, sig

        if lookup is None:
            # degenerate lookup: f = t = h1 = h2 = 0 (widgets_jax algebra)
            ls = c("lookup")
            ls2 = ls.sqr()
            ls3 = ls2 * ls
            one = FV.one()
            opd = c("delta") + one
            epsF = c("epsilon")
            eps_opd = epsF * opd
            compressed = W.lc4(a, b, cw, d, c("zeta"))
            term_a = q_lookup * compressed * ls
            term_b = z2F * (opd * epsF * eps_opd) * ls2
            term_c = -(z2_n * eps_opd * eps_opd * ls2)
            term_d = (z2F - one) * l1F * ls3
            lkp = term_a + term_b + term_c + term_d
        else:
            lkp = W.lookup_quotient_term(
                q_lookup, a, b, cw, d, ev(8), ev(9), nxt(9), ev(10),
                nxt(10), ev(11), z2F, z2_n, l1F, c("delta"), c("epsilon"),
                c("zeta"), c("lookup"))

        numer = gate + perm + lkp
        Q = mont.mont_mul(FR, numer.v, sct.vh_inv[:, j:j + 1])
        D = mont.mont_mul(FR, cols.intt(Q), shift_inv)
        contrib = mont.mont_mul(FR, D[:, None, :],
                                sct.combine_c[:, :, j][:, :, None])
        acc = mont.add(FR, acc, contrib)
        del E, numer, Q, D, contrib
    return acc


def _eval_at(cols, stack, point):
    """Evaluate K polys (L, K, n) at one point (L,) -> (L, K): the rank's
    columns against its powers of the point, summed over the ranks."""
    pows = cols.coef.powers(FR, point)
    return cols.coef.sum(FR, mont.mont_mul(FR, stack, pows[:, None, :]))


def _lincomb(stack, coeffs):
    """sum_k coeffs[:, k] * stack[:, k, :] -> (L, n)."""
    prods = mont.mont_mul(FR, stack, coeffs[:, :, None])
    return tpoly.sum_last(FR, prods.transpose(1, 2))


def _open(cols, stack, coeffs, point):
    """chi-aggregation + synthetic division by (X - point), padded back to
    n coefficients (the padding column is the rank's that holds n-1)."""
    return cols.coef.divide(FR, _lincomb(stack, coeffs), point)


# ---------------------------------------------------------------------------
# the prover
# ---------------------------------------------------------------------------

def prove_torch(witness: ProverWitness, dev_pk: DevProverKey,
                dev_srs: DevSRS, transcript, cfg: ProverConfig = None):
    """Counterpart of `prove_tpu`: returns a `Proof` byte-identical to the
    spec's. Runs on cfg.device (CUDA unless "cpu" was asked for)."""
    cfg = cfg or ProverConfig()
    with kernels.impl(cfg.impl):
        return _prove(witness, dev_pk, dev_srs, transcript, cfg)


def _round_marker(cfg):
    state = {"t": time.time()}

    def mark(label, arr):
        if cfg.log is None:
            return
        arr.reshape(-1)[:1].cpu()
        now = time.time()
        cfg.log(f"prove {label}: {now - state['t']:.3f}s")
        state["t"] = now
    return mark


def _combine_split(compressed_t, compressed_f):
    """Spec `combine_split` (native C) of the compressed table and
    witness columns, (L, n) Montgomery -> (h1, h2) (L, n) Montgomery. The C
    code reads n rows of 32 little-endian bytes: the raw 16-bit limbs of
    each value, low limb first."""
    L, n = compressed_t.shape

    def rows(x):
        raw = mont.from_mont(FR, x).t().cpu().numpy()
        return raw.astype("<u2").tobytes()

    h1b, h2b = native.combine_split_bytes(rows(compressed_t),
                                          rows(compressed_f), n)

    def back(b):
        raw = np.frombuffer(b, "<u2").reshape(n, L).T.astype(np.int32)
        return mont.to_mont(FR, torch.from_numpy(raw).to(
            compressed_t.device))

    return back(h1b), back(h2b)


def _lookup_round(cols, dev_pk, witness, zeta):
    """Round 2 with a real table: compressed t and f (f takes t's first
    row where q_lookup == 0), h1/h2 by combine_split. Returns evaluations
    (f, t, h1, h2) and polynomials (f, t, h1, h2), the rank's columns.
    The host's combine_split needs whole columns: the compressed ones are
    gathered, and each rank keeps its columns of h1 and h2."""
    mask = witness.q_lookup_zero_mask
    tc = [FV(c) for c in dev_pk.table_cols]
    compressed_t = W.lc4(tc[0], tc[1], tc[2], tc[3], zeta).v
    whole_t = cols.evals.gather(compressed_t)
    w = witness.wires_dev
    m = mask[None]
    zero = torch.zeros_like(compressed_t)
    f_cols = [torch.where(m, whole_t[:, :1].expand_as(compressed_t),
                          w[0])] + [torch.where(m, zero, x) for x in w[1:]]
    compressed_f = W.lc4(*[FV(c) for c in f_cols], zeta).v
    h_1, h_2 = (cols.evals.take(h) for h in _combine_split(
        whole_t, cols.evals.gather(compressed_f)))
    del whole_t
    polys = cols.intt(torch.stack(
        [compressed_f, compressed_t, h_1, h_2], dim=1))
    return ((compressed_f, compressed_t, h_1, h_2),
            tuple(polys[:, i] for i in range(4)))


def _on_columns(obj, cols, mesh, *args):
    """The key, witness or SRS `obj` as this rank's columns: sharded here
    if it is whole, checked if it is sharded already."""
    if obj.shard_of == cols.key:
        return obj
    if obj.shard_of is None:
        return obj.shard(mesh, *args)
    raise ValueError(f"{type(obj).__name__} holds the columns (n, size, "
                     f"rank) {obj.shard_of}, not {cols.key}")


def _prove(witness, dev_pk, dev_srs, transcript, cfg):
    if not dev_pk.lookup_degenerate and witness.q_lookup_zero_mask is None:
        raise ValueError("a key with a lookup table needs the witness's "
                         "q_lookup_zero_mask (ProverWitness.from_composer)")
    dev = cfg.device
    n = dev_pk.n
    log_n = dev_pk.log_n
    cols = pmesh.Columns(log_n, dev, cfg.mesh)
    if cols.sharded:
        dev_pk = _on_columns(dev_pk, cols, cfg.mesh)
        witness = _on_columns(witness, cols, cfg.mesh)
        dev_srs = _on_columns(dev_srs, cols, cfg.mesh, n)
    elif {dev_pk.shard_of, witness.shard_of, dev_srs.shard_of} != {None}:
        raise ValueError("sharded inputs need the mesh they were sharded "
                         "over (ProverConfig.mesh)")
    width = cols.coef.layout.width
    sct = cols.subcoset_tables()
    t = transcript
    mark = _round_marker(cfg)

    def scal(x):
        return FR.scalar(x, dev)

    t.append_pi(b"pi", witness.public_inputs)

    # ------------------------------------------------------------- round 1
    pi_col = torch.zeros((FR.L, width), dtype=torch.int32, device=dev)
    local = {cols.evals.layout.local(g): v % M
             for g, v in witness.public_inputs.items()}
    local.pop(None, None)
    if local:
        pos = torch.tensor(list(local), dtype=torch.int64, device=dev)
        pi_col[:, pos] = FR.tensor(list(local.values()), dev)
    wires5 = torch.stack(list(witness.wires_dev) + [pi_col], dim=1)
    wires = wires5[:, :4]
    polys5 = cols.intt(wires5)
    wire_polys, pi_poly = polys5[:, :4], polys5[:, 4]
    w_comms = commit_batch(dev_srs, wire_polys, cfg)
    for label, c in zip((b"w_l", b"w_r", b"w_o", b"w_4"), w_comms):
        t.append_g1(label, c)

    mark("round1 (wires intt + 4 commits)", wire_polys)

    # ------------------------------------------------------------- round 2
    zeta_i = t.challenge_scalar(b"zeta")
    t.append_fr(b"zeta", zeta_i)
    zero_poly = torch.zeros((FR.L, width), dtype=torch.int32, device=dev)
    if dev_pk.lookup_degenerate:
        # all-zero table & q_lookup: f = t = h1 = h2 = 0 and their
        # commitments are the identity (gen_proof.cuh:107-115 shortcut)
        lookup_evals = (zero_poly,) * 4
        lookup_polys = None
        table_poly = f_poly = h_1_poly = h_2_poly = zero_poly
        f_comm = h_1_comm = h_2_comm = None
    else:
        lookup_evals, lookup_polys = _lookup_round(
            cols, dev_pk, witness, FV.const(zeta_i))
        f_poly, table_poly, h_1_poly, h_2_poly = lookup_polys
        f_comm, h_1_comm, h_2_comm = commit_batch(
            dev_srs, torch.stack([f_poly, h_1_poly, h_2_poly], dim=1), cfg)
    t.append_g1(b"f", f_comm)
    t.append_g1(b"h1", h_1_comm)
    t.append_g1(b"h2", h_2_comm)
    mark("round2 (lookup compress + combine_split + 3 commits)", h_2_poly)

    # ------------------------------------------------------------- round 3
    beta_i = t.challenge_scalar(b"beta")
    t.append_fr(b"beta", beta_i)
    gamma_i = t.challenge_scalar(b"gamma")
    t.append_fr(b"gamma", gamma_i)
    delta_i = t.challenge_scalar(b"delta")
    t.append_fr(b"delta", delta_i)
    epsilon_i = t.challenge_scalar(b"epsilon")
    t.append_fr(b"epsilon", epsilon_i)
    assert len({beta_i, gamma_i, delta_i, epsilon_i}) == 4

    sigma_evals = torch.stack(dev_pk.sigma_evals_n, dim=1)
    num_z, den_z, tot_z, num_2, den_2, tot_2 = _z_parts(
        cols, sct.roots, wires, sigma_evals, *lookup_evals, scal(beta_i),
        scal(gamma_i), scal(delta_i), scal(epsilon_i))
    del lookup_evals
    z_poly = _z_finish(cols, num_z, den_z, mont.host_inverse(FR, tot_z))
    z_2_poly = _z_finish(cols, num_2, den_2, mont.host_inverse(FR, tot_2))
    del num_z, den_z, num_2, den_2
    z_comm, z_2_comm = commit_batch(
        dev_srs, torch.stack([z_poly, z_2_poly], dim=1), cfg)
    t.append_g1(b"z", z_comm)
    mark("round3 (grand products + 2 commits)", z_2_poly)

    # ------------------------------------------------------------- round 4
    alpha_i = t.challenge_scalar(b"alpha")
    t.append_fr(b"alpha", alpha_i)
    range_i = t.challenge_scalar(b"range separation challenge")
    t.append_fr(b"range seperation challenge", range_i)
    logic_i = t.challenge_scalar(b"logic separation challenge")
    t.append_fr(b"logic seperation challenge", logic_i)
    fbsm_i = t.challenge_scalar(b"fixed base separation challenge")
    t.append_fr(b"fixed base separation challenge", fbsm_i)
    ca_i = t.challenge_scalar(b"variable base separation challenge")
    t.append_fr(b"variable base separation challenge", ca_i)
    lookup_i = t.challenge_scalar(b"lookup separation challenge")
    t.append_fr(b"lookup separation challenge", lookup_i)

    ch = {"alpha": scal(alpha_i), "beta": scal(beta_i),
          "gamma": scal(gamma_i), "delta": scal(delta_i),
          "epsilon": scal(epsilon_i), "zeta": scal(zeta_i),
          "range": scal(range_i), "logic": scal(logic_i),
          "fbsm": scal(fbsm_i), "ca": scal(ca_i), "lookup": scal(lookup_i)}
    t_stack = _quotient(cols, sct, dev_pk, wire_polys[:, 0],
                        wire_polys[:, 1], wire_polys[:, 2], wire_polys[:, 3],
                        z_poly, z_2_poly, pi_poly, lookup_polys, ch)
    mark("round4 quotient", t_stack)
    t_comms = commit_batch(dev_srs, t_stack, cfg)
    for i in range(8):
        t.append_g1(b"t_" + str(i + 1).encode(), t_comms[i])
    mark("round4 (8 commits)", t_stack)

    # ------------------------------------------------------------- round 5
    z_ch_i = t.challenge_scalar(b"z")
    t.append_fr(b"z", z_ch_i)
    shifted_i = z_ch_i * cols.omega % M

    sp = dev_pk.sel_poly
    at_z_polys = [wire_polys[:, 0], wire_polys[:, 1], wire_polys[:, 2],
                  wire_polys[:, 3],
                  dev_pk.sigma_poly[0], dev_pk.sigma_poly[1],
                  dev_pk.sigma_poly[2],
                  sp["q_arith"], sp["q_lookup"], sp["q_c"], sp["q_l"],
                  sp["q_r"], sp["q_hl"], sp["q_hr"], sp["q_h4"],
                  h_1_poly, h_2_poly, f_poly, table_poly]
    at_sz_polys = [z_poly, wire_polys[:, 0], wire_polys[:, 1],
                   wire_polys[:, 3], z_2_poly, h_1_poly, table_poly]
    evs_z = _eval_at(cols, torch.stack(at_z_polys, dim=1), scal(z_ch_i))
    evs_sz = _eval_at(cols, torch.stack(at_sz_polys, dim=1),
                      scal(shifted_i))
    ints = FR.from_mont_host(torch.cat([evs_z, evs_sz], dim=1))
    (a_eval, b_eval, c_eval, d_eval, ls_eval, rs_eval, os_eval, q_arith_eval,
     q_lookup_eval, q_c_eval, q_l_eval, q_r_eval, q_hl_eval, q_hr_eval,
     q_h4_eval, h1_eval, h2_eval, f_eval, table_eval) = ints[:19]
    (perm_eval, a_next_eval, b_next_eval, d_next_eval, z2_next_eval,
     h1_next_eval, table_next_eval) = ints[19:]

    vanishing_eval = (pow(z_ch_i, n, M) - 1) % M
    z_to_n = (vanishing_eval + 1) % M
    l1_eval = vanishing_eval * pow(n * ((z_ch_i - 1) % M) % M, -1, M) % M

    evaluations = Evaluations(
        a_eval=a_eval, b_eval=b_eval, c_eval=c_eval, d_eval=d_eval,
        left_sigma_eval=ls_eval, right_sigma_eval=rs_eval,
        out_sigma_eval=os_eval, permutation_eval=perm_eval,
        q_lookup_eval=q_lookup_eval, z2_next_eval=z2_next_eval,
        h1_eval=h1_eval, h1_next_eval=h1_next_eval, h2_eval=h2_eval,
        f_eval=f_eval, table_eval=table_eval,
        table_next_eval=table_next_eval,
        custom_evals=[
            ("q_arith_eval", q_arith_eval), ("q_c_eval", q_c_eval),
            ("q_l_eval", q_l_eval), ("q_r_eval", q_r_eval),
            ("q_hl_eval", q_hl_eval), ("q_hr_eval", q_hr_eval),
            ("q_h4_eval", q_h4_eval), ("a_next_eval", a_next_eval),
            ("b_next_eval", b_next_eval), ("d_next_eval", d_next_eval),
        ])

    ev = evaluations
    t.append_fr(b"a_eval", ev.a_eval)
    t.append_fr(b"b_eval", ev.b_eval)
    t.append_fr(b"c_eval", ev.c_eval)
    t.append_fr(b"d_eval", ev.d_eval)
    t.append_fr(b"left_sig_eval", ev.left_sigma_eval)
    t.append_fr(b"right_sig_eval", ev.right_sigma_eval)
    t.append_fr(b"out_sig_eval", ev.out_sigma_eval)
    t.append_fr(b"perm_eval", ev.permutation_eval)
    t.append_fr(b"f_eval", ev.f_eval)
    t.append_fr(b"q_lookup_eval", ev.q_lookup_eval)
    t.append_fr(b"lookup_perm_eval", ev.z2_next_eval)
    t.append_fr(b"h_1_eval", ev.h1_eval)
    t.append_fr(b"h_1_next_eval", ev.h1_next_eval)
    t.append_fr(b"h_2_eval", ev.h2_eval)
    for label, value in ev.custom_evals:
        t.append_fr(label.encode(), value)

    # linearisation: scalar coefficients on the host (exact spec
    # formulas), one device linear combination
    lin_terms = []

    def add_term(poly, coeff):
        lin_terms.append((poly, coeff % M))

    ab = a_eval * b_eval % M
    add_term(sp["q_m"], ab * q_arith_eval)
    add_term(sp["q_l"], a_eval * q_arith_eval)
    add_term(sp["q_r"], b_eval * q_arith_eval)
    add_term(sp["q_o"], c_eval * q_arith_eval)
    add_term(sp["q_4"], d_eval * q_arith_eval)
    add_term(sp["q_hl"], pow(a_eval, 5, M) * q_arith_eval)
    add_term(sp["q_hr"], pow(b_eval, 5, M) * q_arith_eval)
    add_term(sp["q_h4"], pow(d_eval, 5, M) * q_arith_eval)
    add_term(sp["q_c"], q_arith_eval)
    add_term(sp["q_range"], range_constraint(
        range_i, a_eval, b_eval, c_eval, d_eval, d_next_eval))
    add_term(sp["q_logic"], logic_constraint(
        logic_i, a_eval, b_eval, c_eval, d_eval, a_next_eval, b_next_eval,
        d_next_eval, q_c_eval))
    add_term(sp["q_fixed_group_add"], fbsm_constraint(
        fbsm_i, a_eval, b_eval, c_eval, d_eval, a_next_eval, b_next_eval,
        d_next_eval, q_l_eval, q_r_eval, q_c_eval))
    add_term(sp["q_variable_group_add"], ca_constraint(
        ca_i, a_eval, b_eval, c_eval, d_eval, a_next_eval, b_next_eval,
        d_next_eval))

    ls2 = lookup_i * lookup_i % M
    ls3 = ls2 * lookup_i % M
    opd = (delta_i + 1) % M
    eps_opd = epsilon_i * opd % M
    compressed = lc([a_eval, b_eval, c_eval, d_eval], zeta_i)
    add_term(sp["q_lookup"], (compressed - f_eval) % M * lookup_i % M)
    b0 = (epsilon_i + f_eval) % M
    b1 = (eps_opd + table_eval + delta_i * table_next_eval) % M
    b2 = l1_eval * ls3 % M
    add_term(z_2_poly, (opd * b0 % M * b1 % M * ls2 + b2) % M)
    c0 = (-z2_next_eval) % M * ls2 % M
    c1 = (eps_opd + h2_eval + delta_i * h1_next_eval) % M
    add_term(h_1_poly, c0 * c1 % M)

    beta_z = beta_i * z_ch_i % M
    a0 = (a_eval + beta_z + gamma_i) % M
    a1 = (b_eval + K1 * beta_z + gamma_i) % M
    a2 = (c_eval + K2 * beta_z + gamma_i) % M
    a3 = (d_eval + K3 * beta_z + gamma_i) % M
    ident = a0 * a1 % M * a2 % M * a3 % M * alpha_i % M
    add_term(z_poly, (ident + l1_eval * (alpha_i * alpha_i % M)) % M)
    s0 = (a_eval + beta_i * ls_eval + gamma_i) % M
    s1 = (b_eval + beta_i * rs_eval + gamma_i) % M
    s2 = (c_eval + beta_i * os_eval + gamma_i) % M
    copy = s0 * s1 % M * s2 % M * beta_i % M * perm_eval % M * alpha_i % M
    add_term(dev_pk.sigma_poly[3], (-copy) % M)

    zn_pow = 1
    for i in range(8):
        add_term(t_stack[:, i], (-vanishing_eval) % M * zn_pow % M)
        zn_pow = zn_pow * z_to_n % M

    lin_poly = _lincomb(torch.stack([p for p, _ in lin_terms], dim=1),
                        FR.tensor([c for _, c in lin_terms], dev))

    mark("round5 (evaluations + linearisation)", lin_poly)

    # ------------------------------------------------------------ openings
    aw_i = t.challenge_scalar(b"aggregate_witness")
    aw_polys = [lin_poly, dev_pk.sigma_poly[0], dev_pk.sigma_poly[1],
                dev_pk.sigma_poly[2], f_poly, h_2_poly, table_poly,
                wire_polys[:, 0], wire_polys[:, 1], wire_polys[:, 2],
                wire_polys[:, 3]]
    aw_chis = [pow(aw_i, k, M) for k in range(len(aw_polys))]
    aw_q = _open(cols, torch.stack(aw_polys, dim=1),
                 FR.tensor(aw_chis, dev), scal(z_ch_i))

    saw_i = t.challenge_scalar(b"aggregate_witness")
    saw_polys = [z_poly, wire_polys[:, 0], wire_polys[:, 1],
                 wire_polys[:, 3], h_1_poly, z_2_poly, table_poly]
    saw_chis = [pow(saw_i, k, M) for k in range(len(saw_polys))]
    saw_q = _open(cols, torch.stack(saw_polys, dim=1),
                  FR.tensor(saw_chis, dev), scal(shifted_i))

    mark("openings (2 divisions)", saw_q)
    aw_opening, saw_opening = commit_batch(
        dev_srs, torch.stack([aw_q, saw_q], dim=1), cfg)
    mark("openings (2 commits)", saw_q)

    return Proof(
        a_comm=w_comms[0], b_comm=w_comms[1], c_comm=w_comms[2],
        d_comm=w_comms[3], z_comm=z_comm, f_comm=f_comm, h_1_comm=h_1_comm,
        h_2_comm=h_2_comm, z_2_comm=z_2_comm, t_comms=t_comms,
        aw_opening=aw_opening, saw_opening=saw_opening,
        evaluations=evaluations)

