"""Polynomial-commitment abstraction — counterpart of the reference's
`HomomorphicCommitment` trait (`plonk-core/src/commitment.rs:8-56`), which
parameterizes the PLONK pipeline over KZG10 (SonicKZG10) and an IPA
scheme; the generic test matrix instantiates both (`test.rs:15-118`).

A PC backend exposes:
    commit(coeffs)                        -> commitment
    open_aggregate(polys, point, chi)     -> opening proof
    check(comms, point, evals, proof, chi)-> bool
Both backends share the chi-power aggregation algebra the protocol
requires (homomorphic in the commitments)."""

from ..params import R_MOD
from . import kzg
from . import ipa
from .curve import g1_add, g1_mul

M = R_MOD


def _combine_evals(evals, challenge):
    v, chi = 0, 1
    for e in evals:
        v = (v + chi * e) % M
        chi = chi * challenge % M
    return v


def _combine_comms(comms, challenge):
    c_comb, chi = None, 1
    for c in comms:
        if c is not None:
            c_comb = g1_add(c_comb, g1_mul(c, chi))
        chi = chi * challenge % M
    return c_comb


def _combine_polys(polys, challenge):
    agg, chi = [], 1
    for p in polys:
        if len(agg) < len(p):
            agg = agg + [0] * (len(p) - len(agg))
        for i, c in enumerate(p):
            agg[i] = (agg[i] + chi * c) % M
        chi = chi * challenge % M
    return agg


class KzgPC:
    """SonicKZG10 over a powers-of-tau SRS (the production scheme)."""

    name = "kzg"

    def __init__(self, srs):
        self.srs = srs

    def commit(self, coeffs):
        return kzg.commit(self.srs, coeffs)

    def open_aggregate(self, polys, point, challenge):
        return kzg.open_aggregate(self.srs, polys, point, challenge)

    def check(self, comms, point, evals, proof, challenge):
        return kzg.check(self.srs, comms, point, evals, proof, challenge)


class IpaPC:
    """Bulletproofs-style inner-product argument: transparent setup,
    log-size openings (`ref/ipa.py`). The aggregate opening commits to
    the chi-combined polynomial; soundness of the combined evaluation
    rides on ipa.check binding z and v into its own transcript."""

    name = "ipa"

    def __init__(self, params: ipa.IpaParams):
        self.params = params

    def commit(self, coeffs):
        return ipa.commit(self.params, coeffs)

    def open_aggregate(self, polys, point, challenge):
        agg = _combine_polys(polys, challenge)
        v, proof = ipa.open_proof(self.params, agg, point)
        return proof

    def check(self, comms, point, evals, proof, challenge):
        c_comb = _combine_comms(comms, challenge)
        v_comb = _combine_evals(evals, challenge)
        return ipa.check(self.params, c_comb, point, v_comb, proof)
