"""Sigma permutation construction (copy constraints).

Clone of `plonk-core/src/permutation/mod.rs:101-215`: identity-initialised
per-wire sigma maps, variable cycles in wire-insertion order, then mapped to
coset representatives H, K1·H, K2·H, K3·H.
"""

from ..params import R_MOD, K1, K2, K3
from ..ref.domain import Domain

KS = (1, K1, K2, K3)


def compute_sigma_permutations(var_map, n):
    """Returns 4 lists of (wire_type, gate_index) of length n."""
    sigmas = [[(w, i) for i in range(n)] for w in range(4)]
    for wire_list in var_map.values():
        m = len(wire_list)
        for idx, (wt, gate) in enumerate(wire_list):
            nxt = wire_list[(idx + 1) % m]
            if gate < n:
                sigmas[wt][gate] = nxt
    return sigmas


def sigma_evals(sigmas, domain: Domain):
    """Map sigma wire-data to field elements: K_w * omega^i."""
    roots = list(domain.elements())
    out = []
    for s in sigmas:
        out.append([KS[wt] * roots[i] % R_MOD for (wt, i) in s])
    return out


def compute_sigma_polynomials(cs, n, domain: Domain):
    """Returns (4 sigma coefficient polys, 4 sigma eval vectors)."""
    assert n == domain.n
    sigmas = compute_sigma_permutations(cs.var_map, n)
    evals = sigma_evals(sigmas, domain)
    polys = [domain.ifft(e) for e in evals]
    return polys, evals
