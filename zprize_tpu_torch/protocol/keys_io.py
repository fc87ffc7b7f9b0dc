"""Prover/verifier key persistence — the port of
`zprize_tpu/protocol/keys_io.py`, with the same files: the prover key as a
compressed npz of limbs-leading uint32 arrays (16-bit limbs, Montgomery
form; keys `n`, `sp_<selector>`, `sigp_i`, `sige_i`, `tbl_i`), the
verifier key as JSON of decimal commitment coordinates. A file written by
either package loads into the other. Saves are atomic (write a temporary
file, then rename), so a crash never leaves a half-written key behind.
"""

import json
import os

import numpy as np
import torch

from ..device import resolve
from ..ref.prover import VerifierKey, SELECTOR_ORDER
from .prover_torch import DevProverKey


def _np(t):
    return t.cpu().numpy().astype(np.uint32)


def save_prover_key(pk: DevProverKey, path: str):
    arrays = {"n": np.asarray([pk.n])}
    for k, v in pk.sel_poly.items():
        arrays[f"sp_{k}"] = _np(v)
    for i, v in enumerate(pk.sigma_poly):
        arrays[f"sigp_{i}"] = _np(v)
    for i, v in enumerate(pk.sigma_evals_n):
        arrays[f"sige_{i}"] = _np(v)
    for i, v in enumerate(pk.table_cols):
        arrays[f"tbl_{i}"] = _np(v)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_prover_key(path: str, device=None) -> DevProverKey:
    """The key's tensors land on `device` (CUDA unless "cpu" is given)."""
    dev = resolve(device)
    with np.load(path) as z:
        def t(name):
            return torch.from_numpy(z[name].astype(np.int32)).to(dev)

        pk = DevProverKey()
        pk.n = int(z["n"][0])
        pk.log_n = pk.n.bit_length() - 1
        pk.sel_poly = {k: t(f"sp_{k}") for k in SELECTOR_ORDER}
        pk.sigma_poly = [t(f"sigp_{i}") for i in range(4)]
        pk.sigma_evals_n = [t(f"sige_{i}") for i in range(4)]
        pk.table_cols = [t(f"tbl_{i}") for i in range(4)]
        pk.lookup_degenerate = bool(
            not np.any(z["sp_q_lookup"])
            and all(not np.any(z[f"tbl_{i}"]) for i in range(4)))
    return pk


def _pt(p):
    return None if p is None else [str(p[0]), str(p[1])]


def _unpt(v):
    return None if v is None else (int(v[0]), int(v[1]))


def save_verifier_key(vk: VerifierKey, path: str):
    data = {
        "n": vk.n,
        "commitments": {k: _pt(v) for k, v in vk.commitments.items()},
        "table_commitments": [_pt(v) for v in vk.table_commitments],
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)


def load_verifier_key(path: str) -> VerifierKey:
    with open(path) as f:
        data = json.load(f)
    return VerifierKey(
        data["n"],
        {k: _unpt(v) for k, v in data["commitments"].items()},
        [_unpt(v) for v in data["table_commitments"]])
