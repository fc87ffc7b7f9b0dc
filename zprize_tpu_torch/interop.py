"""Carry state from the JAX package into the port: its parameters, given
as numpy arrays (limbs-leading uint32, 16-bit limbs, Montgomery form),
become the port's int32 tensors on a device. The values are the same bits,
so one key and one witness can feed both provers."""

import numpy as np
import torch

from .device import resolve
from .protocol.prover_torch import DevProverKey


def _t(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    return torch.from_numpy(a.astype(np.int32)).to(device)


def srs_points(x, y, inf, device=None):
    """`device_srs` points (x (24, n), y (24, n), inf (n,)) -> tensors."""
    dev = resolve(device)
    return _t(x, dev), _t(y, dev), _t(inf, dev)


def prover_key(sel_poly, sigma_poly, sigma_evals_n, table_cols,
               lookup_degenerate, n, device=None):
    """The fields of a JAX `DevProverKey` -> the port's DevProverKey."""
    dev = resolve(device)
    pk = DevProverKey()
    pk.n = int(n)
    pk.log_n = pk.n.bit_length() - 1
    pk.sel_poly = {k: _t(v, dev) for k, v in sel_poly.items()}
    pk.sigma_poly = [_t(v, dev) for v in sigma_poly]
    pk.sigma_evals_n = [_t(v, dev) for v in sigma_evals_n]
    pk.table_cols = [_t(v, dev) for v in table_cols]
    pk.lookup_degenerate = bool(lookup_degenerate)
    return pk


def prover_key_from_jax(jax_pk, device=None):
    """Convenience over `prover_key` for an object with the JAX
    DevProverKey's attributes (arrays are read with np.asarray)."""
    return prover_key(
        {k: np.asarray(v) for k, v in jax_pk.sel_poly.items()},
        [np.asarray(v) for v in jax_pk.sigma_poly],
        [np.asarray(v) for v in jax_pk.sigma_evals_n],
        [np.asarray(v) for v in jax_pk.table_cols],
        jax_pk.lookup_degenerate, jax_pk.n, device)


def witness_wires(wires, device=None):
    """`ProverWitness` wire columns [4 x (16, n)] -> tensors."""
    dev = resolve(device)
    return [_t(w, dev) for w in wires]
