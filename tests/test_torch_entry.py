"""The port's entry step, batched Poseidon hash, examples and Merkle
circuit on the CPU: `poseidon.vectorized.hash2_batch` against the JAX
package's and the copied spec's `hash2`; `entry(device="cpu")`'s step
against the Python-int spec (`hash2` of the same 128 pairs, then the spec
domain's INTT of size 2^7; the JAX `entry()` is not run, since its 2^7 NTT
plan alone compiles for ~23 s on a CPU); the copied `merkle/circuit.py`
against the JAX one; both examples end to end with device="cpu" (marked
slow: on a CPU every kernel runs its plain version, and the examples' MSMs
take minutes there). Exact comparisons."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_threads  # noqa: F401  (one torch thread)

from zprize_tpu.circuit.composer import StandardComposer as JaxComposer
from zprize_tpu.fields.mont import FR as JFR
from zprize_tpu.merkle.circuit import MerkleTreeCircuit as JaxCircuit
from zprize_tpu.merkle.tree import MerkleTree as JaxTree
from zprize_tpu.poseidon.constants import PoseidonConstants as JaxPoseidon
from zprize_tpu.poseidon.vectorized import hash2_batch as jax_hash2_batch
from zprize_tpu_torch.circuit import StandardComposer
from zprize_tpu_torch.entry import entry
from zprize_tpu_torch.fields.mont import FR
from zprize_tpu_torch.merkle.circuit import MerkleTreeCircuit
from zprize_tpu_torch.merkle.tree import MerkleTree
from zprize_tpu_torch.params import R_MOD
from zprize_tpu_torch.poseidon.constants import PoseidonConstants
from zprize_tpu_torch.poseidon.ref import hash2
from zprize_tpu_torch.poseidon.vectorized import hash2_batch
from zprize_tpu_torch.ref.domain import Domain


def _ints(m, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD
            for _ in range(m)]


def test_hash2_batch_matches_jax():
    xs, ys = _ints(4, 1), _ints(4, 2)
    xs[0], ys[0] = 0, R_MOD - 1
    got = hash2_batch(FR.tensor(xs, "cpu"), FR.tensor(ys, "cpu"))
    want = jax_hash2_batch(jnp.asarray(JFR.to_mont_host(xs)),
                           jnp.asarray(JFR.to_mont_host(ys)))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def test_hash2_batch_matches_spec_hash2():
    xs, ys = _ints(8, 3), _ints(8, 4)
    param = PoseidonConstants.generate(3)
    got = hash2_batch(FR.tensor(xs, "cpu"), FR.tensor(ys, "cpu"))
    assert FR.from_mont_host(got) == [hash2(param, x, y)
                                      for x, y in zip(xs, ys)]


def test_entry_step_matches_spec():
    """The step on the inputs `entry` makes: the spec's hash of each pair,
    then the spec domain's inverse FFT of size 2^7."""
    step, (left, right) = entry(device="cpu")
    rng = np.random.default_rng(0)
    lefts = [rng.integers(0, 1 << 62).item() for _ in range(128)]
    rights = [rng.integers(0, 1 << 62).item() for _ in range(128)]
    assert torch.equal(left, torch.from_numpy(
        JFR.to_mont_host(lefts).astype(np.int32)))
    assert FR.from_mont_host(right) == rights
    out = step(left, right)
    assert out.shape == (16, 128) and out.dtype == torch.int32
    param = PoseidonConstants.generate(3)
    hashes = [hash2(param, x, y) for x, y in zip(lefts, rights)]
    assert FR.from_mont_host(out) == Domain(128).ifft(hashes)


def test_merkle_circuit_gate_count_matches_jax():
    """The copied MerkleTreeCircuit emits as many gates as the JAX one at
    height 3, every gate satisfied, with the same padded size."""
    rng = random.Random(9)
    leaves = [rng.randrange(R_MOD) for _ in range(4)]
    param, jparam = PoseidonConstants.generate(3), JaxPoseidon.generate(3)
    circ = MerkleTreeCircuit(param, MerkleTree(param, leaves, 3))
    jcirc = JaxCircuit(jparam, JaxTree(jparam, leaves, 3))
    cs, jcs = StandardComposer(), JaxComposer()
    circ.gadget(cs)
    jcirc.gadget(jcs)
    cs.check_circuit_satisfied()
    assert cs.n == jcs.n == 4 + 3 * 193 + 1
    assert circ.padded_circuit_size() == jcirc.padded_circuit_size()
    assert cs.public_inputs == jcs.public_inputs


@pytest.mark.slow
def test_merkle_example_runs_on_cpu():
    from zprize_tpu_torch.examples import merkle_tree
    out = merkle_tree.main(height=2, device="cpu")
    assert out["verify"] is True and out["gates"] == 4 + 193 + 1
    assert out["paths"] == 2


@pytest.mark.slow
def test_simple_circuit_example_runs_on_cpu():
    from zprize_tpu_torch.examples import simple_circuit
    out = simple_circuit.main("cpu")
    assert out["gates"] == 272 and out["verify"] is True
