"""The port's first slice end to end on the CPU: Merkle layout and witness
against `zprize_tpu.merkle.layout`, a height-3 proof from the spec's key
(`DevProverKey.from_ref`) and the JAX layout's witness byte-identical to the
executable spec's `zprize_tpu.ref.prover.prove`, the copied spec modules
against their originals, and the port's import and device rules."""

import ast
import copy
import os
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_threads  # noqa: F401  (one torch thread)

from zprize_tpu.params import R_MOD
from zprize_tpu.circuit.composer import StandardComposer
from zprize_tpu.fields.mont import FR as JFR
from zprize_tpu.merkle.circuit import gen_constraints
from zprize_tpu.merkle.layout import MerkleLayout as JaxLayout
from zprize_tpu.merkle.tree import MerkleTree
from zprize_tpu.poseidon.constants import PoseidonConstants as JaxPoseidon
from zprize_tpu.protocol import prover_tpu as tp
from zprize_tpu.protocol.serde import serialize_proof as jax_serialize
from zprize_tpu.protocol.transcript_protocol import TranscriptProtocol
from zprize_tpu.ref import prover as rp

from zprize_tpu_torch.fields.mont import FR
from zprize_tpu_torch.merkle.layout import MerkleLayout
from zprize_tpu_torch.protocol import prover_torch as pt
from zprize_tpu_torch.protocol.serde import serialize_proof
from zprize_tpu_torch.protocol.transcript_protocol import \
    TranscriptProtocol as PortTranscript
from zprize_tpu_torch.ref import prover as port_rp
from zprize_tpu_torch.ref.verifier import verify as port_verify

H = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(h=H, seed=7):
    rng = random.Random(seed)
    return [rng.randrange(R_MOD) for _ in range(1 << (h - 1))]


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_layout_and_witness_match_jax_layout():
    leaves = _leaves()
    jl = JaxLayout(H)
    lay = MerkleLayout(H, device="cpu")
    assert (lay.n, lay.n_vars, lay.root_gate_pos) == \
        (jl.n, jl.n_vars, jl.root_gate_pos)
    for name, v in jl.selector_limbs.items():
        assert np.array_equal(_u32(lay.selector_limbs[name]), v), name
    assert np.array_equal(lay.wire_index, jl.wire_index)
    assert np.array_equal(lay.sigma_flat(), jl.sigma_flat())
    jw, jroot, jnodes = jl.witness(jnp.asarray(JFR.to_mont_host(leaves)))
    w, root, nodes = lay.witness(FR.tensor(leaves, "cpu"))
    assert root == jroot
    assert np.array_equal(_u32(nodes), np.asarray(jnodes))
    for got, want in zip(w, jw):
        assert np.array_equal(_u32(got), np.asarray(want))


@pytest.fixture(scope="module")
def ref_h3(srs_1k):
    """Spec preprocessing + proof of the height-3 Merkle circuit."""
    param = JaxPoseidon.generate(3)
    leaves = _leaves()
    tree = MerkleTree(param, leaves, H)
    cs = StandardComposer()
    gen_constraints(tree, cs, param)
    tr = TranscriptProtocol(b"Merkle tree")
    pk, vk = rp.preprocess(cs, srs_1k, tr)
    proof = rp.prove(cs, pk, srs_1k, tr.clone())
    pi = {JaxLayout(H).root_gate_pos: (-tree.root()) % R_MOD}
    return {"srs": srs_1k, "pk": pk, "vk": vk, "proof": proof,
            "leaves": leaves, "pi": pi}


def test_sigma_evals_match_spec_key(ref_h3):
    """The layout's sigma evals equal the spec key's (the JAX layout's
    own sigma_evals_device is pinned to the same composer values, and its
    table builder takes most of a minute to compile on a CPU)."""
    lay = MerkleLayout(H, device="cpu")
    got = [FR.from_mont_host(e) for e in lay.sigma_evals_device()]
    assert got == ref_h3["pk"].sigma_evals_n


def _port_inputs(ref):
    """The spec's key and SRS through the port's `from_ref`, and the JAX
    layout's witness (numpy arrays of the same limb bits)."""
    pk = pt.DevProverKey.from_ref(ref["pk"], "cpu")
    dev_srs = pt.DevSRS.from_ref(ref["srs"], "cpu")
    jw, root, _ = JaxLayout(H).witness(
        jnp.asarray(JFR.to_mont_host(ref["leaves"])))
    wires = [torch.from_numpy(np.asarray(w).astype(np.int32)) for w in jw]
    assert {k: (-root) % R_MOD for k in ref["pi"]} == ref["pi"]
    return pk, dev_srs, wires, ref["pi"]


def test_proof_byte_identical_to_spec(ref_h3):
    pk, dev_srs, wires, pi = _port_inputs(ref_h3)
    tr = PortTranscript(b"Merkle tree")
    port_rp.seed_transcript(tr, ref_h3["vk"])
    cfg = pt.ProverConfig(device="cpu")
    proof = pt.prove_torch(pt.ProverWitness(wires, pi), pk, dev_srs, tr, cfg)
    assert serialize_proof(proof) == jax_serialize(ref_h3["proof"])
    vtr = PortTranscript(b"Merkle tree")
    port_rp.seed_transcript(vtr, ref_h3["vk"])
    assert port_verify(ref_h3["vk"], ref_h3["srs"], proof, pi, vtr)


def test_copied_verify_accepts_spec_proof_and_rejects_tampering(ref_h3):
    vk, srs, proof, pi = (ref_h3[k] for k in ("vk", "srs", "proof", "pi"))
    vtr = PortTranscript(b"Merkle tree")
    port_rp.seed_transcript(vtr, vk)
    assert port_verify(vk, srs, proof, pi, vtr)
    bad = copy.deepcopy(proof)
    bad.evaluations.a_eval = (bad.evaluations.a_eval + 1) % R_MOD
    vtr = PortTranscript(b"Merkle tree")
    port_rp.seed_transcript(vtr, vk)
    assert not port_verify(vk, srs, bad, pi, vtr)


def test_copied_spec_modules_match_originals():
    from zprize_tpu.ref import prover as orig_rp
    from zprize_tpu.transcript.merlin import Transcript as JaxMerlin
    from zprize_tpu_torch.poseidon.constants import PoseidonConstants
    from zprize_tpu_torch.transcript.merlin import Transcript
    a, b = PoseidonConstants.generate(3), JaxPoseidon.generate(3)
    assert a.round_constants == b.round_constants
    assert a.mds_matrices.m == b.mds_matrices.m
    assert (a.full_rounds, a.partial_rounds, a.domain_tag) == \
        (b.full_rounds, b.partial_rounds, b.domain_tag) == (8, 55, 3)
    assert port_rp.SELECTOR_ORDER == orig_rp.SELECTOR_ORDER
    assert port_rp.SIGMA_NAMES == orig_rp.SIGMA_NAMES
    assert port_rp.SEED_ORDER == orig_rp.SEED_ORDER
    # verbatim copies: the spec prover, the gate library, JubJub, the
    # native combine_split, the Merkle circuit
    for rel in ("ref/prover.py", "circuit/gates_ext.py", "curve/jubjub.py",
                "circuit/__init__.py", "native/hostops.c",
                "merkle/circuit.py"):
        with open(os.path.join(ROOT, "zprize_tpu", rel), "rb") as f:
            orig = f.read()
        with open(os.path.join(ROOT, "zprize_tpu_torch", rel), "rb") as f:
            assert f.read() == orig, rel
    # upstream merlin test vector (merlin/src/transcript.rs tests)
    for T in (Transcript, JaxMerlin):
        t = T(b"test protocol")
        t.append_message(b"some label", b"some data")
        assert t.challenge_bytes(b"challenge", 32).hex() == (
            "d5a21972d0d5fe320c0d263fac7fffb8"
            "145aa640af6e9bca177c03c7efcf0615")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "zprize_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    # the walk reaches the multi-rank prover and its tool
    for rel in ("parallel/mesh.py", "entry.py", "tools/multihost_dryrun.py"):
        assert os.path.join(ROOT, "zprize_tpu_torch", rel) in files, rel
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "zprize_tpu"), \
                    f"{path} imports {name}"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from zprize_tpu_torch.protocol.srs import device_srs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MerkleLayout(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_srs(15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.ProverConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.prove_torch(None, None, None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.DevSRS.from_ref(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.DevProverKey.from_ref(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.ProverWitness.from_composer(None, 16)
    from zprize_tpu_torch.entry import entry
    from zprize_tpu_torch.examples import merkle_tree, simple_circuit
    for main in (entry, merkle_tree.main, simple_circuit.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()


@pytest.mark.slow
def test_proof_equals_prove_tpu(ref_h3):
    """Directly against the JAX prover (XLA on the CPU, host MSM)."""
    pk, dev_srs, wires, pi = _port_inputs(ref_h3)
    jw = tp.ProverWitness([jnp.asarray(_u32(w)) for w in wires], pi,
                          jnp.ones((pk.n,), dtype=bool))
    jtr = TranscriptProtocol(b"Merkle tree")
    rp.seed_transcript(jtr, ref_h3["vk"])
    jproof = tp.prove_tpu(jw, tp.DevProverKey.from_ref(ref_h3["pk"]),
                          tp.DevSRS(ref_h3["srs"], device=False), jtr,
                          tp.ProverConfig(msm_backend="host"))
    tr = PortTranscript(b"Merkle tree")
    port_rp.seed_transcript(tr, ref_h3["vk"])
    proof = pt.prove_torch(pt.ProverWitness(wires, pi), pk, dev_srs, tr,
                           pt.ProverConfig(device="cpu"))
    assert serialize_proof(proof) == jax_serialize(jproof)
