"""The port's general-circuit path on the CPU against the JAX package:
`DevProverKey.from_ref` / `ProverWitness.from_composer` against the JAX
ones, proofs of the arithmetic + range + public-input circuit and of the
lookup circuit of `tests/test_prover_tpu.py` byte-identical to the
executable spec `zprize_tpu.ref.prover.prove` with both MSM backends, the
native `combine_split` against the spec's, `keys_io` files read across the
two packages, and `prove_many`. Inputs are seeded; comparisons exact."""

import multiprocessing
import random

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread)

from zprize_tpu.params import R_MOD
from zprize_tpu.circuit.composer import StandardComposer as JaxComposer
from zprize_tpu.protocol import keys_io as jax_keys_io
from zprize_tpu.protocol import prover_tpu as tp
from zprize_tpu.protocol.serde import serialize_proof as jax_serialize
from zprize_tpu.protocol.transcript_protocol import TranscriptProtocol
from zprize_tpu.ref import prover as rp

from zprize_tpu_torch import native
from zprize_tpu_torch.circuit.composer import StandardComposer
from zprize_tpu_torch.protocol import keys_io
from zprize_tpu_torch.protocol import prover_torch as pt
from zprize_tpu_torch.protocol.batch import prove_many
from zprize_tpu_torch.protocol.serde import serialize_proof
from zprize_tpu_torch.protocol.transcript_protocol import \
    TranscriptProtocol as PortTranscript
from zprize_tpu_torch.ref import prover as port_rp
from zprize_tpu_torch.ref.verifier import verify as port_verify


def _arith(cs):
    """tests/test_prover_tpu.py `_build_circuit`."""
    a = cs.add_input(20)
    b = cs.add_input(5)
    cs.arithmetic_gate(q_l=1, q_r=1, w_l=a, w_r=b, q_o=0, w_o=cs.zero_var,
                       pi=(-25) % R_MOD)
    e = cs.mul(a, b)
    cs.constrain_to_constant(e, 100)
    cs.range_gate(a, 6)
    return cs


def _lookup(cs):
    """tests/test_prover_tpu.py lookup circuit."""
    cs.lookup_table.insert_multiple_xor(0, 4)
    a = cs.add_input(2)
    b = cs.add_input(3)
    c = cs.add_input(1)
    cs.lookup_gate(a, b, c)
    return cs


CIRCUITS = {"arith": (_arith, b"test"), "lookup": (_lookup, b"lk")}


@pytest.fixture(scope="module")
def spec(srs_1k):
    """Per circuit: the spec's key and proof (JAX package) and the port's
    own preprocess of the port's composer."""
    out = {}
    for name, (build, label) in CIRCUITS.items():
        jcs = build(JaxComposer())
        tr = TranscriptProtocol(label)
        pk, vk = rp.preprocess(jcs, srs_1k, tr)
        proof = rp.prove(jcs, pk, srs_1k, tr.clone())
        cs = build(StandardComposer())
        ptr = PortTranscript(label)
        ppk, pvk = port_rp.preprocess(cs, srs_1k, ptr)
        out[name] = {"jcs": jcs, "pk": pk, "vk": vk,
                     "proof": jax_serialize(proof), "cs": cs, "port_pk": ppk,
                     "port_vk": pvk, "tr": ptr, "label": label}
    return out


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_from_ref_and_from_composer_match_jax(spec, name):
    s = spec[name]
    assert s["port_vk"].commitments == s["vk"].commitments
    assert s["port_vk"].table_commitments == s["vk"].table_commitments
    dpk = pt.DevProverKey.from_ref(s["port_pk"], "cpu")
    jpk = tp.DevProverKey.from_ref(s["pk"])
    assert (dpk.n, dpk.log_n, dpk.lookup_degenerate) == \
        (jpk.n, jpk.log_n, jpk.lookup_degenerate) == \
        (jpk.n, jpk.log_n, name == "arith")
    assert list(dpk.sel_poly) == list(jpk.sel_poly)
    for k in jpk.sel_poly:
        assert np.array_equal(_u32(dpk.sel_poly[k]),
                              np.asarray(jpk.sel_poly[k])), k
    for field in ("sigma_poly", "sigma_evals_n", "table_cols"):
        for got, want in zip(getattr(dpk, field), getattr(jpk, field)):
            assert np.array_equal(_u32(got), np.asarray(want)), field
    w = pt.ProverWitness.from_composer(s["cs"], dpk.n, "cpu")
    jw = tp.ProverWitness.from_composer(s["jcs"], jpk.n)
    for got, want in zip(w.wires_dev, jw.wires_dev):
        assert np.array_equal(_u32(got), np.asarray(want))
    assert np.array_equal(w.q_lookup_zero_mask.numpy(),
                          np.asarray(jw.q_lookup_zero_mask))
    assert np.array_equal(
        dpk.q_lookup_zero_mask(s["cs"], dpk.n).numpy(),
        np.asarray(jpk.q_lookup_zero_mask(s["jcs"], jpk.n)))
    assert w.public_inputs == jw.public_inputs


def _prove(s, srs, backend, pk=None):
    # a 2-bit window: the fewest plain point additions at n = 16 (the
    # automatic choice is held to the spec by test_torch_slice.py)
    cfg = pt.ProverConfig(device="cpu", msm_backend=backend,
                          msm_window_bits=2 if backend == "device" else None)
    pk = pk or pt.DevProverKey.from_ref(s["port_pk"], "cpu")
    w = pt.ProverWitness.from_composer(s["cs"], pk.n, "cpu")
    return pt.prove_torch(w, pk, pt.DevSRS.from_ref(srs, "cpu"),
                          s["tr"].clone(), cfg)


def _verifies(s, srs, proof, pi=None):
    vtr = PortTranscript(s["label"])
    port_rp.seed_transcript(vtr, s["port_vk"])
    return port_verify(s["port_vk"], srs, proof,
                       s["cs"].public_inputs if pi is None else pi, vtr)


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_proof_byte_identical_to_spec(spec, srs_1k, name, backend):
    s = spec[name]
    proof = _prove(s, srs_1k, backend)
    assert serialize_proof(proof) == s["proof"]
    assert (proof.f_comm is None) == (name == "arith")
    assert _verifies(s, srs_1k, proof)


def test_native_combine_split_matches_spec():
    rng = random.Random(11)
    for n in (1, 16, 257):
        pool = [rng.randrange(R_MOD) for _ in range(max(1, n // 4))]
        t = [rng.choice(pool) for _ in range(n)]
        f = [rng.choice(t) for _ in range(n)]

        def rows(xs):
            return b"".join(x.to_bytes(32, "little") for x in xs)

        h1, h2 = native.combine_split_bytes(rows(t), rows(f), n)
        want1, want2 = rp.combine_split(t, f)
        assert (len(want1), len(want2)) == (n, n)
        assert h1 == rows(want1) and h2 == rows(want2)
        f[-1] = next(x for x in range(n + 1) if x not in t)
        with pytest.raises(ValueError, match="not in t"):
            rp.combine_split(t, f)
        with pytest.raises(ValueError, match="not in t"):
            native.combine_split_bytes(rows(t), rows(f), n)


def _same_pk(a, b):
    """Two prover keys (either package) hold the same arrays."""
    def arr(x):
        return np.asarray(x).astype(np.uint32)
    assert a.n == b.n and a.lookup_degenerate == b.lookup_degenerate
    assert sorted(a.sel_poly) == sorted(b.sel_poly)
    for k in a.sel_poly:
        assert np.array_equal(arr(a.sel_poly[k]), arr(b.sel_poly[k])), k
    for field in ("sigma_poly", "sigma_evals_n", "table_cols"):
        for x, y in zip(getattr(a, field), getattr(b, field)):
            assert np.array_equal(arr(x), arr(y)), field


def test_keys_io_files_cross_packages(spec, tmp_path):
    s = spec["lookup"]
    dpk = pt.DevProverKey.from_ref(s["port_pk"], "cpu")
    jpk = tp.DevProverKey.from_ref(s["pk"])
    keys_io.save_prover_key(dpk, str(tmp_path / "port_pk.npz"))
    keys_io.save_verifier_key(s["port_vk"], str(tmp_path / "port_vk.json"))
    jax_keys_io.save_prover_key(jpk, str(tmp_path / "jax_pk.npz"))
    jax_keys_io.save_verifier_key(s["vk"], str(tmp_path / "jax_vk.json"))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "jax_pk.npz", "jax_vk.json", "port_pk.npz", "port_vk.json"]
    for path in ("port_pk.npz", "jax_pk.npz"):
        mine = keys_io.load_prover_key(str(tmp_path / path), "cpu")
        theirs = jax_keys_io.load_prover_key(str(tmp_path / path))
        assert not mine.lookup_degenerate
        _same_pk(mine, dpk)
        _same_pk(theirs, dpk)
    for path in ("port_vk.json", "jax_vk.json"):
        for vk in (keys_io.load_verifier_key(str(tmp_path / path)),
                   jax_keys_io.load_verifier_key(str(tmp_path / path))):
            assert vk.n == s["vk"].n
            assert vk.commitments == s["vk"].commitments
            assert vk.table_commitments == s["vk"].table_commitments


def test_proof_from_a_loaded_key(spec, srs_1k, tmp_path):
    """A key saved by the JAX package and loaded by the port proves the
    spec's proof."""
    s = spec["lookup"]
    path = str(tmp_path / "pk.npz")
    jax_keys_io.save_prover_key(tp.DevProverKey.from_ref(s["pk"]), path)
    proof = _prove(s, srs_1k, "host", keys_io.load_prover_key(path, "cpu"))
    assert serialize_proof(proof) == s["proof"]


def _product_circuit(x, y):
    """tests/test_prover_tpu.py `test_prove_many_batch` circuit: one shape,
    a public input that depends on the witness."""
    cs = StandardComposer()
    a = cs.add_input(x)
    b = cs.add_input(y)
    p = cs.mul(a, b)
    cs.arithmetic_gate(q_l=1, q_r=0, w_l=p, w_r=cs.zero_var, q_o=0,
                       w_o=cs.zero_var, pi=(-(x * y)) % R_MOD)
    return cs


@pytest.fixture(scope="module")
def batch(srs_1k):
    """Two witnesses of one circuit shape, its key, and each witness's
    proof from a single prove_torch call."""
    cs1, cs2 = _product_circuit(6, 7), _product_circuit(3, 11)
    tr = PortTranscript(b"batch")
    pk, vk = port_rp.preprocess(cs1, srs_1k, tr)
    dpk = pt.DevProverKey.from_ref(pk, "cpu")
    dsrs = pt.DevSRS.from_ref(srs_1k, "cpu")
    ws = [pt.ProverWitness.from_composer(cs, pk.n, "cpu")
          for cs in (cs1, cs2)]
    cfg = pt.ProverConfig(device="cpu", msm_backend="host")
    singles = [serialize_proof(pt.prove_torch(w, dpk, dsrs, tr.clone(), cfg))
               for w in ws]
    return {"pk": dpk, "vk": vk, "srs": dsrs, "ws": ws, "tr": tr,
            "singles": singles}


@pytest.mark.parametrize("devices", [None, ["cpu"], ["cpu", "cpu"]],
                         ids=["sequential", "one_device", "two_processes"])
def test_prove_many_equals_single_proofs(batch, srs_1k, devices):
    """In this process without devices or with one; with two, each
    device's proofs in a spawned process of its own."""
    b = batch
    cfg = pt.ProverConfig(device="cpu", msm_backend="host")
    stats = []
    proofs, wall, pps = prove_many(b["ws"], b["pk"], b["srs"], b["tr"], cfg,
                                   devices, stats=stats)
    assert len(proofs) == 2 and wall > 0 and pps > 0
    assert len(stats) == len(devices or [None])
    for k, one in enumerate(stats):
        assert one["device"] == "cpu"
        assert len(one["prove_s"]) == len(one["cpu_s"]) == \
            len(b["ws"][k::len(stats)])
        # a spawned process reports its launches; this process keeps them
        # in kernels.COUNTS
        assert ("launches" in one) == (len(stats) > 1)
    assert [serialize_proof(p) for p in proofs] == b["singles"]
    assert proofs[0].evaluations != proofs[1].evaluations
    for proof, w in zip(proofs, b["ws"]):
        vtr = PortTranscript(b"batch")
        port_rp.seed_transcript(vtr, b["vk"])
        assert port_verify(b["vk"], srs_1k, proof, w.public_inputs, vtr)


def test_prove_many_names_the_failing_worker(batch):
    """A worker whose proof raises is named, with its device and its
    traceback, and no worker process outlives the call."""
    b = batch
    short = pt.ProverWitness([w[:, :-1] for w in b["ws"][1].wires_dev],
                             b["ws"][1].public_inputs,
                             b["ws"][1].q_lookup_zero_mask)
    cfg = pt.ProverConfig(device="cpu", msm_backend="host")
    with pytest.raises(RuntimeError,
                       match=r"prove_many: worker 1 on cpu raised") as e:
        prove_many([b["ws"][0], short], b["pk"], b["srs"], b["tr"], cfg,
                   ["cpu", "cpu"])
    assert "Traceback" in str(e.value)
    assert multiprocessing.active_children() == []


def test_prove_many_needs_the_cards_it_names(batch):
    """A card this machine does not have is named before any process
    starts; there is no quiet fallback to another device."""
    b = batch
    missing = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=rf"device cuda:{missing} is not"):
        prove_many(b["ws"], b["pk"], b["srs"], b["tr"],
                   pt.ProverConfig(device="cpu", msm_backend="host"),
                   ["cpu", f"cuda:{missing}"])
    assert multiprocessing.active_children() == []


def test_real_lookup_needs_the_witness_mask(spec, srs_1k):
    s = spec["lookup"]
    pk = pt.DevProverKey.from_ref(s["port_pk"], "cpu")
    w = pt.ProverWitness.from_composer(s["cs"], pk.n, "cpu")
    w.q_lookup_zero_mask = None
    with pytest.raises(ValueError, match="q_lookup_zero_mask"):
        pt.prove_torch(w, pk, pt.DevSRS.from_ref(srs_1k, "cpu"),
                       s["tr"].clone(), pt.ProverConfig(device="cpu"))


def test_config_rejects_unknown_msm_options():
    with pytest.raises(ValueError, match="msm_backend"):
        pt.ProverConfig(device="cpu", msm_backend="gpu")
    with pytest.raises(ValueError, match="divide 16"):
        pt.ProverConfig(device="cpu", msm_window_bits=5)
