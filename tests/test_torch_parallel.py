"""The port's multi-rank prover on the CPU: `zprize_tpu_torch/parallel/
mesh.py` (four-step NTT and INTT with an all_to_all transpose, sharded
MSM window, point sum and Poseidon, `spawn_cpu`), the meshed
`prove_torch` and `entry.dryrun_multichip`.

Every rank is a gloo process started by `mesh.spawn_cpu`: the JAX package
runs `tests/test_parallel.py` on 8 virtual devices of one process, which
torch does not have. The ranks' results are held to the JAX package's
oracles (`reference_four_step_check`, the spec domain, the Python-int
curve, `poseidon.ref.hash2`, `ref.prover.prove` and its verifier) with
exact equality, as everywhere in the port.

The JAX package is imported inside the tests, not at the top: each
spawned rank imports this module to find its function, and should not
pay for importing JAX. The comparison with the JAX package's compiled
INTT is `slow` (its 2^8 plan compiles for ~40 s on a CPU), as is the dry
run (a spec set-up, two ranks' proves and a verify: ~30 s).
"""

import random
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from zprize_tpu_torch.circuit import StandardComposer
from zprize_tpu_torch.curve import g1
from zprize_tpu_torch.entry import dryrun_circuit
from zprize_tpu_torch.fields.mont import FR
from zprize_tpu_torch.params import R_MOD
from zprize_tpu_torch.parallel import mesh as pmesh
from zprize_tpu_torch.protocol import prover_torch as pt
from zprize_tpu_torch.protocol.serde import serialize_proof
from zprize_tpu_torch.protocol.srs import device_srs, host_srs

SPAWN_TIMEOUT_S = 300
TAU = 123456789
LABEL = b"test"


def _fr_ints(t):
    return FR.from_mont_host(t.reshape(FR.L, -1))


def _point(p):
    """xyzz (4L,) -> affine Python-int point (or None)."""
    return g1.xyzz_to_affine_host(p[:, None])[0]


@pytest.mark.parametrize("m", [6, 7])
def test_shard_last_takes_the_rank_block_or_the_whole(m):
    """An axis of 6 splits over 3 ranks, one of 7 does not (every rank then
    keeps it whole, as `ProverConfig.shard_last` replicates)."""
    t = torch.arange(2 * m).reshape(2, m)
    blocks = [pmesh.shard_last(types.SimpleNamespace(rank=r, size=3), t)
              for r in range(3)]
    if m % 3:
        assert all(b is t for b in blocks)
    else:
        assert all(b.is_contiguous() for b in blocks)
        assert torch.equal(torch.cat(blocks, dim=-1), t)


def test_make_mesh_without_rank_needs_torchrun_environment(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK is not set"):
        pmesh.make_mesh(device="cpu")


@pytest.mark.parametrize("rank,size", [(0, 1), (1, 2), (3, 4)])
@pytest.mark.parametrize("invert", [False, True])
def test_four_step_twiddles_are_the_rank_rows_powers(rank, size, invert):
    """The twiddles gathered from the radix-2 plan's half-table are
    w^(+-i1 k2) for this rank's rows i1, computed here with Python ints."""
    from zprize_tpu.ref.field import root_of_unity
    fsp = pmesh.FourStepPlan(4, 4, "cpu")
    tw = pmesh.FourStepPlan.twiddles(
        fsp, types.SimpleNamespace(rank=rank, size=size), invert)
    rows = fsp.n1 // size
    assert tw.shape == (FR.L, rows, fsp.n2)
    w = root_of_unity(8)
    if invert:
        w = pow(w, -1, R_MOD)
    assert _fr_ints(tw) == [pow(w, (rank * rows + i) * k, R_MOD)
                            for i in range(rows) for k in range(fsp.n2)]


# ---------------------------------------------------------------------------
# the primitives, on 2 and 4 ranks
# ---------------------------------------------------------------------------

def _inputs():
    """Seeded inputs, drawn as tests/test_parallel.py draws them."""
    from zprize_tpu_torch.ref.curve import G1_GEN, g1_mul
    rng = random.Random(11)
    rows = [[rng.randrange(R_MOD) for _ in range(16)] for _ in range(16)]
    rng = random.Random(12)
    evals = [rng.randrange(R_MOD) for _ in range(256)]
    rng = random.Random(3)
    msm_pts = [g1_mul(G1_GEN, rng.randrange(1, 500)) for _ in range(32)]
    digits = [rng.randrange(16) for _ in range(32)]
    rng = random.Random(6)
    sum_pts = [g1_mul(G1_GEN, rng.randrange(1, 500)) for _ in range(16)]
    rng = random.Random(4)
    left = [rng.randrange(R_MOD) for _ in range(16)]
    right = [rng.randrange(R_MOD) for _ in range(16)]
    srs_pts, _, _ = device_srs(31, tau=TAU, device="cpu")
    rng = np.random.default_rng(5)
    polys = FR.tensor([int(v) for v in rng.integers(0, 1 << 62, 2 * 16)],
                      "cpu").reshape(FR.L, 2, 16)
    return {"rows": rows, "evals": evals, "msm_pts": msm_pts,
            "digits": digits, "sum_pts": sum_pts, "left": left,
            "right": right, "srs_pts": srs_pts, "polys": polys}


def _commit_rank(mesh, inp):
    """commit_batch of two n = 16 polys through the mesh (2-bit windows:
    the fewest plain point additions at n = 16), and whether it took the
    sharded MSM."""
    calls = []
    sharded = pmesh.sharded_msm_windows

    def spy(*a):
        calls.append(1)
        return sharded(*a)
    pmesh.sharded_msm_windows = spy
    cfg = pt.ProverConfig(mesh=mesh, msm_window_bits=2)
    got = pt.commit_batch(pt.DevSRS(inp["srs_pts"], None), inp["polys"],
                          cfg)
    return got, bool(calls)


def _primitives_rank(mesh, inp):
    """Every sharded primitive once on this rank; Python-int results."""
    fsp = pmesh.FourStepPlan(4, 4, "cpu")                       # n = 256
    flat = [v for row in inp["rows"] for v in row]
    x = FR.tensor(flat, "cpu").reshape(FR.L, fsp.n1, fsp.n2)
    R = pmesh.four_step_ntt(fsp, mesh, x)
    coeffs = pmesh.four_step_intt_natural(fsp, mesh,
                                          FR.tensor(inp["evals"], "cpu"))
    mx, my, _ = g1.affine_points_to_device(inp["msm_pts"], "cpu")
    digits = torch.tensor(inp["digits"], dtype=torch.int64)
    window = pmesh.sharded_msm_window_partials(mesh, mx, my, digits, 4)
    sx, sy, _ = g1.affine_points_to_device(inp["sum_pts"], "cpu")
    total = pmesh.sharded_point_sum(mesh, sx, sy)
    hashes = pmesh.sharded_poseidon_hashes(
        mesh, FR.tensor(inp["left"], "cpu"), FR.tensor(inp["right"], "cpu"))
    commit, sharded = _commit_rank(mesh, inp)
    return {"R": [_fr_ints(R[:, i]) for i in range(fsp.n1)],
            "coeffs": _fr_ints(coeffs), "window": _point(window),
            "total": _point(total), "hashes": _fr_ints(hashes),
            "commit": commit, "sharded": sharded}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, inputs):
    return pmesh.spawn_cpu(_primitives_rank, request.param, inputs,
                           timeout_s=SPAWN_TIMEOUT_S)


def test_four_step_ntt_matches_reference(ranks, inputs):
    """FourStepPlan(4, 4): n = 256, 16 x 16, as test_parallel.py."""
    from zprize_tpu.parallel.mesh import reference_four_step_check
    # the JAX oracle reads only n1 and n2 of its plan
    plan = types.SimpleNamespace(n1=16, n2=16)
    assert ranks["R"] == reference_four_step_check(plan, inputs["rows"])


def test_four_step_intt_natural_matches_spec(ranks, inputs):
    """Against the spec domain that `zprize_tpu.ops.ntt` is pinned to."""
    from zprize_tpu.ref.domain import Domain
    assert ranks["coeffs"] == Domain(256).ifft(inputs["evals"])


@pytest.mark.slow
def test_four_step_intt_natural_matches_jax_intt(ranks, inputs):
    import jax.numpy as jnp
    from zprize_tpu.fields.mont import FR as JFR
    from zprize_tpu.ops import ntt as jntt
    want = jntt.intt(jntt.get_plan(8),
                     jnp.asarray(JFR.to_mont_host(inputs["evals"])))
    assert ranks["coeffs"] == JFR.from_mont_host(np.asarray(want))


def test_sharded_msm_window_matches_curve_sum(ranks, inputs):
    """32 points, 4-bit digits, as test_parallel.py."""
    from zprize_tpu.ref.curve import g1_add, g1_mul
    expect = None
    for p, d in zip(inputs["msm_pts"], inputs["digits"]):
        expect = g1_add(expect, g1_mul(p, d))
    assert ranks["window"] == expect


def test_sharded_point_sum_matches_curve_sum(ranks, inputs):
    from zprize_tpu.ref.curve import g1_add
    expect = None
    for p in inputs["sum_pts"]:
        expect = g1_add(expect, p)
    assert ranks["total"] == expect


def test_sharded_poseidon_matches_spec_hash2(ranks, inputs):
    from zprize_tpu.poseidon.constants import PoseidonConstants
    from zprize_tpu.poseidon.ref import hash2
    c = PoseidonConstants.generate(3)
    assert ranks["hashes"] == [hash2(c, a, b) for a, b in
                               zip(inputs["left"], inputs["right"])]


# ---------------------------------------------------------------------------
# the meshed prover
# ---------------------------------------------------------------------------

def _prove(mesh, srs, pk, transcript):
    """The port's prove of the circuit, msm window 8, on the CPU; through
    `mesh` unless it is None."""
    cs = dryrun_circuit(StandardComposer())
    cfg = pt.ProverConfig(device=None if mesh else "cpu", mesh=mesh,
                          msm_window_bits=8)
    return pt.prove_torch(pt.ProverWitness.from_composer(cs, pk.n, "cpu"),
                          pt.DevProverKey.from_ref(pk, "cpu"),
                          pt.DevSRS.from_ref(srs, "cpu"), transcript.clone(),
                          cfg)


@pytest.fixture(scope="module")
def proofs():
    """The meshed proof at world size 2 (rank 0's: every rank folds the
    same gathered window points), the port's unmeshed proof, and the
    spec's key and proof (JAX package), over the first 65 powers of tau =
    123456789 (those of `srs_1k`; a circuit of n = 16 reads no more). The
    ranks prove while this process makes the spec's proof and the
    unmeshed one."""
    from zprize_tpu.circuit.composer import StandardComposer as JaxComposer
    from zprize_tpu.protocol.serde import serialize_proof as jax_serialize
    from zprize_tpu.protocol.transcript_protocol import TranscriptProtocol
    from zprize_tpu.ref import prover as rp
    from zprize_tpu_torch.protocol.transcript_protocol import \
        TranscriptProtocol as PortTranscript
    from zprize_tpu_torch.ref import prover as port_rp
    threads = torch.get_num_threads()
    # one thread, as each rank has: the plain versions' small tensor
    # operations slow down ~3x when 8 threads contend with the ranks
    torch.set_num_threads(1)
    try:
        pts, lite, _ = device_srs(64, tau=TAU, device="cpu")
        srs = host_srs(pts, lite)
        ptr = PortTranscript(LABEL)
        port_pk, _ = port_rp.preprocess(
            dryrun_circuit(StandardComposer()), srs, ptr)
        with ThreadPoolExecutor(max_workers=1) as ex:
            ranks = ex.submit(pmesh.spawn_cpu, _prove, 2, srs, port_pk, ptr,
                              timeout_s=SPAWN_TIMEOUT_S)
            jcs = dryrun_circuit(JaxComposer())
            tr = TranscriptProtocol(LABEL)
            pk, vk = rp.preprocess(jcs, srs, tr)
            spec = jax_serialize(rp.prove(jcs, pk, srs, tr.clone()))
            unmeshed = serialize_proof(_prove(None, srs, port_pk, ptr))
            meshed = serialize_proof(ranks.result())
    finally:
        torch.set_num_threads(threads)
    return {"srs": srs, "vk": vk, "jcs": jcs, "spec": spec,
            "unmeshed": unmeshed, "meshed": meshed}


def test_meshed_proof_equals_spec(proofs):
    assert proofs["meshed"] == proofs["spec"]


def test_meshed_proof_verifies(proofs):
    """The spec's verifier on the meshed bytes, read back by the JAX
    package's deserializer."""
    from zprize_tpu.protocol.serde import deserialize_proof
    from zprize_tpu.protocol.transcript_protocol import TranscriptProtocol
    from zprize_tpu.ref import prover as rp
    from zprize_tpu.ref.verifier import verify
    vtr = TranscriptProtocol(LABEL)
    rp.seed_transcript(vtr, proofs["vk"])
    assert verify(proofs["vk"], proofs["srs"],
                  deserialize_proof(proofs["meshed"]),
                  proofs["jcs"].public_inputs, vtr)


def test_meshed_proof_equals_unmeshed_port_proof(proofs):
    assert proofs["meshed"] == proofs["unmeshed"]


@pytest.fixture(scope="module")
def unmeshed_commit(inputs):
    return pt.commit_batch(pt.DevSRS(inputs["srs_pts"], None),
                           inputs["polys"],
                           pt.ProverConfig(device="cpu", msm_window_bits=2))


def test_meshed_commit_equals_unmeshed(ranks, unmeshed_commit):
    """n = 16 splits over 2 and 4 ranks: the sharded MSM, the same
    points."""
    assert ranks["sharded"]
    assert ranks["commit"] == unmeshed_commit


def test_commit_on_three_ranks_is_unmeshed(inputs, unmeshed_commit):
    """n = 16 does not split over 3 ranks: every rank commits whole."""
    got, sharded = pmesh.spawn_cpu(_commit_rank, 3, inputs,
                                   timeout_s=SPAWN_TIMEOUT_S)
    assert not sharded
    assert got == unmeshed_commit


# ---------------------------------------------------------------------------
# spawn_cpu's failures, and the dry run
# ---------------------------------------------------------------------------

def _failing_rank(mesh, how):
    if mesh.rank == 1:
        if how == "raise":
            raise ValueError("rank one fails on purpose")
        time.sleep(3600)
    if how == "raise":
        # rank 0 waits in a collective that rank 1 never joins
        torch.distributed.barrier()
    return mesh.rank


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_spawn_cpu_names_the_failing_rank(how):
    """A rank that raises is named as soon as it does (the deadline is
    generous: starting a rank takes seconds, more on a loaded machine);
    a rank that hangs is killed at a short deadline and named."""
    timeout = SPAWN_TIMEOUT_S if how == "raise" else 6
    t0 = time.monotonic()
    if how == "raise":
        with pytest.raises(RuntimeError, match="rank 1 raised") as e:
            pmesh.spawn_cpu(_failing_rank, 2, how, timeout_s=timeout)
        assert "rank one fails on purpose" in str(e.value)
    else:
        with pytest.raises(TimeoutError, match=r"rank\(s\) \[.*1\]"):
            pmesh.spawn_cpu(_failing_rank, 2, how, timeout_s=timeout)
    # raised within its timeout, plus the time to kill and join
    assert time.monotonic() - t0 < timeout + 30


def test_multihost_dryrun_tool_with_torchrun_environment():
    """The tool's two ranks meet as torchrun starts them (env://)."""
    from zprize_tpu_torch.tools import multihost_dryrun
    multihost_dryrun.run(timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.slow
def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    from zprize_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(2, device="cpu")
    assert out == {"shapes": [(16, 16), (16, 8, 8)],
                   "proof_bytes_equal": True, "verify": True}
    lines = capsys.readouterr().out.splitlines()
    assert lines == [
        "dryrun_multichip(2): primitives ok — shapes [(16, 16), (16, 8, 8)]",
        "dryrun_multichip(2): full meshed proof byte-equal to spec + "
        "verified"]
