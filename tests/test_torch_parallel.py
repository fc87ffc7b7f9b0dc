"""The port's multi-rank prover on the CPU: `zprize_tpu_torch/parallel/
mesh.py` (four-step NTT and INTT with an all_to_all transpose, sharded
MSM window, point sum and Poseidon, `spawn_cpu`), the steps of a rank's
columns (`Split`, `Columns`: the sharded transforms, the next-gate halo,
the carried scans, the evaluations) held to the whole functions at both
parities of log n, the sharded `prove_torch` (each rank holding n/D
columns of its key, witness, SRS and tables) and `entry.dryrun_multichip`.

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

import torch_threads  # noqa: F401  (one torch thread)

from zprize_tpu_torch.circuit import StandardComposer
from zprize_tpu_torch.curve import g1
from zprize_tpu_torch.entry import dryrun_circuit
from zprize_tpu_torch.fields.mont import FR
from zprize_tpu_torch.ops import ntt, poly
from zprize_tpu_torch.params import R_MOD
from zprize_tpu_torch.parallel import mesh as pmesh
from zprize_tpu_torch.protocol import prover_torch as pt
from zprize_tpu_torch.protocol.serde import serialize_proof
from zprize_tpu_torch.protocol.srs import device_srs, host_srs
from zprize_tpu_torch.protocol.transcript_protocol import \
    TranscriptProtocol as PortTranscript
from zprize_tpu_torch.ref import prover as port_rp

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
    # the first 65 powers of tau = 123456789 (those of `srs_1k`; a
    # circuit of n = 16 reads no more), and the port's preprocess of each
    # circuit: its key and the transcript seeded with its verifier key
    pts, lite, _ = device_srs(64, tau=TAU, device="cpu")
    srs = host_srs(pts, lite)
    keys = {}
    for name, (build, label) in CIRCUITS.items():
        tr = PortTranscript(label)
        keys[name] = (port_rp.preprocess(build(StandardComposer()), srs,
                                         tr)[0], tr)
    return {"rows": rows, "evals": evals, "msm_pts": msm_pts,
            "digits": digits, "sum_pts": sum_pts, "left": left,
            "right": right, "srs_pts": srs_pts, "polys": polys,
            "srs": srs, "keys": keys}


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


SPLIT_LOG_NS = (4, 5)          # n = 16 (n1 = n2 = 4) and 32 (4 x 8)
SPLIT_STEPS = ("ntt", "intt", "next", "prev", "prefix_product", "divide",
               "powers_coef", "powers_evals", "sum")


def _split_operands(log_n):
    """Seeded (L, 2, n) values and a point z (Python ints)."""
    rng = np.random.default_rng(40 + log_n)
    n = 1 << log_n
    x = FR.tensor([int(v) for v in rng.integers(0, 1 << 62, 2 * n)],
                  "cpu").reshape(FR.L, 2, n)
    return x, int(rng.integers(2, 1 << 62))


def _split_steps(cols, x, z):
    """Each step of `SPLIT_STEPS` on this rank's columns of x, gathered
    whole (with the whole `Columns` the steps are the whole functions)."""
    ce, ee = cols.coef, cols.evals
    zt = FR.scalar(z, "cpu")
    return {
        "ntt": ee.gather(cols.ntt(ce.take(x))),
        "intt": ce.gather(cols.intt(ee.take(x))),
        "next": ee.gather(ee.shift(ee.take(x), 1)),
        "prev": ee.gather(ee.shift(ee.take(x), -1)),
        "prefix_product": ee.gather(ee.prefix_product(FR, ee.take(x[:, 0]))),
        "divide": ce.gather(ce.divide(FR, ce.take(x[:, 0]), zt)),
        "powers_coef": ce.gather(ce.powers(FR, zt)),
        "powers_evals": ee.gather(ee.powers(FR, zt)),
        "sum": ce.sum(FR, ce.take(x)),
    }


def _widths(pk, witness, sct, srs=None):
    """The last dimension of every (L, ..., n) tensor of a key, witness,
    sub-coset tables and SRS (the point-major SRS copy's first)."""
    ts = (list(pk.sel_poly.values()) + pk.sigma_poly + pk.sigma_evals_n
          + pk.table_cols + witness.wires_dev
          + [witness.q_lookup_zero_mask]
          + [sct.shift_pows, sct.shift_inv_pows, sct.roots])
    if srs is not None:
        ts += list(srs.points) + [srs.packed.t()]
    return {t.shape[-1] for t in ts}


def _lookup_circuit(cs):
    """tests/test_prover_tpu.py lookup circuit (as test_torch_circuit.py
    builds it)."""
    cs.lookup_table.insert_multiple_xor(0, 4)
    a = cs.add_input(2)
    b = cs.add_input(3)
    c = cs.add_input(1)
    cs.lookup_gate(a, b, c)
    return cs


CIRCUITS = {"dryrun": (dryrun_circuit, LABEL),
            "lookup": (_lookup_circuit, b"lk")}


def _primitives_rank(mesh, inp):
    """Every sharded primitive once on this rank, and (but on 2 ranks) the
    sharded proof of the dry-run circuit; Python-int results."""
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
    split = {}
    for log_n in SPLIT_LOG_NS:
        cols = pmesh.Columns(log_n, "cpu", mesh)
        assert cols.sharded
        split[log_n] = {k: _fr_ints(v) for k, v in
                        _split_steps(cols, *_split_operands(log_n)).items()}
    # at 2 ranks the `proofs` fixture proves
    proof = serialize_proof(_prove(mesh, inp["srs"], inp["keys"]["dryrun"])) \
        if mesh.size != 2 else None
    return {"R": [_fr_ints(R[:, i]) for i in range(fsp.n1)],
            "coeffs": _fr_ints(coeffs), "window": _point(window),
            "total": _point(total), "hashes": _fr_ints(hashes),
            "commit": commit, "sharded": sharded, "split": split,
            "proof": proof}


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

def _prove(mesh, srs, key, circuit="dryrun"):
    """The port's prove of `circuit` (key: its port key and seeded
    transcript), msm window 2 (the fewest plain point additions at n =
    16, as in test_torch_circuit.py), on the CPU; through `mesh` unless it
    is None. Through a mesh every input is sharded first, and every tensor of
    the rank's key, witness, SRS and sub-coset tables must be n/D columns
    wide (n when n does not split over the ranks)."""
    pk, transcript = key
    cs = CIRCUITS[circuit][0](StandardComposer())
    dpk = pt.DevProverKey.from_ref(pk, "cpu")
    witness = pt.ProverWitness.from_composer(cs, pk.n, "cpu")
    dsrs = pt.DevSRS.from_ref(srs, "cpu")
    if mesh is not None:
        cols = pmesh.Columns(pk.n.bit_length() - 1, "cpu", mesh)
        dpk, witness = dpk.shard(mesh), witness.shard(mesh)
        dsrs = dsrs.shard(mesh, pk.n)
        sct = cols.subcoset_tables()
        # whole, the SRS keeps all its points
        got = _widths(dpk, witness, sct, dsrs) if cols.sharded else \
            _widths(dpk, witness, sct)
        width = pk.n // mesh.size if cols.sharded else pk.n
        if got != {width}:
            raise AssertionError(f"rank {mesh.rank}: widths {got}, not "
                                 f"{{{width}}}")
    cfg = pt.ProverConfig(device=None if mesh else "cpu", mesh=mesh,
                          msm_window_bits=2)
    return pt.prove_torch(witness, dpk, dsrs, transcript.clone(), cfg)


def _spec_proof(circuit, srs):
    """The spec's verifier key and proof bytes of `circuit` (JAX
    package), and its composer."""
    from zprize_tpu.circuit.composer import StandardComposer as JaxComposer
    from zprize_tpu.protocol.serde import serialize_proof as jax_serialize
    from zprize_tpu.protocol.transcript_protocol import TranscriptProtocol
    from zprize_tpu.ref import prover as rp
    build, label = CIRCUITS[circuit]
    jcs = build(JaxComposer())
    tr = TranscriptProtocol(label)
    pk, vk = rp.preprocess(jcs, srs, tr)
    return {"vk": vk, "proof": jax_serialize(rp.prove(jcs, pk, srs,
                                                       tr.clone())),
            "jcs": jcs, "label": label}


def _spec_verifies(s, srs, proof_bytes):
    """The spec's verifier on proof bytes, read back by the JAX package's
    deserializer."""
    from zprize_tpu.protocol.serde import deserialize_proof
    from zprize_tpu.protocol.transcript_protocol import TranscriptProtocol
    from zprize_tpu.ref import prover as rp
    from zprize_tpu.ref.verifier import verify
    vtr = TranscriptProtocol(s["label"])
    rp.seed_transcript(vtr, s["vk"])
    return verify(s["vk"], srs, deserialize_proof(proof_bytes),
                  s["jcs"].public_inputs, vtr)


@pytest.fixture(scope="module")
def spec(inputs):
    return {name: _spec_proof(name, inputs["srs"]) for name in CIRCUITS}


@pytest.fixture(scope="module")
def proofs(inputs, spec):
    """The meshed proof at world size 2 (rank 0's: every rank folds the
    same gathered window points), the port's unmeshed proof, and the
    spec's key and proof (JAX package), over the first 65 powers of tau =
    123456789 (those of `srs_1k`; a circuit of n = 16 reads no more). The
    ranks prove while this process makes the unmeshed proof."""
    srs, key = inputs["srs"], inputs["keys"]["dryrun"]
    with ThreadPoolExecutor(max_workers=1) as ex:
        ranks = ex.submit(pmesh.spawn_cpu, _prove, 2, srs, key,
                          timeout_s=SPAWN_TIMEOUT_S)
        unmeshed = serialize_proof(_prove(None, srs, key))
        meshed = serialize_proof(ranks.result())
    s = spec["dryrun"]
    return {"srs": srs, "vk": s["vk"], "jcs": s["jcs"], "spec": s["proof"],
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


def _three_rank(mesh, inp):
    """A commit and a proof on one of 3 ranks, over which n = 16 splits
    neither by points nor by columns."""
    commit = _commit_rank(mesh, inp)
    return commit, serialize_proof(_prove(mesh, inp["srs"],
                                          inp["keys"]["dryrun"]))


@pytest.fixture(scope="module")
def three_ranks(inputs):
    return pmesh.spawn_cpu(_three_rank, 3, inputs, timeout_s=SPAWN_TIMEOUT_S)


def test_commit_on_three_ranks_is_unmeshed(three_ranks, unmeshed_commit):
    """n = 16 does not split over 3 ranks: every rank commits whole."""
    got, sharded = three_ranks[0]
    assert not sharded
    assert got == unmeshed_commit


def test_proof_on_three_ranks_runs_whole(three_ranks, spec):
    """A four-step side of n = 16 (4) does not split over 3 ranks: every
    rank holds all n columns (`_prove` checks the widths) and proves
    whole, the spec's bytes."""
    assert three_ranks[1] == spec["dryrun"]["proof"]


# ---------------------------------------------------------------------------
# a rank's columns and the sharded prover, on 2 and 4 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split_whole():
    """The whole functions (radix-2 NTT, torch.roll, the scans, powers,
    sum_last) on the operands the ranks split."""
    return {log_n: {k: _fr_ints(v) for k, v in _split_steps(
        pmesh.Columns(log_n, "cpu"), *_split_operands(log_n)).items()}
        for log_n in SPLIT_LOG_NS}


@pytest.mark.parametrize("log_n", SPLIT_LOG_NS)
@pytest.mark.parametrize("step", SPLIT_STEPS)
def test_split_step_equals_whole(ranks, split_whole, step, log_n):
    """Each step on the rank's columns, gathered, equals the whole step:
    at n = 16 over 4 ranks a rank holds one column of each row, so every
    element sits at a rank's edge; at n = 32 the coefficient (4) and the
    evaluation (8) layouts differ."""
    assert ranks["split"][log_n][step] == split_whole[log_n][step]


def test_split_whole_steps_match_python_ints():
    """The whole `Split` steps that have no JAX counterpart held to
    Python ints: the shifts, the shifted prefix product, the padded
    quotient by (X - z) and the powers."""
    log_n = 5
    n = 1 << log_n
    x, z = _split_operands(log_n)
    got = {k: _fr_ints(v) for k, v in _split_steps(
        pmesh.Columns(log_n, "cpu"), x, z).items()}
    a = _fr_ints(x[:, 0])
    assert got["next"][:n] == a[1:] + a[:1]
    assert got["prev"][:n] == a[-1:] + a[:-1]
    pre, acc = [], 1
    for v in a:
        pre.append(acc)
        acc = acc * v % R_MOD
    assert got["prefix_product"] == pre
    q = [sum(a[j] * pow(z, j - i - 1, R_MOD) for j in range(i + 1, n))
         % R_MOD for i in range(n)]
    assert got["divide"] == q
    assert got["powers_coef"] == [pow(z, g, R_MOD) for g in range(n)]


def _sharded_proof(ranks, proofs):
    """The dry-run circuit's sharded proof at this world size: on 2 ranks
    the `proofs` fixture's."""
    return ranks["proof"] or proofs["meshed"]


def test_sharded_proof_equals_spec(ranks, proofs, spec):
    """The dry-run circuit, n = 16, each rank holding n/D columns of its
    key, witness, SRS and tables (checked in `_prove`)."""
    assert _sharded_proof(ranks, proofs) == spec["dryrun"]["proof"]


def test_sharded_proof_verifies(ranks, proofs, spec, inputs):
    assert _spec_verifies(spec["dryrun"], inputs["srs"],
                          _sharded_proof(ranks, proofs))


def test_sharded_proof_equals_unmeshed_port_proof(ranks, proofs):
    assert _sharded_proof(ranks, proofs) == proofs["unmeshed"]


def _fake_rank(rank, size):
    """A rank's place in a mesh, for the steps that need no collective
    (`shard`, and `prove_torch` up to its first collective)."""
    return types.SimpleNamespace(rank=rank, size=size,
                                 device=torch.device("cpu"))


@pytest.mark.parametrize("size", [2, 4])
def test_rank_shards_put_together_make_the_whole(inputs, size):
    """Each rank's `shard` of the lookup circuit's key, witness and SRS,
    its columns put back at their places (`Layout.local`), gives the
    whole: coefficient columns for the polys and the SRS, evaluation
    columns for the sigma evaluations, tables, wires and mask."""
    pk, _ = inputs["keys"]["lookup"]
    n = pk.n
    cs = _lookup_circuit(StandardComposer())
    dpk = pt.DevProverKey.from_ref(pk, "cpu")
    wit = pt.ProverWitness.from_composer(cs, n, "cpu")
    srs = pt.DevSRS.from_ref(inputs["srs"], "cpu")

    def whole(pick, shards, layouts):
        out = torch.zeros_like(pick(dpk, wit, srs))[..., :n]
        for (rk, w, sr), lay in zip(shards, layouts):
            pos = [g for g in range(n) if lay.local(g) is not None]
            out[..., pos] = pick(rk, w, sr)
        return out

    shards, coef, evals = [], [], []
    for r in range(size):
        mesh = _fake_rank(r, size)
        cols = pmesh.Columns(n.bit_length() - 1, "cpu", mesh)
        shards.append((dpk.shard(mesh), wit.shard(mesh),
                       srs.shard(mesh, n)))
        assert {x.shard_of for x in shards[-1]} == {cols.key}
        coef.append(cols.coef.layout)
        evals.append(cols.evals.layout)
    picks = {
        "q_lookup": (lambda k, w, s: k.sel_poly["q_lookup"], coef),
        "sigma_1": (lambda k, w, s: k.sigma_poly[1], coef),
        "srs_x": (lambda k, w, s: s.points[0], coef),
        "sigma_evals_2": (lambda k, w, s: k.sigma_evals_n[2], evals),
        "table_0": (lambda k, w, s: k.table_cols[0], evals),
        "wire_3": (lambda k, w, s: w.wires_dev[3], evals),
        "mask": (lambda k, w, s: w.q_lookup_zero_mask, evals),
    }
    for name, (pick, layouts) in picks.items():
        assert torch.equal(whole(pick, shards, layouts),
                           pick(dpk, wit, srs)[..., :n]), name


def test_sharded_inputs_need_their_mesh(inputs):
    """A key sharded for rank 0 is refused without a mesh and by rank 1,
    before any collective."""
    pk, tr = inputs["keys"]["dryrun"]
    cs = dryrun_circuit(StandardComposer())
    sharded = pt.DevProverKey.from_ref(pk, "cpu").shard(_fake_rank(0, 2))
    args = (pt.ProverWitness.from_composer(cs, pk.n, "cpu"), sharded,
            pt.DevSRS.from_ref(inputs["srs"], "cpu"), tr.clone())
    with pytest.raises(ValueError, match="need the mesh"):
        pt.prove_torch(*args, pt.ProverConfig(device="cpu"))
    with pytest.raises(ValueError, match=r"holds the columns .* \(16, 2, 0\)"):
        pt.prove_torch(*args, pt.ProverConfig(mesh=_fake_rank(1, 2)))


@pytest.fixture(scope="module")
def lookup_proof(inputs):
    """The real-lookup circuit's sharded proof on 2 ranks: round 2 gathers
    the compressed columns for the host's combine_split and keeps each
    rank's columns of h1 and h2."""
    return serialize_proof(pmesh.spawn_cpu(
        _prove, 2, inputs["srs"], inputs["keys"]["lookup"], "lookup",
        timeout_s=SPAWN_TIMEOUT_S))


def test_sharded_lookup_proof_equals_spec(lookup_proof, spec):
    assert lookup_proof == spec["lookup"]["proof"]


def test_sharded_lookup_proof_verifies(lookup_proof, spec, inputs):
    assert _spec_verifies(spec["lookup"], inputs["srs"], lookup_proof)


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


def test_multihost_dryrun_tool_with_torchrun_environment(srs_1k):
    """The tool's two ranks meet as torchrun starts them (env://) and run
    its three stages; the full meshed proof of every rank equals the JAX
    package's spec proof (`zprize_tpu.ref.prover.prove`, same circuit,
    SRS and transcript), made here while the ranks run, and verifies.
    The SRS is the first 8 * circuit_bound + 9 powers of `srs_1k`, whose
    tau is the tool's: the points of the tool's `SRS.setup`."""
    from zprize_tpu.circuit.composer import StandardComposer as JaxComposer
    from zprize_tpu.protocol.serde import deserialize_proof, \
        serialize_proof as jax_serialize
    from zprize_tpu.protocol.transcript_protocol import TranscriptProtocol
    from zprize_tpu.ref import prover as rp
    from zprize_tpu.ref.kzg import SRS
    from zprize_tpu.ref.verifier import verify
    from zprize_tpu_torch.tools import multihost_dryrun as tool
    with ThreadPoolExecutor(max_workers=1) as ex:
        ranks = ex.submit(tool.run, timeout_s=SPAWN_TIMEOUT_S)
        jcs = dryrun_circuit(JaxComposer())
        assert tool.TAU == 123456789
        srs = SRS(srs_1k.powers_of_g[:8 * jcs.circuit_bound() + 9],
                  srs_1k.h, srs_1k.beta_h)
        tr = TranscriptProtocol(tool.LABEL)
        pk, vk = rp.preprocess(jcs, srs, tr)
        spec = jax_serialize(rp.prove(jcs, pk, srs, tr.clone()))
        got = ranks.result()
    assert got == [spec] * tool.NPROC
    vtr = TranscriptProtocol(tool.LABEL)
    rp.seed_transcript(vtr, vk)
    assert verify(vk, srs, deserialize_proof(got[0]), jcs.public_inputs,
                  vtr)


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
