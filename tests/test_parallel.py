"""Multi-chip sharding on the 8-device virtual CPU mesh (limbs-leading
(L, ...) layout)."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zprize_tpu.params import R_MOD
from zprize_tpu.fields.mont import FR
from zprize_tpu.parallel import mesh as pmesh


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


@needs_8
def test_four_step_ntt_sharded():
    rng = random.Random(11)
    fsp = pmesh.FourStepPlan(4, 4)  # n = 256, 16x16
    m = pmesh.make_mesh(8)
    rows = [[rng.randrange(R_MOD) for _ in range(fsp.n2)]
            for _ in range(fsp.n1)]
    flat = [rows[i1][i2] for i1 in range(fsp.n1) for i2 in range(fsp.n2)]
    dev = jnp.asarray(FR.to_mont_host(flat)).reshape(FR.L, fsp.n1, fsp.n2)
    out = pmesh.four_step_ntt(fsp, m, dev)
    got = [FR.from_mont_host(np.asarray(out[:, i, :]))
           for i in range(fsp.n1)]
    expect = pmesh.reference_four_step_check(fsp, rows)
    assert got == expect


@pytest.mark.slow
@needs_8
def test_sharded_msm_window():
    from zprize_tpu.curve.g1 import (affine_points_to_device,
                                     xyzz_to_affine_host)
    from zprize_tpu.ref.curve import G1_GEN, g1_mul, g1_add
    rng = random.Random(3)
    n = 32
    pts = [g1_mul(G1_GEN, rng.randrange(1, 500)) for _ in range(n)]
    digs = np.asarray([rng.randrange(16) for _ in range(n)], dtype=np.uint32)
    x, y, _inf = affine_points_to_device(pts)
    m = pmesh.make_mesh(8)
    out = pmesh.sharded_msm_window_partials(m, x, y, jnp.asarray(digs),
                                            window_bits=4, capacity=8)
    got = xyzz_to_affine_host({k: v[:, None] for k, v in out.items()})[0]
    expect = None
    for p, d in zip(pts, digs):
        expect = g1_add(expect, g1_mul(p, int(d)))
    assert got == expect


@needs_8
def test_sharded_poseidon():
    from zprize_tpu.poseidon.constants import PoseidonConstants
    from zprize_tpu.poseidon.ref import hash2
    c = PoseidonConstants.generate(3)
    rng = random.Random(4)
    L = [rng.randrange(R_MOD) for _ in range(16)]
    R = [rng.randrange(R_MOD) for _ in range(16)]
    m = pmesh.make_mesh(8)
    out = pmesh.sharded_poseidon_hashes(
        m, jnp.asarray(FR.to_mont_host(L)), jnp.asarray(FR.to_mont_host(R)))
    assert FR.from_mont_host(np.asarray(out)) == \
        [hash2(c, l, r) for l, r in zip(L, R)]


@needs_8
def test_sharded_point_sum():
    from zprize_tpu.curve.g1 import (affine_points_to_device,
                                     xyzz_to_affine_host)
    from zprize_tpu.ref.curve import G1_GEN, g1_mul, g1_add
    rng = random.Random(6)
    pts = [g1_mul(G1_GEN, rng.randrange(1, 500)) for _ in range(16)]
    x, y, _inf = affine_points_to_device(pts)
    m = pmesh.make_mesh(8)
    out = pmesh.sharded_point_sum(m, x, y)
    got = xyzz_to_affine_host({k: v[:, None] for k, v in out.items()})[0]
    expect = None
    for p in pts:
        expect = g1_add(expect, p)
    assert got == expect


@pytest.mark.slow
@needs_8
def test_meshed_prover_bit_exact(srs_1k):
    """prove_tpu with cfg.mesh set (pk/witness/SRS n-axes sharded over the
    8-device mesh, XLA-SPMD-partitioned round programs + sharded MSM) must
    reproduce the executable spec's proof byte-for-byte — the multi-chip
    prover differential."""
    from zprize_tpu.circuit.composer import StandardComposer
    from zprize_tpu.ref import prover as rp
    from zprize_tpu.ref.verifier import verify
    from zprize_tpu.protocol.transcript_protocol import TranscriptProtocol
    from zprize_tpu.protocol import prover_tpu as tp

    cs = StandardComposer()
    a = cs.add_input(20)
    b = cs.add_input(5)
    cs.arithmetic_gate(q_l=1, q_r=1, w_l=a, w_r=b, q_o=0, w_o=cs.zero_var,
                       pi=(-25) % R_MOD)
    e = cs.mul(a, b)
    cs.constrain_to_constant(e, 100)
    cs.range_gate(a, 6)

    tr = TranscriptProtocol(b"test")
    pk, vk = rp.preprocess(cs, srs_1k, tr)
    proof_ref = rp.prove(cs, pk, srs_1k, tr.clone())

    dev_pk = tp.DevProverKey.from_ref(pk)
    dev_srs = tp.DevSRS(srs_1k)
    cfg = tp.ProverConfig(msm_backend="device", msm_window_bits=8,
                          mesh=pmesh.make_mesh(8))
    witness = tp.ProverWitness.from_composer(cs, pk.n)
    proof_mesh = tp.prove_tpu(witness, dev_pk, dev_srs, tr.clone(), cfg)

    assert proof_mesh.a_comm == proof_ref.a_comm
    assert proof_mesh.t_comms == proof_ref.t_comms
    assert proof_mesh.evaluations == proof_ref.evaluations
    assert proof_mesh.aw_opening == proof_ref.aw_opening
    assert proof_mesh.saw_opening == proof_ref.saw_opening

    vtr = TranscriptProtocol(b"test")
    rp.seed_transcript(vtr, vk)
    assert verify(vk, srs_1k, proof_mesh, cs.public_inputs, vtr)


@needs_8
def test_four_step_intt_natural_matches_single_device():
    from zprize_tpu.ops import ntt as jntt
    rng = random.Random(12)
    fsp = pmesh.FourStepPlan(4, 4)
    n = 256
    xs = [rng.randrange(R_MOD) for _ in range(n)]
    m = pmesh.make_mesh(8)
    evals = jnp.asarray(FR.to_mont_host(xs))
    coeffs_sharded = pmesh.four_step_intt_natural(fsp, m, evals)
    plan = jntt.get_plan(8)
    coeffs_single = jntt.intt(plan, evals)
    assert FR.from_mont_host(np.asarray(coeffs_sharded)) == \
        FR.from_mont_host(np.asarray(coeffs_single))


@pytest.mark.slow(reason="known failure: XLA:CPU aborts in "
                  "backend_compile_and_load under the four concurrent "
                  "prove_tpu compiles (ROADMAP.md, 'Known failure')")
@needs_8
def test_prove_many_data_parallel(srs_1k):
    """Whole-proof DP: 4 proofs spread over 4 devices run concurrently
    (threads + per-device pk/SRS replicas) and are byte-identical to
    sequential proving."""
    from zprize_tpu.circuit.composer import StandardComposer
    from zprize_tpu.ref import prover as rp
    from zprize_tpu.ref.verifier import verify
    from zprize_tpu.protocol.transcript_protocol import TranscriptProtocol
    from zprize_tpu.protocol import prover_tpu as tp
    from zprize_tpu.protocol.batch import prove_many

    def build(x, y):
        cs = StandardComposer()
        a = cs.add_input(x)
        b = cs.add_input(y)
        p = cs.mul(a, b)
        cs.arithmetic_gate(q_l=1, q_r=0, w_l=p, w_r=cs.zero_var, q_o=0,
                           w_o=cs.zero_var, pi=(-(x * y)) % R_MOD)
        return cs

    cs1 = build(6, 7)
    tr = TranscriptProtocol(b"dp")
    pk, vk = rp.preprocess(cs1, srs_1k, tr)
    dev_pk = tp.DevProverKey.from_ref(pk)
    dev_srs = tp.DevSRS(srs_1k)
    cfg = tp.ProverConfig(msm_backend="device", msm_window_bits=8)

    wits = [tp.ProverWitness.from_composer(build(6, 7), pk.n),
            tp.ProverWitness.from_composer(build(3, 14), pk.n),
            tp.ProverWitness.from_composer(build(2, 21), pk.n),
            tp.ProverWitness.from_composer(build(42, 1), pk.n)]

    devs = jax.devices()[:4]
    proofs, wall, pps = prove_many(wits, dev_pk, dev_srs, tr, cfg,
                                   devices=devs)

    # byte-exact vs sequential
    seq, _, _ = prove_many(wits[:2], dev_pk, dev_srs, tr, cfg)
    assert proofs[0].a_comm == seq[0].a_comm
    assert proofs[0].aw_opening == seq[0].aw_opening
    assert proofs[1].t_comms == seq[1].t_comms
    assert proofs[1].evaluations == seq[1].evaluations

    for proof, w in zip(proofs, wits):
        vtr = TranscriptProtocol(b"dp")
        rp.seed_transcript(vtr, vk)
        assert verify(vk, srs_1k, proof, w.public_inputs, vtr)
