"""Entry points of the port of `__graft_entry__.py`.

entry() — the forward step on the flagship workload: one batched Poseidon
Merkle level (witness synthesis) feeding a 2^7 INTT (round-1 wire
polynomial construction).

    step, (left, right) = entry()          # on the card
    out = step(left, right)                # (16, 128) Montgomery limbs

The 128 input pairs come from `np.random.default_rng(0)` by the JAX
package's recipe, so both packages feed the step the same field elements.
The step runs the multiplication and addition kernels (Poseidon rounds)
and the butterfly kernel (INTT stages).

dryrun_multichip(n) — the meshed prover on n ranks
(`parallel/mesh.py`): first the sharded primitives on small shapes
(data-parallel Poseidon, a four-step NTT whose transpose is an
all_to_all, a point sum joined by an all_gather), each held to its
single-rank counterpart; then a whole proof of a small circuit with
`ProverConfig(mesh=...)`, byte-equal to the executable spec's proof and
verified. On the CPU the ranks are spawned gloo processes; on the card it
is one rank on one NCCL group (the machine this was built for has one
card).
"""

import tempfile

import numpy as np

from .params import R_MOD
from .circuit import StandardComposer
from .device import resolve
from .fields.mont import FR
from .ops import ntt
from .poseidon.vectorized import hash2_batch

M = 128
LOG_N = 7
# the dry run's proof: SRS of 2^8 + 1 powers of this tau
DRYRUN_LOG_SRS = 8
DRYRUN_TAU = 123456789
DRYRUN_LABEL = b"dryrun"
DRYRUN_TIMEOUT_S = 600


def _rand_fr(rng, m, device):
    """(L, m) random field elements below 2^62, Montgomery limbs."""
    return FR.tensor([rng.integers(0, 1 << 62).item() for _ in range(m)],
                     device)


def entry(device=None):
    """Returns (step, (left, right)) on `device` (CUDA unless "cpu" is
    asked for)."""
    dev = resolve(device)
    plan = ntt.get_plan(LOG_N, dev)

    def step(left, right):
        return ntt.intt(plan, hash2_batch(left, right))

    rng = np.random.default_rng(0)
    left = _rand_fr(rng, M, dev)
    right = _rand_fr(rng, M, dev)
    return step, (left, right)


def dryrun_circuit(cs):
    """The dry run's circuit (`__graft_entry__.dryrun_multichip`), added to
    the composer `cs` (this package's `StandardComposer`, or one with its
    methods) and returned: a sum with a public input, a product held to a
    constant, a range gate."""
    a = cs.add_input(20)
    b = cs.add_input(5)
    cs.arithmetic_gate(q_l=1, q_r=1, w_l=a, w_r=b, q_o=0, w_o=cs.zero_var,
                       pi=(-25) % R_MOD)
    e = cs.mul(a, b)
    cs.constrain_to_constant(e, 100)
    cs.range_gate(a, 6)
    return cs


def _dryrun_rank(mesh, srs, pk, vk, transcript, spec_bytes):
    """One rank of the dry run; raises on any mismatch."""
    import torch
    from .curve import g1
    from .parallel import mesh as pmesh
    from .protocol import prover_torch as pt
    from .protocol.serde import serialize_proof
    from .protocol.transcript_protocol import TranscriptProtocol
    from .ref.curve import G1_GEN, g1_mul
    from .ref.prover import seed_transcript
    from .ref.verifier import verify

    dev, n_dev = mesh.device, mesh.size
    rng = np.random.default_rng(0)
    # shapes sized to the mesh, drawn in the JAX dry run's order
    log_side = max(3, n_dev.bit_length())
    fsp = pmesh.FourStepPlan(log_side, log_side, dev)
    rows = _rand_fr(rng, fsp.n, dev).reshape(FR.L, fsp.n1, fsp.n2)
    left = _rand_fr(rng, 8 * n_dev, dev)
    right = _rand_fr(rng, 8 * n_dev, dev)
    npts = 16 * n_dev
    # the multiples G, 2G, ..., npts G
    xs, ys, _ = g1.affine_points_to_device(
        [g1_mul(G1_GEN, k) for k in range(1, npts + 1)], dev)

    hashes = pmesh.sharded_poseidon_hashes(mesh, left, right)
    evals = pmesh.four_step_ntt(fsp, mesh, rows)
    total = pmesh.sharded_point_sum(mesh, xs, ys)
    natural = rows.transpose(1, 2).reshape(FR.L, fsp.n)
    if not torch.equal(hashes, hash2_batch(left, right)):
        raise AssertionError("sharded Poseidon != hash2_batch")
    if not torch.equal(evals.reshape(FR.L, fsp.n),
                       ntt.ntt(ntt.get_plan(2 * log_side, dev), natural)):
        raise AssertionError("meshed four-step NTT != ops/ntt NTT")
    if g1.xyzz_to_affine_host(total[:, None])[0] != \
            g1_mul(G1_GEN, npts * (npts + 1) // 2):
        raise AssertionError("sharded point sum != (sum k) G")

    cs = dryrun_circuit(StandardComposer())
    cfg = pt.ProverConfig(mesh=mesh)
    proof = pt.prove_torch(pt.ProverWitness.from_composer(cs, pk.n, dev),
                           pt.DevProverKey.from_ref(pk, dev),
                           pt.DevSRS.from_ref(srs, dev), transcript.clone(),
                           cfg)
    if serialize_proof(proof) != spec_bytes:
        raise AssertionError(f"rank {mesh.rank}: meshed proof != spec proof")
    if mesh.rank == 0:
        vtr = TranscriptProtocol(DRYRUN_LABEL)
        seed_transcript(vtr, vk)
        if not verify(vk, srs, proof, cs.public_inputs, vtr):
            raise AssertionError("meshed proof does not verify")
    return {"shapes": [tuple(hashes.shape), tuple(evals.shape)],
            "proof_bytes_equal": True, "verify": True}


def dryrun_multichip(n_devices, device=None):
    """The counterpart of `__graft_entry__.dryrun_multichip`: the sharded
    primitives on `n_devices` ranks, then a whole meshed proof, byte-equal
    to the spec's and verified. Prints the same two lines and returns rank
    0's summary; raises, naming the rank, when a rank fails. On the CPU
    (device="cpu") the ranks are spawned gloo processes; on CUDA one
    process a card over NCCL (`mesh.spawn_cuda`), or with one device one
    rank in this process."""
    import torch
    from .parallel import mesh as pmesh
    from .protocol.serde import serialize_proof
    from .protocol.srs import device_srs, host_srs
    from .protocol.transcript_protocol import TranscriptProtocol
    from .ref import prover as rp

    if n_devices < 1 or n_devices & (n_devices - 1):
        raise ValueError("power-of-two devices expected")
    dev = resolve(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks on CUDA need {n_devices} "
                         f"cards; this machine has "
                         f"{torch.cuda.device_count()}")
    # the spec's key and proof, once, on the host; device_srs with this
    # tau gives the points of SRS.setup(2^8, tau)
    pts, lite, _ = device_srs(1 << DRYRUN_LOG_SRS, tau=DRYRUN_TAU,
                              device=dev)
    srs = host_srs(pts, lite)
    cs = dryrun_circuit(StandardComposer())
    tr = TranscriptProtocol(DRYRUN_LABEL)
    pk, vk = rp.preprocess(cs, srs, tr)
    spec_bytes = serialize_proof(rp.prove(cs, pk, srs, tr.clone()))
    args = (srs, pk, vk, tr, spec_bytes)
    if dev.type == "cpu":
        out = pmesh.spawn_cpu(_dryrun_rank, n_devices, *args,
                              timeout_s=DRYRUN_TIMEOUT_S)
    elif n_devices > 1:
        out = pmesh.spawn_cuda(_dryrun_rank, n_devices, *args,
                               timeout_s=DRYRUN_TIMEOUT_S)[0]
    else:
        with tempfile.TemporaryDirectory(prefix="zk-mesh-") as d:
            with pmesh.make_mesh(dev, init_method=f"file://{d}/rendezvous",
                                 rank=0, world_size=1) as mesh:
                out = _dryrun_rank(mesh, *args)
    print(f"dryrun_multichip({n_devices}): primitives ok — shapes "
          f"{out['shapes']}", flush=True)
    print(f"dryrun_multichip({n_devices}): full meshed proof "
          f"byte-equal to spec + verified", flush=True)
    return out
