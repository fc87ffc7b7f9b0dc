"""zprize_tpu_torch — the PLONK prover of `zprize_tpu`, ported to PyTorch
with hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

Layout mirrors `zprize_tpu` so each module's counterpart is easy to find:

  fields/    — 16-bit-limb Montgomery Fr/Fq arithmetic on (L, n) tensors;
               `fields/kernels.py` binds the CUDA kernels in `csrc/` and
               keeps a plain PyTorch version of each beside it.
  ops/       — powers/evaluation/scans, NTT, Pippenger MSM.
  curve/     — BLS12-381 G1 in xyzz coordinates.
  protocol/  — SRS, the 5-round prover, widgets, proof/transcript spec.
  poseidon/, merkle/ — batched Poseidon witness, tiled Merkle layout.
  ref/, transcript/, circuit/ — host-side executable spec, copied from
               `zprize_tpu` so this package imports neither JAX nor it.
  native/    — the plookup `combine_split` in C (built with gcc).
  parallel/  — the meshed prover's primitives over `torch.distributed`
               (NCCL on the card, gloo on the CPU).
  examples/, tools/ — runnable with `python3 -m`: the simple-circuit and
               Merkle examples; the timeline, memory attribution and
               micro-benchmarks of the card (card only); the
               multi-process dry run of the meshed primitives (CPU).

Entry points (`entry.entry`, `entry.dryrun_multichip`, `device_srs`,
`parallel.mesh.make_mesh`, `MerkleLayout`, `preprocess_layout`,
`DevProverKey.from_ref`, `DevSRS.from_ref`, `ProverWitness.from_composer`,
`prove_torch`, `keys_io.load_prover_key`, `prove_many`) run on CUDA unless
the caller passes device="cpu".
"""

__version__ = "0.1.0"
