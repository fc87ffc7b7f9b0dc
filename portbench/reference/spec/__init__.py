"""A frozen copy of the port's pure-Python spec (`zprize_tpu_torch/` paths
below), kept here so that no later change to the program can move the
yardstick that judges its proofs.

Copied unchanged, each under its own path: `params.py`; `ref/` curve,
domain, field; `protocol/` widgets, serde, proof, transcript_protocol;
`transcript/` merlin, strobe, keccak, serialize; `poseidon/` gadget, ref,
constants, grain, mds, matrix, round_numbers. Copied with a cut:
`ref/verifier.py`, whose `verify` takes its opening check `pc` as an
argument (the reference passes its own, which checks the KZG openings
with the known tau, so the pairing and the commitment schemes are not
copied), and `circuit/composer.py`, without `check_circuit_satisfied`
(the satisfiability oracle, whose module is not copied).

Nothing here imports torch, numpy, the port or the JAX package."""
