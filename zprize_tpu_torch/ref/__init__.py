"""Pure-Python executable spec of the prover stack.

Plays the role the Rust/arkworks CPU prover plays in the reference
(`plonk-core/src/proof_system/prover.rs:171-660`): a slow, obviously-correct
implementation used as the oracle for every TPU kernel and for round-level
differential tests.
"""
