"""Proof container mirroring ZK-Garage's `Proof` struct
(`plonk-core/src/proof_system/proof.rs:60-118`,
`linearisation_poly.rs:30-165`)."""

from dataclasses import dataclass, field
from typing import List, Tuple, Optional


@dataclass
class Evaluations:
    # wire evals at z
    a_eval: int = 0
    b_eval: int = 0
    c_eval: int = 0
    d_eval: int = 0
    # permutation evals
    left_sigma_eval: int = 0
    right_sigma_eval: int = 0
    out_sigma_eval: int = 0
    permutation_eval: int = 0  # z(omega*z)
    # lookup evals
    q_lookup_eval: int = 0
    z2_next_eval: int = 0
    h1_eval: int = 0
    h1_next_eval: int = 0
    h2_eval: int = 0
    f_eval: int = 0
    table_eval: int = 0
    table_next_eval: int = 0
    # custom evals: ordered (label, value) pairs
    custom_evals: List[Tuple[str, int]] = field(default_factory=list)

    def get_custom(self, label: str) -> int:
        for lbl, v in self.custom_evals:
            if lbl == label:
                return v
        raise KeyError(label)


@dataclass
class Proof:
    a_comm: Optional[tuple]
    b_comm: Optional[tuple]
    c_comm: Optional[tuple]
    d_comm: Optional[tuple]
    z_comm: Optional[tuple]
    f_comm: Optional[tuple]
    h_1_comm: Optional[tuple]
    h_2_comm: Optional[tuple]
    z_2_comm: Optional[tuple]
    t_comms: List[Optional[tuple]]  # t_1..t_8
    aw_opening: Optional[tuple]
    saw_opening: Optional[tuple]
    evaluations: Evaluations
