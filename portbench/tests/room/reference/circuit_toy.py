"""The reference of the toy general circuit (see `check.py`), a system
that only the tests add: its circuit laid out by the reference's copy of
the spec's composer from `recipes/circuit_toy.py`, its verifier key under
tau by the columns path of `vk.py`, and each witness's public inputs from
its own layout.

Run: python3 -m portbench.reference.circuit_toy < job.json"""

import os
import time

from .. import inputs
from ..recipes import circuit_toy as recipe
from . import check
from .spec.circuit.composer import SELECTOR_NAMES, StandardComposer
from .vk import columns_verifier_key, sigma_of_cycles

TIMEOUT_S = 120


def judge(job, workers=None):
    """The verdict on `job`'s proofs (see `check.py`)."""
    t0 = time.monotonic()
    workers = workers or min(16, os.cpu_count() or 1)
    circuits = [recipe.build(StandardComposer(), *v)
                for v in recipe.values(job["seed"], job["witnesses"])]
    cs = circuits[0]
    n = cs.circuit_bound()
    table = cs.lookup_table.columns()
    cs.pad_to(n)
    tau = inputs.tau(job["seed"])
    vk = columns_verifier_key(
        n, {name: getattr(cs, name) for name in SELECTOR_NAMES},
        sigma_of_cycles(cs.var_map.values(), n), table, tau, workers)
    t_vk = time.monotonic() - t0
    with check.pool(workers, vk=vk, tau=tau, label=recipe.LABEL) as pool:
        ok, distinct, reasons = check.verify_all(
            pool, job["proofs"], [c.public_inputs for c in circuits])
    return check.verdict(job, ok, distinct, reasons, n, t_vk, t0)


if __name__ == "__main__":
    check.main(judge)
