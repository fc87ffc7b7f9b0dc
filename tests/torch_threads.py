"""One torch intra-op thread for the port's CPU tests: each
`tests/test_torch_*.py` that runs on the CPU imports this module first.

The tier-1 run starts six pytest workers on eight cores. With torch's
default of one intra-op thread a core in each, the port's plain limb ops
on (16, 2^11) tensors and up wait at their thread barriers, and tests that
take seconds alone take minutes. Every xdist worker collects every test
file, so the setting holds for the whole worker process. Spawned ranks and
`prove_many` workers are fresh processes and set their own."""

import torch

torch.set_num_threads(1)
