"""collective_s.mesh4: device seconds a proof inside torch.distributed's
collectives on rank 0: the NCCL kernels (every kernel whose name holds
"nccl") inside the traced proofs, summed, over the traced proofs. The
port issues `all_to_all_single` and `all_gather`; the harness's barriers
before and after the window and its broadcast between proofs lie outside
every proof (`trace.py`) and are not read. It counts a rank's wait for
its peers inside a collective too. Layer: ranks (`parallel/mesh`)."""

from portbench.trace import per_proof

UNIT, LAYER, MOVES = "s", "ranks", "mesh_prove_s"


def read(run):
    if run.trace is None:
        return None
    total = sum(e - s for name, s, e in run.trace.ops
                if "nccl" in name.lower())
    return per_proof(run.trace, total) if total > 0 else None
