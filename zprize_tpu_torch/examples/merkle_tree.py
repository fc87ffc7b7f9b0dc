"""Example: a Poseidon Merkle-tree proof end to end on the port — the
counterpart of `examples/merkle_tree.py` (the reference's
`merkle-tree/src/main.rs`: one proof and its verification), at a small
height.

The tree is built on the host (`MerkleTree`); the circuit's key and
witness come from the tiled layout on the device (`MerkleLayout`,
`preprocess_layout`, `witness`), the proof from `prove_torch`, and the
copied spec verifier checks it. The same tree through the composer
circuit (`merkle/circuit.py`) must satisfy every gate with as many gates as
the layout has, and the membership paths of the first and last leaf must
verify against the root.

Run: python3 -m zprize_tpu_torch.examples.merkle_tree [--height 3]
                                                      [--device cpu]
"""

import argparse
import random
import time

import torch

from ..params import R_MOD
from ..circuit import StandardComposer
from ..device import resolve
from ..fields.mont import FR
from ..merkle.circuit import MerkleTreeCircuit
from ..merkle.layout import MerkleLayout
from ..merkle.preprocess import preprocess_layout
from ..merkle.tree import MerkleTree
from ..poseidon.constants import PoseidonConstants
from ..protocol import prover_torch as prover
from ..protocol.serde import serialize_proof
from ..protocol.srs import device_srs
from ..protocol.transcript_protocol import TranscriptProtocol
from ..ref.prover import seed_transcript
from ..ref.verifier import verify

TAU = 0xBEEF


def main(height=3, device=None):
    """Prove and verify a height-`height` tree on `device` (CUDA unless
    "cpu"); returns {"height", "gates", "n", "proof_bytes", "verify",
    "paths", "seconds"}."""
    dev = resolve(device)
    secs = {}
    rng = random.Random(42)
    param = PoseidonConstants.generate(3)
    leaves = [rng.randrange(R_MOD) for _ in range(1 << (height - 1))]

    t0 = time.time()
    tree = MerkleTree(param, leaves, height)
    secs["tree"] = time.time() - t0
    print(f"tree built, root={hex(tree.root())[:18]}... "
          f"({secs['tree']:.2f}s)", flush=True)

    lay = MerkleLayout(height, device=dev)
    print(f"circuit: {lay.n_real} gates, domain 2^{lay.n.bit_length() - 1}",
          flush=True)
    cs = StandardComposer()
    MerkleTreeCircuit(param, tree).gadget(cs)
    cs.check_circuit_satisfied()
    if cs.n != lay.n_real:
        raise AssertionError(f"composer circuit has {cs.n} gates, the "
                             f"layout {lay.n_real}")

    cfg = prover.ProverConfig(device=dev)
    t0 = time.time()
    points, lite, _ = device_srs(lay.n + 8, tau=TAU, device=dev)
    dev_srs = prover.DevSRS(points, lite)
    tr = TranscriptProtocol(b"Merkle tree")
    pk, vk = preprocess_layout(lay, dev_srs, tr, cfg)
    secs["preprocess"] = time.time() - t0
    print(f"preprocess: {secs['preprocess']:.1f}s", flush=True)

    t0 = time.time()
    wires, root, _ = lay.witness(FR.tensor(leaves, dev))
    if root != tree.root():
        raise AssertionError("the layout's witness root differs from the "
                             "tree's")
    pi = {lay.root_gate_pos: (-root) % R_MOD}
    proof = prover.prove_torch(prover.ProverWitness(wires, pi), pk, dev_srs,
                               tr, cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs["prove"] = time.time() - t0
    size = len(serialize_proof(proof))
    print(f"prove: {secs['prove']:.1f}s ({size} proof bytes)", flush=True)

    vtr = TranscriptProtocol(b"Merkle tree")
    seed_transcript(vtr, vk)
    t0 = time.time()
    ok = bool(verify(vk, lite, proof, pi, vtr))
    secs["verify"] = time.time() - t0
    print(f"verify: {ok} ({secs['verify']:.1f}s)", flush=True)
    if not ok:
        raise AssertionError("the Merkle proof does not verify")

    # membership proofs (path.rs parity)
    paths = (0, (1 << (height - 1)) - 1)
    for idx in paths:
        if not tree.gen_proof(idx).verify(param, tree.root()):
            raise AssertionError(f"membership path of leaf {idx} fails")
    print("membership paths verify", flush=True)
    return {"height": height, "gates": lay.n_real, "n": lay.n,
            "proof_bytes": size, "verify": ok, "paths": len(paths),
            "seconds": secs}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.height, args.device)
