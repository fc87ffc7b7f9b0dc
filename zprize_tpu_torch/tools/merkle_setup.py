"""The Merkle main path's set-up on the card, shared by the tools that
time or attribute one prove: SRS, layout, key, a seeded witness."""

import numpy as np

from ..params import R_MOD
from ..device import resolve
from ..fields.mont import FR
from ..merkle.layout import MerkleLayout
from ..merkle.preprocess import preprocess_layout
from ..protocol import prover_torch as prover
from ..protocol.srs import device_srs
from ..protocol.transcript_protocol import TranscriptProtocol
from ..ref.prover import seed_transcript

LABEL = b"Merkle tree"


def seeded_leaves(m, seed):
    """m leaves of 31 random bytes each from `np.random.default_rng(seed)`
    (the recipe `chip_smoke.py` proves with)."""
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(31), "little") for _ in range(m)]


class MerkleSetup:
    """What one prove of the Merkle circuit needs, ready on the device."""

    def __init__(self, lay, dev_srs, lite, pk, vk, witness):
        self.lay, self.dev_srs, self.lite = lay, dev_srs, lite
        self.pk, self.vk, self.witness = pk, vk, witness

    @classmethod
    def build(cls, height, device=None):
        dev = resolve(device)
        lay = MerkleLayout(height, device=dev)
        pts, lite, _ = device_srs(lay.n + 8, device=dev)
        dev_srs = prover.DevSRS(pts, lite)
        pk, vk = preprocess_layout(lay, dev_srs, TranscriptProtocol(LABEL),
                                   prover.ProverConfig(device=dev))
        leaves = FR.tensor(seeded_leaves(lay.m_leaves, height), dev)
        wires, root, _ = lay.witness(leaves)
        witness = prover.ProverWitness(
            wires, {lay.root_gate_pos: (-root) % R_MOD})
        return cls(lay, dev_srs, lite, pk, vk, witness)

    def transcript(self):
        t = TranscriptProtocol(LABEL)
        seed_transcript(t, self.vk)
        return t

    def prove(self, log=None):
        """One prove through the kernels; `log` as `ProverConfig.log`."""
        cfg = prover.ProverConfig(device=self.lay.device, log=log)
        return prover.prove_torch(self.witness, self.pk, self.dev_srs,
                                  self.transcript(), cfg)
