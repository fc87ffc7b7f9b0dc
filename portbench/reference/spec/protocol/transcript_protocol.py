"""PLONK transcript protocol over the merlin clone
(`plonk-core/src/transcript.rs:27-50`)."""

from ..transcript.merlin import Transcript
from ..transcript.serialize import (serialize_fr, serialize_g1,
                                    serialize_public_inputs,
                                    fr_from_random_bytes)

CHALLENGE_BYTES = 31  # F::size_in_bits()/8 = 255/8


class TranscriptProtocol:
    def __init__(self, label: bytes):
        self.t = Transcript(label)

    def clone(self):
        tp = TranscriptProtocol.__new__(TranscriptProtocol)
        tp.t = self.t.clone()
        return tp

    def append_fr(self, label: bytes, x: int):
        self.t.append_message(label, serialize_fr(x))

    def append_g1(self, label: bytes, pt):
        self.t.append_message(label, serialize_g1(pt))

    def append_pi(self, label: bytes, pi_dict):
        self.t.append_message(label, serialize_public_inputs(pi_dict))

    def challenge_scalar(self, label: bytes) -> int:
        return fr_from_random_bytes(self.t.challenge_bytes(label, CHALLENGE_BYTES))

    def circuit_domain_sep(self, n: int):
        self.t.append_message(b"dom-sep", b"circuit_size")
        self.t.append_u64(b"n", n)
