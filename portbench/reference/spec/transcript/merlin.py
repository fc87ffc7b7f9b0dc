"""Merlin transcript clone — byte-compatible with the merlin crate used by the
reference prover/verifier (`plonk-core/src/transcript.rs`, merlin v3)."""

import struct

from .strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class Transcript:
    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t.strobe = Strobe128.__new__(Strobe128)
        t.strobe.state = bytearray(self.strobe.state)
        t.strobe.pos = self.strobe.pos
        t.strobe.pos_begin = self.strobe.pos_begin
        t.strobe.cur_flags = self.strobe.cur_flags
        return t

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int):
        self.append_message(label, struct.pack("<Q", x))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", n), True)
        return self.strobe.prf(n, False)
