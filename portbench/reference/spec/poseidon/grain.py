"""Grain LFSR round-constant generation — clone of
`plonk-hashing/src/poseidon/round_constant.rs` (neptune-derived)."""

from collections import deque

from ..params import R_MOD


class GrainLFSR:
    def __init__(self, init_sequence, field_size):
        assert len(init_sequence) == 80
        self.state = deque(init_sequence)
        self.field_size = field_size
        for _ in range(160):
            self._generate_new_bit()
        assert len(self.state) == 80

    def _generate_new_bit(self):
        s = self.state
        new_bit = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.popleft()
        s.append(new_bit)
        return new_bit

    def _next_bits_raw(self, n):
        return [self._generate_new_bit() for _ in range(n)]

    def next_filtered_bit(self):
        """Iterator semantics of the Rust impl: skip a bit after each 0."""
        new_bit = self._generate_new_bit()
        while not new_bit:
            self._generate_new_bit()
            new_bit = self._generate_new_bit()
        return self._generate_new_bit()

    def _next_byte(self, bit_count):
        acc = 0
        for _ in range(bit_count):
            acc = (acc << 1) | (1 if self.next_filtered_bit() else 0)
        return acc

    def get_next_bytes(self, n_bytes):
        """Big-endian byte string with a short first byte when field_size%8."""
        remainder_bits = self.field_size % 8
        out = bytearray(n_bytes)
        out[0] = self._next_byte(remainder_bits if remainder_bits else 8)
        for i in range(1, n_bytes):
            out[i] = self._next_byte(8)
        return bytes(out)


def _append_bits(bits, n, value):
    for i in range(n - 1, -1, -1):
        bits.append((value >> i) & 1)


def generate_constants(field, sbox, field_size, t, r_f, r_p):
    """Returns (r_f + r_p) * t Fr round constants."""
    num_constants = (r_f + r_p) * t
    bits = []
    _append_bits(bits, 2, field)
    _append_bits(bits, 4, sbox)
    _append_bits(bits, 12, field_size)
    _append_bits(bits, 12, t)
    _append_bits(bits, 10, r_f)
    _append_bits(bits, 10, r_p)
    _append_bits(bits, 30, (1 << 30) - 1)
    grain = GrainLFSR(bits, field_size)
    out = []
    while len(out) < num_constants:
        candidate = int.from_bytes(grain.get_next_bytes(32), "big")
        if candidate < R_MOD:
            out.append(candidate)
    return out
