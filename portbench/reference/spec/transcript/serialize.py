"""arkworks-CanonicalSerialize-compatible byte encodings.

Matches the reference's C++ reimplementation
(`plonk-core/lib/PLONK/src/serialize.cuh`, `transcript/flags.hpp`):
  - Fr: 32-byte little-endian canonical integer.
  - G1 compressed: 48-byte LE x-coordinate; flags OR'd into the last byte:
    infinity -> 1<<6, y "positive" (y > -y) -> 1<<7.
  - PublicInputs (BTreeMap<usize, Fr>): u64 length, then (u64 pos, Fr value)
    pairs in key order.
  - challenge scalars: 31 PRF bytes interpreted as a LE integer
    (`F::from_random_bytes` with MODULUS_BITS/8 bytes, transcript.rs:40-44).
"""

import struct

from ..params import R_MOD, Q_MOD


def serialize_fr(x: int) -> bytes:
    return int(x % R_MOD).to_bytes(32, "little")


def serialize_fq(x: int) -> bytes:
    return int(x % Q_MOD).to_bytes(48, "little")


def serialize_g1(pt) -> bytes:
    """Compressed arkworks encoding of a G1 affine point (or None=infinity)."""
    if pt is None:
        buf = bytearray(48)
        buf[47] |= 1 << 6
        return bytes(buf)
    x, y = pt
    buf = bytearray(serialize_fq(x))
    neg_y = (Q_MOD - y) % Q_MOD
    if y > neg_y:  # PositiveY flag
        buf[47] |= 1 << 7
    return bytes(buf)


def serialize_public_inputs(pi_dict) -> bytes:
    """`PublicInputs` = BTreeMap<usize, F> (proof_system/pi.rs:33-36)."""
    items = sorted(pi_dict.items())
    out = bytearray(struct.pack("<Q", len(items)))
    for pos, val in items:
        out += struct.pack("<Q", pos)
        out += serialize_fr(val)
    return bytes(out)


def fr_from_random_bytes(buf: bytes) -> int:
    """31-byte challenge -> Fr (always < r since 248 bits)."""
    return int.from_bytes(buf, "little") % R_MOD
