"""Keccak-f[1600] permutation (host-side, pure Python).

Counterpart of the reference's CPU Keccak used by its Merlin reimplementation
(`plonk-core/lib/PLONK/src/strobe.cpp:21-178`). The transcript is O(1)-sized
work per proof, so a host implementation is the right cost tradeoff on TPU too.
"""

MASK = (1 << 64) - 1

_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


def _rotl(x, n):
    return ((x << n) | (x >> (64 - n))) & MASK


def keccak_f1600(state_bytes: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (little-endian lanes)."""
    a = [[0] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            off = 8 * (x + 5 * y)
            a[x][y] = int.from_bytes(state_bytes[off:off + 8], "little")

    for rnd in range(24):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROTC[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y] & MASK) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= _RC[rnd]

    for x in range(5):
        for y in range(5):
            off = 8 * (x + 5 * y)
            state_bytes[off:off + 8] = a[x][y].to_bytes(8, "little")
