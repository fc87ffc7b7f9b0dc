"""The yardstick of a kernel's share of its roofline: the card's peaks and
the least work a transform needs, counted from its shape alone, so that
no implementation of the transform changes the count.

Peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet; the
CUDA C++ Programming Guide's throughput table for compute capability 9.0):
  * HBM3: 3.35e12 bytes/s;
  * 32-bit integer multiply-add (IMAD): 64 issue slots a clock an SM,
    132 SMs, 1,980 MHz boost: 1.67270e13 slots/s.
A card whose `power.limit` is below 700 W runs slower than these peaks;
the run prints the limit beside every share.

The least time of a length-n transform of B columns (NTT or INTT, any
branch, radix-2, four-step or fused) is the larger of:
  * bytes: every element read once and written once, 32 bytes an Fr
    element: 2 * 32 * n * B bytes (twiddle tables not counted);
  * products: every butterfly twiddle other than 1. Radix-2 has (n/2)
    log2 n butterflies, and n - 1 of them take the twiddle 1 (stage s
    has 2^(s-1) distinct twiddles, one of them 1, in n/2^s butterflies
    each: sum_s n/2^s = n - 1). A four-step transform meets the same
    count: its two sub-transforms and mid twiddles are the same
    butterflies regrouped. 1/n and coset scalings are not counted: an
    implementation can fold them into a twiddle table.
    (n/2) log2 n - (n - 1) Fr products a column, at MONT_SLOTS issue
    slots each.

MONT_SLOTS, the fewest 32-bit multiply-add issue slots of a Montgomery
product of two 8-word (256-bit) operands, word by word (CIOS):
  * the 512-bit product a * b: 8 x 8 word products, each a low and a
    high half (mad.lo + mad.hi): 128 slots;
  * the reduction, 8 rounds of m = t_0 * (-r^-1 mod 2^32) and t += m * r:
    Fr's r has the low words 0x00000001 and 0xffffffff, so
    -r^-1 = 0xffffffff mod 2^32 (m = -t_0, no multiply), m * r_0 = m and
    m * r_1 = m * 2^32 - m need no multiply; the other 6 words are 12
    slots a round: 96 slots.
  224 slots in all. Karatsuba-style splitting could trade some word
  products for additions; no implementation in this repository does, and
  this count is the bound such a change would have to restate.
"""

HBM_BYTES_S = 3.35e12
IMAD_SLOTS_CLOCK_SM = 64
SMS = 132
CLOCK_HZ = 1.98e9
SLOTS_S = IMAD_SLOTS_CLOCK_SM * SMS * CLOCK_HZ
FR_BYTES = 32
MONT_SLOTS = 128 + 8 * 12


def transform_products(n):
    """Fr products of one length-n column: twiddles other than 1."""
    log_n = n.bit_length() - 1
    return (n // 2) * log_n - (n - 1)


def transform_bytes(n):
    return 2 * FR_BYTES * n


def transform_least_s(n, batch=1):
    """(least seconds, "bytes" or "products") of `batch` columns."""
    by_bytes = batch * transform_bytes(n) / HBM_BYTES_S
    by_products = batch * transform_products(n) * MONT_SLOTS / SLOTS_S
    return (by_products, "products") if by_products >= by_bytes \
        else (by_bytes, "bytes")
