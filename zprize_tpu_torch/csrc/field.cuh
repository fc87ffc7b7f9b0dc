// BLS12-381 Fr / Fq Montgomery arithmetic and G1 xyzz formulas for one
// thread per element.
//
// Storage is the JAX package's layout: limbs-leading (L, n) 32-bit words
// holding 16-bit limbs little-endian (L = 16 for Fr, 24 for Fq), Montgomery
// form, fully reduced. In registers a value is N = L/2 32-bit words.
// Montgomery R is 2^256 (Fr) / 2^384 (Fq) for both packings, so the values
// are the same bits.
//
// Both fields run the CIOS product in explicit carry chains of inline PTX
// (mad.lo.cc / madc.hi.cc / addc.cc): the partial products of a row are
// split into the even and the odd words of `a`, each summed by its own chain
// (the design of sppark's ff/mont_t.cuh), and the shift of a row rides in
// the addends of the next row's multiply-adds. A 12-word (Fq) product is 588
// multiply-adds (576 for the 32x32-bit halves of a*b and m*p, 12 for m)
// and about 60 adds; an 8-word (Fr) one 264 and about 40. ptxas fuses each lo/hi pair into one
// IMAD.WIDE.U32(.X), which issues at half the IMAD rate on sm_90 (the
// int_rate line of chip_smoke.py), so 588 is also the count of IMAD issue
// slots. Each asm block holds one whole chain: the carry flag
// never crosses a block boundary, so the compiler cannot reorder a chain
// apart.
//
// Every value stays canonical (fully reduced) at every store and at every
// zero test: the curve formulas test ZZ == 0 (identity) and P == R == 0
// (doubling), and the coordinates are bit-identical to the JAX package's.
//
// Counterpart of `zprize_tpu/fields/limbmath.py` (mul, add, sub, neg,
// xyzz_double, xyzz_add, affine_lift), which the Pallas kernels of
// `zprize_tpu/fields/pkern.py` run on (L, 8192) VMEM tiles.
#pragma once
#include <cstdint>

__constant__ uint32_t FR_MOD[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
__constant__ uint32_t FQ_MOD[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// R mod p (Montgomery one) for Fq, used by the affine lift
__constant__ uint32_t FQ_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

struct Fr {
  static constexpr int N = 8;                 // 32-bit words
  static constexpr uint32_t NP0 = 0xffffffffu;  // -p^-1 mod 2^32
  __device__ static __forceinline__ uint32_t mod(int i) { return FR_MOD[i]; }
};

struct Fq {
  static constexpr int N = 12;
  static constexpr uint32_t NP0 = 0xfffcfffdu;
  __device__ static __forceinline__ uint32_t mod(int i) { return FQ_MOD[i]; }
};

// a*b*R^-1 mod p (Montgomery product), a + b mod p, a - b mod p, each
// specialised for both fields below; r may alias a or b: it is written
// last.
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b);
template <class F>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b);
template <class F>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b);

template <class F>
__device__ __forceinline__ bool is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) acc |= a[j];
  return acc == 0;
}

template <class F>
__device__ __forceinline__ void neg_mod(uint32_t* r, const uint32_t* a) {
  const bool z = is_zero<F>(a);
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    uint64_t v = (uint64_t)F::mod(j) - a[j] - borrow;
    r[j] = z ? 0u : (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
}

// ---------------------------------------------------------------------------
// Fq in PTX carry chains. Bounds: p < 2^381, so a + b < 2p and every
// running value of the product below stays under 2^384; the chains whose
// last carry is provably 0 end without one.
// ---------------------------------------------------------------------------
namespace fq {

// acc[0..11] += (v[0], v[2], .., v[10]) * s, word pair 2j getting v[2j] * s;
// the carry out goes into `top`
__device__ __forceinline__ void mac_even(uint32_t* acc, uint32_t& top,
                                         const uint32_t* v, uint32_t s) {
  asm volatile(
      "mad.lo.cc.u32 %0, %13, %19, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
      "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
      "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
      "addc.u32 %12, %12, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]),
        "+r"(acc[10]), "+r"(acc[11]), "+r"(top)
      : "r"(v[0]), "r"(v[2]), "r"(v[4]), "r"(v[6]), "r"(v[8]), "r"(v[10]),
        "r"(s));
}

// the same without a carry out (the sum fits in 12 words)
__device__ __forceinline__ void mac_odd(uint32_t* acc, const uint32_t* v,
                                        uint32_t s) {
  asm volatile(
      "mad.lo.cc.u32 %0, %12, %18, %0;\n\t"
      "madc.hi.cc.u32 %1, %12, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %13, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %18, %7;\n\t"
      "madc.lo.cc.u32 %8, %16, %18, %8;\n\t"
      "madc.hi.cc.u32 %9, %16, %18, %9;\n\t"
      "madc.lo.cc.u32 %10, %17, %18, %10;\n\t"
      "madc.hi.u32 %11, %17, %18, %11;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]),
        "+r"(acc[10]), "+r"(acc[11])
      : "r"(v[0]), "r"(v[2]), "r"(v[4]), "r"(v[6]), "r"(v[8]), "r"(v[10]),
        "r"(s));
}

// y0 += x[1], then x = (x >> 64) + (v[0], v[2], .., v[10]) * s with the
// carry of the first add: the shift that moves a row's odd-word
// accumulator one word down rides in the addends of the multiply-adds
__device__ __forceinline__ void shift_mac(uint32_t& y0, uint32_t* x,
                                          const uint32_t* v, uint32_t s) {
  asm volatile(
      "add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %13, %19, %3;\n\t"
      "madc.hi.cc.u32 %2, %13, %19, %4;\n\t"
      "madc.lo.cc.u32 %3, %14, %19, %5;\n\t"
      "madc.hi.cc.u32 %4, %14, %19, %6;\n\t"
      "madc.lo.cc.u32 %5, %15, %19, %7;\n\t"
      "madc.hi.cc.u32 %6, %15, %19, %8;\n\t"
      "madc.lo.cc.u32 %7, %16, %19, %9;\n\t"
      "madc.hi.cc.u32 %8, %16, %19, %10;\n\t"
      "madc.lo.cc.u32 %9, %17, %19, %11;\n\t"
      "madc.hi.cc.u32 %10, %17, %19, %12;\n\t"
      "madc.lo.cc.u32 %11, %18, %19, 0;\n\t"
      "madc.hi.u32 %12, %18, %19, 0;"
      : "+r"(y0), "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
        "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "+r"(x[8]), "+r"(x[9]),
        "+r"(x[10]), "+r"(x[11])
      : "r"(v[0]), "r"(v[2]), "r"(v[4]), "r"(v[6]), "r"(v[8]), "r"(v[10]),
        "r"(s));
}

// e[k] += o[k + 1] for k < 11, the carry into e[11]
__device__ __forceinline__ void merge(uint32_t* e, const uint32_t* o) {
  asm volatile(
      "add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]),
        "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]),
        "+r"(e[10]), "+r"(e[11])
      : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]),
        "r"(o[7]), "r"(o[8]), "r"(o[9]), "r"(o[10]), "r"(o[11]));
}

// d -= b; borrow = 0xffffffff if it borrowed, else 0
__device__ __forceinline__ void sub_words(uint32_t* d, uint32_t& borrow,
                                          const uint32_t* b) {
  borrow = 0;
  asm volatile(
      "sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, %12, 0;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(borrow)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
}

// s += b (no carry out: a + b < 2p < 2^384)
__device__ __forceinline__ void add_words(uint32_t* s, const uint32_t* b) {
  asm volatile(
      "add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]),
        "+r"(s[5]), "+r"(s[6]), "+r"(s[7]), "+r"(s[8]), "+r"(s[9]),
        "+r"(s[10]), "+r"(s[11])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
}

// d += p if bw != 0 (one predicated chain): the fix-up of a subtraction
// that borrowed; the carry out is dropped, so d wraps back below p
__device__ __forceinline__ void add_p_if(uint32_t* d, uint32_t bw) {
  asm volatile(
      "{\n\t"
      ".reg .pred bz;\n\t"
      "setp.ne.u32 bz, %12, 0;\n\t"
      "@bz add.cc.u32 %0, %0, %13;\n\t"
      "@bz addc.cc.u32 %1, %1, %14;\n\t"
      "@bz addc.cc.u32 %2, %2, %15;\n\t"
      "@bz addc.cc.u32 %3, %3, %16;\n\t"
      "@bz addc.cc.u32 %4, %4, %17;\n\t"
      "@bz addc.cc.u32 %5, %5, %18;\n\t"
      "@bz addc.cc.u32 %6, %6, %19;\n\t"
      "@bz addc.cc.u32 %7, %7, %20;\n\t"
      "@bz addc.cc.u32 %8, %8, %21;\n\t"
      "@bz addc.cc.u32 %9, %9, %22;\n\t"
      "@bz addc.cc.u32 %10, %10, %23;\n\t"
      "@bz addc.u32 %11, %11, %24;\n\t"
      "}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11])
      : "r"(bw), "r"(FQ_MOD[0]), "r"(FQ_MOD[1]), "r"(FQ_MOD[2]),
        "r"(FQ_MOD[3]), "r"(FQ_MOD[4]), "r"(FQ_MOD[5]), "r"(FQ_MOD[6]),
        "r"(FQ_MOD[7]), "r"(FQ_MOD[8]), "r"(FQ_MOD[9]), "r"(FQ_MOD[10]),
        "r"(FQ_MOD[11]));
}

// t = t - p if t >= p, for t < 2p, in place: t -= p, then p added back by
// one predicated chain if that borrowed (no second copy of t is live)
__device__ __forceinline__ void reduce(uint32_t* t) {
  asm volatile(
      "{\n\t"
      ".reg .u32 bw;\n\t"
      ".reg .pred bz;\n\t"
      "sub.cc.u32 %0, %0, %12;\n\t"
      "subc.cc.u32 %1, %1, %13;\n\t"
      "subc.cc.u32 %2, %2, %14;\n\t"
      "subc.cc.u32 %3, %3, %15;\n\t"
      "subc.cc.u32 %4, %4, %16;\n\t"
      "subc.cc.u32 %5, %5, %17;\n\t"
      "subc.cc.u32 %6, %6, %18;\n\t"
      "subc.cc.u32 %7, %7, %19;\n\t"
      "subc.cc.u32 %8, %8, %20;\n\t"
      "subc.cc.u32 %9, %9, %21;\n\t"
      "subc.cc.u32 %10, %10, %22;\n\t"
      "subc.cc.u32 %11, %11, %23;\n\t"
      "mov.u32 bw, 0;\n\t"
      "subc.u32 bw, bw, 0;\n\t"
      "setp.ne.u32 bz, bw, 0;\n\t"
      "@bz add.cc.u32 %0, %0, %12;\n\t"
      "@bz addc.cc.u32 %1, %1, %13;\n\t"
      "@bz addc.cc.u32 %2, %2, %14;\n\t"
      "@bz addc.cc.u32 %3, %3, %15;\n\t"
      "@bz addc.cc.u32 %4, %4, %16;\n\t"
      "@bz addc.cc.u32 %5, %5, %17;\n\t"
      "@bz addc.cc.u32 %6, %6, %18;\n\t"
      "@bz addc.cc.u32 %7, %7, %19;\n\t"
      "@bz addc.cc.u32 %8, %8, %20;\n\t"
      "@bz addc.cc.u32 %9, %9, %21;\n\t"
      "@bz addc.cc.u32 %10, %10, %22;\n\t"
      "@bz addc.u32 %11, %11, %23;\n\t"
      "}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11])
      : "r"(FQ_MOD[0]), "r"(FQ_MOD[1]), "r"(FQ_MOD[2]), "r"(FQ_MOD[3]),
        "r"(FQ_MOD[4]), "r"(FQ_MOD[5]), "r"(FQ_MOD[6]), "r"(FQ_MOD[7]),
        "r"(FQ_MOD[8]), "r"(FQ_MOD[9]), "r"(FQ_MOD[10]), "r"(FQ_MOD[11]));
}

// one CIOS row after the first: y is the accumulator of the even word
// positions, x the odd one (x[k] at position k + 1, x[0] = 0 after the
// last reduction); adds a * bi, then m * p with m = y[0] * NP0, which
// clears y[0]. The next row swaps the two.
__device__ __forceinline__ void row(uint32_t* y, uint32_t* x,
                                   const uint32_t* a, uint32_t bi) {
  shift_mac(y[0], x, a + 1, bi);
  mac_even(y, x[11], a, bi);
  const uint32_t m = y[0] * Fq::NP0;
  mac_odd(x, FQ_MOD + 1, m);
  mac_even(y, x[11], FQ_MOD, m);
}

}  // namespace fq

template <>
__device__ __forceinline__ void mont_mul<Fq>(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b) {
  uint32_t e[12], o[12];
  const uint32_t b0 = b[0];
#pragma unroll
  for (int j = 0; j < 12; j += 2) {
    e[j] = a[j] * b0;
    e[j + 1] = __umulhi(a[j], b0);
    o[j] = a[j + 1] * b0;
    o[j + 1] = __umulhi(a[j + 1], b0);
  }
  const uint32_t m = e[0] * Fq::NP0;
  fq::mac_odd(o, FQ_MOD + 1, m);
  fq::mac_even(e, o[11], FQ_MOD, m);
#pragma unroll
  for (int i = 1; i < 12; i += 2) {
    fq::row(o, e, a, b[i]);
    if (i + 1 < 12) fq::row(e, o, a, b[i + 1]);
  }
  // after row 11 the even positions are in o (o[0] = 0): result = e + o / 2^32
  fq::merge(e, o);
  fq::reduce(e);
#pragma unroll
  for (int j = 0; j < 12; j++) r[j] = e[j];
}

template <>
__device__ __forceinline__ void add_mod<Fq>(uint32_t* r, const uint32_t* a,
                                            const uint32_t* b) {
  uint32_t s[12];
#pragma unroll
  for (int j = 0; j < 12; j++) s[j] = a[j];
  fq::add_words(s, b);
  fq::reduce(s);
#pragma unroll
  for (int j = 0; j < 12; j++) r[j] = s[j];
}

template <>
__device__ __forceinline__ void sub_mod<Fq>(uint32_t* r, const uint32_t* a,
                                            const uint32_t* b) {
  uint32_t d[12], borrow;
#pragma unroll
  for (int j = 0; j < 12; j++) d[j] = a[j];
  fq::sub_words(d, borrow, b);
  fq::add_p_if(d, borrow);
#pragma unroll
  for (int j = 0; j < 12; j++) r[j] = d[j];
}

// ---------------------------------------------------------------------------
// Fr in PTX carry chains, the design of the Fq chains below on 8 words.
// Bounds: r < 2^255 (its top word 0x73eda753 < 2^31), so a + b < 2r < 2^256,
// and a CIOS row's running value t + a*b_i + m*r < 2r + 2r*2^32 < 2^288 fits
// the 9 words of the two accumulators; the chains whose last carry is
// provably 0 end without one.
// ---------------------------------------------------------------------------
namespace fr {

// acc[0..7] += (v[0], v[2], v[4], v[6]) * s, word pair 2j getting
// v[2j] * s; the carry out goes into `top`
__device__ __forceinline__ void mac_even(uint32_t* acc, uint32_t& top,
                                         const uint32_t* v, uint32_t s) {
  asm volatile(
      "mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(top)
      : "r"(v[0]), "r"(v[2]), "r"(v[4]), "r"(v[6]), "r"(s));
}

// the same without a carry out (the sum fits in 8 words)
__device__ __forceinline__ void mac_odd(uint32_t* acc, const uint32_t* v,
                                        uint32_t s) {
  asm volatile(
      "mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32 %7, %11, %12, %7;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7])
      : "r"(v[0]), "r"(v[2]), "r"(v[4]), "r"(v[6]), "r"(s));
}

// y0 += x[1], then x = (x >> 64) + (v[0], v[2], v[4], v[6]) * s with the
// carry of the first add
__device__ __forceinline__ void shift_mac(uint32_t& y0, uint32_t* x,
                                          const uint32_t* v, uint32_t s) {
  asm volatile(
      "add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
      "madc.hi.u32 %8, %12, %13, 0;"
      : "+r"(y0), "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
        "+r"(x[5]), "+r"(x[6]), "+r"(x[7])
      : "r"(v[0]), "r"(v[2]), "r"(v[4]), "r"(v[6]), "r"(s));
}

// e[k] += o[k + 1] for k < 7, the carry into e[7]
__device__ __forceinline__ void merge(uint32_t* e, const uint32_t* o) {
  asm volatile(
      "add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]),
        "+r"(e[5]), "+r"(e[6]), "+r"(e[7])
      : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]),
        "r"(o[7]));
}

// d -= b; borrow = 0xffffffff if it borrowed, else 0
__device__ __forceinline__ void sub_words(uint32_t* d, uint32_t& borrow,
                                          const uint32_t* b) {
  borrow = 0;
  asm volatile(
      "sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32 %8, %8, 0;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(borrow)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
}

// s += b (no carry out: a + b < 2r < 2^256)
__device__ __forceinline__ void add_words(uint32_t* s, const uint32_t* b) {
  asm volatile(
      "add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]),
        "+r"(s[5]), "+r"(s[6]), "+r"(s[7])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
}

// d += r if bw != 0 (one predicated chain): the fix-up of a subtraction
// that borrowed; the carry out is dropped, so d wraps back below r
__device__ __forceinline__ void add_p_if(uint32_t* d, uint32_t bw) {
  asm volatile(
      "{\n\t"
      ".reg .pred bz;\n\t"
      "setp.ne.u32 bz, %8, 0;\n\t"
      "@bz add.cc.u32 %0, %0, %9;\n\t"
      "@bz addc.cc.u32 %1, %1, %10;\n\t"
      "@bz addc.cc.u32 %2, %2, %11;\n\t"
      "@bz addc.cc.u32 %3, %3, %12;\n\t"
      "@bz addc.cc.u32 %4, %4, %13;\n\t"
      "@bz addc.cc.u32 %5, %5, %14;\n\t"
      "@bz addc.cc.u32 %6, %6, %15;\n\t"
      "@bz addc.u32 %7, %7, %16;\n\t"
      "}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(bw), "r"(FR_MOD[0]), "r"(FR_MOD[1]), "r"(FR_MOD[2]),
        "r"(FR_MOD[3]), "r"(FR_MOD[4]), "r"(FR_MOD[5]), "r"(FR_MOD[6]),
        "r"(FR_MOD[7]));
}


// t = t - r if t >= r, for t < 2r
__device__ __forceinline__ void reduce(uint32_t* t) {
  uint32_t bw;
  sub_words(t, bw, FR_MOD);
  add_p_if(t, bw);
}

// one CIOS row after the first, as fq::row: y the accumulator of the even
// word positions, x the odd one
__device__ __forceinline__ void row(uint32_t* y, uint32_t* x,
                                   const uint32_t* a, uint32_t bi) {
  shift_mac(y[0], x, a + 1, bi);
  mac_even(y, x[7], a, bi);
  const uint32_t m = y[0] * Fr::NP0;
  mac_odd(x, FR_MOD + 1, m);
  mac_even(y, x[7], FR_MOD, m);
}

}  // namespace fr

template <>
__device__ __forceinline__ void mont_mul<Fr>(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b) {
  uint32_t e[8], o[8];
  const uint32_t b0 = b[0];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    e[j] = a[j] * b0;
    e[j + 1] = __umulhi(a[j], b0);
    o[j] = a[j + 1] * b0;
    o[j + 1] = __umulhi(a[j + 1], b0);
  }
  const uint32_t m = e[0] * Fr::NP0;
  fr::mac_odd(o, FR_MOD + 1, m);
  fr::mac_even(e, o[7], FR_MOD, m);
#pragma unroll
  for (int i = 1; i < 8; i += 2) {
    fr::row(o, e, a, b[i]);
    if (i + 1 < 8) fr::row(e, o, a, b[i + 1]);
  }
  // after row 7 the even positions are in o (o[0] = 0): result = e + o / 2^32
  fr::merge(e, o);
  fr::reduce(e);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = e[j];
}

template <>
__device__ __forceinline__ void add_mod<Fr>(uint32_t* r, const uint32_t* a,
                                            const uint32_t* b) {
  uint32_t s[8];
#pragma unroll
  for (int j = 0; j < 8; j++) s[j] = a[j];
  fr::add_words(s, b);
  fr::reduce(s);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = s[j];
}

template <>
__device__ __forceinline__ void sub_mod<Fr>(uint32_t* r, const uint32_t* a,
                                            const uint32_t* b) {
  uint32_t d[8], borrow;
#pragma unroll
  for (int j = 0; j < 8; j++) d[j] = a[j];
  fr::sub_words(d, borrow, b);
  fr::add_p_if(d, borrow);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = d[j];
}

// ---------------------------------------------------------------------------
// (L, n) 16-bit-limb storage <-> N 32-bit words in registers.
// `per` is the input's column period: n for a full operand, 1 for a
// broadcast scalar, k for an operand tiled along the flattened batch.
// ---------------------------------------------------------------------------
template <int N>
__device__ __forceinline__ void load_fe(uint32_t* w, const uint32_t* base,
                                        long long stride, long long col) {
#pragma unroll
  for (int i = 0; i < N; i++) {
    const uint32_t lo = base[(2 * i) * stride + col];
    const uint32_t hi = base[(2 * i + 1) * stride + col];
    w[i] = (lo & 0xffffu) | (hi << 16);
  }
}

template <int N>
__device__ __forceinline__ void store_fe(uint32_t* base, long long stride,
                                         long long col, const uint32_t* w) {
#pragma unroll
  for (int i = 0; i < N; i++) {
    base[(2 * i) * stride + col] = w[i] & 0xffffu;
    base[(2 * i + 1) * stride + col] = w[i] >> 16;
  }
}

// ---------------------------------------------------------------------------
// G1 over Fq in xyzz coordinates; identity is ZZ == 0. The formulas and the
// special-case selection order are limbmath.xyzz_add's, so the output
// coordinates are bit-identical to the JAX package's (a Montgomery product
// by one returns its operand, and products of canonical values do not
// depend on their order). Each function keeps one point and a few
// temporaries live, and reads the other operand from its source (an object
// with load(coord, w) or load_x / load_y) when it needs a coordinate.
// ---------------------------------------------------------------------------
struct Xyzz {
  uint32_t X[12], Y[12], ZZ[12], ZZZ[12];
};
enum Coord { CX = 0, CY = 1, CZZ = 2, CZZZ = 3 };

__device__ __forceinline__ void fq_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < 12; j++) r[j] = a[j];
}

__device__ __forceinline__ void fq_set_one(uint32_t* r, bool zero) {
#pragma unroll
  for (int j = 0; j < 12; j++) r[j] = zero ? 0u : FQ_ONE[j];
}

// p = 2p in place, dbl-2008-s-1 (a = 0): 6M + 2S
__device__ __forceinline__ void xyzz_double(Xyzz& p) {
  uint32_t V[12], W[12], S[12], t[12];
  add_mod<Fq>(t, p.Y, p.Y);           // U = 2Y
  mont_mul<Fq>(V, t, t);              // V = U^2
  mont_mul<Fq>(W, t, V);              // W = U V
  mont_mul<Fq>(S, p.X, V);            // S = X V
  mont_mul<Fq>(p.ZZ, V, p.ZZ);        // ZZ3 = V ZZ
  mont_mul<Fq>(p.ZZZ, W, p.ZZZ);      // ZZZ3 = W ZZZ
  mont_mul<Fq>(t, p.X, p.X);          // XX
  add_mod<Fq>(V, t, t);
  add_mod<Fq>(V, V, t);               // M = 3 XX
  mont_mul<Fq>(p.X, V, V);
  add_mod<Fq>(t, S, S);
  sub_mod<Fq>(p.X, p.X, t);           // X3 = M^2 - 2S
  sub_mod<Fq>(S, S, p.X);
  mont_mul<Fq>(S, V, S);
  mont_mul<Fq>(t, W, p.Y);
  sub_mod<Fq>(p.Y, S, t);             // Y3 = M (S - X3) - W Y
}

// The add-2008-s-1 tail. In: P = U2 - U1, R = S2 - S1, zz = ZZ1 ZZ2,
// zzz = ZZZ1 ZZZ2, U1, S1. Out: X3 in P, Y3 in R, ZZ3 in zz, ZZZ3 in zzz;
// U1 and S1 are overwritten. kUnitZ: zz = zzz = 1 (two affine operands),
// so ZZ3 = PP and ZZZ3 = PPP with no product.
template <bool kUnitZ>
__device__ __forceinline__ void add_tail(uint32_t* P, uint32_t* R,
                                         uint32_t* zz, uint32_t* zzz,
                                         uint32_t* U1, uint32_t* S1) {
  uint32_t t[12];
  mont_mul<Fq>(t, P, P);              // PP
  mont_mul<Fq>(P, P, t);              // PPP
  if (kUnitZ) {
    fq_copy(zz, t);
    fq_copy(zzz, P);
  } else {
    mont_mul<Fq>(zz, zz, t);          // ZZ3 = ZZ1 ZZ2 PP
    mont_mul<Fq>(zzz, zzz, P);        // ZZZ3 = ZZZ1 ZZZ2 PPP
  }
  mont_mul<Fq>(U1, U1, t);            // Q = U1 PP
  mont_mul<Fq>(S1, S1, P);            // S1 PPP
  mont_mul<Fq>(t, R, R);
  sub_mod<Fq>(t, t, P);               // R^2 - PPP
  add_mod<Fq>(P, U1, U1);
  sub_mod<Fq>(P, t, P);               // X3 = R^2 - PPP - 2Q
  sub_mod<Fq>(t, U1, P);
  mont_mul<Fq>(t, R, t);
  sub_mod<Fq>(R, t, S1);              // Y3 = R (Q - X3) - S1 PPP
}

// q = p + q, add-2008-s-1 (12M + 2S), complete: q = O gives p, p = O gives
// q, P == Q doubles p, P == -Q gives ZZ3 = ZZZ3 = 0. p comes from `src`.
template <class Src>
__device__ __forceinline__ void xyzz_add_to(Xyzz& q, const Src& src) {
  if (is_zero<Fq>(q.ZZ)) {
    src.load(CX, q.X);
    src.load(CY, q.Y);
    src.load(CZZ, q.ZZ);
    src.load(CZZZ, q.ZZZ);
    return;
  }
  uint32_t t[12], U1[12], S1[12];
  src.load(CZZ, t);
  if (is_zero<Fq>(t)) return;
  mont_mul<Fq>(q.X, q.X, t);          // U2 = X2 ZZ1
  src.load(CX, U1);
  mont_mul<Fq>(U1, U1, q.ZZ);         // U1 = X1 ZZ2
  mont_mul<Fq>(q.ZZ, q.ZZ, t);        // ZZ1 ZZ2
  src.load(CZZZ, t);
  mont_mul<Fq>(q.Y, q.Y, t);          // S2 = Y2 ZZZ1
  src.load(CY, S1);
  mont_mul<Fq>(S1, S1, q.ZZZ);        // S1 = Y1 ZZZ2
  mont_mul<Fq>(q.ZZZ, q.ZZZ, t);      // ZZZ1 ZZZ2
  sub_mod<Fq>(q.X, q.X, U1);          // P = U2 - U1
  sub_mod<Fq>(q.Y, q.Y, S1);          // R = S2 - S1
  if (is_zero<Fq>(q.X) && is_zero<Fq>(q.Y)) {
    src.load(CX, q.X);
    src.load(CY, q.Y);
    src.load(CZZ, q.ZZ);
    src.load(CZZZ, q.ZZZ);
    xyzz_double(q);
    return;
  }
  add_tail<false>(q.X, q.Y, q.ZZ, q.ZZZ, U1, S1);
}

// p = p + lift(q) for an affine q from `src`, (0, 0) the identity: K8's
// formula and selection order with ZZ2 = ZZZ2 = 1 folded in (U1 = X1,
// S1 = Y1, ZZ1 ZZ2 = ZZ1): 8M + 2S.
template <class Src>
__device__ __forceinline__ void xyzz_add_mixed_to(Xyzz& p, const Src& src) {
  uint32_t x[12], y[12];
  src.load_x(x);
  src.load_y(y);
  if (is_zero<Fq>(x) && is_zero<Fq>(y)) return;
  if (is_zero<Fq>(p.ZZ)) {
    fq_copy(p.X, x);
    fq_copy(p.Y, y);
    fq_set_one(p.ZZ, false);
    fq_set_one(p.ZZZ, false);
    return;
  }
  mont_mul<Fq>(x, x, p.ZZ);           // U2 = x ZZ1
  sub_mod<Fq>(x, x, p.X);             // P = U2 - X1
  mont_mul<Fq>(y, y, p.ZZZ);          // S2 = y ZZZ1
  sub_mod<Fq>(y, y, p.Y);             // R = S2 - Y1
  if (is_zero<Fq>(x) && is_zero<Fq>(y)) {
    xyzz_double(p);
    return;
  }
  add_tail<false>(x, y, p.ZZ, p.ZZZ, p.X, p.Y);
  fq_copy(p.X, x);
  fq_copy(p.Y, y);
}

// affine (x, y) in o.X, o.Y -> xyzz in place; (0, 0) is the identity
// (limbmath.affine_lift)
__device__ __forceinline__ void affine_lift(Xyzz& o) {
  const bool inf = is_zero<Fq>(o.X) && is_zero<Fq>(o.Y);
  fq_set_one(o.ZZ, inf);
  fq_set_one(o.ZZZ, inf);
}

// o = lift(a) + lift(b) for affine a in o.X, o.Y and b in (bx, by): K9's
// formula and selection order with ZZ = ZZZ = 1 (6M + ...: no product by
// one is made); bx, by are overwritten
__device__ __forceinline__ void affine_add2(Xyzz& o, uint32_t* bx,
                                            uint32_t* by) {
  if (is_zero<Fq>(bx) && is_zero<Fq>(by)) {
    affine_lift(o);
    return;
  }
  if (is_zero<Fq>(o.X) && is_zero<Fq>(o.Y)) {
    fq_copy(o.X, bx);
    fq_copy(o.Y, by);
    affine_lift(o);
    return;
  }
  sub_mod<Fq>(bx, bx, o.X);           // P = x2 - x1
  sub_mod<Fq>(by, by, o.Y);           // R = y2 - y1
  if (is_zero<Fq>(bx) && is_zero<Fq>(by)) {
    affine_lift(o);
    xyzz_double(o);
    return;
  }
  add_tail<true>(bx, by, o.ZZ, o.ZZZ, o.X, o.Y);
  fq_copy(o.X, bx);
  fq_copy(o.Y, by);
}
