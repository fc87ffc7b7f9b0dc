// BLS12-381 Fr / Fq Montgomery arithmetic for one thread per element.
//
// Storage is the JAX package's layout: limbs-leading (L, n) 32-bit words
// holding 16-bit limbs little-endian (L = 16 for Fr, 24 for Fq), Montgomery
// form, fully reduced. In registers a value is N = L/2 32-bit words, so the
// CIOS product below runs on 32x32->64-bit multiply-adds. Montgomery R is
// 2^256 (Fr) / 2^384 (Fq) for both packings, so the values are the same bits.
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

// r = t - p if (hi or t >= p) else t; r may alias t.
template <class F>
__device__ __forceinline__ void cond_sub(uint32_t* r, const uint32_t* t,
                                         uint32_t hi) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    uint64_t s = (uint64_t)t[j] - F::mod(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool take = hi != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) r[j] = take ? d[j] : t[j];
}

// Montgomery product a*b*R^-1 mod p (CIOS). p < R/4 for both fields, so
// the running value stays below 2p and one conditional subtract reduces it.
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::NP0;
    s = (uint64_t)m * F::mod(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)m * F::mod(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  cond_sub<F>(r, t, t[N]);
}

template <class F>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b) {
  uint32_t s[F::N];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    uint64_t v = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  cond_sub<F>(r, s, c);
}

template <class F>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  if (borrow) {
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < F::N; j++) {
      uint64_t v = (uint64_t)d[j] + F::mod(j) + c;
      d[j] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
  }
#pragma unroll
  for (int j = 0; j < F::N; j++) r[j] = d[j];
}

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
// G1 over Fq in xyzz coordinates; identity is ZZ == 0. Same formulas and
// the same special-case selection order as limbmath.xyzz_add, so the output
// coordinates are bit-identical to the JAX package's.
// ---------------------------------------------------------------------------
struct Xyzz {
  uint32_t X[12], Y[12], ZZ[12], ZZZ[12];
};

// dbl-2008-s-1 (a = 0): 6M + 2S
__device__ __forceinline__ void xyzz_double(Xyzz& o, const Xyzz& p) {
  uint32_t U[12], V[12], W[12], S[12], M[12], t[12], t2[12];
  add_mod<Fq>(U, p.Y, p.Y);
  mont_mul<Fq>(V, U, U);
  mont_mul<Fq>(W, U, V);
  mont_mul<Fq>(S, p.X, V);
  mont_mul<Fq>(t, p.X, p.X);          // XX
  add_mod<Fq>(M, t, t);
  add_mod<Fq>(M, M, t);               // 3 XX
  mont_mul<Fq>(t, M, M);
  add_mod<Fq>(t2, S, S);
  sub_mod<Fq>(o.X, t, t2);            // X3 = M^2 - 2S
  sub_mod<Fq>(t, S, o.X);
  mont_mul<Fq>(t2, M, t);
  mont_mul<Fq>(t, W, p.Y);
  sub_mod<Fq>(o.Y, t2, t);            // Y3 = M (S - X3) - W Y
  mont_mul<Fq>(o.ZZ, V, p.ZZ);
  mont_mul<Fq>(o.ZZZ, W, p.ZZZ);
}

// add-2008-s-1: 12M + 2S, complete: identity operands, P == Q (doubling)
// and P == -Q (ZZ3 = ZZZ3 = 0 falls out of PP = PPP = 0).
__device__ __forceinline__ void xyzz_add(Xyzz& o, const Xyzz& p,
                                         const Xyzz& q) {
  if (is_zero<Fq>(q.ZZ)) { o = p; return; }
  if (is_zero<Fq>(p.ZZ)) { o = q; return; }
  uint32_t U1[12], S1[12], P[12], R[12], t[12], t2[12];
  mont_mul<Fq>(U1, p.X, q.ZZ);
  mont_mul<Fq>(t, q.X, p.ZZ);         // U2
  sub_mod<Fq>(P, t, U1);
  mont_mul<Fq>(S1, p.Y, q.ZZZ);
  mont_mul<Fq>(t, q.Y, p.ZZZ);        // S2
  sub_mod<Fq>(R, t, S1);
  if (is_zero<Fq>(P) && is_zero<Fq>(R)) { xyzz_double(o, p); return; }
  uint32_t PP[12], PPP[12], Q[12];
  mont_mul<Fq>(PP, P, P);
  mont_mul<Fq>(PPP, P, PP);
  mont_mul<Fq>(Q, U1, PP);
  mont_mul<Fq>(t, R, R);
  sub_mod<Fq>(t, t, PPP);
  add_mod<Fq>(t2, Q, Q);
  sub_mod<Fq>(o.X, t, t2);            // X3 = R^2 - PPP - 2Q
  sub_mod<Fq>(t, Q, o.X);
  mont_mul<Fq>(t2, R, t);
  mont_mul<Fq>(t, S1, PPP);
  sub_mod<Fq>(o.Y, t2, t);            // Y3 = R (Q - X3) - S1 PPP
  mont_mul<Fq>(t, p.ZZ, q.ZZ);
  mont_mul<Fq>(o.ZZ, t, PP);
  mont_mul<Fq>(t, p.ZZZ, q.ZZZ);
  mont_mul<Fq>(o.ZZZ, t, PPP);
}

// affine (x, y) -> xyzz; (0, 0) encodes the identity (limbmath.affine_lift)
__device__ __forceinline__ void affine_lift(Xyzz& o) {
  const bool inf = is_zero<Fq>(o.X) && is_zero<Fq>(o.Y);
#pragma unroll
  for (int j = 0; j < 12; j++) {
    o.ZZ[j] = inf ? 0u : FQ_ONE[j];
    o.ZZZ[j] = o.ZZ[j];
  }
}
