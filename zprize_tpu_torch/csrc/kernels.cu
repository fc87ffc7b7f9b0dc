// The nine field/curve kernels of the port, one thread per element, with a
// plain C interface (bound from Python through ctypes by
// `zprize_tpu_torch/fields/kernels.py`).
//
// Each replaces one Pallas entry point of `zprize_tpu/fields/pkern.py`:
//   zk_mul             K1 pkern.mul            a*b*R^-1        Fr, Fq
//   zk_add             K2 pkern.add            a+b             Fr, Fq
//   zk_sub             K3 pkern.sub            a-b             Fr, Fq
//   zk_neg             K4 pkern.neg            -a              Fr, Fq
//   zk_butterfly_stage K5 pkern.mul_add_sub    (u+vw, u-vw)    Fr
//   zk_mul3            K6 pkern.mul3           a*b*c*R^-2      Fr, Fq
//   zk_xyzz_add        K7 pkern.xyzz_add       xyzz + xyzz     Fq
//   zk_xyzz_add_mixed  K8 pkern.xyzz_add_mixed xyzz + affine   Fq
//   zk_xyzz_add_affine2 K9 pkern.xyzz_add_affine2 affine+affine Fq
//
// Bound: the (L, n) layout stores 16 bits in every 32-bit word, so the field
// ops move 2x the bytes of a packed layout and are memory-bound on an H100
// (Fr add: 192 B per element for ~30 integer ops). The curve kernels do
// ~14-22 Fq products (~300 multiply-adds each) per ~1.2 KB and are bound by
// integer multiply throughput. K6 keeps a*b in registers, so it moves 4 (not
// 6) field elements per column; K8 reads an affine operand (48 words) where
// K7 reads a second xyzz one (96). Design: the batch axis is the fastest-moving
// one, so the 32 threads of a warp read 32 consecutive words of each limb
// row (coalesced); limbs live in registers; the tail is masked so any n
// works. Every launcher returns cudaGetLastError().
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPointThreads = 128;

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

__device__ __forceinline__ long long col_of(long long col, long long per,
                                            long long n) {
  return per == n ? col : col % per;
}

enum Op { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2 };

template <class F, int OPK>
__global__ void __launch_bounds__(kThreads)
binary_kernel(const uint32_t* __restrict__ a, long long pa,
              const uint32_t* __restrict__ b, long long pb,
              uint32_t* __restrict__ out, long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t x[F::N], y[F::N], r[F::N];
  load_fe<F::N>(x, a, pa, col_of(col, pa, n));
  load_fe<F::N>(y, b, pb, col_of(col, pb, n));
  if (OPK == OP_MUL) mont_mul<F>(r, x, y);
  if (OPK == OP_ADD) add_mod<F>(r, x, y);
  if (OPK == OP_SUB) sub_mod<F>(r, x, y);
  store_fe<F::N>(out, n, col, r);
}

// K6: both Montgomery products in registers, no round trip of a*b
template <class F>
__global__ void __launch_bounds__(kThreads)
mul3_kernel(const uint32_t* __restrict__ a, long long pa,
            const uint32_t* __restrict__ b, long long pb,
            const uint32_t* __restrict__ c, long long pc,
            uint32_t* __restrict__ out, long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t x[F::N], y[F::N], r[F::N];
  load_fe<F::N>(x, a, pa, col_of(col, pa, n));
  load_fe<F::N>(y, b, pb, col_of(col, pb, n));
  mont_mul<F>(r, x, y);
  load_fe<F::N>(y, c, pc, col_of(col, pc, n));
  mont_mul<F>(x, r, y);
  store_fe<F::N>(out, n, col, x);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
neg_kernel(const uint32_t* __restrict__ a, long long pa,
           uint32_t* __restrict__ out, long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t x[F::N], r[F::N];
  load_fe<F::N>(x, a, pa, col_of(col, pa, n));
  neg_mod<F>(r, x);
  store_fe<F::N>(out, n, col, r);
}

// One radix-2 stage over a (16, n) Fr array whose columns are blocks of
// 2*half: u = column blk*2h + j, v = u + h, w = tw[:, j * tw_step].
__global__ void __launch_bounds__(kThreads)
butterfly_stage_kernel(const uint32_t* __restrict__ a,
                       uint32_t* __restrict__ out, long long n,
                       int log_half, const uint32_t* __restrict__ tw,
                       long long tw_n, long long tw_step) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (n >> 1)) return;
  const long long half = 1LL << log_half;
  const long long blk = t >> log_half;
  const long long j = t & (half - 1);
  const long long iu = (blk << (log_half + 1)) + j;
  const long long iv = iu + half;
  uint32_t u[8], v[8], w[8], vw[8], r[8];
  load_fe<8>(u, a, n, iu);
  load_fe<8>(v, a, n, iv);
  load_fe<8>(w, tw, tw_n, j * tw_step);
  mont_mul<Fr>(vw, v, w);
  add_mod<Fr>(r, u, vw);
  store_fe<8>(out, n, iu, r);
  sub_mod<Fr>(r, u, vw);
  store_fe<8>(out, n, iv, r);
}

__device__ __forceinline__ void load_xyzz(Xyzz& p, const uint32_t* base,
                                          long long stride, long long col) {
  load_fe<12>(p.X, base, stride, col);
  load_fe<12>(p.Y, base + 24 * stride, stride, col);
  load_fe<12>(p.ZZ, base + 48 * stride, stride, col);
  load_fe<12>(p.ZZZ, base + 72 * stride, stride, col);
}

__device__ __forceinline__ void store_xyzz(uint32_t* base, long long stride,
                                           long long col, const Xyzz& p) {
  store_fe<12>(base, stride, col, p.X);
  store_fe<12>(base + 24 * stride, stride, col, p.Y);
  store_fe<12>(base + 48 * stride, stride, col, p.ZZ);
  store_fe<12>(base + 72 * stride, stride, col, p.ZZZ);
}

// p, q: (96, n) stacked X, Y, ZZ, ZZZ (24 limb rows each)
__global__ void __launch_bounds__(kPointThreads)
xyzz_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                uint32_t* __restrict__ out, long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  Xyzz a, b, r;
  load_xyzz(a, p, n, col);
  load_xyzz(b, q, n, col);
  xyzz_add(r, a, b);
  store_xyzz(out, n, col, r);
}

// xyzz p (96, n) + affine (qx, qy) -> xyzz (96, n); (0, 0) = identity.
// The identity test reads (qx, qy) before the lift (ZZ = ZZZ = 1).
__global__ void __launch_bounds__(kPointThreads)
xyzz_add_mixed_kernel(const uint32_t* __restrict__ p,
                      const uint32_t* __restrict__ qx,
                      const uint32_t* __restrict__ qy,
                      uint32_t* __restrict__ out, long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  Xyzz a, b, r;
  load_xyzz(a, p, n, col);
  load_fe<12>(b.X, qx, n, col);
  load_fe<12>(b.Y, qy, n, col);
  affine_lift(b);
  xyzz_add(r, a, b);
  store_xyzz(out, n, col, r);
}

// affine (px, py) + affine (qx, qy) -> xyzz (96, n); (0, 0) = identity
__global__ void __launch_bounds__(kPointThreads)
xyzz_add_affine2_kernel(const uint32_t* __restrict__ px,
                        const uint32_t* __restrict__ py,
                        const uint32_t* __restrict__ qx,
                        const uint32_t* __restrict__ qy,
                        uint32_t* __restrict__ out, long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  Xyzz a, b, r;
  load_fe<12>(a.X, px, n, col);
  load_fe<12>(a.Y, py, n, col);
  load_fe<12>(b.X, qx, n, col);
  load_fe<12>(b.Y, qy, n, col);
  affine_lift(a);
  affine_lift(b);
  xyzz_add(r, a, b);
  store_xyzz(out, n, col, r);
}

template <int OPK>
int launch_binary(int field, const void* a, long long pa, const void* b,
                  long long pb, void* out, long long n, cudaStream_t s) {
  if (n <= 0) return 0;
  const auto* A = static_cast<const uint32_t*>(a);
  const auto* B = static_cast<const uint32_t*>(b);
  auto* O = static_cast<uint32_t*>(out);
  if (field == 0)
    binary_kernel<Fr, OPK><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        A, pa, B, pb, O, n);
  else
    binary_kernel<Fq, OPK><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        A, pa, B, pb, O, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// field: 0 = Fr (L = 16), 1 = Fq (L = 24). All arrays are (L, n) or
// (L, per) int32 words on the device; per is the operand's column period.
int zk_mul(int field, const void* a, long long pa, const void* b,
           long long pb, void* out, long long n, void* stream) {
  return launch_binary<OP_MUL>(field, a, pa, b, pb, out, n,
                               static_cast<cudaStream_t>(stream));
}

int zk_add(int field, const void* a, long long pa, const void* b,
           long long pb, void* out, long long n, void* stream) {
  return launch_binary<OP_ADD>(field, a, pa, b, pb, out, n,
                               static_cast<cudaStream_t>(stream));
}

int zk_sub(int field, const void* a, long long pa, const void* b,
           long long pb, void* out, long long n, void* stream) {
  return launch_binary<OP_SUB>(field, a, pa, b, pb, out, n,
                               static_cast<cudaStream_t>(stream));
}

int zk_mul3(int field, const void* a, long long pa, const void* b,
            long long pb, const void* c, long long pc, void* out,
            long long n, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const uint32_t*>(a);
  const auto* B = static_cast<const uint32_t*>(b);
  const auto* C = static_cast<const uint32_t*>(c);
  auto* O = static_cast<uint32_t*>(out);
  if (field == 0)
    mul3_kernel<Fr><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        A, pa, B, pb, C, pc, O, n);
  else
    mul3_kernel<Fq><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        A, pa, B, pb, C, pc, O, n);
  return (int)cudaGetLastError();
}

int zk_neg(int field, const void* a, long long pa, void* out, long long n,
           void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const uint32_t*>(a);
  auto* O = static_cast<uint32_t*>(out);
  if (field == 0)
    neg_kernel<Fr><<<blocks_for(n, kThreads), kThreads, 0, s>>>(A, pa, O, n);
  else
    neg_kernel<Fq><<<blocks_for(n, kThreads), kThreads, 0, s>>>(A, pa, O, n);
  return (int)cudaGetLastError();
}

int zk_butterfly_stage(const void* a, void* out, long long n, int log_half,
                       const void* tw, long long tw_n, long long tw_step,
                       void* stream) {
  if (n <= 1) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  butterfly_stage_kernel<<<blocks_for(n >> 1, kThreads), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out), n,
      log_half, static_cast<const uint32_t*>(tw), tw_n, tw_step);
  return (int)cudaGetLastError();
}

int zk_xyzz_add(const void* p, const void* q, void* out, long long n,
                void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  xyzz_add_kernel<<<blocks_for(n, kPointThreads), kPointThreads, 0, s>>>(
      static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(q),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

int zk_xyzz_add_mixed(const void* p, const void* qx, const void* qy,
                      void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  xyzz_add_mixed_kernel<<<blocks_for(n, kPointThreads), kPointThreads, 0,
                          s>>>(
      static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(qx),
      static_cast<const uint32_t*>(qy), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

int zk_xyzz_add_affine2(const void* px, const void* py, const void* qx,
                        const void* qy, void* out, long long n,
                        void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  xyzz_add_affine2_kernel<<<blocks_for(n, kPointThreads), kPointThreads, 0,
                            s>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(qx), static_cast<const uint32_t*>(qy),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
