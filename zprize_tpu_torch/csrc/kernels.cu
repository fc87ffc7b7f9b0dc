// The field/curve kernels of the port, one thread per element (or per
// chunk of bucket members), with a plain C interface (bound from Python
// through ctypes by `zprize_tpu_torch/fields/kernels.py`).
//
// Each replaces one Pallas entry point of `zprize_tpu/fields/pkern.py`:
//   zk_mul             K1 pkern.mul            a*b*R^-1        Fr, Fq
//   zk_add             K2 pkern.add            a+b             Fr, Fq
//   zk_sub             K3 pkern.sub            a-b             Fr, Fq
//   zk_neg             K4 pkern.neg            -a              Fr, Fq
//   zk_butterfly_stage K5 pkern.mul_add_sub    (u+vw, u-vw)    Fr
//   zk_ntt_pass        K5's NTT stages, several in one launch          Fr
//   zk_mul3            K6 pkern.mul3           a*b*c*R^-2      Fr, Fq
//   zk_xyzz_add        K7 pkern.xyzz_add       xyzz + xyzz     Fq
//   zk_xyzz_add_pairs  K7 over one tree level (adjacent column pairs)
//   zk_xyzz_add_mixed  K8 pkern.xyzz_add_mixed xyzz + affine   Fq
//   zk_xyzz_add_affine2 K9 pkern.xyzz_add_affine2 affine+affine Fq
//   zk_bucket_acc      MSM bucket sums, first level: K9's then K8's body
//                      over gathered members (the job of K9 and of K7's
//                      tree levels in pkern's MSM)
//   zk_bucket_sum      MSM bucket sums, later levels: K7's body
//
// Bound: the (L, n) layout stores 16 bits in every 32-bit word, so the field
// ops move 2x the bytes of a packed layout and are memory-bound on an H100
// (Fr add: 192 B per element for ~30 integer ops). The curve kernels do
// 6-14 Fq products of 588 32-bit multiply-adds each per ~1.2 KB and are
// bound by the integer multiply-add rate (64 per clock per SM on sm_90).
// Design: the batch axis is the fastest-moving one, so the 32 threads of a
// warp read 32 consecutive words of each limb row (coalesced); limbs live
// in registers; the tail is masked so any n works. The curve kernels keep
// one point in registers and read the other operand's coordinates when
// the formula needs them (field.cuh); they carry no minimum-blocks launch
// bound, since every budget that would fit more blocks on an SM made ptxas
// spill. The bucket kernels gather points from the point-major SRS copy (96 B
// per point, six 16-byte loads) and sum up to msm.CHUNK members a thread,
// so no slot grid is padded and no gathered copy is written. Every
// launcher returns cudaGetLastError().
#include <cuda_runtime.h>

#include <algorithm>

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
// 2*half rows of `lanes` = 2^log_lanes columns each (a stage along axis -2
// of (16, ..., rows, lanes); lanes = 1 is the flat stage along the last
// axis). Thread t takes lane t & (lanes-1) of pair p = t >> log_lanes:
// u = row blk*2h + j, v = u + h, w = tw[:, j * tw_step]. Neighbouring
// threads read neighbouring columns of each limb row either way, and with
// lanes >= 32 the 32 threads of a warp read one twiddle (one broadcast).
__global__ void __launch_bounds__(kThreads)
butterfly_stage_kernel(const uint32_t* __restrict__ a,
                       uint32_t* __restrict__ out, long long n,
                       int log_half, int log_lanes,
                       const uint32_t* __restrict__ tw, long long tw_n,
                       long long tw_step) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (n >> 1)) return;
  const long long lane = t & ((1LL << log_lanes) - 1);
  const long long p = t >> log_lanes;
  const long long half = 1LL << log_half;
  const long long blk = p >> log_half;
  const long long j = p & (half - 1);
  const long long iu = (((blk << (log_half + 1)) + j) << log_lanes) + lane;
  const long long iv = iu + (half << log_lanes);
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

// Fused NTT pass (ntt_pass): stages s0+1 .. s1 of the radix-2 DIT schedule
// that K5 runs one launch a stage (`zprize_tpu/fields/pkern.py:172`, chained
// by `zprize_tpu/ops/ntt.py`'s `_core` and `_core_axis2`), over a
// (16, batch, R, M) Fr array along its R = 2^log_rows rows, M = 2^log_lanes
// lanes a row. Position p of the transform lies in row p, or, with `bitrev`
// (first pass only, s0 = 0), in row bitrev(p): the bit-reversal gather of
// the radix-2 transform. Stage s pairs positions blk*2^s + j and
// blk*2^s + j + 2^(s-1) with w = tw[j * (R >> s)], as K5 does.
//
// Stages s0+1 .. s1 keep the bits of p outside [s0, s1) fixed, so one block
// takes a tile of 2^(s1-s0) positions ("mid") x G consecutive low positions
// ("lo") x m consecutive lanes x C batch items, at most 2^kPassTileLog
// elements: it loads the tile once into shared memory, optionally times
// `mul` (one Fr scalar, or an (R, M) table indexed [row, lane] of the
// input: the four-step's mid twiddles, or 1/n), runs every stage of the
// pass there with a __syncthreads between stages, and stores it once,
// optionally transposed to (batch, M, R). So a 2^11-point transform costs
// one or two passes over device memory in place of 11 K5 launches, and the
// gather, the twiddle product and the transposing copy that surrounded
// those stages cost none (1/n scales the input, not the output: the
// transform is linear). Between the
// passes of one transform the array is kept packed, (8, N) words of two
// limbs each (`packed_in`, `packed_out`), so those passes move 32 B an
// element where the ends move 64.
//
// Bound: a pass moves 64-128 B an element; a butterfly takes one Fr product
// (264 multiply-add issue slots, field.cuh) and an add and a subtract, so a
// pass of 5-6 stages needs about as long for its products as for its bytes,
// and, since a block loads, computes and stores in turn, it pays roughly
// the sum. The design keeps the operands in shared memory (word k of tile
// element e at k * stride + e + e/32, so strided rows and bit-reversed
// positions spread over the banks), skips the product where the twiddle is
// one (every butterfly of stage 1, and whole warps later), and reads each
// twiddle from the small sub-transform table, which stays in L1/L2. The tile
// takes at least 8 lanes (or, for a transposed store, 8 consecutive rows)
// where there are that many, so every limb row of a load or a store is a
// whole 32-byte sector, and blocks that share the lines of a transposed
// store run side by side.
constexpr int kPassThreads = 256;
constexpr int kPassTileLog = 11;

__device__ __forceinline__ int pass_slot(int e) { return e + (e >> 5); }

// Montgomery one of Fr (2^256 mod r)
__device__ __forceinline__ bool is_fr_one(const uint32_t* w) {
  return ((w[0] ^ 0xfffffffeu) | (w[1] ^ 0x00000001u) | (w[2] ^ 0x00034802u) |
          (w[3] ^ 0x5884b7fau) | (w[4] ^ 0xecbc4ff5u) | (w[5] ^ 0x998c4fefu) |
          (w[6] ^ 0xacc5056fu) | (w[7] ^ 0x1824b159u)) == 0;
}

// the low `bits` bits of x reversed
__device__ __forceinline__ long long rev_bits(long long x, int bits) {
  return bits ? (long long)(__brevll((unsigned long long)x) >> (64 - bits))
              : 0;
}

struct PassTile {
  int log_t, log_g, log_m, log_c;
};

__global__ void __launch_bounds__(kPassThreads)
ntt_pass_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                long long batch, int log_rows, int log_lanes, int s0, int s1,
                PassTile tile, int bitrev, const uint32_t* __restrict__ tw,
                long long tw_n, const uint32_t* __restrict__ mul,
                long long mul_n, int transpose, int packed_in,
                int packed_out) {
  extern __shared__ uint32_t sm[];
  const int log_t = tile.log_t, log_g = tile.log_g, log_m = tile.log_m,
            log_c = tile.log_c;
  const int E = 1 << (log_c + log_t + log_g + log_m);
  const int stride = E + (E >> 5);
  const long long n = batch << (log_rows + log_lanes);
  // block -> (batch items, high positions, lanes, low positions): blocks
  // that write the neighbouring rows of a transposed store run together,
  // so their partial lines meet in L2
  long long blk = blockIdx.x;
  const int lane_bits = log_lanes - log_m, lo_bits = s0 - log_g,
            hi_bits = log_rows - s1;
  const long long lo0 = (blk & ((1LL << lo_bits) - 1)) << log_g;
  blk >>= lo_bits;
  const long long lane0 = (blk & ((1LL << lane_bits) - 1)) << log_m;
  blk >>= lane_bits;
  const long long hi = blk & ((1LL << hi_bits) - 1);
  const long long b0 = (blk >> hi_bits) << log_c;
  const int m = 1 << log_m, g = 1 << log_g, t = 1 << log_t;

  // load: tile element e = ((c * t + mid) * g + lo) * m + lane; with
  // `bitrev` the loop runs over rows in order (row r holds position
  // bitrev(r), so neighbouring threads read neighbouring rows)
  for (int i = threadIdx.x; i < E; i += kPassThreads) {
    const int lane = i & (m - 1), lo = (i >> log_m) & (g - 1);
    const int mr = (i >> (log_m + log_g)) & (t - 1);
    const int c = i >> (log_m + log_g + log_t);
    const long long b = b0 + c;
    if (b >= batch) continue;
    int mid;
    long long row;
    if (bitrev) {
      mid = (int)rev_bits(mr, log_t);
      row = ((long long)mr << hi_bits) | rev_bits(hi, hi_bits);
    } else {
      mid = mr;
      row = (hi << s1) | ((long long)mid << s0) | (lo0 + lo);
    }
    uint32_t w[8];
    const long long col =
        (((b << log_rows) | row) << log_lanes) | (lane0 + lane);
    if (packed_in) {
#pragma unroll
      for (int k = 0; k < 8; k++) w[k] = a[k * n + col];
    } else {
      load_fe<8>(w, a, n, col);
    }
    if (mul) {
      uint32_t x[8];
      load_fe<8>(x, mul, mul_n,
                 mul_n == 1 ? 0 : (row << log_lanes) | (lane0 + lane));
      mont_mul<Fr>(w, w, x);
    }
    const int e = (((c << log_t | mid) << log_g | lo) << log_m) | lane;
#pragma unroll
    for (int k = 0; k < 8; k++) sm[k * stride + pass_slot(e)] = w[k];
  }
  __syncthreads();

  for (int q = 1; q <= log_t; q++) {
    const int s = s0 + q, hq = 1 << (q - 1);
    for (int f = threadIdx.x; f < (E >> 1); f += kPassThreads) {
      const int lane = f & (m - 1), lo = (f >> log_m) & (g - 1);
      const int pair = (f >> (log_m + log_g)) & ((t >> 1) - 1);
      const int c = f >> (log_m + log_g + log_t - 1);
      const int jj = pair & (hq - 1);
      const int umid = ((pair >> (q - 1)) << q) | jj;
      const int eu = (((c << log_t | umid) << log_g | lo) << log_m) | lane;
      const int ev = eu + (hq << (log_g + log_m));
      const long long j = ((long long)jj << s0) | (lo0 + lo);
      uint32_t u[8], v[8], w[8], r[8];
      load_fe<8>(w, tw, tw_n, j << (log_rows - s));
#pragma unroll
      for (int k = 0; k < 8; k++) {
        u[k] = sm[k * stride + pass_slot(eu)];
        v[k] = sm[k * stride + pass_slot(ev)];
      }
      if (!is_fr_one(w)) mont_mul<Fr>(v, v, w);
      add_mod<Fr>(r, u, v);
      sub_mod<Fr>(v, u, v);
#pragma unroll
      for (int k = 0; k < 8; k++) {
        sm[k * stride + pass_slot(eu)] = r[k];
        sm[k * stride + pass_slot(ev)] = v[k];
      }
    }
    __syncthreads();
  }

  // store; a transposed store runs over (c, lane, mid, lo) so that
  // neighbouring threads write neighbouring rows
  for (int i = threadIdx.x; i < E; i += kPassThreads) {
    int lane, lo, mid, c;
    if (transpose) {
      lo = i & (g - 1);
      mid = (i >> log_g) & (t - 1);
      lane = (i >> (log_g + log_t)) & (m - 1);
    } else {
      lane = i & (m - 1);
      lo = (i >> log_m) & (g - 1);
      mid = (i >> (log_m + log_g)) & (t - 1);
    }
    c = i >> (log_m + log_g + log_t);
    const long long b = b0 + c;
    if (b >= batch) continue;
    const int e = (((c << log_t | mid) << log_g | lo) << log_m) | lane;
    uint32_t w[8];
#pragma unroll
    for (int k = 0; k < 8; k++) w[k] = sm[k * stride + pass_slot(e)];
    const long long p = (hi << s1) | ((long long)mid << s0) | (lo0 + lo);
    const long long ln = lane0 + lane;
    const long long col = transpose
                              ? (((b << log_lanes) | ln) << log_rows) | p
                              : (((b << log_rows) | p) << log_lanes) | ln;
    if (packed_out) {
#pragma unroll
      for (int k = 0; k < 8; k++) out[k * n + col] = w[k];
    } else {
      store_fe<8>(out, n, col, w);
    }
  }
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

// operand sources of the curve formulas (field.cuh)
// xyzz point at column `col` of a (96, stride) limb array
struct LimbXyzz {
  const uint32_t* base;
  long long stride, col;
  __device__ __forceinline__ void load(int c, uint32_t* w) const {
    load_fe<12>(w, base + 24LL * c * stride, stride, col);
  }
};

// affine point at column `col` of two (24, stride) limb arrays
struct LimbAffine {
  const uint32_t *x, *y;
  long long stride, col;
  __device__ __forceinline__ void load_x(uint32_t* w) const {
    load_fe<12>(w, x, stride, col);
  }
  __device__ __forceinline__ void load_y(uint32_t* w) const {
    load_fe<12>(w, y, stride, col);
  }
};

// affine point of the point-major SRS copy: 24 packed words, x then y
// (96 B, six 16-byte loads)
struct PackedAffine {
  const uint32_t* row;
  __device__ __forceinline__ void load4(uint32_t* w, int q) const {
    const uint4* r = reinterpret_cast<const uint4*>(row) + q;
#pragma unroll
    for (int k = 0; k < 3; k++) {
      const uint4 v = r[k];
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
  }
  __device__ __forceinline__ void load_x(uint32_t* w) const { load4(w, 0); }
  __device__ __forceinline__ void load_y(uint32_t* w) const { load4(w, 3); }
};

// K7, p, q: (96, n) stacked X, Y, ZZ, ZZZ (24 limb rows each)
__global__ void __launch_bounds__(kPointThreads)
xyzz_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                uint32_t* __restrict__ out, long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  Xyzz acc;
  load_xyzz(acc, q, n, col);
  xyzz_add_to(acc, LimbXyzz{p, n, col});
  store_xyzz(out, n, col, acc);
}

// K7 over one tree level: p (96, rows * m) -> out (96, rows * h) with
// h = ceil(m / 2), out[r, i] = p[r, 2i] + p[r, 2i + 1] and an odd tail
// p[r, m - 1] copied (the sum with the identity)
__global__ void __launch_bounds__(kPointThreads)
xyzz_add_pairs_kernel(const uint32_t* __restrict__ p,
                      uint32_t* __restrict__ out, long long rows,
                      long long m) {
  const long long h = (m + 1) / 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * h) return;
  const long long r = t / h;
  const long long a = r * m + 2 * (t - r * h);
  const long long n = rows * m;
  Xyzz acc;
  if (a + 1 < (r + 1) * m) {
    load_xyzz(acc, p, n, a + 1);
    xyzz_add_to(acc, LimbXyzz{p, n, a});
  } else {
    load_xyzz(acc, p, n, a);
  }
  store_xyzz(out, rows * h, t, acc);
}

// K8, xyzz p (96, n) + affine (qx, qy) -> xyzz (96, n); (0, 0) = identity
__global__ void __launch_bounds__(kPointThreads)
xyzz_add_mixed_kernel(const uint32_t* __restrict__ p,
                      const uint32_t* __restrict__ qx,
                      const uint32_t* __restrict__ qy,
                      uint32_t* __restrict__ out, long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  Xyzz acc;
  load_xyzz(acc, p, n, col);
  xyzz_add_mixed_to(acc, LimbAffine{qx, qy, n, col});
  store_xyzz(out, n, col, acc);
}

// K9, affine (px, py) + affine (qx, qy) -> xyzz (96, n); (0, 0) = identity
__global__ void __launch_bounds__(kPointThreads)
xyzz_add_affine2_kernel(const uint32_t* __restrict__ px,
                        const uint32_t* __restrict__ py,
                        const uint32_t* __restrict__ qx,
                        const uint32_t* __restrict__ qy,
                        uint32_t* __restrict__ out, long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  Xyzz acc;
  uint32_t bx[12], by[12];
  load_fe<12>(acc.X, px, n, col);
  load_fe<12>(acc.Y, py, n, col);
  load_fe<12>(bx, qx, n, col);
  load_fe<12>(by, qy, n, col);
  affine_add2(acc, bx, by);
  store_xyzz(out, n, col, acc);
}

// MSM bucket sums, first level. Chunk c holds the sorted bucket members
// idx[start[c]], .., idx[end[c] - 1] (point numbers into pts, the
// point-major SRS copy); one thread gathers them and adds them in order:
// the first two with K9's body, each later one with K8's (xyzz + affine),
// a chunk of one is lifted. The sum goes to column col[c] of out
// (96, out_n).
__global__ void __launch_bounds__(kPointThreads)
bucket_acc_kernel(const uint32_t* __restrict__ pts,
                  const int* __restrict__ idx, const int* __restrict__ start,
                  const int* __restrict__ end, const int* __restrict__ col,
                  uint32_t* __restrict__ out, long long out_n,
                  long long chunks) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const int s = start[c], e = end[c];
  Xyzz acc;
  const PackedAffine a{pts + 24LL * idx[s]};
  a.load_x(acc.X);
  a.load_y(acc.Y);
  if (e - s == 1) {
    affine_lift(acc);
  } else {
    uint32_t bx[12], by[12];
    const PackedAffine b{pts + 24LL * idx[s + 1]};
    b.load_x(bx);
    b.load_y(by);
    affine_add2(acc, bx, by);
    for (int k = s + 2; k < e; k++)
      xyzz_add_mixed_to(acc, PackedAffine{pts + 24LL * idx[k]});
  }
  store_xyzz(out, out_n, col[c], acc);
}

// MSM bucket sums, later levels: chunk c sums the xyzz partials in columns
// start[c] .. end[c] - 1 of part (96, part_n), each added as the first
// operand of K7's body (acc = part[k] + acc), into column col[c] of out.
__global__ void __launch_bounds__(kPointThreads)
bucket_sum_kernel(const uint32_t* __restrict__ part, long long part_n,
                  const int* __restrict__ start, const int* __restrict__ end,
                  const int* __restrict__ col, uint32_t* __restrict__ out,
                  long long out_n, long long chunks) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const int s = start[c], e = end[c];
  Xyzz acc;
  load_xyzz(acc, part, part_n, s);
  for (int k = s + 1; k < e; k++)
    xyzz_add_to(acc, LimbXyzz{part, part_n, k});
  store_xyzz(out, out_n, col[c], acc);
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
                       int log_lanes, const void* tw, long long tw_n,
                       long long tw_step, void* stream) {
  if (n <= 1) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  butterfly_stage_kernel<<<blocks_for(n >> 1, kThreads), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out), n,
      log_half, log_lanes, static_cast<const uint32_t*>(tw), tw_n, tw_step);
  return (int)cudaGetLastError();
}

// a: (16, batch * 2^log_rows * 2^log_lanes), or (8, ..) with packed_in;
// out: (16, ..) or (8, ..) with packed_out, (batch, R, M) or with
// `transpose` (batch, M, R); tw: (16, tw_n); mul: null, or (16, mul_n) with
// mul_n 1 or R * M, multiplying the input. The tile follows from the shape: 2^(s1
// - s0) positions, then up to 8 consecutive rows for a transposed store,
// then lanes, then low positions, then batch items, to 2^kPassTileLog
// elements.
int zk_ntt_pass(const void* a, void* out, long long batch, int log_rows,
                int log_lanes, int s0, int s1, int bitrev, const void* tw,
                long long tw_n, const void* mul, long long mul_n,
                int transpose, int packed_in, int packed_out,
                void* stream) {
  const int log_t = s1 - s0;
  if (s0 < 0 || log_t < 0 || s1 > log_rows || log_t > kPassTileLog ||
      (bitrev && s0 != 0))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const int cap = kPassTileLog - log_t;
  PassTile tile;
  tile.log_t = log_t;
  const int keep_g = transpose ? std::min(std::min(s0, 3), cap) : 0;
  tile.log_m = std::min(log_lanes, cap - keep_g);
  tile.log_g = std::min(s0, cap - tile.log_m);
  int log_b = 0;
  while ((1LL << log_b) < batch) log_b++;
  tile.log_c = std::min(cap - tile.log_m - tile.log_g, log_b);
  const long long groups = (batch + (1LL << tile.log_c) - 1) >> tile.log_c;
  const long long blocks =
      groups << ((log_rows - s1) + (s0 - tile.log_g) + (log_lanes - tile.log_m));
  const int E = 1 << (tile.log_c + log_t + tile.log_g + tile.log_m);
  const int smem = 8 * (E + (E >> 5)) * (int)sizeof(uint32_t);
  constexpr int kMaxTile = 1 << kPassTileLog;
  cudaError_t err = cudaFuncSetAttribute(
      ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      8 * (kMaxTile + (kMaxTile >> 5)) * (int)sizeof(uint32_t));
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  ntt_pass_kernel<<<(unsigned)blocks, kPassThreads, smem, s>>>(
      static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out), batch,
      log_rows, log_lanes, s0, s1, tile, bitrev,
      static_cast<const uint32_t*>(tw), tw_n,
      static_cast<const uint32_t*>(mul), mul_n, transpose, packed_in,
      packed_out);
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

int zk_xyzz_add_pairs(const void* p, void* out, long long rows, long long m,
                      void* stream) {
  const long long total = rows * ((m + 1) / 2);
  if (total <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  xyzz_add_pairs_kernel<<<blocks_for(total, kPointThreads), kPointThreads, 0,
                          s>>>(static_cast<const uint32_t*>(p),
                               static_cast<uint32_t*>(out), rows, m);
  return (int)cudaGetLastError();
}

// pts: (npts, 24) packed affine points; idx, start, end, col: int32
int zk_bucket_acc(const void* pts, const void* idx, const void* start,
                  const void* end, const void* col, void* out,
                  long long out_n, long long chunks, void* stream) {
  if (chunks <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  bucket_acc_kernel<<<blocks_for(chunks, kPointThreads), kPointThreads, 0,
                      s>>>(
      static_cast<const uint32_t*>(pts), static_cast<const int*>(idx),
      static_cast<const int*>(start), static_cast<const int*>(end),
      static_cast<const int*>(col), static_cast<uint32_t*>(out), out_n,
      chunks);
  return (int)cudaGetLastError();
}

int zk_bucket_sum(const void* part, long long part_n, const void* start,
                  const void* end, const void* col, void* out,
                  long long out_n, long long chunks, void* stream) {
  if (chunks <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  bucket_sum_kernel<<<blocks_for(chunks, kPointThreads), kPointThreads, 0,
                      s>>>(
      static_cast<const uint32_t*>(part), part_n,
      static_cast<const int*>(start), static_cast<const int*>(end),
      static_cast<const int*>(col), static_cast<uint32_t*>(out), out_n,
      chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
