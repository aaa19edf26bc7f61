// FlashAttention forward and backward for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of the JAX package:
//   * hvd_flash_forward       <- horovod_tpu/ops/attention.py::_flash_kernel
//   * hvd_flash_backward_dq   <- horovod_tpu/ops/attention.py::_flash_bwd_dq_kernel
//   * hvd_flash_backward_dkdv <- horovod_tpu/ops/attention.py::_flash_bwd_dkdv_kernel
//
// What they compute (q, dO (B, Sq, H, D); k, v (B, Sk, Hkv, D), read in place;
// query head h reads K/V head h / (H / Hkv); lse and delta (B*H, Sq) f32):
//   forward: s = (q . k) * scale in f32, an online softmax over key tiles,
//            p rounded to V's dtype before P.V, out = acc / max(l, 1e-30) in
//            q's dtype, lse = m + log(max(l, 1e-30)) in natural-log units;
//   dq:      p = exp(s - lse), ds = p * (dO . v - delta), dq = scale * sum ds k
//            with ds rounded to K's dtype;
//   dkdv:    dv = sum p^T dO (p rounded to dO's dtype), dk = scale * sum ds^T q
//            (ds rounded to Q's dtype), summed in f32 over every query head of
//            the GQA group and every query tile, written once at Hkv width.
// Masking: key j is allowed for query row i when j < Sk, the key mask (if any)
// holds it, and, when causal, j <= i + (Sk - Sq) (the decode convention).
// Disallowed entries are zeroed explicitly, never left to exp(-1e30): a row
// with no allowed key gives zeros and lse = -1e30 + log(1e-30), and its
// gradients are zero. Any Sq and Sk work without padding. Key (or query)
// tiles wholly on the far side of the causal diagonal are skipped.
//
// What bounds them: at the training slice's shape (bf16, B=8, S=1024, H=16,
// Hkv=8, D=64, causal) the work is ~4, ~6 and ~8 * D operations per allowed
// (query, key) pair for forward, dq and dkdv: 17-34 GFLOP against ~50 MB of
// traffic, far above the H100's ~295 operations per byte, so the tensor
// cores' rate is the roofline.
//
// bfloat16 (the training path): all three kernels are built for that
// roofline. A block is a producer warpgroup and two or three consumer
// warpgroups. One producer thread issues TMA loads of whole tiles (4-D
// tensor maps over the (B, S, heads, D) layout, zero-filled past S) into a
// ring of shared-memory stages guarded by mbarriers, so loads overlap the
// math. Each consumer owns 64 rows and runs every product as wgmma (the only
// path to the full tensor-core rate): both operands from shared memory for
// the scores (S = Q K^T, and dP = dO V^T in dq), and the score fragment
// repacked to bf16 as the register A operand of the second product (P.V,
// dS.K, P^T.dO, dS^T.Q), B read MN-major. Accumulators live in registers
// the producer gave up (setmaxnreg). The softmax runs in one FFMA and one
// ex2 per score, log2(e) folded into the scale; masking runs only on the
// tiles that need it (a key mask, the diagonal, the ragged last key tile).
// Forward: 192 query rows per block at D = 64 (three consumers, which the
// exponentials need), 128 at D = 128, 128-key K/V tiles, the longest causal
// query tiles launched first. dq: 192 query rows per block at D = 64
// (three consumers), 128 at D = 128, Q and dO loaded once, 64-key K/V
// tiles (S, dP and dQ share the registers). dk/dv: 128 keys per block, 64-row
// Q/dO tiles with their lse and delta slices.
//
// float32 (parity, not the bf16 main path), and both types at head_dim 256:
// the FMA family, loops over float32 tiles in shared memory (no TF32, so
// float32 stays float32; bf16 is widened as it is loaded, p and ds rounded
// to bf16 before their products as the plain versions round them, and the
// outputs narrowed as they are written), with the scores and P in a
// per-warp scratch tile and the accumulators in shared memory. 64 rows per
// block at D = 64 and 128, 32 at D = 256, where 64 would not fit shared
// memory. A D = 256 wgmma design is later work: no configuration of the
// repo has that width, and these kernels close the operand range.
//
// The TPU kernels' tile sizes (512 / 1024, chosen for v5e VMEM) and their
// head-folding transposes have no counterpart here.
//
// Plain C interface, loaded with ctypes: every entry point returns
// cudaGetLastError() after its launch (0 = launched) or cudaErrorInvalidValue
// for a shape it does not take.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;    // horovod_tpu's NEG_INF

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// The FMA family's tile geometry: W warps, 16 rows each, so a block owns
// R = 16 W rows (4 warps at D = 64 and 128; 2 at D = 256, whose footprints
// at 64 rows would not fit the 227 KB a block may use: dq would need about
// 280 KB). Tiles hold float32 whatever the operands' type (bf16 is widened
// as it is loaded). Row pitches are padded by one element: the FMA loops
// read columns across lanes, and an odd pitch keeps them on distinct banks.
template <int D, int W>
struct Geo {
  static constexpr int R = 16 * W;     // rows a block owns
  static constexpr int NT = 32 * W;    // threads
  static constexpr int BN = 32;        // streamed tile rows
  static constexpr int LDT = D + 1;    // input tiles
  static constexpr int LDO = D + 1;    // accumulators
  static constexpr int LDS = BN + 1;   // per-warp scratch
  __host__ __device__ static constexpr size_t tile(int rows) {
    return align128((size_t)rows * LDT * sizeof(float));
  }
  __host__ __device__ static constexpr size_t acc() {
    return align128((size_t)R * LDO * sizeof(float));
  }
  __host__ __device__ static constexpr size_t warp_scratch() {
    return align128((size_t)16 * LDS * sizeof(float));
  }
  __host__ __device__ static constexpr size_t scratch() { return warp_scratch() * W; }
  __host__ __device__ static constexpr size_t vec(int n) {
    return align128((size_t)n * sizeof(float));
  }
  __host__ __device__ static constexpr size_t fwd_bytes() {
    return tile(R) + 2 * tile(BN) + acc() + scratch();
  }
  __host__ __device__ static constexpr size_t dq_bytes() {
    return 2 * tile(R) + 2 * tile(BN) + acc() + 2 * scratch() + 2 * vec(R);
  }
  __host__ __device__ static constexpr size_t dkdv_bytes() {
    return 2 * tile(R) + 2 * tile(BN) + 2 * acc() + 2 * scratch() + 2 * vec(BN);
  }
};
static_assert(Geo<256, 2>::dkdv_bytes() <= 232448 && Geo<256, 2>::dq_bytes() <= 232448,
              "D = 256 fits a block's shared memory at 32 rows");

// Operands in float32 or bfloat16, widened to float32 as they are read and
// narrowed as they are written.
__device__ __forceinline__ float ld_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void st_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void st_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// x rounded to T (p and ds are rounded to the operands' type before their
// products, as the plain versions round them).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Copy rows [row0, row0 + R) of head `head` of x (B, S, NH, D), batch b,
// into dst (R x ld) as float32, with NT threads; rows at or past S are zero.
template <int D, int R, int NT, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ x, int b,
                                          int S, int NH, int head, int row0) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D;
    const int c = i % D;
    const int s = row0 + r;
    dst[r * ld + c] = s < S ? ld_f(x + (((size_t)b * S + s) * NH + head) * D + c) : 0.f;
  }
}

// One warp, float32 FMA: C (16 x N, pitch ldc) = [C +] A (16 x K,
// row-major) * op(B), where op(B) is B (K x N, row-major) or, with BT, the
// transpose of B (N x K, row-major). Lane j owns columns j, j + 32, ...
template <int N, int K, bool BT>
__device__ __forceinline__ void warp_mm(const float* A, int lda, const float* B, int ldb,
                                        float* C, int ldc, bool accumulate) {
  constexpr int NJ = N / 32;
  const int lane = threadIdx.x & 31;
  float acc[16][NJ];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = accumulate ? C[r * ldc + lane + 32 * j] : 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float bv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = lane + 32 * j;
      bv[j] = BT ? B[n * ldb + k] : B[k * ldb + n];
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = A[r * lda + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] = fmaf(a, bv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) C[r * ldc + lane + 32 * j] = acc[r][j];
  }
}

// Key tiles of width `tile` that a block of query rows [q0, q0 + rows) must
// visit: all of them, or under causal those not wholly above the diagonal.
__device__ __forceinline__ int live_key_tiles(int q0, int rows, int tile, int sk, int off,
                                              int causal) {
  const int all = (sk + tile - 1) / tile;
  if (!causal) return all;
  const int last = q0 + rows - 1 + off;
  return last < 0 ? 0 : min(all, last / tile + 1);
}

template <typename T, int D, int W>
__global__ void __launch_bounds__(32 * W)
fma_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const uint8_t* __restrict__ mask,
               T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int h, int hkv,
               float scale, int causal) {
  using G = Geo<D, W>;
  constexpr int kRows = G::R;
  constexpr int kThreads = G::NT;
  constexpr int BN = G::BN;
  constexpr int NJ = BN / 32;
  extern __shared__ __align__(128) char smem[];
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRows;
  const int off = sk - sq;

  char* p = smem;
  float* sQ = reinterpret_cast<float*>(p);
  p += G::tile(kRows);
  float* sK = reinterpret_cast<float*>(p);
  p += G::tile(BN);
  float* sV = reinterpret_cast<float*>(p);
  p += G::tile(BN);
  float* sO = reinterpret_cast<float*>(p);
  p += G::acc();
  float* sS = reinterpret_cast<float*>(p + warp * G::warp_scratch());
  float* sP = reinterpret_cast<float*>(sS);

  load_rows<D, kRows, kThreads>(sQ, G::LDT, q, b, sq, h, head, q0);
  for (int i = threadIdx.x; i < kRows * G::LDO; i += kThreads) sO[i] = 0.f;
  __syncthreads();   // a block with no live key tile still reads sO
  const float* Qw = sQ + warp * 16 * G::LDT;
  float* Ow = sO + warp * 16 * G::LDO;

  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const int tiles = live_key_tiles(q0, kRows, BN, sk, off, causal);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();
    load_rows<D, BN, kThreads>(sK, G::LDT, k, b, sk, hkv, kvh, k0);
    load_rows<D, BN, kThreads>(sV, G::LDT, v, b, sk, hkv, kvh, k0);
    __syncthreads();
    warp_mm<BN, D, true>(Qw, G::LDT, sK, G::LDT, sS, G::LDS, false);
    __syncwarp();

    bool key_ok[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = k0 + lane + 32 * j;
      key_ok[j] = c < sk && (mask == nullptr || mask[(size_t)b * sk + c]);
    }
    float pr[16][NJ];
    float alpha[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = q0 + warp * 16 + r;
      float sv[NJ];
      bool ok[NJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = k0 + lane + 32 * j;
        ok[j] = key_ok[j] && (!causal || c <= row + off);
        sv[j] = ok[j] ? sS[r * G::LDS + lane + 32 * j] * scale : kNegInf;
        mx = fmaxf(mx, sv[j]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        pr[r][j] = ok[j] ? expf(sv[j] - m_new) : 0.f;
        sum += pr[r][j];
      }
      alpha[r] = expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + warp_sum(sum);
      m[r] = m_new;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) sP[r * G::LDS + lane + 32 * j] = round_to<T>(pr[r][j]);
#pragma unroll
      for (int c = lane; c < D; c += 32) Ow[r * G::LDO + c] *= alpha[r];
    }
    __syncwarp();
    warp_mm<D, BN, false>(sP, G::LDS, sV, G::LDT, Ow, G::LDO, true);
  }
  __syncwarp();

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = out + (((size_t)b * sq + row) * h + head) * D;
    for (int c = lane; c < D; c += 32) st_f(orow + c, Ow[r * G::LDO + c] / denom);
    if (lane == 0) lse[(size_t)bh * sq + row] = m[r] + logf(denom);
  }
}

template <typename T, int D, int W>
__global__ void __launch_bounds__(32 * W)
fma_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ mask,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk, int h,
              int hkv, float scale, int causal) {
  using G = Geo<D, W>;
  constexpr int kRows = G::R;
  constexpr int kThreads = G::NT;
  constexpr int BN = G::BN;
  constexpr int NJ = BN / 32;
  extern __shared__ __align__(128) char smem[];
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRows;
  const int off = sk - sq;

  char* p = smem;
  float* sQ = reinterpret_cast<float*>(p);
  p += G::tile(kRows);
  float* sdO = reinterpret_cast<float*>(p);
  p += G::tile(kRows);
  float* sK = reinterpret_cast<float*>(p);
  p += G::tile(BN);
  float* sV = reinterpret_cast<float*>(p);
  p += G::tile(BN);
  float* sdQ = reinterpret_cast<float*>(p);
  p += G::acc();
  float* sS = reinterpret_cast<float*>(p + warp * G::warp_scratch());
  p += G::scratch();
  float* sdP = reinterpret_cast<float*>(p + warp * G::warp_scratch());
  p += G::scratch();
  float* sL = reinterpret_cast<float*>(p);
  p += G::vec(kRows);
  float* sDelta = reinterpret_cast<float*>(p);
  float* sdS = reinterpret_cast<float*>(sS);

  load_rows<D, kRows, kThreads>(sQ, G::LDT, q, b, sq, h, head, q0);
  load_rows<D, kRows, kThreads>(sdO, G::LDT, dout, b, sq, h, head, q0);
  for (int i = threadIdx.x; i < kRows * G::LDO; i += kThreads) sdQ[i] = 0.f;
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const int row = q0 + i;
    sL[i] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    sDelta[i] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  __syncthreads();
  const float* Qw = sQ + warp * 16 * G::LDT;
  const float* dOw = sdO + warp * 16 * G::LDT;
  float* dQw = sdQ + warp * 16 * G::LDO;

  const int tiles = live_key_tiles(q0, kRows, BN, sk, off, causal);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();
    load_rows<D, BN, kThreads>(sK, G::LDT, k, b, sk, hkv, kvh, k0);
    load_rows<D, BN, kThreads>(sV, G::LDT, v, b, sk, hkv, kvh, k0);
    __syncthreads();
    warp_mm<BN, D, true>(Qw, G::LDT, sK, G::LDT, sS, G::LDS, false);
    warp_mm<BN, D, true>(dOw, G::LDT, sV, G::LDT, sdP, G::LDS, false);
    __syncwarp();

    bool key_ok[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = k0 + lane + 32 * j;
      key_ok[j] = c < sk && (mask == nullptr || mask[(size_t)b * sk + c]);
    }
    float ds[16][NJ];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = q0 + warp * 16 + r;
      const float lr = sL[warp * 16 + r];
      const float dr = sDelta[warp * 16 + r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = k0 + lane + 32 * j;
        const int e = r * G::LDS + lane + 32 * j;
        const bool ok = row < sq && key_ok[j] && (!causal || c <= row + off);
        const float pv = ok ? expf(sS[e] * scale - lr) : 0.f;
        ds[r][j] = pv * (sdP[e] - dr);
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) sdS[r * G::LDS + lane + 32 * j] = round_to<T>(ds[r][j]);
    }
    __syncwarp();
    warp_mm<D, BN, false>(sdS, G::LDS, sK, G::LDT, dQw, G::LDO, true);
  }
  __syncwarp();

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    if (row >= sq) continue;
    T* drow = dq + (((size_t)b * sq + row) * h + head) * D;
    for (int c = lane; c < D; c += 32) st_f(drow + c, dQw[r * G::LDO + c] * scale);
  }
}

template <typename T, int D, int W>
__global__ void __launch_bounds__(32 * W)
fma_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const uint8_t* __restrict__ mask,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                int sq, int sk, int h, int hkv, float scale, int causal) {
  using G = Geo<D, W>;
  constexpr int kRows = G::R;
  constexpr int kThreads = G::NT;
  constexpr int BN = G::BN;
  constexpr int NJ = BN / 32;
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.y / hkv;
  const int kvh = blockIdx.y % hkv;
  const int group = h / hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kRows;
  const int off = sk - sq;

  char* p = smem;
  float* sK = reinterpret_cast<float*>(p);
  p += G::tile(kRows);
  float* sV = reinterpret_cast<float*>(p);
  p += G::tile(kRows);
  float* sQ = reinterpret_cast<float*>(p);
  p += G::tile(BN);
  float* sdO = reinterpret_cast<float*>(p);
  p += G::tile(BN);
  float* sdK = reinterpret_cast<float*>(p);
  p += G::acc();
  float* sdV = reinterpret_cast<float*>(p);
  p += G::acc();
  float* sS = reinterpret_cast<float*>(p + warp * G::warp_scratch());
  p += G::scratch();
  float* sdP = reinterpret_cast<float*>(p + warp * G::warp_scratch());
  p += G::scratch();
  float* sL = reinterpret_cast<float*>(p);
  p += G::vec(BN);
  float* sDelta = reinterpret_cast<float*>(p);
  float* sPT = reinterpret_cast<float*>(sS);
  float* sdST = reinterpret_cast<float*>(sdP);

  load_rows<D, kRows, kThreads>(sK, G::LDT, k, b, sk, hkv, kvh, k0);
  load_rows<D, kRows, kThreads>(sV, G::LDT, v, b, sk, hkv, kvh, k0);
  for (int i = threadIdx.x; i < kRows * G::LDO; i += kThreads) {
    sdK[i] = 0.f;
    sdV[i] = 0.f;
  }
  __syncthreads();   // a block with no live query tile still reads sdK/sdV
  const float* Kw = sK + warp * 16 * G::LDT;
  const float* Vw = sV + warp * 16 * G::LDT;
  float* dKw = sdK + warp * 16 * G::LDO;
  float* dVw = sdV + warp * 16 * G::LDO;

  bool key_ok[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int kr = k0 + warp * 16 + r;
    key_ok[r] = kr < sk && (mask == nullptr || mask[(size_t)b * sk + kr]);
  }

  // Query tiles whose last row reaches this key tile's first key under
  // causal: qt * BN + BN - 1 + off >= k0.
  const int q_tiles = (sq + BN - 1) / BN;
  int qt_first = 0;
  if (causal) {
    const int need = k0 - off - BN + 1;
    qt_first = need <= 0 ? 0 : (need + BN - 1) / BN;
  }
  for (int g = 0; g < group; ++g) {
    const int head = kvh * group + g;
    const size_t bh = (size_t)b * h + head;
    for (int qt = qt_first; qt < q_tiles; ++qt) {
      const int q0 = qt * BN;
      __syncthreads();
      load_rows<D, BN, kThreads>(sQ, G::LDT, q, b, sq, h, head, q0);
      load_rows<D, BN, kThreads>(sdO, G::LDT, dout, b, sq, h, head, q0);
      for (int i = threadIdx.x; i < BN; i += kThreads) {
        const int row = q0 + i;
        sL[i] = row < sq ? lse[bh * sq + row] : 0.f;
        sDelta[i] = row < sq ? delta[bh * sq + row] : 0.f;
      }
      __syncthreads();
      warp_mm<BN, D, true>(Kw, G::LDT, sQ, G::LDT, sS, G::LDS, false);    // s^T
      warp_mm<BN, D, true>(Vw, G::LDT, sdO, G::LDT, sdP, G::LDS, false);  // dp^T
      __syncwarp();

      float pt[16][NJ], dst[16][NJ];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int kr = k0 + warp * 16 + r;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int qi = lane + 32 * j;
          const int row = q0 + qi;
          const int e = r * G::LDS + qi;
          const bool ok = key_ok[r] && row < sq && (!causal || kr <= row + off);
          pt[r][j] = ok ? expf(sS[e] * scale - sL[qi]) : 0.f;
          dst[r][j] = pt[r][j] * (sdP[e] - sDelta[qi]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          sPT[r * G::LDS + lane + 32 * j] = round_to<T>(pt[r][j]);
          sdST[r * G::LDS + lane + 32 * j] = round_to<T>(dst[r][j]);
        }
      }
      __syncwarp();
      warp_mm<D, BN, false>(sPT, G::LDS, sdO, G::LDT, dVw, G::LDO, true);
      warp_mm<D, BN, false>(sdST, G::LDS, sQ, G::LDT, dKw, G::LDO, true);
    }
  }
  __syncwarp();

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int kr = k0 + warp * 16 + r;
    if (kr >= sk) continue;
    const size_t base = (((size_t)b * sk + kr) * hkv + kvh) * D;
    for (int c = lane; c < D; c += 32) {
      st_f(dk + base + c, dKw[r * G::LDO + c] * scale);
      st_f(dv + base + c, dVw[r * G::LDO + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 forward, dq and dk/dv: TMA ring + wgmma, warp-specialised (Hopper)
//
// A block is two or three consumer warpgroups and one producer warpgroup
// after them. Each consumer owns 64 rows (queries in the forward and dq,
// keys in dk/dv) and runs the wgmma products and the elementwise work on them. The
// producer gives back its registers and one thread issues every TMA load
// into a ring of shared-memory stages, each guarded by a full / empty
// mbarrier pair; in dk/dv its first warp also stages the lse and delta
// slices beside each query tile. Tiles arrive as the 128-byte swizzle the
// wgmma descriptors read (sm90.cuh), from 4-D tensor maps over (B, S, heads,
// D): a box that runs past S is zero-filled.

constexpr int kProducerRegs = 24;

// Registers a consumer thread may take once the producer has given its own
// back: the block's share of the register file (65,536 / threads, rounded
// down to 8) less the producer's, spread over the consumers.
__host__ __device__ constexpr int consumer_regs(int wgs) {
  return ((65536 / (128 * (wgs + 1))) / 8 * 8 * (wgs + 1) - kProducerRegs) / wgs / 8 * 8;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (sm90::smem_u32(p) & 1023u)) & 1023u);
}

// Shared memory of the forward: the block's query rows, then the stages of
// 128-key K and V tiles, then the barriers. At D = 64 the softmax's
// exponentials weigh as much as the products, so three consumers share the
// tensor cores (192 query rows); at D = 128 the accumulators need two
// consumers' register budget (128 rows).
template <int D>
struct FwdTiles {
  static constexpr int kWgs = D == 64 ? 3 : 2;
  static constexpr int kThreads = 128 * (kWgs + 1);
  static constexpr int kRows = 64 * kWgs;
  static constexpr int kKeys = 128;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr uint32_t kQBytes = kRows * D * 2;
  static constexpr uint32_t kKVBytes = kKeys * D * 2;   // one K or V tile
  __host__ __device__ static constexpr uint32_t k(int s) { return kQBytes + 2 * s * kKVBytes; }
  __host__ __device__ static constexpr uint32_t v(int s) { return k(s) + kKVBytes; }
  static constexpr uint32_t kBarriers = kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kSmem = kBarriers + 8 * (1 + 2 * kStages) + 1024;   // + alignment
};

// S (64 rows x BN keys) = Q . K^T for one warpgroup: Q rows at `q_addr`
// (chunk pitch BM rows), the K tile at `k_addr`; both K-major.
template <int D, int BM, int BN>
__device__ __forceinline__ void issue_scores(float (&sc)[BN / 2], uint32_t q_addr,
                                             uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    sm90::wgmma_ss<BN>(sc, sm90::desc(q_addr + (kk / 4) * BM * 128 + col, 16, 1024),
                       sm90::desc(k_addr + (kk / 4) * BN * 128 + col, 16, 1024), kk > 0);
  }
}

// O (64 x D) += P (registers) . V, the V tile at `v_addr` read MN-major.
template <int D, int BN>
__device__ __forceinline__ void issue_values(float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                             uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    sm90::wgmma_rs<D>(o, pa[kk], sm90::desc(v_addr + kk * 16 * 128, BN * 128, 1024));
  }
}

// One tile of the online softmax, in place: the raw scores `sc` of keys k0 ..
// k0 + BN - 1 become p = exp2(s * scale_log2 - m) against the rows' new
// running max m (log2 units), one FFMA and one exp2 each; l gains this
// thread's share of their sum and `alpha` is the factor that rescales the
// rows' earlier sums. Masking runs only where some entry is disallowed: a
// key mask, the ragged last tile (its zero-filled keys), the tiles on the
// diagonal. Disallowed p are exactly 0.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale_log2, int k0,
                                               const uint8_t* __restrict__ mask, int b, int sk,
                                               int row_lo, int off, int causal, int r0) {
  const int lane = threadIdx.x % 32;
  // With c = |scale_log2| the max of s * c is c times the max of s; a
  // negative scale flips the scores first.
  if (scale_log2 < 0.f) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = -sc[i];
  }
  const float c = fabsf(scale_log2);
  if (mask != nullptr || k0 + BN > sk || (causal && k0 + BN - 1 > r0 + off)) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = k0 + 8 * j + 2 * (lane % 4) + cc;
        const bool key_ok = col < sk && (mask == nullptr || mask[(size_t)b * sk + col]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!key_ok || (causal && col > row_lo + 8 * i + off)) {
            sc[4 * j + 2 * i + cc] = -INFINITY;
          }
        }
      }
    }
  }
  float mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m[i], mx * c);
    mu[i] = mx == -INFINITY ? 0.f : mx;   // no allowed key yet: every p is 0
    alpha[i] = sm90::exp2_ftz(m[i] - mu[i]);
    m[i] = mx;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // Disallowed entries: exp2(-inf) = 0.
      sc[4 * j + e] = sm90::exp2_ftz(fmaf(sc[4 * j + e], c, -mu[e / 2]));
      sum[e / 2] += sc[4 * j + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
}

// One block per (b * h, 64 * kWgs query rows), the last query tiles first: under
// causal they have the most key tiles, so the grid's tail is the short ones.
template <int D>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, 1)
bf16_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                    int h, int hkv, float scale_log2, int causal) {
  using T = FwdTiles<D>;
  constexpr int BM = T::kRows;
  constexpr int BN = T::kKeys;
  constexpr int S = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kBarriers);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int off = sk - sq;
  const int tiles = live_key_tiles(q0, BM, BN, sk, off, causal);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::tma_prefetch(&tq);
    sm90::tma_prefetch(&tk);
    sm90::tma_prefetch(&tv);
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128 * T::kWgs);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == T::kWgs) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * T::kWgs) {
      sm90::mbar_arrive_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(smem + c * BM * 128, &tq, q_full, 64 * c, head, q0, b);
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % S;
        sm90::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * T::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load_4d(smem + T::k(s) + c * BN * 128, &tk, &full[s], 64 * c, kvh, t * BN, b);
          sm90::tma_load_4d(smem + T::v(s) + c * BN * 128, &tv, &full[s], 64 * c, kvh, t * BN, b);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<consumer_regs(T::kWgs)>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r0 = q0 + 64 * wg;                          // this warpgroup's first row
    const int row_lo = r0 + 16 * (tid / 32) + lane / 4;   // this thread's rows: +0, +8
    const uint32_t base = sm90::smem_u32(smem);
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
    float l[2] = {0.f, 0.f};               // this thread's share of the row sums

    const uint32_t q_addr = base + wg * 64 * 128;
    sm90::mbar_wait(q_full, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % S;
      const int k0 = t * BN;
      sm90::mbar_wait(&full[s], (t / S) & 1);
      // A tile wholly above this warpgroup's diagonal adds nothing.
      if (!causal || k0 <= r0 + 63 + off) {
        float sc[BN / 2], alpha[2];
        sm90::wgmma_fence();
        issue_scores<D, BM, BN>(sc, q_addr, base + T::k(s));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        online_softmax<BN>(sc, m, l, alpha, scale_log2, k0, mask, b, sk, row_lo, off, causal, r0);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
        }
        uint32_t pa[BN / 16][4];
        sm90::pack_a<BN>(pa, sc);
        sm90::wgmma_fence();
        issue_values<D, BN>(o, pa, base + T::v(s));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
      }
      sm90::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = row_lo + 8 * i;
      if (row >= sq) continue;
      const bool dead = l[i] == 0.f;   // no allowed key: zeros, lse = -1e30 + log(1e-30)
      const float inv = dead ? 0.f : 1.f / l[i];
      __nv_bfloat16* dst = out + (((size_t)b * sq + row) * h + head) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
      if (lane % 4 == 0) {
        lse[(size_t)bh * sq + row] = dead ? kNegInf + logf(1e-30f) : m[i] * kLn2 + logf(l[i]);
      }
    }
  }
}

// Shared memory of dk/dv: the block's 128 K and V rows, then the stages of
// 64-row Q and dO tiles with their lse (times log2 e) and delta slices, then
// the barriers.
template <int D>
struct DkdvTiles {
  static constexpr int kWgs = 2;
  static constexpr int kThreads = 128 * (kWgs + 1);
  static constexpr int kKeys = 64 * kWgs;
  static constexpr int kRows = 64;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr uint32_t kKVBytes = kKeys * D * 2;      // K or V
  static constexpr uint32_t kQBytes = kRows * D * 2;       // one Q or dO tile
  static constexpr uint32_t kStageBytes = 2 * kQBytes + 1024;
  __host__ __device__ static constexpr uint32_t stage(int s) {
    return 2 * kKVBytes + s * kStageBytes;
  }
  static constexpr uint32_t kBarriers = 2 * kKVBytes + kStages * kStageBytes;
  static constexpr size_t kSmem = kBarriers + 8 * (1 + 2 * kStages) + 1024;
};

// One block per (b, kv head, 128 keys), sweeping every query head of the
// group and every query tile that reaches its keys, in a fixed order: dk and
// dv are summed in wgmma accumulators and written once, no atomics.
template <int D>
__global__ void __launch_bounds__(DkdvTiles<D>::kThreads, 1)
bf16_dkdv_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const uint8_t* __restrict__ mask,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq,
                     int sk, int h, int hkv, float scale, int causal) {
  using T = DkdvTiles<D>;
  constexpr int BN = T::kKeys;
  constexpr int BM = T::kRows;
  constexpr int S = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + T::kBarriers);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int b = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  const int group = h / hkv;
  const int k0 = blockIdx.y * BN;
  const int off = sk - sq;
  // Query tiles whose last row reaches this block's first key under causal.
  const int q_tiles = (sq + BM - 1) / BM;
  int qt_first = 0;
  if (causal) {
    const int need = k0 - off - BM + 1;
    qt_first = need <= 0 ? 0 : min(q_tiles, (need + BM - 1) / BM);
  }
  const int per_head = q_tiles - qt_first;
  const int iters = group * per_head;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::tma_prefetch(&tq);
    sm90::tma_prefetch(&tk);
    sm90::tma_prefetch(&tv);
    sm90::tma_prefetch(&tdo);
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 32);
      sm90::mbar_init(&empty[s], 128 * T::kWgs);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == T::kWgs) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == 4 * T::kWgs) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_full, 2 * T::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load_4d(smem + c * BN * 128, &tk, kv_full, 64 * c, kvh, k0, b);
          sm90::tma_load_4d(smem + T::kKVBytes + c * BN * 128, &tv, kv_full, 64 * c, kvh, k0, b);
        }
      }
      for (int it = 0; it < iters; ++it) {
        const int s = it % S;
        const int head = kvh * group + it / per_head;
        const int q0 = (qt_first + it % per_head) * BM;
        uint8_t* stage = smem + T::stage(s);
        float* s_lse = reinterpret_cast<float*>(stage + 2 * T::kQBytes);
        sm90::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        // Rows past Sq get lse = +inf (p = 0) and delta = 0.
        const size_t row0 = ((size_t)b * h + head) * sq;
        for (int i = lane; i < BM; i += 32) {
          const bool in = q0 + i < sq;
          s_lse[i] = in ? lse[row0 + q0 + i] * kLog2e : INFINITY;
          s_lse[BM + i] = in ? delta[row0 + q0 + i] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[s], 2 * T::kQBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            sm90::tma_load_4d(stage + c * BM * 128, &tq, &full[s], 64 * c, head, q0, b);
            sm90::tma_load_4d(stage + T::kQBytes + c * BM * 128, &tdo, &full[s], 64 * c, head,
                              q0, b);
          }
        } else {
          sm90::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<consumer_regs(T::kWgs)>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int kw = k0 + 64 * wg;                          // this warpgroup's first key
    const int key_lo = kw + 16 * (tid / 32) + lane / 4;   // this thread's keys: +0, +8
    const float scale_log2 = scale * kLog2e;
    const uint32_t base = sm90::smem_u32(smem);
    const uint32_t k_addr = base + wg * 64 * 128;
    const uint32_t v_addr = k_addr + T::kKVBytes;
    bool key_ok[2] = {true, true};
    if (mask != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        key_ok[i] = key_lo + 8 * i < sk && mask[(size_t)b * sk + key_lo + 8 * i];
      }
    }
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    for (int it = 0; it < iters; ++it) {
      const int s = it % S;
      const int q0 = (qt_first + it % per_head) * BM;
      sm90::mbar_wait(&full[s], (it / S) & 1);
      // A query tile whose every row lies before this warpgroup's first key
      // (under causal) adds nothing.
      if (!causal || kw <= q0 + BM - 1 + off) {
        const uint32_t q_addr = base + T::stage(s);
        const uint32_t do_addr = q_addr + T::kQBytes;
        const float* s_lse = reinterpret_cast<const float*>(smem + T::stage(s) + 2 * T::kQBytes);
        const float* s_delta = s_lse + BM;
        float st[BM / 2], dpt[BM / 2];   // s^T and dp^T: keys x queries
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk / 4) * BN * 128 + (kk % 4) * 32;
          const uint32_t qcol = (kk / 4) * BM * 128 + (kk % 4) * 32;
          sm90::wgmma_ss<BM>(st, sm90::desc(k_addr + col, 16, 1024),
                             sm90::desc(q_addr + qcol, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk / 4) * BN * 128 + (kk % 4) * 32;
          const uint32_t qcol = (kk / 4) * BM * 128 + (kk % 4) * 32;
          sm90::wgmma_ss<BM>(dpt, sm90::desc(v_addr + col, 16, 1024),
                             sm90::desc(do_addr + qcol, 16, 1024), kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);

        const bool masked = mask != nullptr || (causal && kw + 63 > q0 + off);
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qi = 8 * j + 2 * (lane % 4) + c;
            const float lse_l2 = s_lse[qi];
            const float dl = s_delta[qi];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 4 * j + 2 * i + c;
              float p = sm90::exp2_ftz(fmaf(st[e], scale_log2, -lse_l2));
              if (masked) {
                const bool ok = key_ok[i] && (!causal || key_lo + 8 * i <= q0 + qi + off);
                p = ok ? p : 0.f;
              }
              dpt[e] = p * (dpt[e] - dl);
              st[e] = p;
            }
          }
        }
        uint32_t pa[BM / 16][4], da[BM / 16][4];
        sm90::pack_a<BM>(pa, st);
        sm90::pack_a<BM>(da, dpt);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          sm90::wgmma_rs<D>(acc_v, pa[kk], sm90::desc(do_addr + kk * 16 * 128, BM * 128, 1024));
        }
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          sm90::wgmma_rs<D>(acc_k, da[kk], sm90::desc(q_addr + kk * 16 * 128, BM * 128, 1024));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc_k);
        sm90::fence_regs(acc_v);
      }
      sm90::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key_lo + 8 * i;
      if (key >= sk) continue;
      const size_t at = (((size_t)b * sk + key) * hkv + kvh) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) = __floats2bfloat162_rn(
            acc_k[4 * j + 2 * i] * scale, acc_k[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
            __floats2bfloat162_rn(acc_v[4 * j + 2 * i], acc_v[4 * j + 2 * i + 1]);
      }
    }
  }
}

// Shared memory of dq: the block's Q and dO rows, then the stages of K and V
// tiles, then the barriers. Each consumer owns 64 query rows. S, dP (BN / 2
// registers each) and the dQ accumulator (D / 2) live together, so the key
// tile is 64: at D = 64 three consumers share the tensor cores (their
// exponentials overlap the others' products) inside setmaxnreg's 160; at
// D = 128 two, inside 240.
template <int D>
struct DqTiles {
  static constexpr int kWgs = D == 64 ? 3 : 2;
  static constexpr int kThreads = 128 * (kWgs + 1);
  static constexpr int kRows = 64 * kWgs;
  static constexpr int kKeys = 64;
  static constexpr int kStages = 4;
  static constexpr uint32_t kQBytes = kRows * D * 2;    // Q or dO
  static constexpr uint32_t kKVBytes = kKeys * D * 2;   // one K or V tile
  __host__ __device__ static constexpr uint32_t k(int s) {
    return 2 * kQBytes + 2 * s * kKVBytes;
  }
  __host__ __device__ static constexpr uint32_t v(int s) { return k(s) + kKVBytes; }
  static constexpr uint32_t kBarriers = 2 * kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kSmem = kBarriers + 8 * (1 + 2 * kStages) + 1024;
};

// One block per (b * h, 64 * kWgs query rows), the last query tiles first,
// as in the forward. The producer loads the block's Q and dO once and streams the
// live K/V tiles; each consumer, per tile: S = Q K^T and dP = dO V^T by
// wgmma, p = exp2(S * scale * log2 e - lse * log2 e) (one FFMA and one
// ex2), dS = p (dP - delta), then dQ += dS K with dS as the register A
// operand and K read MN-major. Masking runs only on the tiles that need it
// (the forward's test), as a select: a row with no allowed key has lse =
// -1e30 + log(1e-30), so its p is +inf before the select.
template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
bf16_dq_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const uint8_t* __restrict__ mask,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int sq, int sk, int h, int hkv, float scale,
                   int causal) {
  using T = DqTiles<D>;
  constexpr int BM = T::kRows;
  constexpr int BN = T::kKeys;
  constexpr int S = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kBarriers);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int off = sk - sq;
  const int tiles = live_key_tiles(q0, BM, BN, sk, off, causal);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::tma_prefetch(&tq);
    sm90::tma_prefetch(&tk);
    sm90::tma_prefetch(&tv);
    sm90::tma_prefetch(&tdo);
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128 * T::kWgs);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == T::kWgs) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * T::kWgs) {
      sm90::mbar_arrive_expect_tx(q_full, 2 * T::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(smem + c * BM * 128, &tq, q_full, 64 * c, head, q0, b);
        sm90::tma_load_4d(smem + T::kQBytes + c * BM * 128, &tdo, q_full, 64 * c, head, q0, b);
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % S;
        sm90::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * T::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load_4d(smem + T::k(s) + c * BN * 128, &tk, &full[s], 64 * c, kvh, t * BN, b);
          sm90::tma_load_4d(smem + T::v(s) + c * BN * 128, &tv, &full[s], 64 * c, kvh, t * BN, b);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<consumer_regs(T::kWgs)>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r0 = q0 + 64 * wg;                          // this warpgroup's first row
    const int row_lo = r0 + 16 * (tid / 32) + lane / 4;   // this thread's rows: +0, +8
    const float scale_log2 = scale * kLog2e;
    // Rows past Sq take lse = +inf (p = 0) and delta = 0, so their dS is 0.
    float lse_l2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      const bool in = row < sq;
      lse_l2[i] = in ? lse[(size_t)bh * sq + row] * kLog2e : INFINITY;
      dl[i] = in ? delta[(size_t)bh * sq + row] : 0.f;
    }
    const uint32_t base = sm90::smem_u32(smem);
    const uint32_t q_addr = base + wg * 64 * 128;
    const uint32_t do_addr = q_addr + T::kQBytes;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    sm90::mbar_wait(q_full, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % S;
      const int k0 = t * BN;
      sm90::mbar_wait(&full[s], (t / S) & 1);
      // A tile wholly above this warpgroup's diagonal adds nothing.
      if (!causal || k0 <= r0 + 63 + off) {
        const uint32_t k_addr = base + T::k(s);
        float sc[BN / 2], dp[BN / 2];
        sm90::wgmma_fence();
        issue_scores<D, BM, BN>(sc, q_addr, k_addr);
        issue_scores<D, BM, BN>(dp, do_addr, base + T::v(s));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        sm90::fence_regs(dp);
        // Some entry is disallowed: a key mask, the ragged last tile (its
        // zero-filled keys), the tiles on the diagonal.
        const bool masked =
            mask != nullptr || k0 + BN > sk || (causal && k0 + BN - 1 > r0 + off);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = k0 + 8 * j + 2 * (lane % 4) + cc;
            const bool key_ok =
                !masked || (col < sk && (mask == nullptr || mask[(size_t)b * sk + col]));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 4 * j + 2 * i + cc;
              float p = sm90::exp2_ftz(fmaf(sc[e], scale_log2, -lse_l2[i]));
              if (masked) p = key_ok && (!causal || col <= row_lo + 8 * i + off) ? p : 0.f;
              sc[e] = p * (dp[e] - dl[i]);
            }
          }
        }
        uint32_t da[BN / 16][4];
        sm90::pack_a<BN>(da, sc);
        sm90::wgmma_fence();
        issue_values<D, BN>(acc, da, k_addr);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
      }
      sm90::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      if (row >= sq) continue;
      __nv_bfloat16* dst = dq + (((size_t)b * sq + row) * h + head) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;      // out, dq or dk
  void* out1;      // dv
  float* lse_out;
  int b, sq, sk, h, hkv, causal;
  float scale;
};

enum Kind { kForward, kDq, kDkdv };

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The FMA family: float32 at D = 64 and 128 (4 warps), and both types at
// D = 256 (2 warps).
template <typename T, int D, int W>
cudaError_t launch_fma(Kind kind, const Args& a, cudaStream_t stream) {
  using G = Geo<D, W>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (kind == kForward) {
    const size_t bytes = G::fwd_bytes();
    if ((err = prepare(fma_fwd_kernel<T, D, W>, bytes)) != cudaSuccess) return err;
    const dim3 grid((a.sq + G::R - 1) / G::R, a.b * a.h);
    fma_fwd_kernel<T, D, W><<<grid, G::NT, bytes, stream>>>(
        q, k, v, a.mask, static_cast<T*>(a.out0), a.lse_out, a.sq, a.sk, a.h, a.hkv, a.scale,
        a.causal);
  } else if (kind == kDq) {
    const size_t bytes = G::dq_bytes();
    if ((err = prepare(fma_dq_kernel<T, D, W>, bytes)) != cudaSuccess) return err;
    const dim3 grid((a.sq + G::R - 1) / G::R, a.b * a.h);
    fma_dq_kernel<T, D, W><<<grid, G::NT, bytes, stream>>>(
        q, k, v, a.mask, dout, a.lse_in, a.delta, static_cast<T*>(a.out0), a.sq, a.sk, a.h,
        a.hkv, a.scale, a.causal);
  } else {
    const size_t bytes = G::dkdv_bytes();
    if ((err = prepare(fma_dkdv_kernel<T, D, W>, bytes)) != cudaSuccess) return err;
    const dim3 grid((a.sk + G::R - 1) / G::R, a.b * a.hkv);
    fma_dkdv_kernel<T, D, W><<<grid, G::NT, bytes, stream>>>(
        q, k, v, a.mask, dout, a.lse_in, a.delta, static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.sq, a.sk, a.h, a.hkv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time (no -lcuda link).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D tensor map over x (B, S, NH, D) bf16, innermost first (D, NH, S, B),
// whose boxes are 64 columns x 1 head x `rows` rows x 1 sequence with the
// 128-byte swizzle. A box that runs past S arrives zero-filled: it never reads
// the next sequence's rows.
bool rows_map(CUtensorMap* map, const void* x, int b, int s, int nh, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)nh, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)nh * d * 2,
                                 (cuuint64_t)s * nh * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(Kind kind, const Args& a, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (kind == kForward) {
    using T = FwdTiles<D>;
    const dim3 grid(a.b * a.h, (a.sq + T::kRows - 1) / T::kRows);
    CUtensorMap tq, tk, tv;
    if (grid.y > 65535 || !rows_map(&tq, a.q, a.b, a.sq, a.h, D, T::kRows) ||
        !rows_map(&tk, a.k, a.b, a.sk, a.hkv, D, T::kKeys) ||
        !rows_map(&tv, a.v, a.b, a.sk, a.hkv, D, T::kKeys)) {
      return cudaErrorInvalidValue;
    }
    if ((err = prepare(bf16_fwd_tma_kernel<D>, T::kSmem)) != cudaSuccess) return err;
    bf16_fwd_tma_kernel<D><<<grid, T::kThreads, T::kSmem, stream>>>(
        tq, tk, tv, a.mask, static_cast<bf16*>(a.out0), a.lse_out, a.sq, a.sk, a.h, a.hkv,
        a.scale * kLog2e, a.causal);
  } else if (kind == kDq) {
    using T = DqTiles<D>;
    const dim3 grid(a.b * a.h, (a.sq + T::kRows - 1) / T::kRows);
    CUtensorMap tq, tk, tv, tdo;
    if (grid.y > 65535 || !rows_map(&tq, a.q, a.b, a.sq, a.h, D, T::kRows) ||
        !rows_map(&tdo, a.dout, a.b, a.sq, a.h, D, T::kRows) ||
        !rows_map(&tk, a.k, a.b, a.sk, a.hkv, D, T::kKeys) ||
        !rows_map(&tv, a.v, a.b, a.sk, a.hkv, D, T::kKeys)) {
      return cudaErrorInvalidValue;
    }
    if ((err = prepare(bf16_dq_tma_kernel<D>, T::kSmem)) != cudaSuccess) return err;
    bf16_dq_tma_kernel<D><<<grid, T::kThreads, T::kSmem, stream>>>(
        tq, tk, tv, tdo, a.mask, a.lse_in, a.delta, static_cast<bf16*>(a.out0), a.sq, a.sk,
        a.h, a.hkv, a.scale, a.causal);
  } else {
    using T = DkdvTiles<D>;
    const dim3 grid(a.b * a.hkv, (a.sk + T::kKeys - 1) / T::kKeys);
    CUtensorMap tq, tk, tv, tdo;
    if (grid.y > 65535 || !rows_map(&tq, a.q, a.b, a.sq, a.h, D, T::kRows) ||
        !rows_map(&tdo, a.dout, a.b, a.sq, a.h, D, T::kRows) ||
        !rows_map(&tk, a.k, a.b, a.sk, a.hkv, D, T::kKeys) ||
        !rows_map(&tv, a.v, a.b, a.sk, a.hkv, D, T::kKeys)) {
      return cudaErrorInvalidValue;
    }
    if ((err = prepare(bf16_dkdv_tma_kernel<D>, T::kSmem)) != cudaSuccess) return err;
    bf16_dkdv_tma_kernel<D><<<grid, T::kThreads, T::kSmem, stream>>>(
        tq, tk, tv, tdo, a.mask, a.lse_in, a.delta, static_cast<bf16*>(a.out0),
        static_cast<bf16*>(a.out1), a.sq, a.sk, a.h, a.hkv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; d in {64, 128, 256}; any H / Hkv:
// every kernel reads a query head's K/V head as head / (H / Hkv), and dk/dv
// loop over the group at run time.
cudaError_t dispatch(Kind kind, int dtype, int d, const Args& a, cudaStream_t stream) {
  if (a.b <= 0 || a.sq <= 0 || a.sk <= 0 || a.hkv <= 0 || a.h % a.hkv) {
    return cudaErrorInvalidValue;
  }
  if (a.b * (kind == kDkdv ? a.hkv : a.h) > 65535) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d == 64) return launch_fma<float, 64, 4>(kind, a, stream);
    if (d == 128) return launch_fma<float, 128, 4>(kind, a, stream);
    if (d == 256) return launch_fma<float, 256, 2>(kind, a, stream);
  } else if (dtype == 1) {
    if (d == 64) return launch_bf16<64>(kind, a, stream);
    if (d == 128) return launch_bf16<128>(kind, a, stream);
    if (d == 256) return launch_fma<__nv_bfloat16, 256, 2>(kind, a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* hvd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mask: (B, Sk) uint8, or null for no key mask. lse: (B*H, Sq) f32, written.
extern "C" int hvd_flash_forward(const void* q, const void* k, const void* v, const void* mask,
                                 void* out, void* lse, int b, int sq, int sk, int h, int hkv,
                                 int d, float scale, int causal, int dtype, void* stream) {
  Args a{q,       k,      v,  static_cast<const uint8_t*>(mask), nullptr, nullptr, nullptr,
         out,     nullptr, static_cast<float*>(lse), b, sq, sk, h, hkv, causal, scale};
  return static_cast<int>(dispatch(kForward, dtype, d, a, static_cast<cudaStream_t>(stream)));
}

// lse, delta: (B*H, Sq) f32, delta = rowsum(dO * O) - dlse.
extern "C" int hvd_flash_backward_dq(const void* q, const void* k, const void* v,
                                     const void* mask, const void* dout, const void* lse,
                                     const void* delta, void* dq, int b, int sq, int sk, int h,
                                     int hkv, int d, float scale, int causal, int dtype,
                                     void* stream) {
  Args a{q,  k,       v,       static_cast<const uint8_t*>(mask), dout,
         static_cast<const float*>(lse), static_cast<const float*>(delta), dq, nullptr, nullptr,
         b,  sq,      sk,      h,  hkv, causal, scale};
  return static_cast<int>(dispatch(kDq, dtype, d, a, static_cast<cudaStream_t>(stream)));
}

extern "C" int hvd_flash_backward_dkdv(const void* q, const void* k, const void* v,
                                       const void* mask, const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int b, int sq,
                                       int sk, int h, int hkv, int d, float scale, int causal,
                                       int dtype, void* stream) {
  Args a{q,  k,  v,  static_cast<const uint8_t*>(mask), dout,
         static_cast<const float*>(lse), static_cast<const float*>(delta), dk, dv, nullptr,
         b,  sq, sk, h, hkv, causal, scale};
  return static_cast<int>(dispatch(kDkdv, dtype, d, a, static_cast<cudaStream_t>(stream)));
}
