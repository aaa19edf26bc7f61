// FlashAttention-2 forward and backward for Hopper (sm_90a).
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
//            q's dtype, lse = m + log(max(l, 1e-30));
//   dq:      p = exp(s - lse), ds = p * (dO . v - delta), dq = scale * sum ds k
//            with ds rounded to K's dtype;
//   dkdv:    dv = sum p^T dO (p rounded to dO's dtype), dk = scale * sum ds^T q
//            (ds rounded to Q's dtype), summed in f32 over every query head of
//            the GQA group and every query tile, written once at Hkv width.
// Masking: key j is allowed for query row i when j < Sk, the key mask (if any)
// holds it, and, when causal, j <= i + (Sk - Sq) (the decode convention).
// Disallowed entries are zeroed explicitly, never left to exp(-1e30): a row
// with no allowed key gives zeros and lse = -1e30 + log(1e-30), and its
// gradients are zero. Rows and keys past Sq / Sk are bounds-checked, so any
// length works without padding. Key tiles wholly above the causal diagonal
// are skipped.
//
// What bounds them: at the training slice's shape (bf16, B=8, S=1024, H=16,
// Hkv=8, D=64, causal) the work is ~4, ~6 and ~8 * D operations per allowed
// (query, key) pair for forward, dq and dkdv: 17-34 GFLOP against ~50 MB of
// traffic, far above the H100's ~295 operations per byte, so the tensor
// cores' rate is the roofline.
//
// Design (simple first): a block of four warps owns 64 rows (queries for
// the forward and dq, keys for dkdv), 16 per warp, and streams tiles of the
// other operand through shared memory. Every product a warp needs reads only
// its own 16 rows and the shared tile, so between two tile loads a warp runs
// alone: scores, the softmax or gradient elementwise pass, then the second
// product. Two paths:
//   * bfloat16: mma.sync m16n8k16 on the tensor cores, FA-2 style. Scores
//     and accumulators stay in registers; the score fragments are repacked
//     as the A operand of the second product (P.V, dS.K, P^T.dO, dS^T.Q), so
//     P and dS never touch shared memory. Operands load with ldmatrix.
//   * float32: FMA loops over shared memory (no TF32, so float32 stays
//     float32), with the scores and P in a per-warp scratch tile and the
//     accumulators in shared memory.
// The TPU kernels' tile sizes (512 / 1024, chosen for v5e VMEM) and their
// head-folding transposes have no counterpart here. Not yet done: cp.async /
// TMA pipelining of the tile loads, wgmma, and a persistent grid.
//
// Plain C interface, loaded with ctypes: every entry point returns
// cudaGetLastError() after its launch (0 = launched) or cudaErrorInvalidValue
// for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;   // rows a block owns, 16 per warp
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

// float32 tile geometry. Row pitches are padded by one element: the FMA
// loops read columns across lanes, and an odd pitch keeps them on distinct
// banks.
template <int D>
struct Geo {
  static constexpr int BN = 32;        // streamed tile rows
  static constexpr int LDT = D + 1;    // input tiles
  static constexpr int LDO = D + 1;    // accumulators
  static constexpr int LDS = BN + 1;   // per-warp scratch
  __host__ __device__ static constexpr size_t tile(int rows) {
    return align128((size_t)rows * LDT * sizeof(float));
  }
  __host__ __device__ static constexpr size_t acc() {
    return align128((size_t)kRows * LDO * sizeof(float));
  }
  __host__ __device__ static constexpr size_t warp_scratch() {
    return align128((size_t)16 * LDS * sizeof(float));
  }
  __host__ __device__ static constexpr size_t scratch() { return warp_scratch() * kWarps; }
  __host__ __device__ static constexpr size_t vec(int n) {
    return align128((size_t)n * sizeof(float));
  }
  __host__ __device__ static constexpr size_t fwd_bytes() {
    return tile(kRows) + 2 * tile(BN) + acc() + scratch();
  }
  __host__ __device__ static constexpr size_t dq_bytes() {
    return 2 * tile(kRows) + 2 * tile(BN) + acc() + 2 * scratch() + 2 * vec(kRows);
  }
  __host__ __device__ static constexpr size_t dkdv_bytes() {
    return 2 * tile(kRows) + 2 * tile(BN) + 2 * acc() + 2 * scratch() + 2 * vec(BN);
  }
};

// Copy rows [row0, row0 + R) of head `head` of x (B, S, NH, D), batch b,
// into dst (R x ld); rows at or past S are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* __restrict__ x, int b, int S,
                                          int NH, int head, int row0) {
  if constexpr (sizeof(T) == 2) {
    constexpr int VEC = 8;
    constexpr int PER = D / VEC;
    for (int i = threadIdx.x; i < R * PER; i += kThreads) {
      const int r = i / PER;
      const int c = (i % PER) * VEC;
      const int s = row0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (s < S) {
        val = __ldg(reinterpret_cast<const uint4*>(x + (((size_t)b * S + s) * NH + head) * D + c));
      }
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < R * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      const int s = row0 + r;
      dst[r * ld + c] = s < S ? __ldg(x + (((size_t)b * S + s) * NH + head) * D + c) : 0.f;
    }
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

template <int D>
__global__ void __launch_bounds__(kThreads)
f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ mask,
               float* __restrict__ out, float* __restrict__ lse, int sq, int sk, int h, int hkv,
               float scale, int causal) {
  using G = Geo<D>;
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

  load_rows<float, D, kRows>(sQ, G::LDT, q, b, sq, h, head, q0);
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
    load_rows<float, D, BN>(sK, G::LDT, k, b, sk, hkv, kvh, k0);
    load_rows<float, D, BN>(sV, G::LDT, v, b, sk, hkv, kvh, k0);
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
      for (int j = 0; j < NJ; ++j) sP[r * G::LDS + lane + 32 * j] = pr[r][j];
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
    float* orow = out + (((size_t)b * sq + row) * h + head) * D;
    for (int c = lane; c < D; c += 32) orow[c] = (Ow[r * G::LDO + c] / denom);
    if (lane == 0) lse[(size_t)bh * sq + row] = m[r] + logf(denom);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ mask,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, int sq, int sk, int h,
              int hkv, float scale, int causal) {
  using G = Geo<D>;
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

  load_rows<float, D, kRows>(sQ, G::LDT, q, b, sq, h, head, q0);
  load_rows<float, D, kRows>(sdO, G::LDT, dout, b, sq, h, head, q0);
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
    load_rows<float, D, BN>(sK, G::LDT, k, b, sk, hkv, kvh, k0);
    load_rows<float, D, BN>(sV, G::LDT, v, b, sk, hkv, kvh, k0);
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
      for (int j = 0; j < NJ; ++j) sdS[r * G::LDS + lane + 32 * j] = ds[r][j];
    }
    __syncwarp();
    warp_mm<D, BN, false>(sdS, G::LDS, sK, G::LDT, dQw, G::LDO, true);
  }
  __syncwarp();

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    if (row >= sq) continue;
    float* drow = dq + (((size_t)b * sq + row) * h + head) * D;
    for (int c = lane; c < D; c += 32) drow[c] = (dQw[r * G::LDO + c] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
f32_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                int sq, int sk, int h, int hkv, float scale, int causal) {
  using G = Geo<D>;
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

  load_rows<float, D, kRows>(sK, G::LDT, k, b, sk, hkv, kvh, k0);
  load_rows<float, D, kRows>(sV, G::LDT, v, b, sk, hkv, kvh, k0);
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
      load_rows<float, D, BN>(sQ, G::LDT, q, b, sq, h, head, q0);
      load_rows<float, D, BN>(sdO, G::LDT, dout, b, sq, h, head, q0);
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
          sPT[r * G::LDS + lane + 32 * j] = pt[r][j];
          sdST[r * G::LDS + lane + 32 * j] = dst[r][j];
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
      dk[base + c] = (dKw[r * G::LDO + c] * scale);
      dv[base + c] = (dVw[r * G::LDO + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16 with register-resident accumulators (FA-2)
//
// A warp's 16 x 64 score tile lives in registers as eight m16n8 f32
// fragments: thread t holds rows t/4 and t/4 + 8, columns 2(t%4) and
// 2(t%4) + 1 of each 8-column block. That layout is also the A operand
// layout of the next m16n8k16 product once packed to bf16 pairs, so P (or
// dS) never leaves the registers. Operands come from shared memory through
// ldmatrix (row pitch padded by 16 bytes: the eight rows of each 8x8 matrix
// then fall in distinct banks); the B operand of P.V, dS.K, P^T.dO and
// dS^T.Q is read with ldmatrix.trans.

constexpr int kTile = 64;   // streamed tile rows, bf16 path

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b for one m16n8k16 tile, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s (16 x N) = A (16 x K rows at `a`, pitch lda) * B^T, B being N rows of K
// at `b` (pitch ldb): the scores Q K^T, dO V^T, K Q^T and V dO^T.
template <int N, int K>
__device__ __forceinline__ void warp_scores(float (&s)[N / 8][4], const __nv_bfloat16* a,
                                            int lda, const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * lda + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (np * 16 + (lane / 16) * 8 + lane % 8) * ldb + kk * 16
                      + ((lane / 8) % 2) * 8);
      mma_bf16(s[2 * np], af, bf[0], bf[1]);
      mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x N) += P (16 x K, the f32 fragments p rounded to bf16 here) * B,
// B being K rows of N at `b` (pitch ldb): P V, dS K, P^T dO and dS^T Q.
template <int N, int K>
__device__ __forceinline__ void warp_accumulate(float (&acc)[N / 8][4],
                                                const float (&p)[K / 8][4],
                                                const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t af[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ldb + np * 16
                        + (lane / 16) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// Write a warp's 16 x D f32 fragments, times `mul`, as bf16 rows
// row_lo / row_lo + 8 of x (B, S, NH, D); rows at or past S are skipped.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul_lo,
                                           float mul_hi, __nv_bfloat16* x, int b, int S,
                                           int NH, int head, int row_lo) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + half * 8;
    if (row >= S) continue;
    const float mul = half ? mul_hi : mul_lo;
    __nv_bfloat16* dst = x + (((size_t)b * S + row) * NH + head) * D + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

__host__ __device__ constexpr size_t bf16_tile_bytes(int d) {
  return align128((size_t)kRows * (d + 8) * sizeof(__nv_bfloat16));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bf16_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int sq, int sk, int h,
                int hkv, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int NT = kTile / 8;
  extern __shared__ __align__(128) char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + bf16_tile_bytes(D));
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + 2 * bf16_tile_bytes(D));
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRows;
  const int off = sk - sq;
  const int row_lo = q0 + warp * 16 + lane / 4;

  load_rows<__nv_bfloat16, D, kRows>(sQ, LD, q, b, sq, h, head, q0);
  const __nv_bfloat16* Qw = sQ + warp * 16 * LD;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int tiles = live_key_tiles(q0, kRows, kTile, sk, off, causal);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_rows<__nv_bfloat16, D, kTile>(sK, LD, k, b, sk, hkv, kvh, k0);
    load_rows<__nv_bfloat16, D, kTile>(sV, LD, v, b, sk, hkv, kvh, k0);
    __syncthreads();
    float s[NT][4];
    warp_scores<kTile, D>(s, Qw, LD, sK, LD);

    uint32_t ok_bits = 0;   // bit 4 * n + i: fragment entry s[n][i] allowed
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + (lane % 4) * 2 + (i & 1);
        const int row = row_lo + (i / 2) * 8;
        const bool ok = col < sk && (mask == nullptr || mask[(size_t)b * sk + col]) &&
                        (!causal || col <= row + off);
        ok_bits |= (uint32_t)ok << (4 * n + i);
        s[n][i] = ok ? s[n][i] * scale : kNegInf;
        mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = (ok_bits >> (4 * n + i)) & 1u ? expf(s[n][i] - m[i / 2]) : 0.f;
        sum[i / 2] += s[n][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    warp_accumulate<D, kTile>(o, s, sV, LD);
  }

  const float den_lo = fmaxf(l[0], 1e-30f);
  const float den_hi = fmaxf(l[1], 1e-30f);
  store_rows<D>(o, 1.f / den_lo, 1.f / den_hi, out, b, sq, h, head, row_lo);
  if (lane % 4 == 0) {
    if (row_lo < sq) lse[(size_t)bh * sq + row_lo] = m[0] + logf(den_lo);
    if (row_lo + 8 < sq) lse[(size_t)bh * sq + row_lo + 8] = m[1] + logf(den_hi);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bf16_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
               const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int sq, int sk,
               int h, int hkv, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int NT = kTile / 8;
  extern __shared__ __align__(128) char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(smem + bf16_tile_bytes(D));
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + 2 * bf16_tile_bytes(D));
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + 3 * bf16_tile_bytes(D));
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kvh = head / (h / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRows;
  const int off = sk - sq;
  const int row_lo = q0 + warp * 16 + lane / 4;

  load_rows<__nv_bfloat16, D, kRows>(sQ, LD, q, b, sq, h, head, q0);
  load_rows<__nv_bfloat16, D, kRows>(sdO, LD, dout, b, sq, h, head, q0);
  const __nv_bfloat16* Qw = sQ + warp * 16 * LD;
  const __nv_bfloat16* dOw = sdO + warp * 16 * LD;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + r * 8;
    row_lse[r] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    row_delta[r] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int tiles = live_key_tiles(q0, kRows, kTile, sk, off, causal);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_rows<__nv_bfloat16, D, kTile>(sK, LD, k, b, sk, hkv, kvh, k0);
    load_rows<__nv_bfloat16, D, kTile>(sV, LD, v, b, sk, hkv, kvh, k0);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    warp_scores<kTile, D>(s, Qw, LD, sK, LD);
    warp_scores<kTile, D>(dp, dOw, LD, sV, LD);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + (lane % 4) * 2 + (i & 1);
        const int row = row_lo + (i / 2) * 8;
        const bool ok = row < sq && col < sk &&
                        (mask == nullptr || mask[(size_t)b * sk + col]) &&
                        (!causal || col <= row + off);
        const float p = ok ? expf(s[n][i] * scale - row_lse[i / 2]) : 0.f;
        s[n][i] = p * (dp[n][i] - row_delta[i / 2]);
      }
    }
    warp_accumulate<D, kTile>(acc, s, sK, LD);
  }
  store_rows<D>(acc, scale, scale, dq, b, sq, h, head, row_lo);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bf16_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                 const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int sq, int sk, int h, int hkv, float scale,
                 int causal) {
  constexpr int LD = D + 8;
  constexpr int NT = kTile / 8;
  extern __shared__ __align__(128) char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + bf16_tile_bytes(D));
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + 2 * bf16_tile_bytes(D));
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(smem + 3 * bf16_tile_bytes(D));
  float* sL = reinterpret_cast<float*>(smem + 4 * bf16_tile_bytes(D));
  float* sDelta = sL + kTile;
  const int b = blockIdx.y / hkv;
  const int kvh = blockIdx.y % hkv;
  const int group = h / hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kRows;
  const int off = sk - sq;
  const int key_lo = k0 + warp * 16 + lane / 4;

  load_rows<__nv_bfloat16, D, kRows>(sK, LD, k, b, sk, hkv, kvh, k0);
  load_rows<__nv_bfloat16, D, kRows>(sV, LD, v, b, sk, hkv, kvh, k0);
  const __nv_bfloat16* Kw = sK + warp * 16 * LD;
  const __nv_bfloat16* Vw = sV + warp * 16 * LD;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + r * 8;
    key_ok[r] = key < sk && (mask == nullptr || mask[(size_t)b * sk + key]);
  }
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  // Query tiles whose last row reaches this block's first key under causal.
  const int q_tiles = (sq + kTile - 1) / kTile;
  int qt_first = 0;
  if (causal) {
    const int need = k0 - off - kTile + 1;
    qt_first = need <= 0 ? 0 : (need + kTile - 1) / kTile;
  }
  for (int g = 0; g < group; ++g) {
    const int head = kvh * group + g;
    const size_t bh = (size_t)b * h + head;
    for (int qt = qt_first; qt < q_tiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_rows<__nv_bfloat16, D, kTile>(sQ, LD, q, b, sq, h, head, q0);
      load_rows<__nv_bfloat16, D, kTile>(sdO, LD, dout, b, sq, h, head, q0);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const int row = q0 + i;
        sL[i] = row < sq ? lse[bh * sq + row] : 0.f;
        sDelta[i] = row < sq ? delta[bh * sq + row] : 0.f;
      }
      __syncthreads();
      float st[NT][4], dpt[NT][4];
      warp_scores<kTile, D>(st, Kw, LD, sQ, LD);    // s^T: keys x queries
      warp_scores<kTile, D>(dpt, Vw, LD, sdO, LD);  // dp^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = n * 8 + (lane % 4) * 2 + (i & 1);
          const int row = q0 + qi;
          const int key = key_lo + (i / 2) * 8;
          const bool ok = key_ok[i / 2] && row < sq && (!causal || key <= row + off);
          const float p = ok ? expf(st[n][i] * scale - sL[qi]) : 0.f;
          dpt[n][i] = p * (dpt[n][i] - sDelta[qi]);
          st[n][i] = p;
        }
      }
      warp_accumulate<D, kTile>(acc_v, st, sdO, LD);
      warp_accumulate<D, kTile>(acc_k, dpt, sQ, LD);
    }
  }
  store_rows<D>(acc_k, scale, scale, dk, b, sk, hkv, kvh, key_lo);
  store_rows<D>(acc_v, 1.f, 1.f, dv, b, sk, hkv, kvh, key_lo);
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

template <int D>
cudaError_t launch_f32(Kind kind, const Args& a, cudaStream_t stream) {
  using G = Geo<D>;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  cudaError_t err;
  if (kind == kForward) {
    const size_t bytes = G::fwd_bytes();
    if ((err = prepare(f32_fwd_kernel<D>, bytes)) != cudaSuccess) return err;
    const dim3 grid((a.sq + kRows - 1) / kRows, a.b * a.h);
    f32_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
        q, k, v, a.mask, static_cast<float*>(a.out0), a.lse_out, a.sq, a.sk, a.h, a.hkv,
        a.scale, a.causal);
  } else if (kind == kDq) {
    const size_t bytes = G::dq_bytes();
    if ((err = prepare(f32_dq_kernel<D>, bytes)) != cudaSuccess) return err;
    const dim3 grid((a.sq + kRows - 1) / kRows, a.b * a.h);
    f32_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(
        q, k, v, a.mask, dout, a.lse_in, a.delta, static_cast<float*>(a.out0), a.sq, a.sk,
        a.h, a.hkv, a.scale, a.causal);
  } else {
    const size_t bytes = G::dkdv_bytes();
    if ((err = prepare(f32_dkdv_kernel<D>, bytes)) != cudaSuccess) return err;
    const dim3 grid((a.sk + kRows - 1) / kRows, a.b * a.hkv);
    f32_dkdv_kernel<D><<<grid, kThreads, bytes, stream>>>(
        q, k, v, a.mask, dout, a.lse_in, a.delta, static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.sq, a.sk, a.h, a.hkv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(Kind kind, const Args& a, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const size_t tile = bf16_tile_bytes(D);
  cudaError_t err;
  if (kind == kForward) {
    const size_t bytes = 3 * tile;
    if ((err = prepare(bf16_fwd_kernel<D>, bytes)) != cudaSuccess) return err;
    const dim3 grid((a.sq + kRows - 1) / kRows, a.b * a.h);
    bf16_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
        q, k, v, a.mask, static_cast<bf16*>(a.out0), a.lse_out, a.sq, a.sk, a.h, a.hkv,
        a.scale, a.causal);
  } else if (kind == kDq) {
    const size_t bytes = 4 * tile;
    if ((err = prepare(bf16_dq_kernel<D>, bytes)) != cudaSuccess) return err;
    const dim3 grid((a.sq + kRows - 1) / kRows, a.b * a.h);
    bf16_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(
        q, k, v, a.mask, dout, a.lse_in, a.delta, static_cast<bf16*>(a.out0), a.sq, a.sk, a.h,
        a.hkv, a.scale, a.causal);
  } else {
    const size_t bytes = 4 * tile + 2 * align128(kTile * sizeof(float));
    if ((err = prepare(bf16_dkdv_kernel<D>, bytes)) != cudaSuccess) return err;
    const dim3 grid((a.sk + kRows - 1) / kRows, a.b * a.hkv);
    bf16_dkdv_kernel<D><<<grid, kThreads, bytes, stream>>>(
        q, k, v, a.mask, dout, a.lse_in, a.delta, static_cast<bf16*>(a.out0),
        static_cast<bf16*>(a.out1), a.sq, a.sk, a.h, a.hkv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; d in {64, 128}; H / Hkv in {1, 2, 4, 8}.
cudaError_t dispatch(Kind kind, int dtype, int d, const Args& a, cudaStream_t stream) {
  if (a.b <= 0 || a.sq <= 0 || a.sk <= 0 || a.hkv <= 0 || a.h % a.hkv) {
    return cudaErrorInvalidValue;
  }
  const int group = a.h / a.hkv;
  if (group != 1 && group != 2 && group != 4 && group != 8) return cudaErrorInvalidValue;
  if (a.b * (kind == kDkdv ? a.hkv : a.h) > 65535) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d == 64) return launch_f32<64>(kind, a, stream);
    if (d == 128) return launch_f32<128>(kind, a, stream);
  } else if (dtype == 1) {
    if (d == 64) return launch_bf16<64>(kind, a, stream);
    if (d == 128) return launch_bf16<128>(kind, a, stream);
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
