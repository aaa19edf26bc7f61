// Single-token grouped-query decode attention for Hopper (sm_90a).
//
// Replaces the two Pallas decode kernels of the JAX package:
//   * hvd_decode_attention       <- horovod_tpu/ops/decode_attention.py::_decode_kernel
//                                   (contiguous row-flat cache (B, L, Hkv*D),
//                                   keys at positions <= cache_index);
//   * hvd_paged_decode_attention <- horovod_tpu/ops/decode_attention.py::_paged_decode_kernel
//                                   (paged pool (N, block_size, Hkv*D) read through
//                                   a per-sequence block table, bound lens[i]).
// Both launch the same kernel: only the address of a key row differs.
//
// What it computes, per sequence and query head: s_t = (q . k_t) * scale in
// f32 for every position t <= bound, an online softmax in f32, p rounded to
// V's dtype before P.V, and acc / max(l, 1e-30) written in q's dtype. Rows
// above the bound are never read, so the paged pool's null block (block 0)
// cannot reach a sum.
//
// What bounds it: device-memory bytes. Each call reads every valid K and V
// row once, about 2 * (bound + 1) * Hkv * D * sizeof(T) bytes per sequence,
// and does 4 * H * D operations per position: well under one operation per
// byte, so the card's 3.35 TB/s is the roofline.
//
// Design (simple first): one block per (sequence, KV head) holding that
// head's group = H / Hkv query heads. Eight warps stride over positions;
// within a warp, D / VEC lanes share one row (16-byte loads, VEC elements
// each), so a warp reads 32 * 16 bytes of K and of V per row set, four row
// sets in flight before any arithmetic. Warps merge their (m, l, acc) through
// shared memory at the end. The Mosaic workarounds of the Pallas kernels (the
// block-diagonal query, the transposed accumulator, 8-row and 128-lane
// scratch, the VMEM-driven L tiling) have no counterpart here.
//
// Occupancy gap: B * Hkv blocks, 64 at the serving slice's b = 8, Hkv = 8,
// for 132 SMs, and each block walks its whole window alone. Splitting the
// window over several blocks with a combine pass (flash-decoding) is the
// redesign that closes it.
//
// Plain C interface, loaded with ctypes: every entry point returns
// cudaGetLastError() after its launch (0 = launched) or cudaErrorInvalidValue
// for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;   // horovod_tpu's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Unpack one 16-byte load into floats.
__device__ __forceinline__ void unpack(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out, __nv_bfloat16) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// tables == nullptr: contiguous cache, row of position t is seq * window + t,
// bound = cache_index. Otherwise paged: row is tables[seq, t / block_size] *
// block_size + t % block_size, bound = lens[seq]. window is the logical
// length (L, or table_slots * block_size); the bound is clamped below it.
template <typename T, int D, int GROUP>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              const int* __restrict__ tables, const int* __restrict__ lens,
              int cache_index, int window, int table_slots, int block_size,
              int hkv, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LANES = D / VEC;        // lanes sharing one row
  constexpr int ROWS = 32 / LANES;      // rows one warp reads at once
  constexpr int STEP = kWarps * ROWS;   // rows the block reads at once
  static_assert(LANES <= 32 && 32 % LANES == 0, "D / VEC must divide 32");

  const int seq = blockIdx.x / hkv;
  const int kv = blockIdx.x % hkv;
  const int h = hkv * GROUP;
  const size_t f = (size_t)hkv * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LANES;
  const int sl = lane % LANES;

  int bound = tables ? lens[seq] : cache_index;
  bound = min(bound, window - 1);

  float qf[GROUP][VEC];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    const T* qp = q + ((size_t)seq * h + kv * GROUP + g) * D + sl * VEC;
    unpack(load16(qp), qf[g], T());
  }

  float m[GROUP], l[GROUP], acc[GROUP][VEC];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // The loop bound is uniform across a warp (base depends on the warp
  // only), so every lane reaches the shuffles below.
  for (int base = warp * ROWS; base <= bound; base += STEP * kUnroll) {
    uint4 kraw[kUnroll], vraw[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * STEP + sub;
      valid[u] = t <= bound;
      kraw[u] = make_uint4(0, 0, 0, 0);
      vraw[u] = make_uint4(0, 0, 0, 0);
      if (valid[u]) {
        size_t row;
        if (tables) {
          row = (size_t)tables[(size_t)seq * table_slots + t / block_size] * block_size
                + t % block_size;
        } else {
          row = (size_t)seq * window + t;
        }
        const size_t off = row * f + (size_t)kv * D + sl * VEC;
        kraw[u] = load16(k + off);
        vraw[u] = load16(v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[VEC], vf[VEC];
      unpack(kraw[u], kf, T());
      unpack(vraw[u], vf, T());
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(qf[g][e], kf[e], s);
#pragma unroll
        for (int o = LANES / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (valid[u]) {
          s *= scale;
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
          const float pr = to_f(from_f<T>(p));   // p in V's dtype before P.V
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e] * alpha);
          m[g] = m_new;
        }
      }
    }
  }

  // Merge the ROWS row streams of each warp (lanes LANES apart).
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float a = expf(m[g] - m_new);
      const float a_o = expf(m_o - m_new);
      l[g] = l[g] * a + l_o * a_o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + acc_o * a_o;
      }
      m[g] = m_new;
    }
  }

  // Merge the warps through shared memory and write the output.
  __shared__ float sm_m[kWarps][GROUP];
  __shared__ float sm_l[kWarps][GROUP];
  __shared__ float sm_acc[kWarps][GROUP][D];
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (sl == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][sl * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GROUP * D; i += kWarps * 32) {
    const int g = i / D;
    const int e = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * a;
      asum += sm_acc[w][g][e] * a;
    }
    out[((size_t)seq * h + kv * GROUP + g) * D + e] = from_f<T>(asum / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* tables;
  const int* lens;
  int b, hkv, cache_index, window, table_slots, block_size;
  float scale;
};

template <typename T, int D, int GROUP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  decode_kernel<T, D, GROUP><<<a.b * a.hkv, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.tables, a.lens, a.cache_index, a.window, a.table_slots,
      a.block_size, a.hkv, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int group, const Args& a, cudaStream_t stream) {
  switch (group) {
    case 1: return launch<T, D, 1>(a, stream);
    case 2: return launch<T, D, 2>(a, stream);
    case 4: return launch<T, D, 4>(a, stream);
    case 8: return launch<T, D, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_width(int d, int group, const Args& a, cudaStream_t stream) {
  if (d == 64) return by_group<T, 64>(group, a, stream);
  if (d == 128) return by_group<T, 128>(group, a, stream);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.
cudaError_t dispatch(int dtype, int h, int d, const Args& a, cudaStream_t stream) {
  if (a.b <= 0 || a.hkv <= 0 || h % a.hkv || a.window <= 0) return cudaErrorInvalidValue;
  const int group = h / a.hkv;
  if (dtype == 0) return by_width<float>(d, group, a, stream);
  if (dtype == 1) return by_width<__nv_bfloat16>(d, group, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* hvd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int hvd_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                    void* out, int b, int h, int hkv, int d, int window,
                                    int cache_index, float scale, int dtype, void* stream) {
  Args a{q, k_cache, v_cache, out, nullptr, nullptr, b, hkv, cache_index, window, 0, 1, scale};
  return static_cast<int>(dispatch(dtype, h, d, a, static_cast<cudaStream_t>(stream)));
}

extern "C" int hvd_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                          void* out, const void* tables, const void* lens,
                                          int b, int h, int hkv, int d, int table_slots,
                                          int block_size, float scale, int dtype,
                                          void* stream) {
  if (block_size <= 0 || table_slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,
         k_pool,
         v_pool,
         out,
         static_cast<const int*>(tables),
         static_cast<const int*>(lens),
         b,
         hkv,
         0,
         table_slots * block_size,
         table_slots,
         block_size,
         scale};
  return static_cast<int>(dispatch(dtype, h, d, a, static_cast<cudaStream_t>(stream)));
}
