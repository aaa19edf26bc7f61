// Single-token grouped-query decode attention for Hopper (sm_90a).
//
// Replaces the two Pallas decode kernels of the JAX package:
//   * hvd_decode_attention       <- horovod_tpu/ops/decode_attention.py::_decode_kernel
//                                   (contiguous row-flat cache (B, L, Hkv*D),
//                                   keys at positions <= cache_index);
//   * hvd_paged_decode_attention <- horovod_tpu/ops/decode_attention.py::_paged_decode_kernel
//                                   (paged pool (N, block_size, Hkv*D) read through
//                                   a per-sequence block table, bound lens[i]).
// Both launch the same kernels: only the address of a key row differs.
//
// What it computes, per sequence and query head: s_t = (q . k_t) * scale in
// f32 for every position t <= bound, a softmax in f32, p rounded to V's
// dtype before P.V, and acc / max(l, 1e-30) written in q's dtype. Rows above
// the bound are never read, so the paged pool's null block (block 0) cannot
// reach a sum.
//
// What bounds it: device-memory bytes. Each call reads every valid K and V
// row once, about 2 * (bound + 1) * Hkv * D * sizeof(T) bytes per sequence,
// and does 4 * H * D operations per position: well under one operation per
// byte, so the card's 3.35 TB/s is the roofline, and the design's job is to
// keep enough bytes in flight on every SM.
//
// Design (flash-decoding): the logical window splits into chunks of `chunk`
// positions at fixed boundaries 0, chunk, 2 * chunk, ...; the grid is
// (sequence x KV head, chunk), sized on the host from the window alone, so
// a long sequence spreads over many SMs and the longest one no longer sets
// the pace. A block holds its KV head's group = H / Hkv query heads (the
// scale and log2(e) folded into q). Eight warps stride over the chunk's
// positions in batches; within a warp, D / VEC lanes share one row (16-byte
// loads, VEC elements each, kUnroll rows per lane per batch). Each lane
// copies its own 16-byte pieces with cp.async into a private ring of
// kStages batches in shared memory, so kStages - 1 batches are in flight
// while it computes one, and the loads in flight hold no registers. The
// lanes of a row sum their GROUP partial dot products by a reduce-scatter,
// so each lane ends with one query head's score (GROUP / (D / VEC) heads'
// when the group is wider than the lanes of a row: narrow heads, wide
// groups) and runs those heads' softmax alone (one running-max update per
// batch of kUnroll rows, one exp2 per score); the others read its rescale
// and probabilities by shuffle. Warps merge their (m, l, acc) through shared memory in a fixed
// order.
//   * window <= chunk (the serving slice's 256): one launch, and the block
//     writes the output itself: no scratch, no second pass.
//   * otherwise each block writes its un-normalised partial (acc, m, l) to
//     f32 scratch that the wrapper allocates, and decode_combine_kernel
//     merges chunks 0 .. bound / chunk in chunk order (no atomics, so the
//     sums' order never depends on which block finished first). Blocks whose
//     chunk starts past the sequence's bound return at once. The combine is
//     a programmatic dependent launch: it is set up while the split
//     kernel's last blocks run and waits for that grid's writes.
// Chunk boundaries are logical positions, so a scrambled block table, or the
// same rows in a wider table, gives bit-identical output.
//
// The Mosaic workarounds of the Pallas kernels (the block-diagonal query,
// the transposed accumulator, 8-row and 128-lane scratch, the VMEM-driven L
// tiling) have no counterpart here.
//
// Instantiated for head_dim 16, 32, 64, 128 and 256 and blocks of 1, 2, 4,
// 8 and 16 query heads, in float32 and bfloat16, at the pool's own layout
// (padding D in the wrapper would copy the whole pool on every step). Any
// H / Hkv runs: at the largest of those block widths that divides it. A
// float32 row at D = 256 is 64 16-byte pieces, two per lane (the ring then
// holds two batches in flight instead of four). The widest instantiations
// (group 16 at D = 128 and 256) hold 2 x GROUP x D / 32 floats of q and
// acc per lane and spill.
//
// Plain C interface, loaded with ctypes: every entry point returns
// cudaGetLastError() after its launches (0 = launched) or
// cudaErrorInvalidValue for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr int kStages = 4;   // batches in each lane's cp.async ring
// The ring: [kStages][kUnroll][K, V][thread] 16-byte pieces.
constexpr int kRingBytes = kStages * kUnroll * 2 * kWarps * 32 * 16;
constexpr float kNegInf = -1e30f;   // horovod_tpu's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x in one MUFU instruction (results below 2^-126 flush to zero).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// 16 bytes global -> shared, asynchronously (bypassing L1).
__device__ __forceinline__ void cp_async16(uint4* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The sequence's last attended position: cache_index (contiguous) or
// lens[seq] (paged), clamped below the window.
__device__ __forceinline__ int seq_bound(const int* __restrict__ lens, int seq, int cache_index,
                                        int window) {
  return min(lens ? lens[seq] : cache_index, window - 1);
}

// The GROUP partial dot products x[] of one row, summed over the LANES
// lanes that share the row: a reduce-scatter (each step halves the values
// a lane keeps and swaps the other half with its partner), then an
// all-reduce of what is left. With GROUP <= LANES, lane sl ends with the
// full score of query head sl / (LANES / GROUP) in x[0]: GROUP - 1 +
// log2(LANES / GROUP) shuffles instead of GROUP * log2(LANES). With GROUP >
// LANES (narrow heads, wide groups), the halving stops after log2(LANES)
// steps and lane sl ends with the NH = GROUP / LANES heads sl * NH + j in
// x[j]. head_of() below is the one rule for both.
template <int GROUP, int LANES>
__device__ __forceinline__ void reduce_scatter(float (&x)[GROUP], int sl) {
#pragma unroll
  for (int n = GROUP, o = LANES / 2; n > 1 && o > 0; n /= 2, o /= 2) {
    const bool hi = sl & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = hi ? x[i] : x[i + n / 2];
      const float keep = hi ? x[i + n / 2] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
#pragma unroll
  for (int o = LANES / GROUP / 2; o > 0; o /= 2) x[0] += __shfl_xor_sync(0xffffffffu, x[0], o);
}

// Query heads each lane holds after reduce_scatter, and lanes holding each.
template <int GROUP, int LANES>
struct Heads {
  static constexpr int NH = GROUP > LANES ? GROUP / LANES : 1;
  static constexpr int PER = GROUP > LANES ? 1 : LANES / GROUP;
  // The lane (within its row's LANES) that holds head g, at index g % NH.
  static __device__ __forceinline__ int lane_of(int g) { return (g / NH) * PER; }
};

// One block per (sequence x GROUP query heads, chunk): the GROUP heads
// head0 .. head0 + GROUP - 1 share the K/V head head0 / group, where group
// = H / Hkv is the model's (GROUP divides it; GROUP = group is the native
// layout, a smaller GROUP reads the K/V head once per GROUP heads, as the
// flash kernels do, and takes any group). tables == nullptr: contiguous
// cache, row of position t is seq * window + t, bound = cache_index.
// Otherwise paged: row is tables[seq, t / block_size] * block_size + t %
// block_size, bound = lens[seq]. window is the logical length (L, or
// table_slots * block_size). part == nullptr: the window is one chunk and
// the block writes `out`; otherwise it writes its partial record (acc[D],
// m, l; m in log2 units) at part[(seq * H + head) * gridDim.y + chunk].
template <typename T, int D, int GROUP>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, float* __restrict__ part, const int* __restrict__ tables,
              const int* __restrict__ lens, int cache_index, int window, int table_slots,
              int block_size, int hkv, int group, int chunk, float scale_log2) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  // 16-byte pieces of a row per lane: 1, or 2 for a float32 row wider than
  // 32 pieces (D = 256). Piece pc of lane sl covers elements
  // (pc * LANES + sl) * VEC ...
  constexpr int PIECES = D / VEC > 32 ? D / VEC / 32 : 1;
  constexpr int PV = PIECES * VEC;      // elements per lane of a row
  constexpr int LANES = D / PV;         // lanes sharing one row
  constexpr int ROWS = 32 / LANES;      // rows one warp reads at once
  constexpr int STEP = kWarps * ROWS;   // rows the block reads at once
  constexpr int STAGES = kStages / PIECES;   // the ring's bytes stay the same
  static_assert(LANES <= 32 && 32 % LANES == 0, "D / VEC must divide 32");
  static_assert(STAGES >= 2, "the ring holds two batches at least");

  const int blocks_per_seq = hkv * (group / GROUP);
  const int seq = blockIdx.x / blocks_per_seq;
  const int head0 = (blockIdx.x % blocks_per_seq) * GROUP;
  const int kv = head0 / group;
  const int h = hkv * group;
  const size_t f = (size_t)hkv * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LANES;
  const int sl = lane % LANES;

  const int bound = seq_bound(lens, seq, cache_index, window);
  const int c0 = blockIdx.y * chunk;
  if (part != nullptr && c0 > bound) return;   // no row here: the combine skips it
  const int last = min(bound, c0 + chunk - 1);

  float qf[GROUP][PV];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
#pragma unroll
    for (int pc = 0; pc < PIECES; ++pc) {
      const T* qp = q + ((size_t)seq * h + head0 + g) * D + (pc * LANES + sl) * VEC;
      unpack(load16(qp), qf[g] + pc * VEC, T());
    }
#pragma unroll
    for (int e = 0; e < PV; ++e) qf[g][e] *= scale_log2;
  }

  // The running max (log2 units) and sum of this lane's NH query heads;
  // the accumulators of every head of the group.
  using HD = Heads<GROUP, LANES>;
  constexpr int NH = HD::NH;
  float m_own[NH], l_own[NH], acc[GROUP][PV];
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    m_own[j] = kNegInf;
    l_own[j] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
#pragma unroll
    for (int e = 0; e < PV; ++e) acc[g][e] = 0.f;
  }

  // Batch i of this warp covers positions first + i * STEP * kUnroll + u *
  // STEP + sub. The batch count is uniform across a warp, so every lane
  // reaches the shuffles below.
  extern __shared__ uint4 ring[];
  const int first = c0 + warp * ROWS;
  const int batches = first > last ? 0 : (last - first) / (STEP * kUnroll) + 1;
  auto piece = [&](int i, int u, int which, int pc) {
    return ring + ((((i % STAGES) * kUnroll + u) * 2 + which) * PIECES + pc) * (kWarps * 32)
           + threadIdx.x;
  };
  // Copy batch i into its stage and commit a group (an empty one past the
  // last batch, so that the group count stays uniform).
  auto issue = [&](int i) {
    if (i < batches) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = first + i * STEP * kUnroll + u * STEP + sub;
        if (t <= last) {
          size_t row;
          if (tables) {
            row = (size_t)tables[(size_t)seq * table_slots + t / block_size] * block_size
                  + t % block_size;
          } else {
            row = (size_t)seq * window + t;
          }
#pragma unroll
          for (int pc = 0; pc < PIECES; ++pc) {
            const size_t off = row * f + (size_t)kv * D + (pc * LANES + sl) * VEC;
            cp_async16(piece(i, u, 0, pc), k + off);
            cp_async16(piece(i, u, 1, pc), v + off);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < batches; ++i) {
    issue(i + STAGES - 1);         // refills the stage read in batch i - 1
    cp_async_wait<STAGES - 1>();   // batch i has landed
    uint4 kraw[kUnroll][PIECES], vraw[kUnroll][PIECES];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      valid[u] = first + i * STEP * kUnroll + u * STEP + sub <= last;
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc) {
        kraw[u][pc] = valid[u] ? *piece(i, u, 0, pc) : make_uint4(0, 0, 0, 0);
        vraw[u][pc] = valid[u] ? *piece(i, u, 1, pc) : make_uint4(0, 0, 0, 0);
      }
    }
    // This lane's heads' scores of the batch's rows, in log2 units.
    float s_own[NH][kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[PV], x[GROUP];
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc) unpack(kraw[u][pc], kf + pc * VEC, T());
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        x[g] = 0.f;
#pragma unroll
        for (int e = 0; e < PV; ++e) x[g] = fmaf(qf[g][e], kf[e], x[g]);
      }
      reduce_scatter<GROUP, LANES>(x, sl);
#pragma unroll
      for (int j = 0; j < NH; ++j) s_own[j][u] = x[j];
    }
    // One running-max update per batch, for each of this lane's heads.
    float alpha_own[NH], pr_own[NH][kUnroll];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float mx = m_own[j];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = valid[u] ? fmaxf(mx, s_own[j][u]) : mx;
      alpha_own[j] = exp2_ftz(m_own[j] - mx);
      m_own[j] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = valid[u] ? exp2_ftz(s_own[j][u] - mx) : 0.f;
        sum += p;
        pr_own[j][u] = to_f(from_f<T>(p));   // p in V's dtype before P.V
      }
      l_own[j] = l_own[j] * alpha_own[j] + sum;
    }
    float vf[kUnroll][PV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc) unpack(vraw[u][pc], vf[u] + pc * VEC, T());
    }
    // Every head's rescale and probabilities from the lanes that hold them.
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float alpha = __shfl_sync(0xffffffffu, alpha_own[g % NH], HD::lane_of(g), LANES);
      float pr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        pr[u] = __shfl_sync(0xffffffffu, pr_own[g % NH][u], HD::lane_of(g), LANES);
      }
#pragma unroll
      for (int e = 0; e < PV; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a = fmaf(pr[u], vf[u][e], a);
        acc[g][e] = a;
      }
    }
  }

  float m[GROUP], l[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m[g] = __shfl_sync(0xffffffffu, m_own[g % NH], HD::lane_of(g), LANES);
    l[g] = __shfl_sync(0xffffffffu, l_own[g % NH], HD::lane_of(g), LANES);
  }

  // Merge the ROWS row streams of each warp (lanes LANES apart).
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float a = exp2_ftz(m[g] - m_new);
      const float a_o = exp2_ftz(m_o - m_new);
      l[g] = l[g] * a + l_o * a_o;
#pragma unroll
      for (int e = 0; e < PV; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + acc_o * a_o;
      }
      m[g] = m_new;
    }
  }

  // Merge the warps through shared memory, in warp order, and write. The
  // warps' accumulators take kWarps * GROUP * D floats: up to 32 KB they
  // have a static array of their own; above (D = 128 at group 16) they
  // reuse the cp.async ring, once every lane has read its last batch.
  __shared__ float sm_m[kWarps][GROUP];
  __shared__ float sm_l[kWarps][GROUP];
  constexpr int kAcc = kWarps * GROUP * D;
  constexpr bool kAccInRing = kAcc * 4 > 32768;
  static_assert(!kAccInRing || kAcc * 4 <= kRingBytes, "the ring holds the accumulators");
  __shared__ float sm_acc_own[kAccInRing ? 1 : kAcc];
  float* sm_acc = kAccInRing ? reinterpret_cast<float*>(ring) : sm_acc_own;
  if constexpr (kAccInRing) {
    cp_async_wait<0>();
    __syncthreads();
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (sl == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          sm_acc[(warp * GROUP + g) * D + (pc * LANES + sl) * VEC + e] = acc[g][pc * VEC + e];
        }
      }
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
      const float a = exp2_ftz(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * a;
      asum += sm_acc[(w * GROUP + g) * D + e] * a;
    }
    const size_t sh = (size_t)seq * h + head0 + g;
    if (part == nullptr) {
      out[sh * D + e] = from_f<T>(asum / fmaxf(lsum, 1e-30f));
    } else {
      float* rec = part + (sh * gridDim.y + blockIdx.y) * (D + 2);
      rec[e] = asum;
      if (e == 0) {
        rec[D] = mx;
        rec[D + 1] = lsum;
      }
    }
  }
}

// One block per (sequence, query head), one thread per output element:
// merge the partial records of chunks 0 .. bound / chunk, in chunk order.
// A sequence with no attended row (bound < 0) writes zeros.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                      const int* __restrict__ lens, int cache_index, int window, int chunk,
                      int chunks, int h) {
  const int sh = blockIdx.x;
  const int e = threadIdx.x;
  const int bound = seq_bound(lens, sh / h, cache_index, window);
  // Launched as a programmatic dependent of decode_kernel: wait here until
  // that grid has finished and its partials are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* rec = part + (size_t)sh * chunks * (D + 2);
  float mx = kNegInf;
  for (int c = 0; c * chunk <= bound; ++c) mx = fmaxf(mx, rec[c * (D + 2) + D]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c * chunk <= bound; ++c) {
    const float* r = rec + c * (D + 2);
    // Exactly 1 for the chunk that holds the max: one live chunk gives
    // the same bits as the single-chunk path.
    const float a = r[D] == mx ? 1.f : exp2_ftz(r[D] - mx);
    l = fmaf(r[D + 1], a, l);
    acc = fmaf(r[e], a, acc);
  }
  out[(size_t)sh * D + e] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part;
  const int* tables;
  const int* lens;
  int b, hkv, cache_index, window, table_slots, block_size, chunk;
  float scale;
};

template <typename T, int D, int GROUP>
cudaError_t launch(const Args& a, int group, cudaStream_t stream) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      decode_kernel<T, D, GROUP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (ready != cudaSuccess) return ready;
  const int chunks = (a.window + a.chunk - 1) / a.chunk;
  T* out = static_cast<T*>(a.out);
  const dim3 grid(a.b * a.hkv * (group / GROUP), chunks);
  decode_kernel<T, D, GROUP><<<grid, kWarps * 32, kRingBytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), out,
      chunks > 1 ? a.part : nullptr, a.tables, a.lens, a.cache_index, a.window, a.table_slots,
      a.block_size, a.hkv, group, a.chunk, a.scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  // Programmatic dependent launch: the combine grid is set up while the
  // split kernel's last blocks run, instead of after it.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.b * a.hkv * group);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const float* part = a.part;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, D>, part, out, a.lens, a.cache_index,
                            a.window, a.chunk, chunks, a.hkv * group);
}

// The instantiations: head_dim in {16, 32, 64, 128, 256} (ops/_build.py's
// DECODE_WIDTHS) by GROUP in {1, 2, 4, 8, 16} (DECODE_GROUPS). A model's
// group H / Hkv runs at the largest GROUP that divides it: its own where
// it is one of them, else blocks of fewer heads (group 3: one head a block).
template <typename T, int D>
cudaError_t by_group(int group, const Args& a, cudaStream_t stream) {
  if (group % 16 == 0) return launch<T, D, 16>(a, group, stream);
  if (group % 8 == 0) return launch<T, D, 8>(a, group, stream);
  if (group % 4 == 0) return launch<T, D, 4>(a, group, stream);
  if (group % 2 == 0) return launch<T, D, 2>(a, group, stream);
  return launch<T, D, 1>(a, group, stream);
}

template <typename T>
cudaError_t by_width(int d, int group, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16: return by_group<T, 16>(group, a, stream);
    case 32: return by_group<T, 32>(group, a, stream);
    case 64: return by_group<T, 64>(group, a, stream);
    case 128: return by_group<T, 128>(group, a, stream);
    case 256: return by_group<T, 256>(group, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16. A window of more than one chunk needs
// the scratch `part`: (B * H, chunks, D + 2) float32.
cudaError_t dispatch(int dtype, int h, int d, const Args& a, cudaStream_t stream) {
  if (a.b <= 0 || a.hkv <= 0 || h % a.hkv || a.window <= 0 || a.chunk <= 0) {
    return cudaErrorInvalidValue;
  }
  const int chunks = (a.window + a.chunk - 1) / a.chunk;
  if (chunks > 65535 || (chunks > 1 && a.part == nullptr)) return cudaErrorInvalidValue;
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
                                    void* out, void* part, int b, int h, int hkv, int d,
                                    int window, int cache_index, int chunk, float scale,
                                    int dtype, void* stream) {
  Args a{q,       k_cache, v_cache,     out, static_cast<float*>(part), nullptr, nullptr, b, hkv,
         cache_index, window, 0, 1, chunk, scale};
  return static_cast<int>(dispatch(dtype, h, d, a, static_cast<cudaStream_t>(stream)));
}

extern "C" int hvd_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                          void* out, void* part, const void* tables,
                                          const void* lens, int b, int h, int hkv, int d,
                                          int table_slots, int block_size, int chunk,
                                          float scale, int dtype, void* stream) {
  if (block_size <= 0 || table_slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,
         k_pool,
         v_pool,
         out,
         static_cast<float*>(part),
         static_cast<const int*>(tables),
         static_cast<const int*>(lens),
         b,
         hkv,
         0,
         table_slots * block_size,
         table_slots,
         block_size,
         chunk,
         scale};
  return static_cast<int>(dispatch(dtype, h, d, a, static_cast<cudaStream_t>(stream)));
}
