// Native TCP ring collectives for host tensors — the data-plane replacement
// for the reference's MPI CPU ops (horovod/common/ops/mpi_operations.cc):
// bandwidth-optimal ring allreduce (reduce-scatter + allgather phases, the
// same algorithm the reference gets from MPI/NCCL underneath), ring
// allgather with per-rank counts (MPI_Allgatherv equivalent,
// mpi_operations.cc:95-173), and ring broadcast (mpi_operations.cc:334-358).
//
// Exposed as a C ABI consumed over ctypes (the reference exposes its C ABI
// the same way, horovod/common/operations.cc:1595-1650 + common/basics.py).
// Two surfaces: the legacy global-ring functions (hvd_ring_*) used by the
// native engine (engine.cc), and handle-based functions (hvd_ringh_*) so one
// process can hold several rings at once — the two-level hierarchical data
// plane needs a local ring, a cross ring and the flat ring side by side (the
// reference likewise holds one NCCL comm per device set,
// nccl_operations.cc:114).
// Single-threaded by contract: only the controller background thread calls
// in, mirroring the reference's one-background-thread-owns-MPI design
// (SURVEY.md §5 "Race detection").
//
// Connections are authenticated with HMAC-SHA256 over the per-job secret
// (sha256.h), so a stray connection to a ring port cannot inject data.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#if defined(__F16C__)
#include <immintrin.h>
#endif

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "sha256.h"

namespace {

std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

struct Ring {
  int rank = -1;
  int size = 0;
  int left_fd = -1;   // recv from left neighbor
  int right_fd = -1;  // send to right neighbor
  int listen_fd = -1;
  std::vector<uint8_t> secret;
  // Link class this ring's connections ride (LINK_* below): indexes the
  // per-link wire-traffic counters so the flat, local and cross planes
  // account separately (hvd_ring_wire_bytes_total{dtype,link}).
  int link = 0;
  // Optional send-rate cap in bytes/s (0 = unlimited): a token bucket the
  // send paths meter through, used by the bandwidth probe to emulate a
  // slow cross-node link on a loopback box. Per ring, so a hierarchical
  // layout can cap only its cross ring.
  double rate_Bps = 0.0;
  double rate_tokens = 0.0;
  double rate_t = 0.0;
  // Wire-compression scratch, persistent across calls so steady-state
  // allreduces allocate nothing (single-threaded per ring by contract).
  std::vector<char> wtx, wrx, wfwd;
  std::vector<float> wscratch;
};

// Link classes for the wire-traffic counters. Must match
// core.bindings.WIRE_LINK_CODES.
enum WireLink {
  LINK_FLAT = 0,   // the flat (global) ring
  LINK_LOCAL = 1,  // hierarchical intra-node ring
  LINK_CROSS = 2,  // hierarchical cross ring (local roots)
};
constexpr int kNumLinks = 3;

enum DType {
  DT_F32 = 0,
  DT_F64 = 1,
  DT_I32 = 2,
  DT_I64 = 3,
  DT_U8 = 4,
  DT_F16 = 5,
  DT_BF16 = 6,
  DT_I8 = 7,
  DT_I16 = 8,
  DT_U16 = 9,
  DT_BOOL = 10,  // reduced with logical OR (any), like MPI_LOR
};

size_t dtype_size(int dt) {
  switch (dt) {
    case DT_F32: case DT_I32: return 4;
    case DT_F64: case DT_I64: return 8;
    case DT_U8: case DT_I8: case DT_BOOL: return 1;
    case DT_F16: case DT_BF16: case DT_I16: case DT_U16: return 2;
  }
  return 0;
}

// --- in-flight wire compression (round-10: ROADMAP item 4) ------------------
// The reference fuses fp16 compression into its NCCL data path; here the
// analogue compresses each chunk AT SEND TIME on the TCP ring: allreduce
// payloads of f32 travel the wire as bf16/fp16 (half the bytes) or as int8
// with a per-block scale (quarter the bytes), while every accumulation
// stays in f32. Selected per call (the wire_dtype arg threaded from
// HOROVOD_RING_WIRE_DTYPE through common/config.py); WIRE_NONE keeps the
// pre-round-10 byte stream exactly. Non-f32 dtypes always travel
// uncompressed — the half types already are their own wire format, and
// integer sums must be exact.

enum WireDType {
  WIRE_NONE = 0,
  WIRE_BF16 = 1,
  WIRE_F16 = 2,
  WIRE_I8 = 3,
};

// int8 quantization block: ONE f32 scale per this many elements, fixed so
// the wire format never depends on the (autotuned, per-rank) transfer
// chunk size — sender and receiver need no chunk agreement. 4096 elems =
// 16 KiB of f32, 4 KiB on the wire + 4-byte scale (~0.1% overhead).
constexpr long kQuantBlock = 4096;

// Pipelining/transfer chunk for the reduce-while-receive sink AND the
// compress-ahead cursor. 256 KiB was the round-3 constant; round 10 makes
// it runtime-settable (hvd_ring_set_chunk_bytes) so the GP autotuner can
// fit it to the link class (ICI/DCN/TCP/loopback). Multiple of 8 by
// construction (setter rounds), so chunk boundaries stay element-aligned
// for every dtype size.
std::atomic<long> g_chunk_bytes{256 * 1024};

long chunk_bytes_now() { return g_chunk_bytes.load(std::memory_order_relaxed); }

// Wire traffic accounting, indexed by [WireLink][WireDType]: actual bytes
// handed to the kernel vs the f32-equivalent ("logical") bytes they
// carry, plus time spent in compress/decompress kernels. Python mirrors
// these into hvd_ring_wire_bytes_total{dtype,link} /
// hvd_ring_compress_seconds.
std::atomic<long long> g_wire_tx_bytes[kNumLinks][4];
std::atomic<long long> g_wire_logical_bytes[kNumLinks][4];
std::atomic<long long> g_compress_ns{0};

struct CompressTimer {
  std::chrono::steady_clock::time_point t0;
  CompressTimer() : t0(std::chrono::steady_clock::now()) {}
  ~CompressTimer() {
    g_compress_ns.fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - t0)
            .count(),
        std::memory_order_relaxed);
  }
};

// Wire bytes for n f32 elements under a wire dtype (int8 adds one f32
// scale per quant block).
size_t wire_nbytes(long n, int wire) {
  switch (wire) {
    case WIRE_BF16: case WIRE_F16: return (size_t)n * 2;
    case WIRE_I8:
      return (size_t)n + 4 * (size_t)((n + kQuantBlock - 1) / kQuantBlock);
    default: return (size_t)n * 4;
  }
}


// --- half-precision conversions (scalar; reference uses F16C intrinsics
// with a scalar fallback, common/half.cc:28-78) -----------------------------

float f16_to_f32(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(mant & 0x400)) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3ff;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    if (mant) mant |= 0x200;  // quiet the NaN, like VCVTPH2PS
    bits = sign | 0x7f800000 | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t f32_to_f16(float f) {
  // Round-to-nearest-even, matching F16C's _mm256_cvtps_ph: the scalar
  // tail and the vector body must produce byte-identical results.
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint16_t sign = (uint16_t)((bits >> 16) & 0x8000);
  int32_t exp = (int32_t)((bits >> 23) & 0xff) - 127 + 15;
  uint32_t mant = bits & 0x7fffff;
  if (exp >= 31) {
    if (((bits >> 23) & 0xff) == 0xff && mant)
      // NaN: quiet bit + truncated payload, exactly VCVTPS2PH's result
      // (an exp>=31 finite or inf still becomes inf below).
      return sign | 0x7e00 | (uint16_t)(mant >> 13);
    return sign | 0x7c00;  // overflow -> inf
  }
  if (exp <= 0) {
    if (exp < -10) return sign;
    mant |= 0x800000;
    uint32_t shift = (uint32_t)(14 - exp);
    uint32_t half = mant >> shift;
    uint32_t dropped_mask = (1u << shift) - 1;
    uint32_t dropped = mant & dropped_mask;
    uint32_t halfway = 1u << (shift - 1);
    if (dropped > halfway || (dropped == halfway && (half & 1)))
      half++;  // RNE on the subnormal shift
    return sign | (uint16_t)half;
  }
  uint32_t half = (uint32_t)(exp << 10) | (mant >> 13);
  uint32_t dropped = mant & 0x1fff;
  if (dropped > 0x1000 || (dropped == 0x1000 && (half & 1)))
    half++;  // RNE; mantissa carry correctly bumps the exponent
  return sign | (uint16_t)half;
}

float bf16_to_f32(uint16_t h) {
  uint32_t bits = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t f32_to_bf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  // round-to-nearest-even on the dropped 16 bits
  uint32_t rounding = 0x7fff + ((bits >> 16) & 1);
  return (uint16_t)((bits + rounding) >> 16);
}

// --- vectorized half-precision block ops -----------------------------------
// The reference vectorizes its fp16 sum with F16C/AVX intrinsics behind a
// runtime CPUID check (common/half.cc:28-78). Here the dispatch is at
// COMPILE time: bindings.py builds this .so with -march=native and keys the
// artifact name on the host CPU's flag signature, so __F16C__ being defined
// means the host has it. Scalar tails use the RNE scalar converters above,
// which match the intrinsics bit-for-bit.

void f16_to_f32_block(const uint16_t* s, float* d, long n) {
  long i = 0;
#if defined(__F16C__)
  for (; i + 8 <= n; i += 8)
    _mm256_storeu_ps(
        d + i, _mm256_cvtph_ps(_mm_loadu_si128((const __m128i*)(s + i))));
#endif
  for (; i < n; i++) d[i] = f16_to_f32(s[i]);
}

void f32_to_f16_block(const float* s, uint16_t* d, long n) {
  long i = 0;
#if defined(__F16C__)
  for (; i + 8 <= n; i += 8)
    _mm_storeu_si128(
        (__m128i*)(d + i),
        _mm256_cvtps_ph(_mm256_loadu_ps(s + i), _MM_FROUND_TO_NEAREST_INT));
#endif
  for (; i < n; i++) d[i] = f32_to_f16(s[i]);
}

void bf16_to_f32_block(const uint16_t* s, float* d, long n) {
  // Branchless widen; autovectorizes under -O3 -march=native.
  for (long i = 0; i < n; i++) d[i] = bf16_to_f32(s[i]);
}

void f32_to_bf16_block(const float* s, uint16_t* d, long n) {
  for (long i = 0; i < n; i++) d[i] = f32_to_bf16(s[i]);
}

// --- wire codec: f32 <-> wire chunk, with int8 residual capture ------------

// The int8 codec's arithmetic contract is plain mul-THEN-add with f32
// rounding at every step: q*scale rounds before it is added/subtracted.
// GCC's default -ffp-contract=fast would fuse those into FMAs (no
// intermediate rounding), making the reduced values compiler-dependent
// and — worse — making the recorded residual differ by an ulp from
// x - (what the receiver actually adds), which breaks the exact
// error-feedback telescoping. Contraction stays off for the codec only.
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")

// Compress n f32 into the wire format. Quant blocks are anchored at the
// start of the region being compressed (callers only ever hand in whole
// segments, or block-aligned chunks of one, so scale positions are
// deterministic for the receiver). For WIRE_I8, `residual` (nullable)
// receives x - dequant(quant(x)) per element — the exact error this
// quantization introduced, which the error-feedback layer
// (controller/native.py) carries into the next allreduce.
size_t wire_compress(const float* src, long n, int wire, char* dst,
                     float* residual) {
  CompressTimer t;
  switch (wire) {
    case WIRE_BF16:
      f32_to_bf16_block(src, (uint16_t*)dst, n);
      return (size_t)n * 2;
    case WIRE_F16:
      f32_to_f16_block(src, (uint16_t*)dst, n);
      return (size_t)n * 2;
    case WIRE_I8: {
      char* p = dst;
      for (long b = 0; b < n; b += kQuantBlock) {
        long m = n - b < kQuantBlock ? n - b : kQuantBlock;
        float amax = 0.0f;
        for (long i = 0; i < m; i++) {
          float a = std::fabs(src[b + i]);
          if (a > amax) amax = a;
        }
        float scale = amax / 127.0f;
        std::memcpy(p, &scale, 4);
        p += 4;
        int8_t* q = (int8_t*)p;
        if (scale == 0.0f) {
          std::memset(q, 0, (size_t)m);
          if (residual)
            for (long i = 0; i < m; i++) residual[b + i] = src[b + i];
        } else {
          float inv = 1.0f / scale;
          for (long i = 0; i < m; i++) {
            float v = src[b + i] * inv;
            // RNE like the half converters; clamp keeps +-inf sane.
            v = v > 127.0f ? 127.0f : (v < -127.0f ? -127.0f : v);
            q[i] = (int8_t)std::nearbyint(v);
          }
          if (residual)
            for (long i = 0; i < m; i++)
              residual[b + i] = src[b + i] - (float)q[i] * scale;
        }
        p += m;
      }
      return (size_t)(p - dst);
    }
  }
  std::memcpy(dst, src, (size_t)n * 4);
  return (size_t)n * 4;
}

// Decompress n elements of a wire chunk into f32. `accumulate` adds into
// dst (reduce-scatter phase, f32 accumulation per the compression
// contract); otherwise overwrites (allgather phase).
void wire_decompress(const char* src, long n, int wire, float* dst,
                     bool accumulate, float* scratch) {
  CompressTimer t;
  switch (wire) {
    case WIRE_BF16: {
      const uint16_t* s = (const uint16_t*)src;
      if (accumulate)
        for (long i = 0; i < n; i++) dst[i] += bf16_to_f32(s[i]);
      else
        bf16_to_f32_block(s, dst, n);
      return;
    }
    case WIRE_F16: {
      const uint16_t* s = (const uint16_t*)src;
      if (accumulate) {
        // F16C-widen into scratch, then a vectorizable f32 add.
        for (long off = 0; off < n; off += kQuantBlock) {
          long m = n - off < kQuantBlock ? n - off : kQuantBlock;
          f16_to_f32_block(s + off, scratch, m);
          for (long i = 0; i < m; i++) dst[off + i] += scratch[i];
        }
      } else {
        f16_to_f32_block(s, dst, n);
      }
      return;
    }
    case WIRE_I8: {
      const char* p = src;
      for (long b = 0; b < n; b += kQuantBlock) {
        long m = n - b < kQuantBlock ? n - b : kQuantBlock;
        float scale;
        std::memcpy(&scale, p, 4);
        p += 4;
        const int8_t* q = (const int8_t*)p;
        if (accumulate)
          for (long i = 0; i < m; i++) dst[b + i] += (float)q[i] * scale;
        else
          for (long i = 0; i < m; i++) dst[b + i] = (float)q[i] * scale;
        p += m;
      }
      return;
    }
  }
  if (accumulate) {
    const float* s = (const float*)src;
    for (long i = 0; i < n; i++) dst[i] += s[i];
  } else {
    std::memcpy(dst, src, (size_t)n * 4);
  }
}

#pragma GCC pop_options

// One cache-friendly block of converted operands per iteration: big enough
// to amortize loop overhead, small enough that 3 x 512 floats stay in L1.
// (bf16 stays on its fused single-pass loop — see accumulate DT_BF16 —
// so only f16 takes the blocked form.)
constexpr long kHalfBlock = 512;

void accumulate_f16(uint16_t* d, const uint16_t* s, long count) {
  float a[kHalfBlock], b[kHalfBlock];
  for (long off = 0; off < count; off += kHalfBlock) {
    long n = count - off < kHalfBlock ? count - off : kHalfBlock;
    f16_to_f32_block(d + off, a, n);
    f16_to_f32_block(s + off, b, n);
    for (long i = 0; i < n; i++) a[i] += b[i];
    f32_to_f16_block(a, d + off, n);
  }
}

void scale_f16(uint16_t* d, long count, double factor) {
  // Multiply in double like every other dtype's scale path (and like the
  // pre-vectorization loop): one rounding convention across half types.
  float a[kHalfBlock];
  for (long off = 0; off < count; off += kHalfBlock) {
    long n = count - off < kHalfBlock ? count - off : kHalfBlock;
    f16_to_f32_block(d + off, a, n);
    for (long i = 0; i < n; i++) a[i] = (float)(a[i] * factor);
    f32_to_f16_block(a, d + off, n);
  }
}

void accumulate(void* dst, const void* src, long count, int dt) {
  switch (dt) {
    case DT_F32: {
      float* d = (float*)dst;
      const float* s = (const float*)src;
      for (long i = 0; i < count; i++) d[i] += s[i];
      break;
    }
    case DT_F64: {
      double* d = (double*)dst;
      const double* s = (const double*)src;
      for (long i = 0; i < count; i++) d[i] += s[i];
      break;
    }
    case DT_I32: {
      int32_t* d = (int32_t*)dst;
      const int32_t* s = (const int32_t*)src;
      for (long i = 0; i < count; i++) d[i] += s[i];
      break;
    }
    case DT_I64: {
      int64_t* d = (int64_t*)dst;
      const int64_t* s = (const int64_t*)src;
      for (long i = 0; i < count; i++) d[i] += s[i];
      break;
    }
    case DT_U8: {
      uint8_t* d = (uint8_t*)dst;
      const uint8_t* s = (const uint8_t*)src;
      for (long i = 0; i < count; i++) d[i] = (uint8_t)(d[i] + s[i]);
      break;
    }
    case DT_I8: {
      int8_t* d = (int8_t*)dst;
      const int8_t* s = (const int8_t*)src;
      for (long i = 0; i < count; i++) d[i] = (int8_t)(d[i] + s[i]);
      break;
    }
    case DT_I16: {
      int16_t* d = (int16_t*)dst;
      const int16_t* s = (const int16_t*)src;
      for (long i = 0; i < count; i++) d[i] = (int16_t)(d[i] + s[i]);
      break;
    }
    case DT_U16: {
      uint16_t* d = (uint16_t*)dst;
      const uint16_t* s = (const uint16_t*)src;
      for (long i = 0; i < count; i++) d[i] = (uint16_t)(d[i] + s[i]);
      break;
    }
    case DT_BOOL: {
      uint8_t* d = (uint8_t*)dst;
      const uint8_t* s = (const uint8_t*)src;
      for (long i = 0; i < count; i++) d[i] = (uint8_t)(d[i] || s[i]);
      break;
    }
    case DT_F16:
      accumulate_f16((uint16_t*)dst, (const uint16_t*)src, count);
      break;
    case DT_BF16: {
      // Single fused pass, not the blocked form: the branchless widen/
      // add/RNE-narrow loop autovectorizes as-is and measured ~3% FASTER
      // than block-converting through scratch (4.0 vs 3.9 Gelem/s).
      uint16_t* d = (uint16_t*)dst;
      const uint16_t* s = (const uint16_t*)src;
      for (long i = 0; i < count; i++)
        d[i] = f32_to_bf16(bf16_to_f32(d[i]) + bf16_to_f32(s[i]));
      break;
    }
  }
}

void scale(void* buf, long count, int dt, double factor) {
  switch (dt) {
    case DT_F32: {
      float* d = (float*)buf;
      for (long i = 0; i < count; i++) d[i] = (float)(d[i] * factor);
      break;
    }
    case DT_F64: {
      double* d = (double*)buf;
      for (long i = 0; i < count; i++) d[i] *= factor;
      break;
    }
    case DT_F16: {
      scale_f16((uint16_t*)buf, count, factor);
      break;
    }
    case DT_BF16: {
      uint16_t* d = (uint16_t*)buf;  // fused pass (see accumulate DT_BF16)
      for (long i = 0; i < count; i++)
        d[i] = f32_to_bf16((float)(bf16_to_f32(d[i]) * factor));
      break;
    }
    default:
      break;  // integer average is not defined; caller avoids it
  }
}

// --- socket helpers --------------------------------------------------------

bool wait_fd(int fd, short events) {
  struct pollfd pfd{fd, events, 0};
  int rc = poll(&pfd, 1, 60000);
  if (rc <= 0) {
    set_error(rc == 0 ? "socket wait timed out (60s)"
                      : std::string("poll: ") + strerror(errno));
    return false;
  }
  return true;
}

// Work on both blocking (handshake) and non-blocking (data phase) fds.
// Last time any ring in this process moved bytes (monotonic seconds).
// shm.cc's barrier reads this — and, crucially, a cross-PROCESS sink in
// the shared segment (set via hvd_ring_set_progress_sink) — to turn its
// timeout into an IDLE timeout: local ranks waiting at a barrier while
// their group leader's cross-node phase moves a large payload observe the
// leader's progress through the shared word and must not be killed.
std::atomic<double> g_last_progress{0.0};
std::atomic<std::atomic<double>*> g_progress_sink{nullptr};

double prog_mono_s() {
  return std::chrono::duration_cast<std::chrono::duration<double>>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

void mark_progress() {
  double now = prog_mono_s();
  g_last_progress.store(now, std::memory_order_relaxed);
  auto* sink = g_progress_sink.load(std::memory_order_acquire);
  if (sink) sink->store(now, std::memory_order_relaxed);
}

// Token-bucket gate for the optional per-ring send-rate cap: how many of
// `want` bytes may go out now (0 = bucket dry; the caller retries after
// the built-in short sleep). ~10 ms burst so pacing is smooth without
// per-byte wakeups. Unlimited (the default) is a single branch.
size_t rate_allow(Ring& ring, size_t want) {
  if (ring.rate_Bps <= 0.0 || want == 0) return want;
  double now = prog_mono_s();
  if (ring.rate_t == 0.0) ring.rate_t = now;
  ring.rate_tokens += (now - ring.rate_t) * ring.rate_Bps;
  ring.rate_t = now;
  double cap = ring.rate_Bps * 0.01 + 65536.0;
  if (ring.rate_tokens > cap) ring.rate_tokens = cap;
  if (ring.rate_tokens < 1.0) {
    std::this_thread::sleep_for(std::chrono::microseconds(200));
    return 0;
  }
  return want < (size_t)ring.rate_tokens ? want
                                         : (size_t)ring.rate_tokens;
}

void rate_consume(Ring& ring, size_t n) {
  if (ring.rate_Bps > 0.0) ring.rate_tokens -= (double)n;
}

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n > 0) {
    ssize_t k = send(fd, p, n, MSG_NOSIGNAL);
    if (k < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        if (!wait_fd(fd, POLLOUT)) return false;
        continue;
      }
      set_error(std::string("send: ") + strerror(errno));
      return false;
    }
    p += k;
    n -= (size_t)k;
    mark_progress();
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n > 0) {
    ssize_t k = recv(fd, p, n, 0);
    if (k < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        if (!wait_fd(fd, POLLIN)) return false;
        continue;
      }
      set_error(std::string("recv: ") + strerror(errno));
      return false;
    }
    if (k == 0) {
      set_error("recv: peer closed");
      return false;
    }
    p += k;
    n -= (size_t)k;
    mark_progress();
  }
  return true;
}

// Segmented pipelining (round-3 verdict item #3): during a reduce-scatter
// step, accumulate already-received chunks into the destination while the
// kernel keeps streaming later bytes into the socket buffers — single
// thread, but compute and wire genuinely overlap. The chunk size balances
// overlap granularity against per-chunk call overhead; 256 KiB default,
// runtime-settable per link class (g_chunk_bytes above).
struct ReduceSink {
  char* dst;        // segment being reduced into (same layout as rbuf)
  int dtype;
  size_t esz;
  size_t acc_done = 0;  // bytes of rbuf already accumulated
  // Snapshot once per step: a mid-step autotune push must not shear the
  // chunk grid this sink is draining on.
  size_t chunk = (size_t)chunk_bytes_now();

  void drain(const char* rbuf, size_t roff, bool final) {
    size_t ready = final ? roff : (roff / chunk) * chunk;
    // Chunk boundaries stay element-aligned: the setter keeps chunk a
    // multiple of every dtype size (1/2/4/8).
    if (ready <= acc_done) return;
    accumulate(dst + acc_done, rbuf + acc_done,
               (long)((ready - acc_done) / esz), dtype);
    acc_done = ready;
  }
};

// Full-duplex exchange: send `sn` bytes right while receiving `rn` bytes from
// left. Poll-driven so large segments can't deadlock on filled socket
// buffers (both neighbors send simultaneously each ring step). When `sink`
// is given, completed receive chunks are reduced in while the rest streams.
bool exchange(Ring& ring, const void* sbuf, size_t sn, void* rbuf, size_t rn,
              ReduceSink* sink = nullptr) {
  size_t soff = 0, roff = 0;
  while (soff < sn || roff < rn) {
    struct pollfd fds[2];
    int nf = 0;
    int si = -1, ri = -1;
    if (soff < sn) {
      fds[nf].fd = ring.right_fd;
      fds[nf].events = POLLOUT;
      si = nf++;
    }
    if (roff < rn) {
      fds[nf].fd = ring.left_fd;
      fds[nf].events = POLLIN;
      ri = nf++;
    }
    int rc = poll(fds, nf, 60000);
    if (rc < 0) {
      if (errno == EINTR) continue;
      set_error(std::string("poll: ") + strerror(errno));
      return false;
    }
    if (rc == 0) {
      set_error("ring exchange timed out (60s)");
      return false;
    }
    if (si >= 0 && (fds[si].revents & (POLLOUT | POLLERR | POLLHUP))) {
      size_t allowed = rate_allow(ring, sn - soff);
      ssize_t k = allowed == 0
                      ? 0
                      : send(ring.right_fd, (const char*)sbuf + soff, allowed,
                             MSG_NOSIGNAL);
      if (k < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
        set_error(std::string("send: ") + strerror(errno));
        return false;
      }
      if (k > 0) {
        soff += (size_t)k;
        rate_consume(ring, (size_t)k);
        mark_progress();
      }
    }
    if (ri >= 0 && (fds[ri].revents & (POLLIN | POLLERR | POLLHUP))) {
      ssize_t k = recv(ring.left_fd, (char*)rbuf + roff, rn - roff, 0);
      if (k < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
        set_error(std::string("recv: ") + strerror(errno));
        return false;
      }
      if (k == 0) {
        set_error("recv: peer closed");
        return false;
      }
      if (k > 0) {
        roff += (size_t)k;
        mark_progress();
        if (sink) sink->drain((const char*)rbuf, roff, false);
      }
    }
  }
  if (sink) sink->drain((const char*)rbuf, roff, true);
  return true;
}

// --- compress-ahead pipeline (round 10) -------------------------------------

// Pipelining granularity in f32 elements: the transfer chunk, rounded up
// to whole int8 quant blocks so scale headers never straddle a chunk.
long wire_chunk_elems(int wire) {
  long e = chunk_bytes_now() / 4;
  if (wire == WIRE_I8) e = ((e + kQuantBlock - 1) / kQuantBlock) * kQuantBlock;
  if (e < kQuantBlock) e = kQuantBlock;
  return e;
}

// Sender side: converts the outgoing f32 segment into wire format one
// chunk AHEAD of the send offset, so the cast of chunk k+1 runs while
// chunk k's bytes drain from the socket buffer — the send-side twin of
// the round-3 ReduceSink.
struct CompressCursor {
  const float* src;
  long n;
  int wire;
  char* wbuf;         // wire_nbytes(n, wire) capacity
  float* residual;    // nullable; int8 error-feedback capture
  long chunk_elems;
  size_t total;       // wire bytes when fully compressed
  long elems_done = 0;
  size_t ready = 0;   // wire bytes materialized so far

  CompressCursor(const float* src, long n, int wire, char* wbuf,
                 float* residual)
      : src(src), n(n), wire(wire), wbuf(wbuf), residual(residual),
        chunk_elems(wire_chunk_elems(wire)), total(wire_nbytes(n, wire)) {}

  bool done() const { return elems_done >= n; }

  void compress_next() {
    long m = n - elems_done < chunk_elems ? n - elems_done : chunk_elems;
    ready += wire_compress(src + elems_done, m, wire, wbuf + ready,
                           residual ? residual + elems_done : nullptr);
    elems_done += m;
  }

  // Invariant after this call: ready > soff unless fully compressed — the
  // exchange loop always has bytes to hand to send().
  void ensure_ahead(size_t soff) {
    size_t one = wire_nbytes(chunk_elems, wire);
    while (!done() && ready < soff + 2 * one) compress_next();
  }
};

// Receiver side: widens completed wire chunks into the f32 destination
// (accumulating during reduce-scatter, overwriting during allgather)
// while later bytes still stream.
struct WireSink {
  float* dst;
  long n;
  int wire;
  const char* wrecv;
  bool acc;          // accumulate (phase 1) vs overwrite (phase 2)
  float* scratch;    // kQuantBlock floats (f16 widen staging)
  long chunk_elems;
  long elems_done = 0;
  size_t consumed = 0;  // wire bytes drained

  void drain(size_t roff, bool final) {
    (void)final;  // the last recv completes the last chunk exactly
    while (elems_done < n) {
      long m = n - elems_done < chunk_elems ? n - elems_done : chunk_elems;
      size_t need = wire_nbytes(m, wire);  // chunk starts block-aligned
      if (roff < consumed + need) return;
      wire_decompress(wrecv + consumed, m, wire, dst + elems_done, acc,
                      scratch);
      consumed += need;
      elems_done += m;
    }
  }
};

// Full-duplex wire exchange: like exchange(), but the send side either
// streams from a CompressCursor (tx != nullptr; compresses ahead of the
// wire) or relays precompressed bytes verbatim (sbuf/sn), and the receive
// side drains completed wire chunks through a WireSink.
bool exchange_w(Ring& ring, CompressCursor* tx, const char* sbuf, size_t sn,
                char* rbuf, size_t rn, WireSink* sink) {
  size_t soff = 0, roff = 0;
  size_t slimit = tx ? tx->total : sn;
  while (soff < slimit || roff < rn) {
    if (tx) tx->ensure_ahead(soff);
    const char* sp = tx ? tx->wbuf : sbuf;
    struct pollfd fds[2];
    int nf = 0;
    int si = -1, ri = -1;
    if (soff < slimit) {
      fds[nf].fd = ring.right_fd;
      fds[nf].events = POLLOUT;
      si = nf++;
    }
    if (roff < rn) {
      fds[nf].fd = ring.left_fd;
      fds[nf].events = POLLIN;
      ri = nf++;
    }
    int rc = poll(fds, nf, 60000);
    if (rc < 0) {
      if (errno == EINTR) continue;
      set_error(std::string("poll: ") + strerror(errno));
      return false;
    }
    if (rc == 0) {
      set_error("ring exchange timed out (60s)");
      return false;
    }
    if (si >= 0 && (fds[si].revents & (POLLOUT | POLLERR | POLLHUP))) {
      size_t avail = tx ? tx->ready : sn;
      size_t allowed = rate_allow(ring, avail - soff);
      ssize_t k = allowed == 0
                      ? 0
                      : send(ring.right_fd, sp + soff, allowed, MSG_NOSIGNAL);
      if (k < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
        set_error(std::string("send: ") + strerror(errno));
        return false;
      }
      if (k > 0) {
        soff += (size_t)k;
        rate_consume(ring, (size_t)k);
        mark_progress();
      }
    }
    if (ri >= 0 && (fds[ri].revents & (POLLIN | POLLERR | POLLHUP))) {
      ssize_t k = recv(ring.left_fd, rbuf + roff, rn - roff, 0);
      if (k < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
        set_error(std::string("recv: ") + strerror(errno));
        return false;
      }
      if (k == 0) {
        set_error("recv: peer closed");
        return false;
      }
      if (k > 0) {
        roff += (size_t)k;
        mark_progress();
        if (sink) sink->drain(roff, false);
      }
    }
  }
  if (sink) sink->drain(roff, true);
  return true;
}

bool parse_addr(const std::string& addr, std::string* host, int* port) {
  size_t colon = addr.rfind(':');
  if (colon == std::string::npos) return false;
  *host = addr.substr(0, colon);
  *port = atoi(addr.c_str() + colon + 1);
  return true;
}

void auth_token(const Ring& ring, int sender_rank, uint8_t out[32]) {
  char msg[64];
  int n = snprintf(msg, sizeof(msg), "hvd-ring-hello:%d", sender_rank);
  hvd::hmac_sha256(ring.secret.data(), ring.secret.size(), (const uint8_t*)msg,
                   (size_t)n, out);
}

void ring_close(Ring& ring) {
  for (int* fd : {&ring.left_fd, &ring.right_fd, &ring.listen_fd}) {
    if (*fd >= 0) {
      close(*fd);
      *fd = -1;
    }
  }
  ring.rank = -1;
  ring.size = 0;
}

// addrs: comma-separated "host:port" per rank, in rank order.
int ring_init(Ring& ring, int rank, int size, const char* addrs_cstr,
              const uint8_t* secret, int secret_len) {
  ring.rank = rank;
  ring.size = size;
  ring.secret.assign(secret, secret + secret_len);
  if (size == 1) return 0;

  std::vector<std::string> addrs;
  std::string cur, all(addrs_cstr);
  for (char c : all) {
    if (c == ',') {
      addrs.push_back(cur);
      cur.clear();
    } else {
      cur += c;
    }
  }
  if (!cur.empty()) addrs.push_back(cur);
  if ((int)addrs.size() != size) {
    set_error("ring_init: addrs count != size");
    return -1;
  }

  std::string my_host;
  int my_port = 0;
  if (!parse_addr(addrs[rank], &my_host, &my_port)) {
    set_error("ring_init: bad own address " + addrs[rank]);
    return -1;
  }

  // Listen for the left neighbor.
  ring.listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(ring.listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  // Request large buffers BEFORE listen/connect: the TCP window-scale
  // factor is fixed at the handshake, and accepted sockets inherit the
  // listener's options. The kernel clamps to net.core.{r,w}mem_max —
  // raise those sysctls for the full 8 MiB on high-BDP links.
  int bufsz = 8 << 20;
  setsockopt(ring.listen_fd, SOL_SOCKET, SO_SNDBUF, &bufsz, sizeof(bufsz));
  setsockopt(ring.listen_fd, SOL_SOCKET, SO_RCVBUF, &bufsz, sizeof(bufsz));
  struct sockaddr_in sa;
  std::memset(&sa, 0, sizeof(sa));
  sa.sin_family = AF_INET;
  sa.sin_addr.s_addr = INADDR_ANY;
  sa.sin_port = htons((uint16_t)my_port);
  if (bind(ring.listen_fd, (struct sockaddr*)&sa, sizeof(sa)) < 0) {
    set_error(std::string("bind ") + addrs[rank] + ": " + strerror(errno));
    return -1;
  }
  if (listen(ring.listen_fd, 4) < 0) {
    set_error(std::string("listen: ") + strerror(errno));
    return -1;
  }

  // Connect to the right neighbor, retrying while it comes up (the Python
  // WorkerClient does the same, controller/service.py).
  int right = (rank + 1) % size;
  std::string rhost;
  int rport;
  if (!parse_addr(addrs[right], &rhost, &rport)) {
    set_error("ring_init: bad right address " + addrs[right]);
    return -1;
  }
  struct addrinfo hints, *res = nullptr;
  std::memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%d", rport);
  if (getaddrinfo(rhost.c_str(), portstr, &hints, &res) != 0 || !res) {
    set_error("getaddrinfo failed for " + rhost);
    return -1;
  }
  // Rendezvous window (reference horovodrun --start-timeout), exported by
  // the launcher as HOROVOD_START_TIMEOUT.
  int start_timeout_s = 120;
  if (const char* st = getenv("HOROVOD_START_TIMEOUT")) {
    int v = atoi(st);
    if (v > 0) start_timeout_s = v;
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::seconds(start_timeout_s);
  while (true) {
    ring.right_fd = socket(AF_INET, SOCK_STREAM, 0);
    setsockopt(ring.right_fd, SOL_SOCKET, SO_SNDBUF, &bufsz, sizeof(bufsz));
    setsockopt(ring.right_fd, SOL_SOCKET, SO_RCVBUF, &bufsz, sizeof(bufsz));
    if (connect(ring.right_fd, res->ai_addr, res->ai_addrlen) == 0) break;
    close(ring.right_fd);
    ring.right_fd = -1;
    if (std::chrono::steady_clock::now() > deadline) {
      freeaddrinfo(res);
      set_error("connect to right neighbor timed out: " + addrs[right]);
      return -1;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
  freeaddrinfo(res);
  setsockopt(ring.right_fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));

  // Authenticate to the right neighbor.
  uint8_t token[36];
  uint32_t rank_be = htonl((uint32_t)rank);
  std::memcpy(token, &rank_be, 4);
  auth_token(ring, rank, token + 4);
  if (!send_all(ring.right_fd, token, sizeof(token))) return -1;

  // Accept + verify the left neighbor.
  int left = (rank - 1 + size) % size;
  ring.left_fd = accept(ring.listen_fd, nullptr, nullptr);
  if (ring.left_fd < 0) {
    set_error(std::string("accept: ") + strerror(errno));
    return -1;
  }
  setsockopt(ring.left_fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  uint8_t peer[36];
  if (!recv_all(ring.left_fd, peer, sizeof(peer))) return -1;
  uint32_t peer_rank_be;
  std::memcpy(&peer_rank_be, peer, 4);
  int peer_rank = (int)ntohl(peer_rank_be);
  uint8_t expect[32];
  auth_token(ring, peer_rank, expect);
  if (peer_rank != left || std::memcmp(peer + 4, expect, 32) != 0) {
    set_error("left-neighbor authentication failed");
    return -1;
  }

  // Non-blocking from here on: exchange() interleaves duplex progress via
  // poll, and a blocking send of a large segment against a neighbor doing
  // the same would deadlock once both socket buffers fill.
  for (int fd : {ring.left_fd, ring.right_fd}) {
    int flags = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  }
  return 0;
}

// Compressed-wire ring allreduce for f32 buffers: the same
// reduce-scatter + allgather schedule as the uncompressed path, but every
// hop's bytes travel as bf16/fp16/int8 while all arithmetic stays f32.
int ring_allreduce_wire_f32(Ring& ring, float* buf, long count, int average,
                            int wire, float* residual) {
  long nseg = ring.size;
  long base_len = count / nseg, rem = count % nseg;
  auto seg_off = [&](long s) { return s * base_len + (s < rem ? s : rem); };
  auto seg_len = [&](long s) { return base_len + (s < rem ? 1 : 0); };
  long max_len = base_len + (rem ? 1 : 0);
  size_t max_wire = wire_nbytes(max_len, wire);
  ring.wtx.resize(max_wire);
  ring.wrx.resize(max_wire);
  ring.wfwd.resize(max_wire);
  long ce = wire_chunk_elems(wire);
  // Widen staging is only ever used in kQuantBlock strides (see
  // wire_decompress's f16 path) — never a full transfer chunk.
  ring.wscratch.resize((size_t)kQuantBlock);

  // Phase 1: reduce-scatter. Outgoing chunks are cast/quantized AT SEND
  // TIME, one chunk ahead of the wire (CompressCursor); received wire
  // chunks widen and accumulate in f32 as they complete (WireSink). For
  // int8, every quantization error this rank introduces lands in
  // `residual` at the sent segment's offsets — phase 1 sends every
  // segment except our own, the phase-2 owner quantization covers that
  // one, so each element's error is written exactly once per call.
  for (int step = 0; step < ring.size - 1; step++) {
    long s_send = (ring.rank - step + ring.size) % ring.size;
    long s_recv = (ring.rank - step - 1 + ring.size) % ring.size;
    CompressCursor tx(buf + seg_off(s_send), seg_len(s_send), wire,
                      ring.wtx.data(),
                      residual ? residual + seg_off(s_send) : nullptr);
    WireSink sink{buf + seg_off(s_recv), seg_len(s_recv), wire,
                  ring.wrx.data(), /*acc=*/true, ring.wscratch.data(), ce};
    if (!exchange_w(ring, &tx, nullptr, 0, ring.wrx.data(),
                    wire_nbytes(seg_len(s_recv), wire), &sink))
      return -1;
    g_wire_tx_bytes[ring.link][wire] += (long long)tx.total;
    g_wire_logical_bytes[ring.link][wire] += 4ll * seg_len(s_send);
  }

  // Our own (fully reduced) segment: quantize it ONCE and keep the
  // dequantized value locally, so the bytes we ship in the allgather are
  // exactly what we hold — every rank ends bit-identical.
  long own = (ring.rank + 1) % ring.size;
  wire_compress(buf + seg_off(own), seg_len(own), wire, ring.wfwd.data(),
                residual ? residual + seg_off(own) : nullptr);
  wire_decompress(ring.wfwd.data(), seg_len(own), wire, buf + seg_off(own),
                  /*accumulate=*/false, ring.wscratch.data());

  // Phase 2: allgather of reduced segments, forwarding the received WIRE
  // bytes verbatim on the next hop. (bf16/f16 recompression would be
  // lossless — half -> f32 -> half round-trips exactly — but an int8
  // block whose max |q| < 127 would re-derive a different scale, so
  // relaying the exact bytes is both cheaper and the only correct
  // choice.) Received chunks decompress into the destination while later
  // bytes still stream.
  for (int step = 0; step < ring.size - 1; step++) {
    long s_send = (ring.rank + 1 - step + ring.size) % ring.size;
    long s_recv = (ring.rank - step + ring.size) % ring.size;
    size_t sn = wire_nbytes(seg_len(s_send), wire);
    size_t rn = wire_nbytes(seg_len(s_recv), wire);
    WireSink sink{buf + seg_off(s_recv), seg_len(s_recv), wire,
                  ring.wrx.data(), /*acc=*/false, ring.wscratch.data(), ce};
    if (!exchange_w(ring, nullptr, ring.wfwd.data(), sn, ring.wrx.data(), rn,
                    &sink))
      return -1;
    g_wire_tx_bytes[ring.link][wire] += (long long)sn;
    g_wire_logical_bytes[ring.link][wire] += 4ll * seg_len(s_send);
    std::swap(ring.wfwd, ring.wrx);  // this step's recv = next step's send
  }
  if (average) scale(buf, count, DT_F32, 1.0 / ring.size);
  return 0;
}

// In-place ring allreduce (sum; average divides afterwards for float
// types). ``wire_dtype`` (WIRE_*) compresses f32 payloads on the wire;
// WIRE_NONE (and every non-f32 dtype) keeps the pre-round-10 byte stream
// exactly. ``residual`` is the int8 error-feedback out-buffer (f32,
// ``count`` elements; see ring_allreduce_wire_f32).
int ring_allreduce(Ring& ring, void* buf, long count, int dtype, int average,
                   int wire_dtype = WIRE_NONE, void* residual = nullptr) {
  // Residual contract: when a caller hands an error-feedback buffer but
  // this call performs NO quantization (size 1, non-int8 wire, non-f32
  // dtype), the buffer is zeroed — a stale residual must never be carried
  // into the next round as if it were this round's error.
  bool quantizing = dtype == DT_F32 && wire_dtype == WIRE_I8 && ring.size > 1;
  if (residual && dtype == DT_F32 && !quantizing)
    std::memset(residual, 0, (size_t)count * 4);
  if (ring.size <= 1) return 0;
  size_t esz = dtype_size(dtype);
  if (esz == 0) {
    set_error("unsupported dtype");
    return -1;
  }
  if (dtype == DT_F32 && wire_dtype != WIRE_NONE &&
      wire_dtype >= 0 && wire_dtype <= WIRE_I8) {
    return ring_allreduce_wire_f32(
        ring, (float*)buf, count, average, wire_dtype,
        quantizing ? (float*)residual : nullptr);
  }
  char* base = (char*)buf;
  long nseg = ring.size;
  long base_len = count / nseg, rem = count % nseg;
  auto seg_off = [&](long s) { return s * base_len + (s < rem ? s : rem); };
  auto seg_len = [&](long s) { return base_len + (s < rem ? 1 : 0); };

  std::vector<char> tmp((size_t)(base_len + 1) * esz);

  // Phase 1: reduce-scatter. After size-1 steps, rank r owns the fully
  // reduced segment (r+1)%size. The ReduceSink accumulates received
  // chunks while later bytes still stream (pipelined, see exchange());
  // HOROVOD_RING_PIPELINE=0 restores the unpipelined exchange-then-reduce
  // sequence (measurement escape hatch, allreduce_bandwidth_r4.json).
  static const bool pipelined = [] {
    const char* e = getenv("HOROVOD_RING_PIPELINE");
    return !(e && e[0] == '0');
  }();
  for (int step = 0; step < ring.size - 1; step++) {
    long s_send = (ring.rank - step + ring.size) % ring.size;
    long s_recv = (ring.rank - step - 1 + ring.size) % ring.size;
    ReduceSink sink{base + seg_off(s_recv) * esz, dtype, esz};
    if (!exchange(ring, base + seg_off(s_send) * esz,
                  (size_t)seg_len(s_send) * esz, tmp.data(),
                  (size_t)seg_len(s_recv) * esz,
                  pipelined ? &sink : nullptr))
      return -1;
    g_wire_tx_bytes[ring.link][WIRE_NONE] +=
        (long long)seg_len(s_send) * (long long)esz;
    g_wire_logical_bytes[ring.link][WIRE_NONE] +=
        (long long)seg_len(s_send) * (long long)esz;
    if (!pipelined)
      accumulate(base + seg_off(s_recv) * esz, tmp.data(), seg_len(s_recv),
                 dtype);
  }
  // Phase 2: allgather of reduced segments.
  for (int step = 0; step < ring.size - 1; step++) {
    long s_send = (ring.rank + 1 - step + ring.size) % ring.size;
    long s_recv = (ring.rank - step + ring.size) % ring.size;
    if (!exchange(ring, base + seg_off(s_send) * esz,
                  (size_t)seg_len(s_send) * esz, base + seg_off(s_recv) * esz,
                  (size_t)seg_len(s_recv) * esz))
      return -1;
    g_wire_tx_bytes[ring.link][WIRE_NONE] +=
        (long long)seg_len(s_send) * (long long)esz;
    g_wire_logical_bytes[ring.link][WIRE_NONE] +=
        (long long)seg_len(s_send) * (long long)esz;
  }
  if (average) scale(buf, count, dtype, 1.0 / ring.size);
  return 0;
}

// Ring allgather with per-rank element counts (MPI_Allgatherv equivalent).
// out must hold sum(counts); own block is copied internally.
int ring_allgather(Ring& ring, const void* in, const long* counts, void* out,
                   int dtype) {
  size_t esz = dtype_size(dtype);
  if (esz == 0) {
    set_error("unsupported dtype");
    return -1;
  }
  std::vector<long> offs(ring.size + 1, 0);
  for (int r = 0; r < ring.size; r++) offs[r + 1] = offs[r] + counts[r];
  char* base = (char*)out;
  std::memcpy(base + offs[ring.rank] * esz, in,
              (size_t)counts[ring.rank] * esz);
  for (int step = 0; step < (ring.size > 1 ? ring.size - 1 : 0); step++) {
    long b_send = (ring.rank - step + ring.size) % ring.size;
    long b_recv = (ring.rank - step - 1 + ring.size) % ring.size;
    if (!exchange(ring, base + offs[b_send] * esz,
                  (size_t)counts[b_send] * esz, base + offs[b_recv] * esz,
                  (size_t)counts[b_recv] * esz))
      return -1;
  }
  return 0;
}

// Ring (pipeline) broadcast from root, in place.
int ring_broadcast(Ring& ring, void* buf, long count, int dtype, int root) {
  if (ring.size <= 1) return 0;
  size_t esz = dtype_size(dtype);
  if (esz == 0) {
    set_error("unsupported dtype");
    return -1;
  }
  size_t nbytes = (size_t)count * esz;
  int right = (ring.rank + 1) % ring.size;
  if (ring.rank == root) {
    return send_all(ring.right_fd, buf, nbytes) ? 0 : -1;
  }
  if (!recv_all(ring.left_fd, buf, nbytes)) return -1;
  if (right != root) {
    if (!send_all(ring.right_fd, buf, nbytes)) return -1;
  }
  return 0;
}

// The default (global) ring used by the legacy hvd_ring_* ABI — the native
// engine's single flat ring (engine.cc).
Ring g_ring;

}  // namespace

extern "C" {

const char* hvd_ring_last_error() { return g_error.c_str(); }

// --- legacy global-ring ABI (native engine path) ---------------------------

int hvd_ring_init(int rank, int size, const char* addrs_cstr,
                  const uint8_t* secret, int secret_len) {
  return ring_init(g_ring, rank, size, addrs_cstr, secret, secret_len);
}

int hvd_ring_allreduce(void* buf, long count, int dtype, int average) {
  return ring_allreduce(g_ring, buf, count, dtype, average);
}

// Wire-compressed variant (round 10): ``wire_dtype`` is a WireDType code
// (0 none, 1 bf16, 2 fp16, 3 int8); ``residual`` is the int8
// error-feedback out-buffer (f32 x count, nullable). The default-code
// path is byte-identical to hvd_ring_allreduce.
int hvd_ring_allreduce_wire(void* buf, long count, int dtype, int average,
                            int wire_dtype, void* residual) {
  return ring_allreduce(g_ring, buf, count, dtype, average, wire_dtype,
                        residual);
}

int hvd_ring_allgather(const void* in, const long* counts, void* out,
                       int dtype) {
  return ring_allgather(g_ring, in, counts, out, dtype);
}

int hvd_ring_broadcast(void* buf, long count, int dtype, int root) {
  return ring_broadcast(g_ring, buf, count, dtype, root);
}

// Raw neighbor I/O for the native engine's control token (engine.cc): the
// token and the fused ResponseList ride the same authenticated connections
// as the data phases, in strict alternation from the single engine thread.
int hvd_ring_send_right(const void* buf, long n) {
  return send_all(g_ring.right_fd, buf, (size_t)n) ? 0 : -1;
}

int hvd_ring_recv_left(void* buf, long n) {
  return recv_all(g_ring.left_fd, buf, (size_t)n) ? 0 : -1;
}

void hvd_ring_shutdown() { ring_close(g_ring); }

// --- handle-based ABI (Python controller; several rings per process) -------

void* hvd_ringh_create(int rank, int size, const char* addrs_cstr,
                       const uint8_t* secret, int secret_len) {
  Ring* ring = new Ring();
  if (ring_init(*ring, rank, size, addrs_cstr, secret, secret_len) != 0) {
    ring_close(*ring);
    delete ring;
    return nullptr;
  }
  return ring;
}

int hvd_ringh_allreduce(void* h, void* buf, long count, int dtype,
                        int average) {
  return ring_allreduce(*(Ring*)h, buf, count, dtype, average);
}

int hvd_ringh_allreduce_wire(void* h, void* buf, long count, int dtype,
                             int average, int wire_dtype, void* residual) {
  return ring_allreduce(*(Ring*)h, buf, count, dtype, average, wire_dtype,
                        residual);
}

int hvd_ringh_allgather(void* h, const void* in, const long* counts, void* out,
                        int dtype) {
  return ring_allgather(*(Ring*)h, in, counts, out, dtype);
}

int hvd_ringh_broadcast(void* h, void* buf, long count, int dtype, int root) {
  return ring_broadcast(*(Ring*)h, buf, count, dtype, root);
}

void hvd_ringh_destroy(void* h) {
  if (!h) return;
  ring_close(*(Ring*)h);
  delete (Ring*)h;
}

// --- dtype kernels shared with the /dev/shm local data plane (shm.cc) ------

void hvd_dtype_accumulate(void* dst, const void* src, long count, int dtype) {
  accumulate(dst, src, count, dtype);
}

// Scalar reference for the half-precision sum: the exact element-at-a-time
// loop the blocked/F16C path replaced. Kept as a test seam — parity tests
// assert the vector path is byte-identical, and the bandwidth artifact
// measures the speedup against it. Other dtypes fall through to the one
// shared implementation.
void hvd_dtype_accumulate_scalar(void* dst, const void* src, long count,
                                 int dtype) {
  if (dtype == DT_F16) {
    uint16_t* d = (uint16_t*)dst;
    const uint16_t* s = (const uint16_t*)src;
    for (long i = 0; i < count; i++)
      d[i] = f32_to_f16(f16_to_f32(d[i]) + f16_to_f32(s[i]));
    return;
  }
  if (dtype == DT_BF16) {
    uint16_t* d = (uint16_t*)dst;
    const uint16_t* s = (const uint16_t*)src;
    for (long i = 0; i < count; i++)
      d[i] = f32_to_bf16(bf16_to_f32(d[i]) + bf16_to_f32(s[i]));
    return;
  }
  accumulate(dst, src, count, dtype);
}

long hvd_dtype_size(int dtype) { return (long)dtype_size(dtype); }

void hvd_dtype_scale(void* buf, long count, int dtype, double factor) {
  scale(buf, count, dtype, factor);
}

// --- wire-compression config + stats (round 10) -----------------------------

// Transfer-chunk size for the reduce-while-receive sink and the
// compress-ahead cursor — per-rank pipelining granularity only (the int8
// wire format is anchored on fixed 4096-element quant blocks, so no
// cross-rank agreement is needed and the autotuner may retune this live).
// Rounded to a multiple of 8 so chunk boundaries stay element-aligned for
// every dtype; clamped to [16 KiB, 64 MiB].
void hvd_ring_set_chunk_bytes(long nbytes) {
  if (nbytes < 16 * 1024) nbytes = 16 * 1024;
  if (nbytes > 64l * 1024 * 1024) nbytes = 64l * 1024 * 1024;
  g_chunk_bytes.store(nbytes & ~7l, std::memory_order_relaxed);
}

long hvd_ring_get_chunk_bytes() { return chunk_bytes_now(); }

// Cumulative allreduce data-phase traffic by wire dtype (index =
// WireDType code 0..3), summed over link classes: actual bytes this rank
// handed to the kernel and the uncompressed-equivalent ("logical") bytes
// they carried, plus the total time spent in compress/decompress
// kernels. Python mirrors these into hvd_ring_wire_bytes_total{dtype,
// link} / hvd_ring_compress_seconds (per-link detail via
// hvd_ring_get_wire_stats_link).
void hvd_ring_get_wire_stats(long long* tx_bytes, long long* logical_bytes,
                             double* compress_s) {
  for (int i = 0; i < 4; i++) {
    long long tx = 0, logical = 0;
    for (int l = 0; l < kNumLinks; l++) {
      tx += g_wire_tx_bytes[l][i].load(std::memory_order_relaxed);
      logical += g_wire_logical_bytes[l][i].load(std::memory_order_relaxed);
    }
    tx_bytes[i] = tx;
    logical_bytes[i] = logical;
  }
  *compress_s = g_compress_ns.load(std::memory_order_relaxed) / 1e9;
}

// Per-link-class slice of the same counters (link = WireLink code 0..2:
// flat/local/cross). The two-level data plane accounts its local and
// cross hops separately, so the wire counters can PROVE "the cross hop
// carries int8 bytes while the local hop stays f32".
void hvd_ring_get_wire_stats_link(int link, long long* tx_bytes,
                                  long long* logical_bytes) {
  if (link < 0 || link >= kNumLinks) link = 0;
  for (int i = 0; i < 4; i++) {
    tx_bytes[i] = g_wire_tx_bytes[link][i].load(std::memory_order_relaxed);
    logical_bytes[i] =
        g_wire_logical_bytes[link][i].load(std::memory_order_relaxed);
  }
}

// Tag a handle-based ring with its link class (WireLink code) so its
// traffic lands in the right counter row. The flat default is 0; the
// engine/controller tag their hierarchical local/cross rings at init.
void hvd_ringh_set_link(void* h, int link) {
  ((Ring*)h)->link = (link >= 0 && link < kNumLinks) ? link : 0;
}

// Cap a handle-based ring's send rate (bytes/s; 0 restores unlimited).
// Emulation/measurement knob: the bandwidth probe uses it to model a
// slow cross-node link on a loopback test box (docs/wire-compression.md);
// production jobs leave it unset.
void hvd_ringh_set_rate(void* h, double bytes_per_s) {
  Ring* ring = (Ring*)h;
  ring->rate_Bps = bytes_per_s > 0.0 ? bytes_per_s : 0.0;
  ring->rate_tokens = 0.0;
  ring->rate_t = 0.0;
}

// Monotonic timestamp of the last byte any ring in this process moved
// (0.0 before any traffic). shm.cc's barrier uses it as a liveness signal
// so its timeout is idle-based, not a cap on a progressing cross phase.
double hvd_ring_progress_mono_s() {
  return g_last_progress.load(std::memory_order_relaxed);
}

// Register a shared-memory word that also receives progress timestamps —
// making ring liveness visible ACROSS the local group's processes. Pass
// nullptr to unregister (must happen before the segment unmaps).
void hvd_ring_set_progress_sink(void* addr) {
  g_progress_sink.store((std::atomic<double>*)addr,
                        std::memory_order_release);
}

}  // extern "C"
