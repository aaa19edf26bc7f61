// Native eager-tier engine: background coordinator thread, negotiation,
// Tensor Fusion, response cache with bitvector coordination, stall detection
// and the Chrome-trace timeline — the C++ runtime around the ring data plane.
//
// Reference: horovod/common/operations.cc — a singleton HorovodGlobalState
// owns a background thread (BackgroundThreadLoop, operations.cc:857) that
// ticks every cycle_time_ms (RunLoopOnce, operations.cc:1246), drains the
// request queue, negotiates globally-ready tensors, packs fusion groups
// (FuseResponses, operations.cc:450-573), executes collectives and fires
// completion callbacks; a bit-indexed response cache short-circuits repeat
// negotiations (operations.cc:1166-1381) and the coordinator warns/aborts on
// stalled ranks (operations.cc:688-769).
//
// Same machine, different transport: where the reference runs negotiation as
// MPI_Gatherv/Bcast among host processes and the data plane on MPI/NCCL,
// this engine circulates a control token around the authenticated TCP ring
// (ring.cc) — rank 0 starts a token carrying its RequestList + cache
// bitvectors, every rank appends its own, rank 0 receives the full set,
// negotiates, and sends the fused ResponseList around the same ring. Data
// phases then run as ring collectives in ResponseList order, which is
// identical on every rank (the invariant the negotiation establishes).
// Python half: horovod_tpu_torch/controller/native.py over the C ABI below
// (the reference exposes its C ABI the same way, operations.cc:1595-1650).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "message.h"
#include "response_cache.h"
#include "timeline.h"

#include "sha256.h"

// Ring data plane C ABI (ring.cc) + /dev/shm local data plane (shm.cc).
extern "C" {
void* hvd_shm_create(int local_rank, int local_size, const char* name,
                     long slot_bytes);
int hvd_shm_allreduce_g(void* h, void* buf, long count, int dtype);
int hvd_shm_broadcast_g(void* h, void* buf, long count, int dtype, int root);
int hvd_shm_allgather_g(void* h, const void* in, const long* counts,
                        void* out, int dtype);
void* hvd_shm_heartbeat_addr(void* h);
void hvd_shm_destroy(void* h);
const char* hvd_shm_last_error();
void hvd_ring_set_progress_sink(void* addr);
int hvd_ring_init(int rank, int size, const char* addrs, const uint8_t* secret,
                  int secret_len);
int hvd_ring_allreduce(void* buf, long count, int dtype, int average);
int hvd_ring_allreduce_wire(void* buf, long count, int dtype, int average,
                            int wire_dtype, void* residual);
int hvd_ring_allgather(const void* in, const long* counts, void* out,
                       int dtype);
int hvd_ring_broadcast(void* buf, long count, int dtype, int root);
int hvd_ring_send_right(const void* buf, long n);
int hvd_ring_recv_left(void* buf, long n);
void hvd_ring_shutdown();
const char* hvd_ring_last_error();
// Handle-based rings (several per process) for the two-level hierarchical
// data plane.
void* hvd_ringh_create(int rank, int size, const char* addrs,
                       const uint8_t* secret, int secret_len);
int hvd_ringh_allreduce(void* h, void* buf, long count, int dtype,
                        int average);
int hvd_ringh_allreduce_wire(void* h, void* buf, long count, int dtype,
                             int average, int wire_dtype, void* residual);
void hvd_ringh_set_link(void* h, int link);
int hvd_ringh_allgather(void* h, const void* in, const long* counts,
                        void* out, int dtype);
int hvd_ringh_broadcast(void* h, void* buf, long count, int dtype, int root);
void hvd_ringh_destroy(void* h);
}

namespace hvd {

// numpy-style names for ring.cc DType codes (error-message parity with the
// Python controller's construct_response).
std::string dtype_name(uint8_t code) {
  switch (code) {
    case 0: return "float32";
    case 1: return "float64";
    case 2: return "int32";
    case 3: return "int64";
    case 4: return "uint8";
    case 5: return "float16";
    case 6: return "bfloat16";
    case 7: return "int8";
    case 8: return "int16";
    case 9: return "uint16";
    case 10: return "bool";
  }
  return "dtype#" + std::to_string((int)code);
}

namespace {

size_t dtype_size(uint8_t dt) {
  // Must mirror ring.cc's DType enum (codes are the ctypes ABI).
  switch (dt) {
    case 0: case 2: return 4;               // f32, i32
    case 1: case 3: return 8;               // f64, i64
    case 4: case 7: case 10: return 1;      // u8, i8, bool
    case 5: case 6: case 8: case 9: return 2;  // f16, bf16, i16, u16
  }
  return 0;
}

double mono_s() {
  return std::chrono::duration_cast<std::chrono::duration<double>>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

constexpr const char* kShutdownMsg = "Horovod has been shut down";

const char* op_name(uint8_t t) {
  switch (t) {
    case RESP_ALLREDUCE: return "ALLREDUCE";
    case RESP_ALLGATHER: return "ALLGATHER";
    case RESP_BROADCAST: return "BROADCAST";
  }
  return "ERROR";
}

// Async-op handle slot (reference torch/handle_manager.h:31-42).
struct HandleSlot {
  int status = 0;  // 0 pending, 1 ok, 2 error
  std::string error;
  uint8_t dtype = 0;
  // Result landed in the caller's own buffer (allreduce/broadcast): data
  // stays empty and the Python side returns the array it enqueued.
  bool in_place = false;
  std::vector<int64_t> shape;
  std::vector<uint8_t> data;
  // Allgather only: every rank's first-dim size from the negotiated
  // Response, so the API layer can locate a rank's slice without a second
  // sizes collective (the reference surfaces the same via TensorShape,
  // torch/adapter_v2.cc:91-102).
  std::vector<int64_t> tensor_sizes;
};

// Tensor-table entry (reference TensorTableEntry, common/common.h:167-184).
// ZERO-COPY CONTRACT: `user` points at the caller-owned buffer passed to
// enqueue. The caller (native.py keeps the numpy array referenced on the
// handle) guarantees it stays alive and un-mutated until the handle
// resolves; the engine reads from it and — for allreduce/broadcast —
// writes the result back into it, the way the reference reduces in place
// on framework-owned memory (mpi_operations.cc:40-49, torch
// _handle_map keeping tensors alive, torch/mpi_ops.py:54).
struct Entry {
  Request request;
  uint8_t* user = nullptr;
  size_t nbytes = 0;
  long long handle = -1;
  // int8 wire error-feedback out-buffer (f32 x element count, caller-owned
  // and pinned like `user`; nullable). The ring writes the quantization
  // error of this tensor's bytes here; controller/native.py carries it
  // into the next allreduce.
  float* residual = nullptr;
  // Trace stamps (monotonic seconds): user call time, and the moment the
  // request departed in a tick — taken POST-send like the Python
  // controller's, so a rank whose sends stall is the rank that looks
  // late. sent_at < 0 = never departed (cache-bypass ops).
  double enqueued_at = 0;
  double sent_at = -1;
};

struct Tick {
  int32_t rank = 0;
  bool shutdown = false;
  std::vector<uint64_t> cache_words;
  std::vector<uint64_t> invalid_words;
  std::vector<Request> requests;
};

struct Reply {
  bool shutdown = false;
  std::vector<uint64_t> bypass_words;
  std::vector<uint64_t> invalid_words;
  ResponseList responses;
  // Base collective sequence id for this cycle (trace correlation): each
  // rank derives per-op ids by walking the identical bypass+responses
  // order, exactly like the Python controller's reply["trace_seq"].
  long long trace_seq = 0;
  // Autotuned gradient-bucket size, pushed by rank 0's tune loop and
  // synced to every rank on the cycle reply (0 = no value yet) — the
  // token slot the round-13 python-engine tune sync left open.
  long long bucket_bytes = 0;
};

void write_tick(Writer& w, const Tick& t) {
  w.i32(t.rank);
  w.u8(t.shutdown ? 1 : 0);
  w.u64vec(t.cache_words);
  w.u64vec(t.invalid_words);
  w.u32((uint32_t)t.requests.size());
  for (const auto& r : t.requests) write_request(w, r);
}

Tick read_tick(Reader& r) {
  Tick t;
  t.rank = r.i32();
  t.shutdown = r.u8() != 0;
  t.cache_words = r.u64vec();
  t.invalid_words = r.u64vec();
  uint32_t n = r.u32();
  for (uint32_t i = 0; i < n && r.ok; i++) t.requests.push_back(read_request(r));
  return t;
}

void write_reply(Writer& w, const Reply& rep) {
  w.u8(rep.shutdown ? 1 : 0);
  w.u64vec(rep.bypass_words);
  w.u64vec(rep.invalid_words);
  w.i64(rep.trace_seq);
  w.i64(rep.bucket_bytes);
  w.u32((uint32_t)rep.responses.responses.size());
  for (const auto& resp : rep.responses.responses) write_response(w, resp);
}

Reply read_reply(Reader& r) {
  Reply rep;
  rep.shutdown = r.u8() != 0;
  rep.bypass_words = r.u64vec();
  rep.invalid_words = r.u64vec();
  rep.trace_seq = r.i64();
  rep.bucket_bytes = r.i64();
  uint32_t n = r.u32();
  for (uint32_t i = 0; i < n && r.ok; i++)
    rep.responses.responses.push_back(read_response(r));
  rep.responses.shutdown = rep.shutdown;
  return rep;
}

class EngineError : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};

// ------------------------------------------------------------- telemetry
// Native half of the five-layer observability stack (docs/observability.md):
// per-op trace spans in a fixed-capacity ring behind ONE atomic enabled
// flag (zero-overhead-off, the r8 cached-boolean contract in C), plus
// always-on cumulative counters and log-spaced time histograms, all
// drained over the C ABI (hvd_eng_get_spans / hvd_eng_get_counters) by
// controller/native.py into the TraceWriter and metrics registry.

// Phase codes: MUST stay index-aligned with trace/tracer.py PHASES
// ("enqueue", "negotiate", "fuse", "execute", "done") — the Python drain
// maps code -> PHASES[code] and the vocabulary is lint-frozen.
enum SpanPhase : int {
  PH_ENQUEUE = 0,
  PH_NEGOTIATE = 1,
  PH_FUSE = 2,
  PH_EXECUTE = 3,
  PH_DONE = 4,
};

constexpr size_t kSpanOpBytes = 64;  // truncated tensor/fused-op name

struct Span {
  double t0 = 0, t1 = 0;  // CLOCK_MONOTONIC seconds (time.monotonic()'s
                          // clock — steady_clock on this platform), so the
                          // Python TraceWriter's monotonic anchor applies.
  long long seq = -1;     // coordinator-assigned collective seq (-1 none)
  int32_t phase = 0;      // SpanPhase
  int32_t tensors = 0;    // fuse spans: entries packed into the fused op
  char op[kSpanOpBytes] = {0};
};

// Histogram bucket upper bounds: EXACTLY the registry's
// DEFAULT_TIME_BUCKETS (metrics/registry.py: 1e-4 * 2^i, i in 0..21) so
// the Python mirror ingests bucket counts verbatim — no re-binning.
constexpr int kHistBuckets = 22;
constexpr int kHistSlots = kHistBuckets + 1;  // + the +Inf overflow slot

struct TimeHist {
  long long counts[kHistSlots] = {0};
  long long count = 0;
  long long sum_us = 0;

  void observe(double seconds) {
    int i = 0;
    double edge = 1e-4;
    while (i < kHistBuckets && seconds > edge) {
      edge *= 2.0;
      i++;
    }
    counts[i]++;
    count++;
    sum_us += (long long)(seconds * 1e6);
  }
};

// Counter-slot layout for hvd_eng_get_counters: APPEND-ONLY, mirrored by
// NATIVE_COUNTER_SCALARS / N_NATIVE_COUNTER_SLOTS in core/bindings.py (a
// drift fails tests/test_torch_native_engine.py).
enum CounterSlot : int {
  CTR_CYCLES = 0,
  CTR_TENSORS = 1,
  CTR_FUSED_TENSORS = 2,
  CTR_PROCESSED_BYTES = 3,
  CTR_FUSION_CAPACITY = 4,
  CTR_FUSION_FILL = 5,
  CTR_SPANS = 6,
  CTR_SPANS_DROPPED = 7,
  CTR_BUCKET_BYTES = 8,
  CTR_CACHE_HITS = 9,
  CTR_CACHE_MISSES = 10,
  // Pipelined data plane (round 16): high-water count of fused groups
  // outstanding on the wire thread, cumulative µs the engine thread spent
  // blocked on the wire (no free fusion slot / draining before a control
  // frame), and cycles whose response order was changed by a priority tag.
  CTR_PIPELINE_DEPTH = 11,
  CTR_PIPELINE_STALL_US = 12,
  CTR_PRIORITY_JUMPS = 13,
  CTR_CYCLE_HIST_COUNT = 14,
  CTR_CYCLE_HIST_SUM_US = 15,
  CTR_CYCLE_HIST_BUCKETS = 16,                           // .. +kHistSlots
  CTR_EXEC_HIST_COUNT = CTR_CYCLE_HIST_BUCKETS + kHistSlots,
  CTR_EXEC_HIST_SUM_US = CTR_EXEC_HIST_COUNT + 1,
  CTR_EXEC_HIST_BUCKETS = CTR_EXEC_HIST_SUM_US + 1,      // .. +kHistSlots
  // Engine generation (bumped per hvd_eng_init): counters restart at
  // zero with every new engine, so the Python mirror re-baselines when
  // it sees a new generation instead of clamping on "decreasing" totals.
  CTR_ENGINE_GEN = CTR_EXEC_HIST_BUCKETS + kHistSlots,
  N_COUNTER_SLOTS = CTR_ENGINE_GEN + 1,                  // 65
};

constexpr size_t kSpanRingDefault = 1 << 16;
constexpr size_t kSpanRingMin = 256;
constexpr size_t kSpanRingMax = 1 << 20;

// Two-level (hierarchical) data-plane state, populated by hvd_eng_init
// BEFORE the Engine is constructed (the engine thread starts in the ctor,
// so the rings must exist first). Analogue of the reference's
// NCCLHierarchicalAllreduce comm pair (nccl_operations.cc:167-363).
struct HierState {
  void* local_ring = nullptr;  // TCP ring inside this node (shm fallback)
  void* cross_ring = nullptr;  // ring of local roots (local_rank 0 only)
  void* shm = nullptr;         // /dev/shm local group (preferred local plane)
  int local_rank = 0, local_size = 1, cross_rank = 0, cross_size = 1;
  bool allreduce = false, allgather = false;
  // Per-link wire dtypes (WireDType codes) for the two-level allreduce
  // data plane: independent knobs for the local and cross hops
  // (HOROVOD_RING_WIRE_DTYPE_LOCAL/_CROSS via common/config.py, defaults
  // by link class). wire_local is ignored when the local plane is the
  // /dev/shm segment — memcpys through one mapping have no wire.
  int wire_local = 0, wire_cross = 0;
};
HierState g_hier;

// The engine singleton (reference HorovodGlobalState, global_state.h:44).
class Engine {
 public:
  Engine(int rank, int size, double cycle_ms, long long fusion_threshold,
         int cache_capacity, bool stall_disable, double stall_warn_s,
         double stall_shutdown_s, const std::string& timeline_path,
         bool timeline_mark_cycles, int wire_dtype, bool pipeline)
      : rank_(rank),
        size_(size),
        cycle_ms_(cycle_ms),
        fusion_threshold_(fusion_threshold),
        stall_disable_(stall_disable),
        stall_warn_s_(stall_warn_s),
        stall_shutdown_s_(stall_shutdown_s),
        wire_dtype_(wire_dtype),
        cache_(cache_capacity),
        hier_(g_hier) {
    // Pipelining covers the flat ring's allreduce path only: the two-level
    // plane's shared cross-hop scratch and multi-ring calls stay serial
    // (allgather/broadcast always drain first — see execute()).
    pipeline_ =
        pipeline && !(hier_.allreduce && (hier_.local_ring || hier_.shm));
    // Test-only determinism hook: per-job wire-thread sleep so a size-1
    // fake ring exhibits measurable fill-while-on-wire overlap.
    const char* delay = getenv("HOROVOD_PIPELINE_TEST_DELAY_US");
    if (delay && *delay) test_delay_us_ = atoll(delay);
    if (!timeline_path.empty() && rank == 0)
      timeline_ = std::make_unique<Timeline>(timeline_path,
                                             timeline_mark_cycles);
    if (pipeline_) wire_thread_ = std::thread([this] { wire_loop(); });
    thread_ = std::thread([this] { run_loop(); });
  }

  ~Engine() {
    request_shutdown();
    if (thread_.joinable()) thread_.join();
    if (timeline_) timeline_->close();
  }

  // ------------------------------------------------------- enqueue (any thread)

  // Returns handle >= 0; -2 duplicate name; -3 shut down.
  long long enqueue(uint8_t op, const std::string& name, void* data,
                    const int64_t* shape, int ndim, uint8_t dtype,
                    int32_t root_rank, void* residual, int32_t priority) {
    std::lock_guard<std::mutex> g(mu_);
    if (closed_ || shutdown_requested_) return -3;
    if (table_.count(name)) return -2;  // reference IncrementTensorCount dup
    Entry e;
    e.enqueued_at = mono_s();
    e.residual = (float*)residual;
    e.request.request_rank = rank_;
    e.request.request_type = op;
    e.request.dtype = dtype;
    e.request.root_rank = root_rank;
    e.request.priority = priority;
    e.request.shape.assign(shape, shape + ndim);
    e.request.tensor_name = name;
    size_t count = 1;
    for (int i = 0; i < ndim; i++) count *= (size_t)shape[i];
    e.nbytes = count * dtype_size(dtype);
    e.user = (uint8_t*)data;  // zero-copy: see Entry's contract note
    long long h = next_handle_++;
    e.handle = h;
    handles_.emplace(h, HandleSlot{});
    table_.emplace(name, std::move(e));
    queue_.push_back(name);
    return h;
  }

  // -------------------------------------------------------- handles (any thread)

  int poll(long long h) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = handles_.find(h);
    if (it == handles_.end()) return -1;
    return it->second.status;
  }

  int wait(long long h) {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      auto it = handles_.find(h);
      if (it == handles_.end()) return -1;
      if (it->second.status != 0) return it->second.status == 1 ? 0 : 1;
      handle_cv_.wait(lk);
    }
  }

  // 0 ok, 1 error, -1 unknown handle, -2 timed out.
  int wait_for(long long h, double timeout_s) {
    std::unique_lock<std::mutex> lk(mu_);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::duration<double>(timeout_s);
    for (;;) {
      auto it = handles_.find(h);
      if (it == handles_.end()) return -1;
      if (it->second.status != 0) return it->second.status == 1 ? 0 : 1;
      if (handle_cv_.wait_until(lk, deadline) == std::cv_status::timeout) {
        auto it2 = handles_.find(h);
        if (it2 != handles_.end() && it2->second.status != 0)
          return it2->second.status == 1 ? 0 : 1;
        return -2;
      }
    }
  }

  HandleSlot* slot(long long h) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = handles_.find(h);
    return it == handles_.end() ? nullptr : &it->second;
  }

  void release(long long h) {
    std::lock_guard<std::mutex> g(mu_);
    handles_.erase(h);
  }

  void set_params(long long fusion_threshold, double cycle_ms) {
    if (fusion_threshold > 0) fusion_threshold_ = fusion_threshold;
    if (cycle_ms > 0) cycle_ms_ = cycle_ms;
  }

  void get_stats(long long* cycles, long long* bytes, double* busy_s) {
    *cycles = cycles_.load();
    *bytes = processed_bytes_.load();
    *busy_s = busy_us_.load() / 1e6;
  }

  // --------------------------------------------------- telemetry (any thread)

  void trace_set(bool enabled, long long capacity) {
    std::lock_guard<std::mutex> g(tele_mu_);
    if (capacity > 0) {
      size_t cap = (size_t)std::min<long long>(
          std::max<long long>(capacity, (long long)kSpanRingMin),
          (long long)kSpanRingMax);
      ring_.assign(cap, Span{});
      ring_head_ = ring_size_ = 0;
    } else if (ring_.empty()) {
      ring_.assign(kSpanRingDefault, Span{});
    }
    trace_on_.store(enabled, std::memory_order_relaxed);
  }

  // One complete span into the ring. THE zero-overhead-off contract: with
  // tracing disabled this is a single relaxed atomic load and a return —
  // nothing else (pinned by the source guard + measured probe in
  // tests/test_native_telemetry.py).
  void stamp_span(int phase, double t0, double t1, long long seq,
                  int tensors, const char* op) {
    if (!trace_on_.load(std::memory_order_relaxed)) return;
    std::lock_guard<std::mutex> g(tele_mu_);
    if (ring_.empty()) return;
    size_t cap = ring_.size();
    size_t pos;
    if (ring_size_ == cap) {
      // Full: the NEW span takes the oldest slot (head advances) and the
      // drop is counted — the engine thread never blocks on a slow
      // drainer and a record is never torn.
      pos = ring_head_;
      ring_head_ = (ring_head_ + 1) % cap;
      spans_dropped_.fetch_add(1, std::memory_order_relaxed);
    } else {
      pos = (ring_head_ + ring_size_) % cap;
      ring_size_++;
    }
    Span& s = ring_[pos];
    s.t0 = t0;
    s.t1 = t1;
    s.seq = seq;
    s.phase = phase;
    s.tensors = tensors;
    std::strncpy(s.op, op ? op : "", kSpanOpBytes - 1);
    s.op[kSpanOpBytes - 1] = 0;
    spans_total_.fetch_add(1, std::memory_order_relaxed);
  }

  // Drain up to `max` spans, oldest first; returns the count consumed.
  int drain_spans(long long max, int32_t* phases, long long* seqs,
                  double* t0s, double* t1s, int32_t* tensors, char* ops,
                  int op_stride) {
    std::lock_guard<std::mutex> g(tele_mu_);
    if (ring_.empty() || max <= 0) return 0;
    long long n = std::min<long long>(max, (long long)ring_size_);
    for (long long i = 0; i < n; i++) {
      const Span& s = ring_[(ring_head_ + (size_t)i) % ring_.size()];
      phases[i] = s.phase;
      seqs[i] = s.seq;
      t0s[i] = s.t0;
      t1s[i] = s.t1;
      tensors[i] = s.tensors;
      std::strncpy(ops + (size_t)i * (size_t)op_stride, s.op,
                   (size_t)op_stride - 1);
      ops[(size_t)i * (size_t)op_stride + (size_t)op_stride - 1] = 0;
    }
    ring_head_ = (ring_head_ + (size_t)n) % ring_.size();
    ring_size_ -= (size_t)n;
    return (int)n;
  }

  void get_counters(long long* out, int n) {
    long long tmp[N_COUNTER_SLOTS] = {0};
    tmp[CTR_CYCLES] = cycles_.load(std::memory_order_relaxed);
    tmp[CTR_TENSORS] = tensors_total_.load(std::memory_order_relaxed);
    tmp[CTR_FUSED_TENSORS] = fused_tensors_.load(std::memory_order_relaxed);
    tmp[CTR_PROCESSED_BYTES] =
        processed_bytes_.load(std::memory_order_relaxed);
    tmp[CTR_FUSION_CAPACITY] = fusion_cap_.load(std::memory_order_relaxed);
    tmp[CTR_FUSION_FILL] = fusion_fill_.load(std::memory_order_relaxed);
    tmp[CTR_SPANS] = spans_total_.load(std::memory_order_relaxed);
    tmp[CTR_SPANS_DROPPED] =
        spans_dropped_.load(std::memory_order_relaxed);
    tmp[CTR_BUCKET_BYTES] = bucket_synced_.load(std::memory_order_relaxed);
    tmp[CTR_CACHE_HITS] = cache_hits_.load(std::memory_order_relaxed);
    tmp[CTR_CACHE_MISSES] = cache_misses_.load(std::memory_order_relaxed);
    tmp[CTR_PIPELINE_DEPTH] =
        pipeline_depth_.load(std::memory_order_relaxed);
    tmp[CTR_PIPELINE_STALL_US] =
        pipeline_stall_us_.load(std::memory_order_relaxed);
    tmp[CTR_PRIORITY_JUMPS] =
        priority_jumps_.load(std::memory_order_relaxed);
    {
      std::lock_guard<std::mutex> g(tele_mu_);
      tmp[CTR_CYCLE_HIST_COUNT] = cycle_hist_.count;
      tmp[CTR_CYCLE_HIST_SUM_US] = cycle_hist_.sum_us;
      for (int i = 0; i < kHistSlots; i++)
        tmp[CTR_CYCLE_HIST_BUCKETS + i] = cycle_hist_.counts[i];
      tmp[CTR_EXEC_HIST_COUNT] = exec_hist_.count;
      tmp[CTR_EXEC_HIST_SUM_US] = exec_hist_.sum_us;
      for (int i = 0; i < kHistSlots; i++)
        tmp[CTR_EXEC_HIST_BUCKETS + i] = exec_hist_.counts[i];
    }
    for (int i = 0; i < n && i < N_COUNTER_SLOTS; i++) out[i] = tmp[i];
  }

  // Coordinator-side tuned-bucket slot: the value rides the NEXT cycle
  // reply to every rank (coordinate() reads it). Harmless on workers.
  void set_tuned_bucket(long long nbytes) {
    bucket_push_.store(nbytes, std::memory_order_relaxed);
  }

  // Micro-bench for the overhead guard: stamp n spans through the real
  // path (enabled or disabled — whatever trace_set left), return seconds.
  double span_probe(long long n) {
    double t0 = mono_s();
    for (long long i = 0; i < n; i++)
      stamp_span(PH_EXECUTE, t0, t0, -1, 0, "probe");
    return mono_s() - t0;
  }

  void request_shutdown() { shutdown_requested_ = true; }
  bool closed() {
    std::lock_guard<std::mutex> g(mu_);
    return closed_;
  }

  // Cooperative teardown: flag the shutdown, wait for the loop to exit
  // (the flag must circulate so every rank closes on the same cycle), then
  // release the bulk memory. The Engine object itself stays alive — see the
  // note at hvd_eng_shutdown.
  void finish() {
    request_shutdown();
    if (thread_.joinable()) thread_.join();
    if (timeline_) timeline_->close();
    std::lock_guard<std::mutex> g(mu_);
    fusion_buffer_.clear();
    fusion_buffer_.shrink_to_fit();
    for (FusionSlot& s : slots_) {
      s.buf.clear();
      s.buf.shrink_to_fit();
      s.residual.clear();
      s.residual.shrink_to_fit();
    }
    finished_ = true;
  }

  bool finished() {
    std::lock_guard<std::mutex> g(mu_);
    return finished_;
  }

  // True when the two-level data plane is active (test/introspection seam;
  // the Python controller exposes its rings the same way).
  bool hier_active() const {
    return (hier_.local_ring != nullptr || hier_.shm != nullptr) &&
           (hier_.allreduce || hier_.allgather);
  }

 private:
  // ------------------------------------------------------------- cycle loop

  void run_loop() {
    try {
      while (true) {
        {
          std::lock_guard<std::mutex> g(mu_);
          if (closed_) break;
        }
        if (rank_ == 0) {
          // The coordinator paces the token (reference sleeps cycle_time in
          // every rank's loop, operations.cc:1250-1255; workers here are
          // paced by token arrival instead). With pipelining the pacing
          // window runs CONCURRENTLY with the wire drain: last cycle's
          // fused groups keep moving on the wire thread while this thread
          // reaps/copies out, and only drain time past the pacing deadline
          // counts as a pipeline stall.
          double deadline = mono_s() + cycle_ms_.load() / 1000.0;
          if (pipeline_) reap_wire(/*wait_all=*/true, deadline);
          double remain = deadline - mono_s();
          if (remain > 0)
            std::this_thread::sleep_for(
                std::chrono::duration<double>(remain));
        }
        double t0 = mono_s();
        if (timeline_) timeline_->mark_cycle_start();
        cycle();
        double dt = mono_s() - t0;
        busy_us_ += (long long)(dt * 1e6);
        {
          std::lock_guard<std::mutex> g(tele_mu_);
          cycle_hist_.observe(dt);
        }
        cycles_++;
      }
    } catch (const std::exception& exc) {
      std::fprintf(stderr, "[hvd-native:%d] engine loop failed: %s\n", rank_,
                   exc.what());
      fail_all_and_close(exc.what());
    }
    if (size_ > 1) hvd_ring_shutdown();
    if (hier_.local_ring) hvd_ringh_destroy(hier_.local_ring);
    if (hier_.cross_ring) hvd_ringh_destroy(hier_.cross_ring);
    // Unregister the heartbeat sink BEFORE unmapping the segment it
    // points into (all ring traffic has stopped; no racing writer).
    if (hier_.shm) {
      hvd_ring_set_progress_sink(nullptr);
      hvd_shm_destroy(hier_.shm);
    }
    hier_.local_ring = hier_.cross_ring = hier_.shm = nullptr;
    if (timeline_) timeline_->close();
  }

  Tick build_tick(std::vector<std::string>* sent_names) {
    std::lock_guard<std::mutex> g(mu_);
    Tick t;
    t.rank = rank_;
    t.shutdown = shutdown_requested_;
    BitMask cache_mask(cache_.capacity());
    BitMask invalid_mask(cache_.capacity());
    for (const std::string& name : queue_) {
      auto& entry = table_.at(name);
      int bit = cache_.lookup(entry.request);
      if (bit >= 0) {
        bit_pending_[bit] = name;
        continue;
      }
      int stale = cache_.stale_bit(entry.request);
      if (stale >= 0) invalid_mask.set(stale);
      t.requests.push_back(entry.request);
      sent_names->push_back(name);
    }
    queue_.clear();
    for (const auto& kv : bit_pending_) cache_mask.set(kv.first);
    t.cache_words = cache_mask.words();
    t.invalid_words = invalid_mask.words();
    return t;
  }

  // Stamp the departure time of this cycle's requests AFTER their tick
  // left (send-path stalls charge the sender — the Python controller's
  // POST-send contract). Only runs with tracing on.
  void mark_sent(const std::vector<std::string>& names) {
    double now = mono_s();
    std::lock_guard<std::mutex> g(mu_);
    for (const auto& name : names) {
      auto it = table_.find(name);
      if (it != table_.end()) it->second.sent_at = now;
    }
  }

  void cycle() {
    // The wire thread shares the ring sockets with the control plane: a
    // rank must fully drain its wire queue before reading a control frame
    // (interleaved reads would corrupt both streams). All ranks drain in
    // the identical FIFO order, so every queued collective's peer traffic
    // is guaranteed to flow before anyone touches control I/O. Rank 0
    // drained inside the pacing window (run_loop) instead.
    if (pipeline_ && rank_ != 0) reap_wire(/*wait_all=*/true);
    std::vector<std::string> sent_names;
    Tick own = build_tick(&sent_names);
    bool tr = trace_on_.load(std::memory_order_relaxed);
    Reply reply;
    if (size_ == 1) {
      if (tr && !sent_names.empty()) mark_sent(sent_names);
      reply = coordinate({own});
    } else if (rank_ == 0) {
      // Start the token with our tick; receive it back with everyone's.
      Writer w;
      w.u32(1);
      write_tick(w, own);
      send_frame(w.buf);
      if (tr && !sent_names.empty()) mark_sent(sent_names);
      std::vector<uint8_t> token = recv_frame();
      Reader r(token.data(), token.size());
      uint32_t n = r.u32();
      std::vector<Tick> ticks;
      for (uint32_t i = 0; i < n && r.ok; i++) ticks.push_back(read_tick(r));
      if (!r.ok || ticks.size() != (size_t)size_)
        throw EngineError("malformed control token");
      std::sort(ticks.begin(), ticks.end(),
                [](const Tick& a, const Tick& b) { return a.rank < b.rank; });
      reply = coordinate(ticks);
      Writer rw;
      write_reply(rw, reply);
      send_frame(rw.buf);
    } else {
      // Append our tick to the token and pass it on.
      std::vector<uint8_t> token = recv_frame();
      Reader r(token.data(), token.size());
      uint32_t n = r.u32();
      Writer w;
      w.u32(n + 1);
      w.buf.insert(w.buf.end(), token.begin() + 4, token.end());
      write_tick(w, own);
      send_frame(w.buf);
      if (tr && !sent_names.empty()) mark_sent(sent_names);
      // Receive the reply; forward before processing so downstream ranks
      // enter the data phase too.
      std::vector<uint8_t> raw = recv_frame();
      if ((rank_ + 1) % size_ != 0) send_frame(raw);
      Reader rr(raw.data(), raw.size());
      reply = read_reply(rr);
      if (!rr.ok) throw EngineError("malformed control reply");
    }
    process_reply(reply);
  }

  // --------------------------------------------------------- control frames
  //
  // Frame-kind coverage vs the 7-kind SPEC in analysis/protocol.py,
  // checked statically by `protocheck --native` (analysis/cpp.py). The
  // native engine's control plane is raw length-prefixed replies on the
  // coordinator wires — it does not yet speak the kind-byte protocol, so
  // every kind beyond the data plane is declared unsupported here rather
  // than silently dropped (ROADMAP item 1 is the work that flips these
  // to handled).
  //
  // hvdabi:frame-kind kind=data status=handled via=recv_frame
  // hvdabi:frame-kind kind=heartbeat status=unsupported reason=python-engine-only
  // hvdabi:frame-kind kind=abort status=unsupported reason=python-engine-only
  // hvdabi:frame-kind kind=join status=unsupported reason=python-engine-only
  // hvdabi:frame-kind kind=reshape status=unsupported reason=python-engine-only
  // hvdabi:frame-kind kind=shard_fetch status=unsupported reason=python-engine-only
  // hvdabi:frame-kind kind=shard_data status=unsupported reason=python-engine-only

  void send_frame(const std::vector<uint8_t>& payload) {
    uint32_t len = (uint32_t)payload.size();
    if (hvd_ring_send_right(&len, 4) != 0 ||
        hvd_ring_send_right(payload.data(), (long)payload.size()) != 0)
      throw EngineError(std::string("control send failed: ") +
                        hvd_ring_last_error());
  }

  std::vector<uint8_t> recv_frame() {
    uint32_t len = 0;
    if (hvd_ring_recv_left(&len, 4) != 0)
      throw EngineError(std::string("control recv failed: ") +
                        hvd_ring_last_error());
    if (len > (1u << 28)) throw EngineError("oversized control frame");
    std::vector<uint8_t> payload(len);
    if (len && hvd_ring_recv_left(payload.data(), (long)len) != 0)
      throw EngineError(std::string("control recv failed: ") +
                        hvd_ring_last_error());
    return payload;
  }

  // ------------------------------------------------------- coordinator side

  Reply coordinate(const std::vector<Tick>& ticks) {
    Reply reply;
    BitMask and_mask(ticks[0].cache_words.empty()
                         ? BitMask(cache_.capacity())
                         : BitMask(ticks[0].cache_words));
    BitMask invalid(cache_.capacity());
    for (const auto& t : ticks) {
      reply.shutdown = reply.shutdown || t.shutdown;
      invalid.or_with(BitMask(t.invalid_words));
      and_mask.and_with(BitMask(t.cache_words));
    }
    and_mask.and_not(invalid);

    // Negotiation (reference operations.cc:1388-1475): accumulate per-tensor
    // requests; a tensor is ready when every rank reported it.
    double now = mono_s();
    std::vector<Response> ready;
    for (const auto& t : ticks) {
      for (const auto& req : t.requests) {
        auto& entry = message_table_[req.tensor_name];
        if (entry.empty()) {
          first_seen_[req.tensor_name] = now;
          if (timeline_)
            timeline_->negotiate_start(req.tensor_name,
                                       op_name(req.request_type));
        }
        if (timeline_)
          timeline_->negotiate_rank_ready(req.tensor_name, t.rank);
        entry[t.rank] = req;
      }
    }
    for (auto it = message_table_.begin(); it != message_table_.end();) {
      if ((int)it->second.size() == size_) {
        std::vector<Request> requests;
        for (int r = 0; r < size_; r++) requests.push_back(it->second[r]);
        ready.push_back(construct_response(requests, size_));
        if (timeline_)
          timeline_->negotiate_end(it->first,
                                   op_name(requests[0].request_type));
        first_seen_.erase(it->first);
        stall_warned_.erase(it->first);
        it = message_table_.erase(it);
      } else {
        ++it;
      }
    }

    check_stalls(now);
    reply.responses.responses = fuse_responses(std::move(ready));
    prioritize_responses(reply.responses.responses);
    reply.responses.shutdown = reply.shutdown;
    reply.bypass_words = and_mask.words();
    reply.invalid_words = invalid.words();
    // One base collective seq id per cycle (the r9 tracer's correlation
    // key): every rank walks the identical bypass-then-responses order,
    // so base + index is the same id on every rank's trace row.
    reply.trace_seq = next_seq_;
    next_seq_ += (long long)and_mask.bits().size() +
                 (long long)reply.responses.responses.size();
    // Synced tuned-bucket push (rank 0's tune loop -> every rank).
    reply.bucket_bytes = bucket_push_.load(std::memory_order_relaxed);
    return reply;
  }

  // Tensor Fusion packing (reference FuseResponses, operations.cc:450-573):
  // join ALLREDUCE responses of equal dtype while the fused byte count stays
  // under the threshold, with look-ahead past mismatched dtypes. dtype/bytes
  // are snapshotted under ONE mu_ acquisition for the whole cycle — the old
  // per-candidate response_dtype()/response_bytes() helpers took the lock
  // O(n^2) times exactly when fusion matters (hundreds of small tensors).
  std::vector<Response> fuse_responses(std::vector<Response> responses) {
    struct Pending {
      Response r;
      uint8_t dtype = 0;
      long long bytes = 0;
    };
    std::deque<Pending> pending;
    {
      std::lock_guard<std::mutex> g(mu_);
      for (auto& r : responses) {
        Pending p;
        if (r.response_type == RESP_ALLREDUCE) {
          p.dtype = table_.at(r.tensor_names[0]).request.dtype;
          for (const auto& name : r.tensor_names)
            p.bytes += (long long)table_.at(name).nbytes;
        }
        p.r = std::move(r);
        pending.push_back(std::move(p));
      }
    }
    std::vector<Response> out;
    while (!pending.empty()) {
      Pending first = std::move(pending.front());
      pending.pop_front();
      if (first.r.response_type != RESP_ALLREDUCE) {
        out.push_back(std::move(first.r));
        continue;
      }
      long long total = first.bytes;
      for (size_t i = 0; i < pending.size();) {
        Pending& cand = pending[i];
        if (cand.r.response_type == RESP_ALLREDUCE &&
            cand.dtype == first.dtype) {
          if (total + cand.bytes <= fusion_threshold_) {
            for (auto& n : cand.r.tensor_names)
              first.r.tensor_names.push_back(std::move(n));
            total += cand.bytes;
            pending.erase(pending.begin() + (long)i);
            continue;
          }
        }
        i++;  // look-ahead (reference operations.cc:483-499)
      }
      out.push_back(std::move(first.r));
    }
    return out;
  }

  // Priority scheduling: the optimizer-critical bucket (tagged by the
  // BucketScheduler, carried on Request.priority) jumps the launch queue
  // HERE, at coordination — the one place with a global view — so every
  // rank executes the identical reordered sequence and the wire FIFO
  // stays rank-consistent (a per-rank local jump would desynchronize the
  // ring call pairing). Stable sort: equal priorities keep negotiation
  // order, so untagged jobs are bit-for-bit unaffected.
  void prioritize_responses(std::vector<Response>& responses) {
    if (responses.size() < 2) return;
    std::vector<int32_t> prio(responses.size(), 0);
    bool any = false;
    {
      std::lock_guard<std::mutex> g(mu_);
      for (size_t i = 0; i < responses.size(); i++) {
        for (const auto& name : responses[i].tensor_names) {
          auto it = table_.find(name);
          if (it != table_.end() && it->second.request.priority > prio[i])
            prio[i] = it->second.request.priority;
        }
        if (prio[i] > 0) any = true;
      }
    }
    if (!any) return;
    std::vector<size_t> order(responses.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](size_t a, size_t b) { return prio[a] > prio[b]; });
    bool moved = false;
    for (size_t i = 0; i < order.size(); i++)
      moved = moved || order[i] != i;
    if (!moved) return;
    std::vector<Response> sorted;
    sorted.reserve(responses.size());
    for (size_t i : order) sorted.push_back(std::move(responses[i]));
    responses = std::move(sorted);
    priority_jumps_.fetch_add(1, std::memory_order_relaxed);
  }

  // Reference CheckForStalledTensors (operations.cc:688-769).
  void check_stalls(double now) {
    if (stall_disable_) return;
    for (const auto& kv : first_seen_) {
      const std::string& name = kv.first;
      double age = now - kv.second;
      if (age <= stall_warn_s_) continue;
      double last = stall_warned_.count(name) ? stall_warned_[name] : 0.0;
      if (now - last > stall_warn_s_) {
        std::string missing;
        const auto& seen = message_table_[name];
        for (int r = 0; r < size_; r++) {
          if (!seen.count(r)) {
            if (!missing.empty()) missing += ", ";
            missing += std::to_string(r);
          }
        }
        std::fprintf(stderr,
                     "[hvd-native:%d] WARNING: One or more tensors were "
                     "submitted to be reduced, gathered or broadcasted by "
                     "subset of ranks and are waiting for remainder of ranks "
                     "for more than %ds. Stalled op: %s [missing ranks: %s]\n",
                     rank_, (int)stall_warn_s_, name.c_str(), missing.c_str());
        stall_warned_[name] = now;
      }
      if (stall_shutdown_s_ > 0 && age > stall_shutdown_s_) {
        std::fprintf(stderr,
                     "[hvd-native:%d] ERROR: Stall duration exceeded "
                     "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS: aborting job "
                     "(stalled op: %s)\n",
                     rank_, name.c_str());
        shutdown_requested_ = true;
      }
    }
  }

  // ----------------------------------------------------------- both sides

  void process_reply(const Reply& reply) {
    double reply_at = mono_s();
    if (reply.bucket_bytes > 0)
      bucket_synced_.store(reply.bucket_bytes, std::memory_order_relaxed);
    BitMask invalid(reply.invalid_words);
    for (int bit : invalid.bits()) {
      std::lock_guard<std::mutex> g(mu_);
      cache_.evict_bit(bit);
      auto it = bit_pending_.find(bit);
      if (it != bit_pending_.end()) {
        // Cache entry died under a pending hit: renegotiate.
        queue_.push_back(it->second);
        bit_pending_.erase(it);
      }
    }

    // Per-op seq ids: base from the reply, walked over the identical
    // bypass-then-responses order on every rank (python _process_reply
    // parity — merged traces correlate across engines on args.seq).
    long long seq = reply.trace_seq;
    BitMask bypass(reply.bypass_words);
    std::vector<int> bypass_bits = bypass.bits();
    // Cache-bypass ops never reach the coordinator's priority sort (they
    // skip negotiation), so the walk order applies the same key locally:
    // priority desc, bit index asc. Priorities are rank-consistent by
    // contract (like dtype agreement), so every rank walks — and stamps
    // seq ids over — the identical order.
    if (bypass_bits.size() > 1) {
      std::lock_guard<std::mutex> g(mu_);
      auto bit_prio = [&](int bit) -> int32_t {
        auto it = bit_pending_.find(bit);
        if (it == bit_pending_.end()) return 0;
        auto te = table_.find(it->second);
        return te == table_.end() ? 0 : te->second.request.priority;
      };
      std::stable_sort(bypass_bits.begin(), bypass_bits.end(),
                       [&](int a, int b) { return bit_prio(a) > bit_prio(b); });
    }
    for (int bit : bypass_bits) {
      // Cached fast path (reference RunBypass, operations.cc:1166-1215).
      std::string cached_name;
      Response cached;
      std::string name;
      {
        std::lock_guard<std::mutex> g(mu_);
        if (!cache_.get(bit, &cached_name, &cached))
          throw EngineError("bypass bit not in cache");
        cache_.touch(bit);
        auto it = bit_pending_.find(bit);
        if (it == bit_pending_.end())
          throw EngineError("bypass bit with no pending tensor");
        name = it->second;
        bit_pending_.erase(it);
      }
      Response r;
      r.response_type = cached.response_type;
      r.tensor_names.push_back(name);
      r.tensor_sizes = cached.tensor_sizes;
      cache_hits_.fetch_add(1, std::memory_order_relaxed);
      execute(r, /*cache_put=*/false, seq++, reply_at);
    }

    for (const auto& resp : reply.responses.responses) {
      if (resp.response_type != RESP_ERROR)
        cache_misses_.fetch_add(1, std::memory_order_relaxed);
      execute(resp, /*cache_put=*/true, seq++, reply_at);
    }

    // Act only on the *circulated* shutdown flag, never the local one: a
    // locally-set flag must first ride a tick so every rank closes on the
    // same cycle (otherwise this rank would drop out of the token chain
    // while peers still expect its hops).
    if (reply.shutdown) {
      // Final-cycle collectives still complete successfully (serial-engine
      // parity): drain the wire queue while the sockets are healthy —
      // every rank holds the same queue, so the drain is symmetric.
      if (pipeline_) reap_wire(/*wait_all=*/true);
      fail_all_and_close(kShutdownMsg);
    }
  }

  // Fail every pending op and close — in ONE critical section, so an
  // enqueue racing the teardown either lands before (and is failed here) or
  // observes closed_ and returns the shutdown error; no handle can slip
  // into the table after the sweep and hang its waiter.
  void fail_all_and_close(const std::string& msg) {
    // Stop the wire thread FIRST: queued WireJobs hold Entry pointers into
    // table_, which the sweep below clears. On the clean path the queue was
    // already drained (process_reply); on error paths the sockets are
    // closed so in-flight ring calls fail promptly instead of hanging on a
    // dead peer. The failed jobs' handles are swept below like any other.
    teardown_wire_thread();
    {
      std::lock_guard<std::mutex> g(mu_);
      for (auto& kv : table_) {
        auto it = handles_.find(kv.second.handle);
        if (it != handles_.end() && it->second.status == 0) {
          it->second.status = 2;
          it->second.error = msg;
        }
      }
      table_.clear();
      queue_.clear();
      bit_pending_.clear();
      closed_ = true;
    }
    handle_cv_.notify_all();
  }

  // ------------------------------------------------------------ data plane

  void execute(const Response& response, bool cache_put, long long seq,
               double reply_at) {
    // Only the allreduce path is pipelined. Everything else (allgather,
    // broadcast, errors) runs serially on this thread and — because it
    // touches the shared ring sockets — must wait for every in-flight
    // wire job first, preserving the serial engine's execution order.
    if (pipeline_ && response.response_type != RESP_ALLREDUCE)
      reap_wire(/*wait_all=*/true);
    if (response.response_type == RESP_ERROR) {
      std::vector<long long> hs;
      {
        std::lock_guard<std::mutex> g(mu_);
        for (const auto& name : response.tensor_names) {
          auto it = table_.find(name);
          if (it == table_.end()) continue;
          auto hit = handles_.find(it->second.handle);
          if (hit != handles_.end()) {
            hit->second.status = 2;
            hit->second.error = response.error_message;
          }
          table_.erase(it);
        }
      }
      handle_cv_.notify_all();
      return;
    }

    // Entries stay in the table until completion; only this thread mutates
    // them after enqueue, so reading outside the lock is safe.
    std::vector<Entry*> entries;
    {
      std::lock_guard<std::mutex> g(mu_);
      for (const auto& name : response.tensor_names)
        entries.push_back(&table_.at(name));
    }
    std::string tname =
        entries.size() == 1
            ? entries[0]->request.tensor_name
            : "fused[" + std::to_string(entries.size()) + "]";
    if (trace_on_.load(std::memory_order_relaxed)) {
      // Retroactive per-tensor spans, now that the fused op's seq is
      // known (python _execute parity): enqueue = user call -> request
      // departure; negotiate = departure -> this reply. Cache-bypass ops
      // never departed — no negotiate span, by design.
      for (Entry* e : entries) {
        double dep = e->sent_at >= 0 ? e->sent_at : reply_at;
        stamp_span(PH_ENQUEUE, e->enqueued_at, dep, seq, 0,
                   e->request.tensor_name.c_str());
        if (e->sent_at >= 0)
          stamp_span(PH_NEGOTIATE, e->sent_at, reply_at, seq, 0,
                     e->request.tensor_name.c_str());
      }
    }
    if (timeline_) timeline_->start(tname, op_name(response.response_type));

    if (pipeline_ && response.response_type == RESP_ALLREDUCE) {
      // Double-buffered path: pack into a free fusion slot and hand the
      // ring call to the wire thread; copy-out, EF residual slices, cache
      // insert and handle completion happen at reap — in FIFO submit
      // order, so results and completion order match the serial engine.
      submit_allreduce(entries, response, cache_put, seq, tname);
      return;
    }

    long long nbytes = 0;
    if (response.response_type == RESP_ALLREDUCE)
      nbytes = execute_allreduce(entries, tname, seq);
    else if (response.response_type == RESP_ALLGATHER)
      nbytes = execute_allgather(*entries[0], response, tname, seq);
    else
      nbytes = execute_broadcast(*entries[0], tname, seq);
    processed_bytes_ += nbytes;
    tensors_total_.fetch_add((long long)entries.size(),
                             std::memory_order_relaxed);
    if (entries.size() > 1)
      fused_tensors_.fetch_add((long long)entries.size(),
                               std::memory_order_relaxed);

    {
      std::lock_guard<std::mutex> g(mu_);
      for (Entry* e : entries) {
        if (cache_put) {
          Response single;
          single.response_type = response.response_type;
          single.tensor_names.push_back(e->request.tensor_name);
          single.tensor_sizes = response.tensor_sizes;
          cache_.put(e->request, single);
        }
        table_.erase(e->request.tensor_name);
      }
    }
    if (timeline_) timeline_->end(tname);
    handle_cv_.notify_all();
  }

  void complete(Entry* e, std::vector<int64_t> shape,
                std::vector<uint8_t> data,
                std::vector<int64_t> tensor_sizes = {}) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = handles_.find(e->handle);
    if (it == handles_.end()) return;
    it->second.status = 1;
    it->second.dtype = e->request.dtype;
    it->second.shape = std::move(shape);
    it->second.data = std::move(data);
    it->second.tensor_sizes = std::move(tensor_sizes);
  }

  // Result already lives in the caller's buffer: no bytes cross the ABI.
  void complete_in_place(Entry* e) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = handles_.find(e->handle);
    if (it == handles_.end()) return;
    it->second.status = 1;
    it->second.dtype = e->request.dtype;
    it->second.shape = e->request.shape;
    it->second.in_place = true;
  }

  // Timeline activity vocabulary mirrors the reference's op-specific names
  // (common.h:30-51): say which data plane actually moved the bytes.
  const char* data_plane_activity(bool hier_enabled) const {
    if (hier_enabled && hier_.shm) return "SHM_CROSS_RING_COLLECTIVE";
    if (hier_enabled && hier_.local_ring) return "HIER_RING_COLLECTIVE";
    return "TCP_COLLECTIVE";
  }

  const char* allreduce_activity() const {
    return data_plane_activity(hier_.allreduce);
  }

  long long execute_allreduce(std::vector<Entry*>& entries,
                              const std::string& tname, long long seq) {
    uint8_t dtype = entries[0]->request.dtype;
    size_t esz = dtype_size(dtype);
    size_t total_bytes = 0;
    for (Entry* e : entries) total_bytes += e->nbytes;
    double t_fuse = mono_s();

    if (entries.size() == 1) {
      // Unfused: reduce in place directly on the caller's buffer — zero
      // staging copies (the reference likewise reduces unfused entries in
      // place, mpi_operations.cc:40-49).
      Entry* e = entries[0];
      if (timeline_) timeline_->activity_start(tname, allreduce_activity());
      double t_exec = mono_s();
      if (size_ > 1) {
        if (hier_.allreduce && (hier_.local_ring || hier_.shm)) {
          // Per-link wire dtypes + residual threading: the hier plane
          // fully writes e->residual (errors or zeros) like the flat one.
          hier_ring_allreduce(e->user, (long)(total_bytes / esz), dtype,
                              e->residual);
        } else if (hvd_ring_allreduce_wire(e->user, (long)(total_bytes / esz),
                                           dtype, 0, wire_dtype_,
                                           e->residual) != 0) {
          throw EngineError(std::string("ring allreduce failed: ") +
                            hvd_ring_last_error());
        }
      } else if (e->residual) {
        std::memset(e->residual, 0, (total_bytes / esz) * sizeof(float));
      }
      double t_done = mono_s();
      if (timeline_) timeline_->activity_end(tname);
      complete_in_place(e);
      observe_exec(t_done - t_exec);
      if (trace_on_.load(std::memory_order_relaxed)) {
        double t_end = mono_s();
        stamp_span(PH_FUSE, t_fuse, t_exec, seq, 1, tname.c_str());
        stamp_span(PH_EXECUTE, t_exec, t_done, seq, 0, tname.c_str());
        stamp_span(PH_DONE, t_done, t_end, seq, 0, tname.c_str());
      }
      return (long long)total_bytes;
    }

    // Fusion buffer (reference FusionBufferManager: one persistent buffer,
    // lazily allocated, fusion_buffer_manager.cc:21-45).
    if (fusion_buffer_.capacity() < total_bytes) {
      if (timeline_) timeline_->activity_start(tname, "INIT_FUSION_BUFFER");
      fusion_buffer_.reserve(std::max(
          total_bytes, (size_t)std::min<long long>(fusion_threshold_,
                                                   64ll << 20)));
      if (timeline_) timeline_->activity_end(tname);
    }
    fusion_buffer_.resize(total_bytes);
    fusion_fill_.store((long long)total_bytes, std::memory_order_relaxed);
    fusion_cap_.store((long long)fusion_buffer_.capacity(),
                      std::memory_order_relaxed);

    if (timeline_) timeline_->activity_start(tname, "MEMCPY_IN_FUSION_BUFFER");
    size_t off = 0;
    for (Entry* e : entries) {
      std::memcpy(fusion_buffer_.data() + off, e->user, e->nbytes);
      off += e->nbytes;
    }
    if (timeline_) {
      timeline_->activity_end(tname);
      timeline_->activity_start(tname, allreduce_activity());
    }
    double t_exec = mono_s();
    // Fused error feedback: the ring records quantization errors for the
    // WHOLE fused buffer into a scratch; each entry's slice is copied out
    // to its own residual after the reduce (entries without one simply
    // drop their slice — uncompensated, like a residual-less caller).
    bool any_residual = false;
    for (Entry* e : entries) any_residual = any_residual || e->residual;
    float* fused_residual = nullptr;
    if (any_residual && dtype == 0 /* DT_F32 */) {
      residual_scratch_.resize(total_bytes / esz);
      fused_residual = residual_scratch_.data();
    }
    if (size_ > 1) {
      if (hier_.allreduce && (hier_.local_ring || hier_.shm)) {
        hier_ring_allreduce(fusion_buffer_.data(),
                            (long)(total_bytes / esz), dtype,
                            fused_residual);
      } else if (hvd_ring_allreduce_wire(fusion_buffer_.data(),
                                         (long)(total_bytes / esz), dtype,
                                         0, wire_dtype_,
                                         fused_residual) != 0) {
        throw EngineError(std::string("ring allreduce failed: ") +
                          hvd_ring_last_error());
      }
    }
    double t_done = mono_s();
    if (timeline_) {
      timeline_->activity_end(tname);
      timeline_->activity_start(tname, "MEMCPY_OUT_FUSION_BUFFER");
    }
    // Unpack straight back into the caller buffers — the old path staged
    // through per-entry vectors plus a ctypes copy on the Python side.
    off = 0;
    for (Entry* e : entries) {
      std::memcpy(e->user, fusion_buffer_.data() + off, e->nbytes);
      if (e->residual) {
        // Both data planes fully write the fused scratch (quantization
        // errors or zeros), so a slice copy is always correct.
        if (fused_residual && size_ > 1)
          std::memcpy(e->residual, fused_residual + off / esz,
                      (e->nbytes / esz) * sizeof(float));
        else
          std::memset(e->residual, 0, (e->nbytes / esz) * sizeof(float));
      }
      off += e->nbytes;
      complete_in_place(e);
    }
    if (timeline_) timeline_->activity_end(tname);
    observe_exec(t_done - t_exec);
    if (trace_on_.load(std::memory_order_relaxed)) {
      double t_end = mono_s();
      stamp_span(PH_FUSE, t_fuse, t_exec, seq, (int)entries.size(),
                 tname.c_str());
      stamp_span(PH_EXECUTE, t_exec, t_done, seq, 0, tname.c_str());
      stamp_span(PH_DONE, t_done, t_end, seq, 0, tname.c_str());
    }
    return (long long)total_bytes;
  }

  // Two-level allreduce: sum inside the node (through /dev/shm when
  // active, TCP local ring otherwise), exchange node sums across the local
  // roots' cross ring, fan back out locally. Each hop applies ITS link's
  // wire dtype (hier_.wire_local / wire_cross) to f32 payloads — the
  // cross hop is the slow inter-node link where int8+EF pays most
  // (docs/wire-compression.md).
  //
  // Residual contract (matches ring_allreduce's): when `residual` is
  // non-null it is FULLY written by this call — each element receives the
  // exact quantization error this rank introduced on whichever hops it
  // quantized (local errors + the root's cross errors), or zero. Summing
  // every rank's residual gives exactly true_sum - computed_sum (local
  // sums are exact or locally compensated; cross errors live on the
  // roots), so the error-feedback telescoping holds through the
  // two-level plane end-to-end.
  void hier_ring_allreduce(void* buf, long count, uint8_t dtype,
                           float* residual) {
    bool f32 = dtype == 0;
    int wl = f32 ? hier_.wire_local : 0;
    int wc = f32 ? hier_.wire_cross : 0;
    bool is_root = hier_.local_rank == 0;
    bool local_q = f32 && wl == 3 /* WIRE_I8 */ && hier_.local_size > 1 &&
                   hier_.local_ring != nullptr;
    bool cross_q = f32 && wc == 3 && hier_.cross_size > 1 && is_root;
    // Cross errors go to the caller's buffer directly when the local hop
    // recorded nothing; when BOTH hops quantize, the cross hop stages
    // through a scratch that is added in (each ring call overwrites its
    // residual buffer, so the two contributions must be summed here).
    float* cross_res = nullptr;
    if (residual) {
      if (cross_q && local_q) {
        hier_residual_scratch_.resize((size_t)count);
        cross_res = hier_residual_scratch_.data();
      } else if (cross_q) {
        cross_res = residual;
      }
      if (!local_q && !cross_q)
        std::memset(residual, 0, (size_t)count * sizeof(float));
    }
    if (hier_.shm) {
      // Local plane is the shared segment: memcpys, no wire, exact sums.
      if (hvd_shm_allreduce_g(hier_.shm, buf, count, dtype) != 0)
        throw EngineError(std::string("shm local allreduce failed: ") +
                          hvd_shm_last_error());
      if (is_root &&
          hvd_ringh_allreduce_wire(hier_.cross_ring, buf, count, dtype, 0,
                                   wc, cross_res) != 0)
        throw EngineError(std::string("cross ring allreduce failed: ") +
                          hvd_ring_last_error());
      if (hvd_shm_broadcast_g(hier_.shm, buf, count, dtype, 0) != 0)
        throw EngineError(std::string("shm local broadcast failed: ") +
                          hvd_shm_last_error());
      return;
    }
    if (hvd_ringh_allreduce_wire(hier_.local_ring, buf, count, dtype, 0, wl,
                                 local_q ? residual : nullptr) != 0)
      throw EngineError(std::string("local ring allreduce failed: ") +
                        hvd_ring_last_error());
    if (is_root &&
        hvd_ringh_allreduce_wire(hier_.cross_ring, buf, count, dtype, 0, wc,
                                 cross_res) != 0)
      throw EngineError(std::string("cross ring allreduce failed: ") +
                        hvd_ring_last_error());
    if (residual && local_q && cross_q)
      for (long i = 0; i < count; i++) residual[i] += cross_res[i];
    if (hvd_ringh_broadcast(hier_.local_ring, buf, count, dtype, 0) != 0)
      throw EngineError(std::string("local ring broadcast failed: ") +
                        hvd_ring_last_error());
  }

  long long execute_allgather(Entry& e, const Response& response,
                              const std::string& tname, long long seq) {
    double t_exec = mono_s();
    uint8_t dtype = e.request.dtype;
    size_t esz = dtype_size(dtype);
    long long trailing = 1;
    for (size_t i = 1; i < e.request.shape.size(); i++)
      trailing *= e.request.shape[i];
    std::vector<long> counts;
    long long total_elems = 0;
    for (int64_t s : response.tensor_sizes) {
      counts.push_back((long)(s * trailing));
      total_elems += s * trailing;
    }
    std::vector<uint8_t> out((size_t)total_elems * esz);
    const char* gather_act = data_plane_activity(hier_.allgather);
    if (timeline_) timeline_->activity_start(tname, gather_act);
    if (size_ > 1) {
      if (hier_.allgather && (hier_.local_ring || hier_.shm)) {
        // Two-level: gather inside the node (shm slots or TCP local ring),
        // local roots exchange node blobs, fan the full result back out
        // (MPIHierarchicalAllgather shape, mpi_operations.cc:179-329 — the
        // shm path IS its MPI_Win_allocate_shared window; contiguous rank
        // grouping makes node order == rank order).
        int ls = hier_.local_size, cr = hier_.cross_rank;
        std::vector<long> local_counts(counts.begin() + (size_t)cr * ls,
                                       counts.begin() + (size_t)(cr + 1) * ls);
        long long local_elems = 0;
        for (long c : local_counts) local_elems += c;
        std::vector<uint8_t> local_out((size_t)local_elems * esz);
        int lrc = hier_.shm
                      ? hvd_shm_allgather_g(hier_.shm, e.user,
                                            local_counts.data(),
                                            local_out.data(), dtype)
                      : hvd_ringh_allgather(hier_.local_ring, e.user,
                                            local_counts.data(),
                                            local_out.data(), dtype);
        if (lrc != 0)
          throw EngineError(std::string("local allgather failed: ") +
                            (hier_.shm ? hvd_shm_last_error()
                                       : hvd_ring_last_error()));
        if (hier_.local_rank == 0) {
          std::vector<long> group_counts(hier_.cross_size, 0);
          for (int g = 0; g < hier_.cross_size; g++)
            for (int i = 0; i < ls; i++)
              group_counts[g] += counts[(size_t)g * ls + i];
          if (hvd_ringh_allgather(hier_.cross_ring, local_out.data(),
                                  group_counts.data(), out.data(),
                                  dtype) != 0)
            throw EngineError(std::string("cross ring allgather failed: ") +
                              hvd_ring_last_error());
        }
        int brc = hier_.shm
                      ? hvd_shm_broadcast_g(hier_.shm, out.data(),
                                            (long)total_elems, dtype, 0)
                      : hvd_ringh_broadcast(hier_.local_ring, out.data(),
                                            (long)total_elems, dtype, 0);
        if (brc != 0)
          throw EngineError(std::string("local broadcast failed: ") +
                            (hier_.shm ? hvd_shm_last_error()
                                       : hvd_ring_last_error()));
      } else if (hvd_ring_allgather(e.user, counts.data(), out.data(),
                                    dtype) != 0) {
        throw EngineError(std::string("ring allgather failed: ") +
                          hvd_ring_last_error());
      }
    } else {
      std::memcpy(out.data(), e.user, e.nbytes);
    }
    if (timeline_) timeline_->activity_end(tname);
    double t_done = mono_s();
    std::vector<int64_t> shape = e.request.shape;
    int64_t dim0 = 0;
    for (int64_t s : response.tensor_sizes) dim0 += s;
    shape[0] = dim0;
    long long nbytes = (long long)out.size();
    complete(&e, std::move(shape), std::move(out), response.tensor_sizes);
    observe_exec(t_done - t_exec);
    trace_exec_done(seq, tname, t_exec, t_done);
    return nbytes;
  }

  long long execute_broadcast(Entry& e, const std::string& tname,
                              long long seq) {
    double t_exec = mono_s();
    size_t esz = dtype_size(e.request.dtype);
    if (timeline_) timeline_->activity_start(tname, "TCP_COLLECTIVE");
    if (size_ > 1) {
      // In place on the caller's buffer: the root sends from it, everyone
      // else receives into it.
      if (hvd_ring_broadcast(e.user, (long)(e.nbytes / esz),
                             e.request.dtype, e.request.root_rank) != 0)
        throw EngineError(std::string("ring broadcast failed: ") +
                          hvd_ring_last_error());
    }
    if (timeline_) timeline_->activity_end(tname);
    double t_done = mono_s();
    complete_in_place(&e);
    observe_exec(t_done - t_exec);
    trace_exec_done(seq, tname, t_exec, t_done);
    return (long long)e.nbytes;
  }

  // execute + done spans for the single-phase ops (allgather/broadcast) —
  // the Python controller's _trace_exec_done shape.
  void trace_exec_done(long long seq, const std::string& op, double t0,
                       double t1) {
    if (!trace_on_.load(std::memory_order_relaxed)) return;
    double t2 = mono_s();
    stamp_span(PH_EXECUTE, t0, t1, seq, 0, op.c_str());
    stamp_span(PH_DONE, t1, t2, seq, 0, op.c_str());
  }

  void observe_exec(double seconds) {
    std::lock_guard<std::mutex> g(tele_mu_);
    exec_hist_.observe(seconds);
  }

  // ------------------------------------------- pipelined data plane (r16)
  //
  // Double-buffered fusion: the engine thread packs fused group N+1 into
  // one FusionSlot and copies group N-1 out of the other while the wire
  // thread keeps group N's ring call moving — the r10 CompressCursor
  // send-ahead pattern lifted one level up, from chunks within a
  // collective to whole fused groups within a cycle. Jobs flow through a
  // strict FIFO (reply order, identical on every rank): the wire thread
  // runs them front-to-back and the engine thread reaps them
  // front-to-back, so ring-call pairing, results, completion order and
  // the EF residual stream are bit-for-bit the serial engine's. The wire
  // thread's residual writes are scoped to its ONE in-flight group; the
  // engine thread slices them out per entry only after the job is done.

  struct FusionSlot {
    std::vector<uint8_t> buf;
    std::vector<float> residual;  // fused EF staging for this slot
    bool busy = false;            // guarded by wire_mu_
  };

  struct WireJob {
    int slot = -1;  // fusion slot index; -1 = in-place single entry
    std::vector<Entry*> entries;
    Response response;  // for cache insertion at reap
    bool cache_put = false;
    long long seq = 0;
    std::string tname;
    uint8_t dtype = 0;
    size_t total_bytes = 0;
    void* wire_buf = nullptr;   // slot buffer or the entry's user buffer
    float* residual = nullptr;  // slot scratch or the entry's residual
    double t_exec = 0, t_done = 0;  // wire window (wire thread)
    bool started = false, done = false;  // guarded by wire_mu_
    std::string error;  // non-empty: the ring call failed
  };

  void wire_loop() {
    std::unique_lock<std::mutex> lk(wire_mu_);
    for (;;) {
      WireJob* job = nullptr;
      wire_cv_.wait(lk, [&] {
        for (auto& j : wire_queue_)
          if (!j->started) return true;
        return wire_stop_;
      });
      for (auto& j : wire_queue_)
        if (!j->started) {
          job = j.get();
          break;
        }
      if (!job) return;  // stop requested and nothing left to run
      job->started = true;
      lk.unlock();
      double t_exec = mono_s();
      try {
        run_wire_job(job);
      } catch (const std::exception& exc) {
        job->error = exc.what();
      }
      double t_done = mono_s();
      job->t_exec = t_exec;
      job->t_done = t_done;
      stamp_span(PH_EXECUTE, t_exec, t_done, job->seq, 0,
                 job->tname.c_str());
      lk.lock();
      job->done = true;
      wire_done_cv_.notify_all();
    }
  }

  // The ring call — the ONLY work the wire thread does. Residual writes
  // target this job's buffers exclusively (the in-flight group), so error
  // feedback telescopes exactly as on the serial path.
  void run_wire_job(WireJob* job) {
    if (test_delay_us_ > 0)
      std::this_thread::sleep_for(
          std::chrono::microseconds(test_delay_us_));
    long count = (long)(job->total_bytes / dtype_size(job->dtype));
    if (size_ > 1) {
      if (hvd_ring_allreduce_wire(job->wire_buf, count, job->dtype, 0,
                                  wire_dtype_, job->residual) != 0)
        throw EngineError(std::string("ring allreduce failed: ") +
                          hvd_ring_last_error());
    } else if (job->residual) {
      std::memset(job->residual, 0, (size_t)count * sizeof(float));
    }
  }

  // Engine thread: pack the group and hand it to the wire thread.
  void submit_allreduce(std::vector<Entry*>& entries,
                        const Response& response, bool cache_put,
                        long long seq, const std::string& tname) {
    uint8_t dtype = entries[0]->request.dtype;
    size_t esz = dtype_size(dtype);
    size_t total_bytes = 0;
    for (Entry* e : entries) total_bytes += e->nbytes;
    double t_fuse = mono_s();

    auto job = std::make_unique<WireJob>();
    job->entries = entries;
    job->response = response;
    job->cache_put = cache_put;
    job->seq = seq;
    job->tname = tname;
    job->dtype = dtype;
    job->total_bytes = total_bytes;

    if (entries.size() == 1) {
      // Unfused: in place on the caller's pinned buffer, no slot burned.
      // The wire thread owns the entry's residual until reap.
      job->wire_buf = entries[0]->user;
      job->residual = size_ > 1 ? entries[0]->residual : nullptr;
    } else {
      int si = acquire_slot();
      FusionSlot& slot = slots_[si];
      if (slot.buf.capacity() < total_bytes) {
        if (timeline_)
          timeline_->activity_start(tname, "INIT_FUSION_BUFFER");
        slot.buf.reserve(std::max(
            total_bytes, (size_t)std::min<long long>(fusion_threshold_,
                                                     64ll << 20)));
        if (timeline_) timeline_->activity_end(tname);
      }
      slot.buf.resize(total_bytes);
      fusion_fill_.store((long long)total_bytes, std::memory_order_relaxed);
      fusion_cap_.store((long long)slot.buf.capacity(),
                        std::memory_order_relaxed);
      if (timeline_)
        timeline_->activity_start(tname, "MEMCPY_IN_FUSION_BUFFER");
      size_t off = 0;
      for (Entry* e : entries) {
        std::memcpy(slot.buf.data() + off, e->user, e->nbytes);
        off += e->nbytes;
      }
      if (timeline_) timeline_->activity_end(tname);
      bool any_residual = false;
      for (Entry* e : entries) any_residual = any_residual || e->residual;
      job->wire_buf = slot.buf.data();
      if (any_residual && dtype == 0 /* DT_F32 */) {
        slot.residual.resize(total_bytes / esz);
        job->residual = slot.residual.data();
      }
      job->slot = si;
    }
    stamp_span(PH_FUSE, t_fuse, mono_s(), seq, (int)entries.size(),
               tname.c_str());
    {
      std::lock_guard<std::mutex> g(wire_mu_);
      wire_queue_.push_back(std::move(job));
      long long depth = (long long)wire_queue_.size();
      if (depth > pipeline_depth_.load(std::memory_order_relaxed))
        pipeline_depth_.store(depth, std::memory_order_relaxed);
    }
    wire_cv_.notify_one();
  }

  // Free fusion slot, reaping opportunistically: with two slots at most
  // two fused groups are outstanding — N on the wire while N+1 packs,
  // because N-1 gets copied out right here.
  int acquire_slot() {
    for (;;) {
      reap_wire(/*wait_all=*/false);
      {
        std::lock_guard<std::mutex> g(wire_mu_);
        for (int i = 0; i < 2; i++)
          if (!slots_[i].busy) {
            slots_[i].busy = true;
            return i;
          }
      }
      // Both slots in flight: block until the oldest job lands (counted
      // as a pipeline stall inside reap_wire's wait).
      reap_wire_front();
    }
  }

  // Reap completed jobs oldest-first. wait_all=true drains the whole
  // queue — required before ANY control-frame I/O, because the wire
  // thread shares the ring sockets. Engine-thread time spent blocked in
  // the wait (beyond `stall_after`, used by rank 0 to exclude its pacing
  // window) is charged to CTR_PIPELINE_STALL_US.
  void reap_wire(bool wait_all, double stall_after = 0.0) {
    for (;;) {
      std::unique_ptr<WireJob> job;
      {
        std::unique_lock<std::mutex> lk(wire_mu_);
        if (wire_queue_.empty()) return;
        if (!wire_queue_.front()->done) {
          if (!wait_all) return;
          double t0 = mono_s();
          wire_done_cv_.wait(
              lk, [&] { return wire_queue_.front()->done; });
          double stalled = mono_s() - std::max(t0, stall_after);
          if (stalled > 0)
            pipeline_stall_us_.fetch_add((long long)(stalled * 1e6),
                                         std::memory_order_relaxed);
        }
        job = std::move(wire_queue_.front());
        wire_queue_.pop_front();
      }
      finish_job(*job);
    }
  }

  // Block until the oldest in-flight job completes and reap it.
  void reap_wire_front() {
    std::unique_ptr<WireJob> job;
    {
      std::unique_lock<std::mutex> lk(wire_mu_);
      if (wire_queue_.empty()) return;
      if (!wire_queue_.front()->done) {
        double t0 = mono_s();
        wire_done_cv_.wait(lk,
                           [&] { return wire_queue_.front()->done; });
        pipeline_stall_us_.fetch_add(
            (long long)((mono_s() - t0) * 1e6),
            std::memory_order_relaxed);
      }
      job = std::move(wire_queue_.front());
      wire_queue_.pop_front();
    }
    finish_job(*job);
  }

  // Reap one job on the engine thread: copy-out + per-entry EF residual
  // slices, cache insert, handle completion, accounting and spans —
  // everything the serial execute_allreduce tail does, in the same order.
  void finish_job(WireJob& job) {
    if (!job.error.empty()) {
      release_slot(job.slot);
      throw EngineError(job.error);
    }
    size_t esz = dtype_size(job.dtype);
    if (job.slot >= 0) {
      FusionSlot& slot = slots_[job.slot];
      if (timeline_)
        timeline_->activity_start(job.tname, "MEMCPY_OUT_FUSION_BUFFER");
      size_t off = 0;
      for (Entry* e : job.entries) {
        std::memcpy(e->user, slot.buf.data() + off, e->nbytes);
        if (e->residual) {
          // Both outcomes fully write the entry's residual: the wire
          // thread's fused scratch slice, or zeros (size-1 / non-f32).
          if (job.residual && size_ > 1)
            std::memcpy(e->residual, job.residual + off / esz,
                        (e->nbytes / esz) * sizeof(float));
          else
            std::memset(e->residual, 0,
                        (e->nbytes / esz) * sizeof(float));
        }
        off += e->nbytes;
      }
      if (timeline_) timeline_->activity_end(job.tname);
      release_slot(job.slot);
    } else if (job.entries.size() == 1 && size_ == 1 &&
               job.entries[0]->residual) {
      std::memset(job.entries[0]->residual, 0,
                  (job.entries[0]->nbytes / esz) * sizeof(float));
    }
    processed_bytes_ += (long long)job.total_bytes;
    tensors_total_.fetch_add((long long)job.entries.size(),
                             std::memory_order_relaxed);
    if (job.entries.size() > 1)
      fused_tensors_.fetch_add((long long)job.entries.size(),
                               std::memory_order_relaxed);
    {
      std::lock_guard<std::mutex> g(mu_);
      for (Entry* e : job.entries) {
        if (job.cache_put) {
          Response single;
          single.response_type = job.response.response_type;
          single.tensor_names.push_back(e->request.tensor_name);
          single.tensor_sizes = job.response.tensor_sizes;
          cache_.put(e->request, single);
        }
        auto it = handles_.find(e->handle);
        if (it != handles_.end()) {
          it->second.status = 1;
          it->second.dtype = e->request.dtype;
          it->second.shape = e->request.shape;
          it->second.in_place = true;
        }
        table_.erase(e->request.tensor_name);
      }
    }
    observe_exec(job.t_done - job.t_exec);
    stamp_span(PH_DONE, job.t_done, mono_s(), job.seq, 0,
               job.tname.c_str());
    if (timeline_) timeline_->end(job.tname);
    handle_cv_.notify_all();
  }

  void release_slot(int si) {
    if (si < 0) return;
    std::lock_guard<std::mutex> g(wire_mu_);
    slots_[si].busy = false;
  }

  // Stop + join the wire thread (idempotent). Queued-but-unstarted jobs
  // still run — on the error path the sockets are closed first so they
  // fail fast instead of hanging on a dead peer; their entries are left
  // for the caller's table sweep.
  void teardown_wire_thread() {
    if (!wire_thread_.joinable()) return;
    bool inflight;
    {
      std::lock_guard<std::mutex> g(wire_mu_);
      wire_stop_ = true;
      inflight = !wire_queue_.empty();
    }
    wire_cv_.notify_all();
    if (inflight && size_ > 1) hvd_ring_shutdown();  // idempotent
    wire_thread_.join();
    std::lock_guard<std::mutex> g(wire_mu_);
    wire_queue_.clear();
    slots_[0].busy = slots_[1].busy = false;
  }

  // ------------------------------------------------------------ members

  int rank_, size_;
  std::atomic<double> cycle_ms_;
  std::atomic<long long> fusion_threshold_;
  bool stall_disable_;
  double stall_warn_s_, stall_shutdown_s_;
  // Wire compression for the flat ring's allreduce data phases (WireDType
  // code from HOROVOD_RING_WIRE_DTYPE via common/config.py; ring.cc only
  // applies it to f32 payloads). The hierarchical plane has its own
  // per-link pair in hier_.wire_local / hier_.wire_cross.
  int wire_dtype_ = 0;
  std::vector<float> residual_scratch_;  // fused-buffer EF staging
  // Cross-hop EF staging when BOTH hier hops quantize (local errors land
  // in the caller's residual, cross errors stage here and are added).
  std::vector<float> hier_residual_scratch_;

  std::mutex mu_;  // guards table_/queue_/handles_/bit_pending_/cache_/closed_
  std::condition_variable handle_cv_;
  std::deque<std::string> queue_;
  std::map<std::string, Entry> table_;
  std::map<long long, HandleSlot> handles_;
  std::map<int, std::string> bit_pending_;
  ResponseCache cache_;
  HierState hier_;  // copied from g_hier at construction
  long long next_handle_ = 0;
  bool closed_ = false;
  bool finished_ = false;
  std::atomic<bool> shutdown_requested_{false};

  // Coordinator-only (reference MessageTable, global_state.h:34).
  std::map<std::string, std::map<int, Request>> message_table_;
  std::map<std::string, double> first_seen_;
  std::map<std::string, double> stall_warned_;

  std::vector<uint8_t> fusion_buffer_;
  std::unique_ptr<Timeline> timeline_;

  std::atomic<long long> cycles_{0};
  std::atomic<long long> processed_bytes_{0};
  std::atomic<long long> busy_us_{0};

  // Telemetry plane (span ring + histograms under tele_mu_; counters are
  // relaxed atomics — always on, a handful of increments per op).
  std::atomic<bool> trace_on_{false};
  std::mutex tele_mu_;  // guards ring_/ring_head_/ring_size_/*_hist_
  std::vector<Span> ring_;
  size_t ring_head_ = 0, ring_size_ = 0;
  TimeHist cycle_hist_, exec_hist_;
  std::atomic<long long> spans_total_{0}, spans_dropped_{0};
  std::atomic<long long> tensors_total_{0}, fused_tensors_{0};
  std::atomic<long long> cache_hits_{0}, cache_misses_{0};
  std::atomic<long long> fusion_fill_{0}, fusion_cap_{0};
  // Synced tuned-bucket slot: push set on rank 0 via the ABI, synced
  // adopted from the cycle reply on every rank.
  std::atomic<long long> bucket_push_{0}, bucket_synced_{0};
  long long next_seq_ = 0;  // coordinator-only: next collective seq id

  // Pipelined data plane (r16). wire_mu_ guards wire_queue_ /
  // wire_stop_ / the slots' busy flags; it is never held across mu_ or
  // tele_mu_ (the static lock graph stays acyclic). Only the engine
  // thread pushes/pops the queue; the wire thread just flips
  // started/done on the front-most unstarted job.
  bool pipeline_ = false;
  long long test_delay_us_ = 0;  // HOROVOD_PIPELINE_TEST_DELAY_US hook
  std::mutex wire_mu_;
  std::condition_variable wire_cv_;       // wakes the wire thread
  std::condition_variable wire_done_cv_;  // wakes the engine thread
  std::deque<std::unique_ptr<WireJob>> wire_queue_;
  bool wire_stop_ = false;
  FusionSlot slots_[2];
  std::atomic<long long> pipeline_depth_{0};     // high-water outstanding
  std::atomic<long long> pipeline_stall_us_{0};  // engine blocked on wire
  std::atomic<long long> priority_jumps_{0};     // reordered cycles
  std::thread wire_thread_;

  std::thread thread_;
};

// Intentionally leaked on shutdown: C-ABI accessors (wait/slot/release) read
// this pointer without a lock from arbitrary Python threads, so destroying
// the Engine while a waiter is inside it would be a use-after-free. Shutdown
// instead joins the background thread and releases the bulk buffers
// (Engine::finish); the husk stays valid so late waiters resolve cleanly.
// The reference keeps its HorovodGlobalState singleton alive for the process
// lifetime the same way (horovod/common/operations.cc:90).
Engine* g_engine = nullptr;
std::mutex g_engine_mu;
std::string g_last_error;
long long g_engine_gen = 0;  // bumped per engine init -> CTR_ENGINE_GEN

}  // namespace
}  // namespace hvd

// ----------------------------------------------------------------- C ABI
// (reference operations.cc:1595-1650 exposes the same lifecycle surface.)

extern "C" {

const char* hvd_eng_last_error() { return hvd::g_last_error.c_str(); }

int hvd_eng_init(int rank, int size, const char* ring_addrs,
                 const uint8_t* secret, int secret_len, double cycle_ms,
                 long long fusion_threshold, int cache_capacity,
                 int stall_disable, double stall_warn_s,
                 double stall_shutdown_s, const char* timeline_path,
                 int timeline_mark_cycles, int wire_dtype,
                 int wire_dtype_local, int wire_dtype_cross, int pipeline) {
  std::lock_guard<std::mutex> g(hvd::g_engine_mu);
  if (hvd::g_engine && !hvd::g_engine->finished()) {
    hvd::g_last_error = "engine already initialized";
    return -1;
  }
  if (size > 1) {
    if (hvd_ring_init(rank, size, ring_addrs, secret, secret_len) != 0) {
      hvd::g_last_error = hvd_ring_last_error();
      return -1;
    }
  }
  // Two-level hierarchical rings (reference HOROVOD_HIERARCHICAL_* flags).
  // Gated exactly like the Python controller: flags on, launcher-exported
  // group addresses present, real two-level topology — the predicate is
  // env-derived so it is identical on every rank.
  hvd::g_hier = hvd::HierState{};
  auto env_true = [](const char* name) {
    // Mirrors the Python config._env_bool exactly: strip, lowercase, and
    // "", "0", "false", "no", "off" are false — both engines must read a
    // documented flag identically.
    const char* v = getenv(name);
    if (!v) return false;
    std::string s(v);
    size_t a = s.find_first_not_of(" \t\r\n");
    if (a == std::string::npos) return false;
    size_t b = s.find_last_not_of(" \t\r\n");
    s = s.substr(a, b - a + 1);
    for (char& c : s) c = (char)tolower((unsigned char)c);
    return s != "" && s != "0" && s != "false" && s != "no" && s != "off";
  };
  auto env_int = [](const char* name, int dflt) {
    const char* v = getenv(name);
    return v && *v ? atoi(v) : dflt;
  };
  const char* local_addrs = getenv("HOROVOD_LOCAL_RING_ADDRS");
  const char* cross_addrs = getenv("HOROVOD_CROSS_RING_ADDRS");
  const char* cpu_ops = getenv("HOROVOD_CPU_OPS");
  hvd::g_hier.allreduce = env_true("HOROVOD_HIERARCHICAL_ALLREDUCE");
  hvd::g_hier.allgather = env_true("HOROVOD_HIERARCHICAL_ALLGATHER");
  hvd::g_hier.local_rank = env_int("HOROVOD_LOCAL_RANK", 0);
  hvd::g_hier.local_size = env_int("HOROVOD_LOCAL_SIZE", 1);
  hvd::g_hier.cross_rank = env_int("HOROVOD_CROSS_RANK", 0);
  hvd::g_hier.cross_size = env_int("HOROVOD_CROSS_SIZE", 1);
  // Per-link wire dtypes ride the ABI (resolved by common/config.py from
  // HOROVOD_RING_WIRE_DTYPE_LOCAL/_CROSS + link-class defaults) so both
  // engines share one resolver; clamp garbage to the untouched stream.
  hvd::g_hier.wire_local =
      (wire_dtype_local >= 0 && wire_dtype_local <= 3) ? wire_dtype_local : 0;
  hvd::g_hier.wire_cross =
      (wire_dtype_cross >= 0 && wire_dtype_cross <= 3) ? wire_dtype_cross : 0;
  if ((hvd::g_hier.allreduce || hvd::g_hier.allgather) && local_addrs &&
      cross_addrs && hvd::g_hier.local_size > 1 &&
      hvd::g_hier.cross_size > 1 && !(cpu_ops && strcmp(cpu_ops, "star") == 0)) {
    // Local plane: /dev/shm by default — same-host bytes move as memcpys
    // through one shared mapping (the reference's MPI_Win_allocate_shared
    // analogue, mpi_operations.cc:216-243) instead of crossing the kernel
    // socket stack twice over loopback. HOROVOD_SHM_DISABLE=1 falls back
    // to the TCP local ring. The choice is env-derived, so it is identical
    // on every local rank — a mixed group would deadlock.
    if (!env_true("HOROVOD_SHM_DISABLE")) {
      // Segment name from the job secret + group id: unique per job, equal
      // across the group's ranks.
      hvd::SHA256 hasher;
      hasher.update(secret, (size_t)secret_len);
      int32_t group = hvd::g_hier.cross_rank;
      hasher.update((const uint8_t*)&group, sizeof(group));
      uint8_t digest[32];
      hasher.finish(digest);
      char name[32] = "/hvd";
      for (int i = 0; i < 8; i++)
        std::snprintf(name + 4 + 2 * i, 3, "%02x", digest[i]);
      long slot = 4 << 20;
      const char* slot_env = getenv("HOROVOD_SHM_SLOT_BYTES");
      if (slot_env && *slot_env && atol(slot_env) > 0) slot = atol(slot_env);
      hvd::g_hier.shm = hvd_shm_create(
          hvd::g_hier.local_rank, hvd::g_hier.local_size, name, slot);
      if (!hvd::g_hier.shm) {
        hvd::g_last_error = std::string("shm local data plane failed (") +
                            hvd_shm_last_error() +
                            "); set HOROVOD_SHM_DISABLE=1 to use the TCP "
                            "local ring";
        return -1;
      }
      // Ring transfers stamp liveness into the shared heartbeat so barrier
      // waiters in OTHER local processes can tell "leader busy on the
      // cross phase" from "rank died" (idle timeout, see shm.cc).
      hvd_ring_set_progress_sink(
          hvd_shm_heartbeat_addr(hvd::g_hier.shm));
    } else {
      hvd::g_hier.local_ring = hvd_ringh_create(
          hvd::g_hier.local_rank, hvd::g_hier.local_size, local_addrs, secret,
          secret_len);
      if (!hvd::g_hier.local_ring) {
        hvd::g_last_error = hvd_ring_last_error();
        return -1;
      }
      hvd_ringh_set_link(hvd::g_hier.local_ring, 1 /* LINK_LOCAL */);
    }
    if (hvd::g_hier.local_rank == 0) {
      hvd::g_hier.cross_ring = hvd_ringh_create(
          hvd::g_hier.cross_rank, hvd::g_hier.cross_size, cross_addrs, secret,
          secret_len);
      if (hvd::g_hier.cross_ring)
        hvd_ringh_set_link(hvd::g_hier.cross_ring, 2 /* LINK_CROSS */);
      if (!hvd::g_hier.cross_ring) {
        hvd::g_last_error = hvd_ring_last_error();
        // Don't leak the half-built pair (its bound listener would make a
        // retry fail with EADDRINUSE forever). Unregister the heartbeat
        // sink BEFORE unmapping the segment it points into — later ring
        // traffic (retry handshakes) must not store through a stale
        // pointer.
        if (hvd::g_hier.local_ring) hvd_ringh_destroy(hvd::g_hier.local_ring);
        if (hvd::g_hier.shm) {
          hvd_ring_set_progress_sink(nullptr);
          hvd_shm_destroy(hvd::g_hier.shm);
        }
        hvd::g_hier = hvd::HierState{};
        return -1;
      }
    }
  } else {
    hvd::g_hier.allreduce = hvd::g_hier.allgather = false;
  }
  // A previous finished engine is leaked deliberately (see g_engine note).
  hvd::g_engine_gen++;
  hvd::g_engine = new hvd::Engine(
      rank, size, cycle_ms, fusion_threshold, cache_capacity,
      stall_disable != 0, stall_warn_s, stall_shutdown_s,
      timeline_path ? timeline_path : "", timeline_mark_cycles != 0,
      wire_dtype, pipeline != 0);
  return 0;
}

long long hvd_eng_enqueue(int op, const char* name, void* data,
                          const long long* shape, int ndim, int dtype,
                          int root_rank, void* residual, int priority) {
  if (!hvd::g_engine) {
    hvd::g_last_error = "engine not initialized";
    return -1;
  }
  return hvd::g_engine->enqueue((uint8_t)op, name, data,
                                (const int64_t*)shape, ndim, (uint8_t)dtype,
                                root_rank, residual, (int32_t)priority);
}

int hvd_eng_poll(long long h) {
  return hvd::g_engine ? hvd::g_engine->poll(h) : -1;
}

int hvd_eng_wait(long long h) {
  return hvd::g_engine ? hvd::g_engine->wait(h) : -1;
}

int hvd_eng_wait_for(long long h, double timeout_s) {
  return hvd::g_engine ? hvd::g_engine->wait_for(h, timeout_s) : -1;
}

int hvd_eng_hier_active() {
  return hvd::g_engine && hvd::g_engine->hier_active() ? 1 : 0;
}

long long hvd_eng_result_nbytes(long long h) {
  auto* s = hvd::g_engine ? hvd::g_engine->slot(h) : nullptr;
  return s ? (long long)s->data.size() : -1;
}

int hvd_eng_result_ndim(long long h) {
  auto* s = hvd::g_engine ? hvd::g_engine->slot(h) : nullptr;
  return s ? (int)s->shape.size() : -1;
}

int hvd_eng_result_dtype(long long h) {
  auto* s = hvd::g_engine ? hvd::g_engine->slot(h) : nullptr;
  return s ? (int)s->dtype : -1;
}

// 1 when the result was written into the caller's enqueue buffer
// (allreduce/broadcast); 0 when it lives in the slot (allgather).
int hvd_eng_result_in_place(long long h) {
  auto* s = hvd::g_engine ? hvd::g_engine->slot(h) : nullptr;
  return s && s->in_place ? 1 : 0;
}

void hvd_eng_result_shape(long long h, long long* out) {
  auto* s = hvd::g_engine ? hvd::g_engine->slot(h) : nullptr;
  if (!s) return;
  for (size_t i = 0; i < s->shape.size(); i++) out[i] = s->shape[i];
}

// Allgather: number of ranks in the negotiated per-rank first-dim list
// (0 for other ops), and the list itself.
int hvd_eng_result_sizes_count(long long h) {
  auto* s = hvd::g_engine ? hvd::g_engine->slot(h) : nullptr;
  return s ? (int)s->tensor_sizes.size() : -1;
}

void hvd_eng_result_sizes(long long h, long long* out) {
  auto* s = hvd::g_engine ? hvd::g_engine->slot(h) : nullptr;
  if (!s) return;
  for (size_t i = 0; i < s->tensor_sizes.size(); i++)
    out[i] = s->tensor_sizes[i];
}

int hvd_eng_result_copy(long long h, void* dst) {
  auto* s = hvd::g_engine ? hvd::g_engine->slot(h) : nullptr;
  if (!s) return -1;
  std::memcpy(dst, s->data.data(), s->data.size());
  return 0;
}

const char* hvd_eng_handle_error(long long h) {
  auto* s = hvd::g_engine ? hvd::g_engine->slot(h) : nullptr;
  return s ? s->error.c_str() : "unknown handle";
}

void hvd_eng_release(long long h) {
  if (hvd::g_engine) hvd::g_engine->release(h);
}

void hvd_eng_set_params(long long fusion_threshold, double cycle_ms) {
  if (hvd::g_engine) hvd::g_engine->set_params(fusion_threshold, cycle_ms);
}

void hvd_eng_get_stats(long long* cycles, long long* bytes, double* busy_s) {
  if (hvd::g_engine)
    hvd::g_engine->get_stats(cycles, bytes, busy_s);
  else {
    *cycles = 0;
    *bytes = 0;
    *busy_s = 0;
  }
}

// 1 when an engine exists in this process (live or finished husk) — lets
// the Python metrics mirror skip processes whose only native use is the
// ring data plane (the Python controller also loads this library).
int hvd_eng_active() { return hvd::g_engine ? 1 : 0; }

// Arm/disarm span tracing. capacity > 0 (re)sizes the span ring (clamped
// to [256, 2^20]; resets it); capacity <= 0 keeps/creates the default.
void hvd_eng_trace_set(int enabled, long long capacity) {
  if (hvd::g_engine) hvd::g_engine->trace_set(enabled != 0, capacity);
}

// Drain up to `max` spans oldest-first into caller-provided parallel
// arrays (`ops` holds fixed `op_stride`-byte NUL-terminated name slots);
// returns the count consumed. Phase codes index trace/tracer.py PHASES.
int hvd_eng_get_spans(long long max, int* phases, long long* seqs,
                      double* t0s, double* t1s, int* tensors, char* ops,
                      int op_stride) {
  if (!hvd::g_engine) return 0;
  return hvd::g_engine->drain_spans(max, phases, seqs, t0s, t1s, tensors,
                                    ops, op_stride);
}

// Cumulative counters + histogram buckets (slot layout: CounterSlot /
// bindings.NATIVE_COUNTER_SCALARS..N_NATIVE_COUNTER_SLOTS). Fills
// min(n, slot count) entries of
// `out`; returns the slot count so callers can size-check. Zeros when no
// engine was ever initialized.
int hvd_eng_get_counters(long long* out, int n) {
  if (hvd::g_engine)
    hvd::g_engine->get_counters(out, n);
  else
    for (int i = 0; i < n && i < hvd::N_COUNTER_SLOTS; i++) out[i] = 0;
  if (n > hvd::CTR_ENGINE_GEN) out[hvd::CTR_ENGINE_GEN] = hvd::g_engine_gen;
  return hvd::N_COUNTER_SLOTS;
}

// Rank 0's tune loop pushes the GP-tuned gradient-bucket size here; the
// value rides the next cycle reply so EVERY rank adopts it together
// (docs/overlap.md — the token slot the r13 sync left open).
void hvd_eng_set_tuned_bucket(long long nbytes) {
  if (hvd::g_engine) hvd::g_engine->set_tuned_bucket(nbytes);
}

// Overhead micro-bench: stamp n spans through the real path under the
// current trace_set state; returns elapsed seconds.
double hvd_eng_span_probe(long long n) {
  return hvd::g_engine ? hvd::g_engine->span_probe(n) : 0.0;
}

int hvd_eng_shutdown() {
  std::lock_guard<std::mutex> g(hvd::g_engine_mu);
  if (!hvd::g_engine) return 0;
  hvd::g_engine->finish();  // join loop + free buffers; husk stays valid
  return 0;
}

}  // extern "C"
