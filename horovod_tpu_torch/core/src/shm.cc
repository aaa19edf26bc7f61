// /dev/shm local data plane: same-host ranks exchange bytes through one
// POSIX shared-memory segment instead of the kernel socket stack.
//
// Reference analogue: MPIHierarchicalAllgather's node-shared window
// (MPI_Win_allocate_shared, horovod/common/ops/mpi_operations.cc:216-243) —
// the reference's intra-node phase is literally a memcpy into shared memory
// followed by cross-node MPI on the node leader. This file gives the native
// engine's hierarchical local phase (engine.cc hier_ring_allreduce /
// execute_allgather) the same structure: slots in a mapped segment, a
// process-shared pthread barrier for phase sync, parallel chunk reduction
// across local ranks, and the cross-node traffic still on the TCP ring of
// local roots. Loopback TCP moves every byte through the kernel twice;
// this moves it through cache-speed memcpy/SIMD reduce loops.
//
// Lifecycle: rank 0 creates and initializes the segment, peers attach and
// spin on the ready flag, everyone meets in one attach barrier, then rank 0
// shm_unlinks the name — the segment lives until the last munmap, and a
// crashed job leaks nothing. A stale same-name segment from a killed job is
// unlinked and recreated. Phase sync is a sense-reversal barrier with a
// 60 s timeout (matching the TCP ring's socket-wait timeout, ring.cc
// wait_fd): a local rank dying mid-operation surfaces as an engine error
// on its peers instead of an unbounded hang.

#include <fcntl.h>
#include <linux/futex.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <climits>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <string>

extern "C" {
// ring.cc (shared dtype kernels + error sink + ring liveness signal)
void hvd_dtype_accumulate(void* dst, const void* src, long count, int dtype);
long hvd_dtype_size(int dtype);
const char* hvd_ring_last_error();
double hvd_ring_progress_mono_s();
}

namespace {

// Written once via hvd_shm-internal set_error; read via hvd_shm_last_error.
std::string g_shm_error;

void set_error(const std::string& msg) { g_shm_error = msg; }

constexpr uint32_t kMagic = 0x48565353;  // "HVSS"
constexpr size_t kAlign = 64;

size_t align_up(size_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

struct Header {
  uint32_t magic;
  std::atomic<uint32_t> ready;
  // Sense-reversal barrier state: arrivals in the current phase, and the
  // phase generation waiters spin on.
  std::atomic<uint32_t> arrived;
  std::atomic<uint32_t> generation;
  // Cross-process liveness word: every local rank's ring layer stamps its
  // transfer progress here (hvd_ring_set_progress_sink), so barrier
  // waiters can tell "leader busy moving bytes" from "rank died". On its
  // own cache line: the leader stores per socket chunk while peers spin
  // on `generation` — sharing a line would ping-pong it every chunk.
  alignas(64) std::atomic<double> heartbeat;
  long slot_bytes;
  int nslots;
};

constexpr double kBarrierTimeoutS = 60.0;  // == ring.cc wait_fd timeout

struct Group {
  Header* hdr = nullptr;
  uint8_t* result = nullptr;  // one slot-sized reduction/broadcast area
  uint8_t* slots = nullptr;   // nslots contiguous slot areas
  size_t map_len = 0;
  int rank = 0;
  int size = 1;
  long slot_bytes = 0;

  uint8_t* slot(int r) const { return slots + (size_t)r * slot_bytes; }
};

double mono_s() {
  return std::chrono::duration_cast<std::chrono::duration<double>>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Process-shared futex on the generation word (plain FUTEX_WAIT/WAKE, not
// the PRIVATE variant — the segment is mapped by several processes).
long futex_wait(std::atomic<uint32_t>* addr, uint32_t expected,
                double timeout_s) {
  struct timespec ts;
  ts.tv_sec = (time_t)timeout_s;
  ts.tv_nsec = (long)((timeout_s - (double)ts.tv_sec) * 1e9);
  return syscall(SYS_futex, (uint32_t*)addr, FUTEX_WAIT, expected, &ts,
                 nullptr, 0);
}

void futex_wake_all(std::atomic<uint32_t>* addr) {
  syscall(SYS_futex, (uint32_t*)addr, FUTEX_WAKE, INT_MAX, nullptr, nullptr,
          0);
}

bool barrier(Group* g) {
  Header* h = g->hdr;
  uint32_t gen = h->generation.load(std::memory_order_acquire);
  uint32_t pos = h->arrived.fetch_add(1, std::memory_order_acq_rel) + 1;
  if (pos == (uint32_t)g->size) {
    // Last arriver releases the phase. arrived resets BEFORE the
    // generation bump: peers only proceed (and re-arrive for the next
    // phase) after acquiring the new generation, which orders the reset
    // before any next-phase increment.
    h->arrived.store(0, std::memory_order_relaxed);
    h->generation.fetch_add(1, std::memory_order_release);
    futex_wake_all(&h->generation);
    return true;
  }
  // Brief yield phase first (covers the near-simultaneous-arrival case
  // without a syscall round-trip), then block in the kernel with a bounded
  // wait — a dead local rank surfaces as an error after kBarrierTimeoutS
  // instead of hanging forever. Kept short: on a timeshared core long
  // yield-spinning steals quanta from the very peers being waited on.
  for (int i = 0; i < 8; i++) {
    if (h->generation.load(std::memory_order_acquire) != gen) return true;
    sched_yield();
  }
  // IDLE timeout, not a phase-duration cap: a peer may legitimately hold
  // everyone at this barrier for a long time while its cross-node TCP
  // phase moves a large payload (hier_ring_allreduce: non-root local
  // ranks wait in the broadcast barrier during the leader's cross-ring
  // exchange). Ring traffic in this process resets the deadline — only
  // "nothing moved for kBarrierTimeoutS" is treated as a dead rank, the
  // same semantics as the ring's per-poll 60 s (ring.cc wait_fd).
  double start = mono_s();
  for (;;) {
    if (h->generation.load(std::memory_order_acquire) != gen) return true;
    // Freshest liveness of the whole local group: this process's ring
    // traffic OR any peer's (stamped into the shared heartbeat word).
    double anchor = hvd_ring_progress_mono_s();
    double hb = h->heartbeat.load(std::memory_order_relaxed);
    if (hb > anchor) anchor = hb;
    if (anchor < start) anchor = start;
    double remain = anchor + kBarrierTimeoutS - mono_s();
    if (remain <= 0) {
      set_error("shm barrier timed out (60s idle) — a local rank died or "
                "stalled mid-operation");
      return false;
    }
    // Wake (or EAGAIN on a raced generation bump, or timeout slice) and
    // re-check; 1 s slices keep the idle deadline honest across spurious
    // wakes and refresh the ring-progress anchor.
    futex_wait(&h->generation, gen, remain < 1.0 ? remain : 1.0);
  }
}

}  // namespace

extern "C" {

const char* hvd_shm_last_error() { return g_shm_error.c_str(); }

// Create (rank 0) or attach (others) the local group segment. `name` must
// be identical across the group and unique per job+group (the engine
// derives it from the job secret). Returns nullptr on failure.
void* hvd_shm_create(int local_rank, int local_size, const char* name,
                     long slot_bytes) {
  // Slot must hold at least one element of the widest dtype (8 bytes) per
  // chunk or the chunk loops would never advance; anything below a page is
  // a misconfiguration anyway.
  if (local_size < 2 || slot_bytes < 4096) {
    set_error("shm group needs local_size >= 2 and slot_bytes >= 4096");
    return nullptr;
  }
  size_t header_len = align_up(sizeof(Header));
  size_t map_len =
      header_len + align_up((size_t)slot_bytes) * (size_t)(local_size + 1);

  int fd = -1;
  if (local_rank == 0) {
    fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0 && errno == EEXIST) {
      // Stale segment from a killed job: replace it.
      shm_unlink(name);
      fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
    }
    if (fd < 0) {
      set_error(std::string("shm_open(create): ") + strerror(errno));
      return nullptr;
    }
    if (ftruncate(fd, (off_t)map_len) != 0) {
      set_error(std::string("ftruncate: ") + strerror(errno));
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    // Attach: the creator may not have run yet; poll briefly. The stale-
    // segment race (we open a dead job's same-name segment just before
    // rank 0 unlinks and recreates it) is closed below by re-checking that
    // the NAME still resolves to the inode we mapped before entering the
    // attach barrier; the job secret is random per launch by default, so
    // same-name staleness only arises with a user-pinned secret.
    for (int tries = 0; tries < 30000; tries++) {  // <= ~30 s
      fd = shm_open(name, O_RDWR, 0600);
      if (fd >= 0) {
        struct stat st;
        if (fstat(fd, &st) == 0 && (size_t)st.st_size >= map_len) break;
        close(fd);
        fd = -1;
      }
      usleep(1000);
    }
    if (fd < 0) {
      set_error("shm attach timed out waiting for the group creator");
      return nullptr;
    }
  }
  struct stat mapped_st;
  if (fstat(fd, &mapped_st) != 0) {
    set_error(std::string("fstat: ") + strerror(errno));
    close(fd);
    if (local_rank == 0) shm_unlink(name);
    return nullptr;
  }

  void* base =
      mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    set_error(std::string("mmap: ") + strerror(errno));
    if (local_rank == 0) shm_unlink(name);
    return nullptr;
  }

  Group* g = new Group();
  g->hdr = (Header*)base;
  g->result = (uint8_t*)base + header_len;
  g->slots = g->result + align_up((size_t)slot_bytes);
  g->map_len = map_len;
  g->rank = local_rank;
  g->size = local_size;
  g->slot_bytes = slot_bytes;

  if (local_rank == 0) {
    g->hdr->arrived.store(0, std::memory_order_relaxed);
    g->hdr->generation.store(0, std::memory_order_relaxed);
    g->hdr->heartbeat.store(0.0, std::memory_order_relaxed);
    g->hdr->magic = kMagic;
    g->hdr->slot_bytes = slot_bytes;
    g->hdr->nslots = local_size;
    g->hdr->ready.store(1, std::memory_order_release);
  } else {
    bool up = false;
    for (int tries = 0; tries < 30000; tries++) {
      if (g->hdr->ready.load(std::memory_order_acquire) == 1 &&
          g->hdr->magic == kMagic) {
        up = true;
        break;
      }
      usleep(1000);
    }
    if (!up || g->hdr->slot_bytes != slot_bytes ||
        g->hdr->nslots != local_size) {
      set_error(!up ? "shm group never became ready"
                    : "shm group geometry mismatch across ranks");
      munmap(base, map_len);
      delete g;
      return nullptr;
    }
    // Stale-segment guard: if the mapping came from a dead job's segment,
    // rank 0 has by now unlinked that name and created a fresh inode (its
    // very first step). Verify the name still resolves to OUR inode; if
    // not, drop everything and re-attach to the fresh one.
    int check_fd = shm_open(name, O_RDWR, 0600);
    bool stale = true;
    if (check_fd >= 0) {
      struct stat now_st;
      if (fstat(check_fd, &now_st) == 0 &&
          now_st.st_ino == mapped_st.st_ino &&
          now_st.st_dev == mapped_st.st_dev)
        stale = false;
      close(check_fd);
    }
    if (stale) {
      munmap(base, map_len);
      delete g;
      // One level of retry reattaches to the fresh segment; a second stale
      // hit means something else owns the name (two live jobs sharing a
      // pinned secret) — refuse rather than loop.
      static thread_local int reattach_depth = 0;
      if (reattach_depth >= 1) {
        set_error("shm segment name keeps changing under us (two jobs "
                  "sharing one HOROVOD_SECRET_KEY?)");
        return nullptr;
      }
      reattach_depth++;
      void* again = hvd_shm_create(local_rank, local_size, name, slot_bytes);
      reattach_depth--;
      return again;
    }
  }

  // Everyone is mapped; the name can go away now — the segment lives until
  // the last munmap, and nothing leaks if the job dies.
  if (!barrier(g)) {
    munmap(base, map_len);
    if (local_rank == 0) shm_unlink(name);
    delete g;
    return nullptr;
  }
  if (local_rank == 0) shm_unlink(name);
  return g;
}

// In-place local-group allreduce (sum / logical-OR for bool). Chunked by
// slot size; within each chunk every rank reduces its 1/N share of the
// elements across all slots in parallel (the local cores do the reduction
// together, the way the reference's node ranks share the window).
int hvd_shm_allreduce_g(void* h, void* buf, long count, int dtype) {
  Group* g = (Group*)h;
  if (!g) {
    set_error("null shm group");
    return -1;
  }
  long esz = hvd_dtype_size(dtype);
  if (esz <= 0) {
    set_error("unsupported dtype for shm allreduce");
    return -1;
  }
  long elems_per_chunk = g->slot_bytes / esz;
  uint8_t* p = (uint8_t*)buf;
  for (long off = 0; off < count; off += elems_per_chunk) {
    long n = count - off < elems_per_chunk ? count - off : elems_per_chunk;
    std::memcpy(g->slot(g->rank), p + off * esz, (size_t)n * esz);
    if (!barrier(g)) return -1;
    // This rank's share of the chunk: elements [lo, hi).
    long per = n / g->size;
    long lo = (long)g->rank * per;
    long hi = g->rank == g->size - 1 ? n : lo + per;
    if (hi > lo) {
      std::memcpy(g->result + lo * esz, g->slot(0) + lo * esz,
                  (size_t)(hi - lo) * esz);
      for (int s = 1; s < g->size; s++)
        hvd_dtype_accumulate(g->result + lo * esz, g->slot(s) + lo * esz,
                             hi - lo, dtype);
    }
    if (!barrier(g)) return -1;
    std::memcpy(p + off * esz, g->result, (size_t)n * esz);
    // The next chunk overwrites slots and result; nobody may still be
    // reading this chunk's bytes when that happens.
    if (!barrier(g)) return -1;
  }
  return 0;
}

int hvd_shm_broadcast_g(void* h, void* buf, long count, int dtype, int root) {
  Group* g = (Group*)h;
  if (!g) {
    set_error("null shm group");
    return -1;
  }
  long esz = hvd_dtype_size(dtype);
  if (esz <= 0) {
    set_error("unsupported dtype for shm broadcast");
    return -1;
  }
  if (root < 0 || root >= g->size) {
    set_error("shm broadcast root out of range");
    return -1;
  }
  long elems_per_chunk = g->slot_bytes / esz;
  uint8_t* p = (uint8_t*)buf;
  for (long off = 0; off < count; off += elems_per_chunk) {
    long n = count - off < elems_per_chunk ? count - off : elems_per_chunk;
    if (g->rank == root)
      std::memcpy(g->result, p + off * esz, (size_t)n * esz);
    if (!barrier(g)) return -1;
    if (g->rank != root)
      std::memcpy(p + off * esz, g->result, (size_t)n * esz);
    if (!barrier(g)) return -1;
  }
  return 0;
}

// Local-group allgather with per-rank element counts (variable first dims).
// Each pass moves up to slot_bytes of each rank's block; receivers copy
// every rank's pass-bytes straight from the slots into the right output
// offsets.
int hvd_shm_allgather_g(void* h, const void* in, const long* counts,
                        void* out, int dtype) {
  Group* g = (Group*)h;
  if (!g) {
    set_error("null shm group");
    return -1;
  }
  long esz = hvd_dtype_size(dtype);
  if (esz <= 0) {
    set_error("unsupported dtype for shm allgather");
    return -1;
  }
  long elems_per_chunk = g->slot_bytes / esz;
  long max_count = 0;
  for (int r = 0; r < g->size; r++)
    if (counts[r] > max_count) max_count = counts[r];
  // Output offset (elements) of each rank's block.
  long my_off = 0;
  for (int r = 0; r < g->rank; r++) my_off += counts[r];

  const uint8_t* src = (const uint8_t*)in;
  uint8_t* dst = (uint8_t*)out;
  for (long off = 0; off < max_count; off += elems_per_chunk) {
    long mine = counts[g->rank] - off;
    if (mine > elems_per_chunk) mine = elems_per_chunk;
    if (mine > 0)
      std::memcpy(g->slot(g->rank), src + off * esz, (size_t)mine * esz);
    if (!barrier(g)) return -1;
    long out_off = 0;
    for (int r = 0; r < g->size; r++) {
      long theirs = counts[r] - off;
      if (theirs > elems_per_chunk) theirs = elems_per_chunk;
      if (theirs > 0)
        std::memcpy(dst + (out_off + off) * esz, g->slot(r),
                    (size_t)theirs * esz);
      out_off += counts[r];
    }
    if (!barrier(g)) return -1;
  }
  return 0;
}

// Address of the shared heartbeat word, for hvd_ring_set_progress_sink.
void* hvd_shm_heartbeat_addr(void* h) {
  Group* g = (Group*)h;
  return g && g->hdr ? (void*)&g->hdr->heartbeat : nullptr;
}

void hvd_shm_destroy(void* h) {
  Group* g = (Group*)h;
  if (!g) return;
  if (g->hdr) munmap((void*)g->hdr, g->map_len);
  delete g;
}

}  // extern "C"
