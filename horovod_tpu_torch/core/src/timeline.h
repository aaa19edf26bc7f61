// Horovod Timeline for the native engine: Chrome-tracing JSON profiler.
//
// Reference: horovod/common/timeline.{h,cc} — rank 0 writes one
// chrome://tracing file covering all ranks (the coordinator knows every
// tensor's lifecycle), with a dedicated writer thread draining a queue so the
// hot path never blocks (timeline.h:46-74, WriterLoop timeline.cc:120).
//
// Event vocabulary and JSON shape match the Python twin
// (horovod_tpu_torch/common/timeline.py) so tooling and tests treat both engines'
// traces identically: per-tensor chrome "process" (pid) metadata, NEGOTIATE_*
// B/E spans, per-rank instant events during negotiation, top-level op spans,
// tid-1 activity spans, and opt-in CYCLE_START instants.

#ifndef HVD_TPU_TIMELINE_H_
#define HVD_TPU_TIMELINE_H_

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>

namespace hvd {

class Timeline {
 public:
  Timeline(const std::string& filename, bool mark_cycles)
      : mark_cycles_(mark_cycles),
        start_(std::chrono::steady_clock::now()),
        file_(std::fopen(filename.c_str(), "w")) {
    if (file_) {
      std::fputs("[\n", file_);
      writer_ = std::thread([this] { writer_loop(); });
    }
  }

  ~Timeline() { close(); }

  bool enabled() const { return file_ != nullptr; }

  void negotiate_start(const std::string& tensor, const char* op_name) {
    char ev[160];
    std::snprintf(ev, sizeof(ev),
                  "{\"name\": \"NEGOTIATE_%s\", \"ph\": \"B\", \"pid\": %d, "
                  "\"ts\": %lld}",
                  op_name, pid_of(tensor), now_us());
    emit(ev);
  }

  // Instant event when a rank's request arrives at the coordinator.
  void negotiate_rank_ready(const std::string& tensor, int rank) {
    char ev[160];
    std::snprintf(ev, sizeof(ev),
                  "{\"name\": \"%d\", \"ph\": \"i\", \"pid\": %d, "
                  "\"ts\": %lld, \"s\": \"p\"}",
                  rank, pid_of(tensor), now_us());
    emit(ev);
  }

  void negotiate_end(const std::string& tensor, const char* op_name) {
    char ev[160];
    std::snprintf(ev, sizeof(ev),
                  "{\"name\": \"NEGOTIATE_%s\", \"ph\": \"E\", \"pid\": %d, "
                  "\"ts\": %lld}",
                  op_name, pid_of(tensor), now_us());
    emit(ev);
  }

  // Top-level operation span (ALLREDUCE/ALLGATHER/BROADCAST).
  void start(const std::string& tensor, const char* op_name) {
    char ev[160];
    std::snprintf(ev, sizeof(ev),
                  "{\"name\": \"%s\", \"ph\": \"B\", \"pid\": %d, "
                  "\"ts\": %lld}",
                  op_name, pid_of(tensor), now_us());
    emit(ev);
  }

  void activity_start(const std::string& tensor, const char* activity) {
    char ev[192];
    std::snprintf(ev, sizeof(ev),
                  "{\"name\": \"%s\", \"ph\": \"B\", \"pid\": %d, "
                  "\"tid\": 1, \"ts\": %lld}",
                  activity, pid_of(tensor), now_us());
    emit(ev);
  }

  void activity_end(const std::string& tensor) {
    char ev[128];
    std::snprintf(ev, sizeof(ev),
                  "{\"ph\": \"E\", \"pid\": %d, \"tid\": 1, \"ts\": %lld}",
                  pid_of(tensor), now_us());
    emit(ev);
  }

  void end(const std::string& tensor) {
    char ev[128];
    std::snprintf(ev, sizeof(ev),
                  "{\"ph\": \"E\", \"pid\": %d, \"ts\": %lld}",
                  pid_of(tensor), now_us());
    emit(ev);
  }

  void mark_cycle_start() {
    if (!mark_cycles_) return;
    char ev[128];
    std::snprintf(ev, sizeof(ev),
                  "{\"name\": \"CYCLE_START\", \"ph\": \"i\", \"pid\": 0, "
                  "\"ts\": %lld, \"s\": \"g\"}",
                  now_us());
    emit(ev);
  }

  void close() {
    if (!file_ || closed_) return;
    {
      std::lock_guard<std::mutex> g(mu_);
      closed_ = true;
    }
    cv_.notify_all();
    if (writer_.joinable()) writer_.join();
    std::fputs("{\"name\": \"trace_end\", \"ph\": \"M\", \"pid\": 0}\n]\n",
               file_);
    std::fclose(file_);
    file_ = nullptr;
  }

 private:
  long long now_us() const {
    return std::chrono::duration_cast<std::chrono::microseconds>(
               std::chrono::steady_clock::now() - start_)
        .count();
  }

  // Tensor names are user input: escape per JSON (the Python twin gets this
  // from json.dumps) so names with quotes/backslashes/control chars keep the
  // trace parseable.
  static std::string json_escape(const std::string& s) {
    std::string out;
    out.reserve(s.size());
    for (unsigned char c : s) {
      switch (c) {
        case '"': out += "\\\""; break;
        case '\\': out += "\\\\"; break;
        case '\n': out += "\\n"; break;
        case '\r': out += "\\r"; break;
        case '\t': out += "\\t"; break;
        default:
          if (c < 0x20) {
            char buf[8];
            std::snprintf(buf, sizeof(buf), "\\u%04x", c);
            out += buf;
          } else {
            out += (char)c;
          }
      }
    }
    return out;
  }

  int pid_of(const std::string& tensor) {
    std::lock_guard<std::mutex> g(pid_mu_);
    auto it = pids_.find(tensor);
    if (it != pids_.end()) return it->second;
    int pid = (int)pids_.size() + 1;
    pids_[tensor] = pid;
    emit("{\"name\": \"process_name\", \"ph\": \"M\", \"pid\": " +
         std::to_string(pid) + ", \"args\": {\"name\": \"" +
         json_escape(tensor) + "\"}}");
    emit("{\"name\": \"process_sort_index\", \"ph\": \"M\", \"pid\": " +
         std::to_string(pid) + ", \"args\": {\"sort_index\": " +
         std::to_string(pid) + "}}");
    return pid;
  }

  void emit(const std::string& event) {
    if (!file_) return;
    {
      std::lock_guard<std::mutex> g(mu_);
      if (closed_ || queue_.size() >= (1u << 20)) return;  // drop, don't block
      queue_.push_back(event);
    }
    cv_.notify_one();
  }

  void writer_loop() {
    std::unique_lock<std::mutex> lk(mu_);
    while (true) {
      cv_.wait(lk, [this] { return closed_ || !queue_.empty(); });
      while (!queue_.empty()) {
        std::string ev = std::move(queue_.front());
        queue_.pop_front();
        lk.unlock();
        std::fputs(ev.c_str(), file_);
        std::fputs(",\n", file_);
        lk.lock();
      }
      if (closed_) return;
    }
  }

  bool mark_cycles_;
  std::chrono::steady_clock::time_point start_;
  std::FILE* file_;
  std::mutex mu_;        // guards queue_ + closed_
  std::mutex pid_mu_;    // guards pids_
  std::condition_variable cv_;
  std::deque<std::string> queue_;
  std::map<std::string, int> pids_;
  bool closed_ = false;
  std::thread writer_;
};

}  // namespace hvd

#endif  // HVD_TPU_TIMELINE_H_
