// Control-plane message protocol for the native engine: Request / Response
// structs, a compact binary wire format, and the cross-rank validation matrix.
//
// Reference: horovod/common/message.{h,cc} + common/wire/message.fbs — each
// rank's background thread emits a Request per pending tensor (rank, type,
// dtype, name, shape, root); the coordinator replies with a fused
// ResponseList. The reference serializes with FlatBuffers; payloads here are
// tiny and ride the already-authenticated ring connections, so a hand-rolled
// little-endian framing is used instead (one fewer vendored dependency).
//
// construct_response reproduces the reference's full validation matrix
// (ConstructResponse, horovod/common/operations.cc:198-371): mismatched
// dtype / op / shape / root across ranks produces an ERROR response whose
// message is delivered to every participating rank's callback. Error strings
// match horovod_tpu_torch/common/message.py (the Python controller) so both
// engines surface identical diagnostics.

#ifndef HVD_TPU_MESSAGE_H_
#define HVD_TPU_MESSAGE_H_

#include <cstdint>
#include <cstring>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace hvd {

enum RequestType : uint8_t {  // reference message.h:47
  REQ_ALLREDUCE = 0,
  REQ_ALLGATHER = 1,
  REQ_BROADCAST = 2,
};

enum ResponseType : uint8_t {  // reference message.h:132
  RESP_ALLREDUCE = 0,
  RESP_ALLGATHER = 1,
  RESP_BROADCAST = 2,
  RESP_ERROR = 3,
};

struct Request {  // reference message.h:40-120
  int32_t request_rank = 0;
  uint8_t request_type = REQ_ALLREDUCE;
  uint8_t dtype = 0;  // ring.cc DType code
  int32_t root_rank = -1;
  // Launch priority (0 = none). The coordinator stable-sorts each cycle's
  // fused responses by the tagged priority so the optimizer-critical
  // bucket jumps the launch queue on EVERY rank identically. Like dtype,
  // the value must agree across ranks for a given tensor; it is NOT part
  // of same_params — a priority mismatch reorders, it doesn't error.
  int32_t priority = 0;
  std::vector<int64_t> shape;
  std::string tensor_name;

  bool same_params(const Request& o) const {
    return request_type == o.request_type && dtype == o.dtype &&
           root_rank == o.root_rank && shape == o.shape;
  }
};

struct RequestList {  // reference message.h:186-215
  std::vector<Request> requests;
  bool shutdown = false;
};

struct Response {  // reference message.h:125-184
  uint8_t response_type = RESP_ALLREDUCE;
  std::vector<std::string> tensor_names;
  std::string error_message;
  // Allgather only: every rank's dim-0 size, rank order.
  std::vector<int64_t> tensor_sizes;
};

struct ResponseList {
  std::vector<Response> responses;
  bool shutdown = false;
};

// ---------------------------------------------------------------- wire format

class Writer {
 public:
  std::vector<uint8_t> buf;
  void u8(uint8_t v) { buf.push_back(v); }
  void u32(uint32_t v) {
    size_t n = buf.size();
    buf.resize(n + 4);
    std::memcpy(buf.data() + n, &v, 4);
  }
  void i32(int32_t v) { u32((uint32_t)v); }
  void i64(int64_t v) {
    size_t n = buf.size();
    buf.resize(n + 8);
    std::memcpy(buf.data() + n, &v, 8);
  }
  void u64(uint64_t v) { i64((int64_t)v); }
  void str(const std::string& s) {
    u32((uint32_t)s.size());
    buf.insert(buf.end(), s.begin(), s.end());
  }
  void i64vec(const std::vector<int64_t>& v) {
    u32((uint32_t)v.size());
    for (int64_t x : v) i64(x);
  }
  void u64vec(const std::vector<uint64_t>& v) {
    u32((uint32_t)v.size());
    for (uint64_t x : v) u64(x);
  }
};

class Reader {
 public:
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  Reader(const uint8_t* data, size_t n) : p(data), end(data + n) {}

  bool need(size_t n) {
    if ((size_t)(end - p) < n) {
      ok = false;
      return false;
    }
    return true;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return *p++;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  int32_t i32() { return (int32_t)u32(); }
  int64_t i64() {
    if (!need(8)) return 0;
    int64_t v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  uint64_t u64() { return (uint64_t)i64(); }
  std::string str() {
    uint32_t n = u32();
    if (!need(n)) return "";
    std::string s((const char*)p, n);
    p += n;
    return s;
  }
  std::vector<int64_t> i64vec() {
    uint32_t n = u32();
    std::vector<int64_t> v;
    v.reserve(n);
    for (uint32_t i = 0; i < n && ok; i++) v.push_back(i64());
    return v;
  }
  std::vector<uint64_t> u64vec() {
    uint32_t n = u32();
    std::vector<uint64_t> v;
    v.reserve(n);
    for (uint32_t i = 0; i < n && ok; i++) v.push_back(u64());
    return v;
  }
};

inline void write_request(Writer& w, const Request& r) {
  w.i32(r.request_rank);
  w.u8(r.request_type);
  w.u8(r.dtype);
  w.i32(r.root_rank);
  w.i32(r.priority);
  w.i64vec(r.shape);
  w.str(r.tensor_name);
}

inline Request read_request(Reader& r) {
  Request q;
  q.request_rank = r.i32();
  q.request_type = r.u8();
  q.dtype = r.u8();
  q.root_rank = r.i32();
  q.priority = r.i32();
  q.shape = r.i64vec();
  q.tensor_name = r.str();
  return q;
}

inline void write_response(Writer& w, const Response& r) {
  w.u8(r.response_type);
  w.str(r.error_message);
  w.u32((uint32_t)r.tensor_names.size());
  for (const auto& n : r.tensor_names) w.str(n);
  w.i64vec(r.tensor_sizes);
}

inline Response read_response(Reader& r) {
  Response q;
  q.response_type = r.u8();
  q.error_message = r.str();
  uint32_t n = r.u32();
  for (uint32_t i = 0; i < n && r.ok; i++) q.tensor_names.push_back(r.str());
  q.tensor_sizes = r.i64vec();
  return q;
}

// --------------------------------------------------------- validation matrix

// Python-tuple-style shape formatting, matching the Python controller's
// error strings: "()", "(2,)", "(2, 3)".
inline std::string shape_str(const std::vector<int64_t>& shape) {
  std::ostringstream os;
  os << "(";
  for (size_t i = 0; i < shape.size(); i++) {
    if (i) os << ", ";
    os << shape[i];
  }
  if (shape.size() == 1) os << ",";
  os << ")";
  return os.str();
}

inline const char* type_name(uint8_t t) {
  switch (t) {
    case REQ_ALLREDUCE: return "allreduce";
    case REQ_ALLGATHER: return "allgather";
    case REQ_BROADCAST: return "broadcast";
  }
  return "?";
}

// dtype_name is provided by the engine (maps ring DType codes to numpy-style
// names for error messages).
std::string dtype_name(uint8_t code);

// Build one tensor's Response once all `size` ranks have submitted requests
// (reference ConstructResponse, operations.cc:198-371: first mismatch wins,
// error names the offending ranks' values). `requests[i]` is rank i's.
inline Response construct_response(const std::vector<Request>& requests,
                                   int size) {
  const Request& first = requests[0];
  const std::string& name = first.tensor_name;
  Response err;
  err.response_type = RESP_ERROR;
  err.tensor_names.push_back(name);

  for (int i = 1; i < size; i++) {
    const Request& req = requests[i];
    if (req.request_type != first.request_type) {
      std::ostringstream os;
      os << "Mismatched collective operations: rank " << first.request_rank
         << " requested " << type_name(first.request_type) << " of tensor "
         << name << ", but rank " << req.request_rank << " requested "
         << type_name(req.request_type) << ".";
      err.error_message = os.str();
      return err;
    }
  }
  for (int i = 1; i < size; i++) {
    const Request& req = requests[i];
    if (req.dtype != first.dtype) {
      std::ostringstream os;
      os << "Mismatched data types: rank " << first.request_rank
         << " has tensor " << name << " with dtype " << dtype_name(first.dtype)
         << ", but rank " << req.request_rank << " has dtype "
         << dtype_name(req.dtype) << ".";
      err.error_message = os.str();
      return err;
    }
  }

  if (first.request_type == REQ_ALLREDUCE) {
    for (int i = 1; i < size; i++) {
      const Request& req = requests[i];
      if (req.shape != first.shape) {
        std::ostringstream os;
        os << "Mismatched allreduce tensor shapes: rank " << first.request_rank
           << " has shape " << shape_str(first.shape) << " for tensor " << name
           << ", but rank " << req.request_rank << " has shape "
           << shape_str(req.shape) << ".";
        err.error_message = os.str();
        return err;
      }
    }
    Response r;
    r.response_type = RESP_ALLREDUCE;
    r.tensor_names.push_back(name);
    return r;
  }

  if (first.request_type == REQ_BROADCAST) {
    for (int i = 1; i < size; i++) {
      const Request& req = requests[i];
      if (req.root_rank != first.root_rank) {
        std::ostringstream os;
        os << "Mismatched broadcast root ranks: rank " << first.request_rank
           << " specified root " << first.root_rank << " for tensor " << name
           << ", but rank " << req.request_rank << " specified "
           << req.root_rank << ".";
        err.error_message = os.str();
        return err;
      }
    }
    if (first.root_rank < 0 || first.root_rank >= size) {
      std::ostringstream os;
      os << "Invalid broadcast root rank " << first.root_rank << " for tensor "
         << name << ": world size is " << size << ".";
      err.error_message = os.str();
      return err;
    }
    const Request& root_req = requests[first.root_rank];
    for (int i = 0; i < size; i++) {
      const Request& req = requests[i];
      if (req.shape != root_req.shape) {
        std::ostringstream os;
        os << "Mismatched broadcast tensor shapes: root rank "
           << root_req.request_rank << " has shape "
           << shape_str(root_req.shape) << " for tensor " << name
           << ", but rank " << req.request_rank << " has shape "
           << shape_str(req.shape) << ".";
        err.error_message = os.str();
        return err;
      }
    }
    Response r;
    r.response_type = RESP_BROADCAST;
    r.tensor_names.push_back(name);
    return r;
  }

  // ALLGATHER
  for (int i = 1; i < size; i++) {
    const Request& req = requests[i];
    if (req.shape.size() != first.shape.size()) {
      std::ostringstream os;
      os << "Mismatched allgather tensor ranks: rank " << first.request_rank
         << " has rank-" << first.shape.size() << " tensor " << name
         << ", but rank " << req.request_rank << " has rank "
         << req.shape.size() << ".";
      err.error_message = os.str();
      return err;
    }
    if (!first.shape.empty() &&
        !std::equal(req.shape.begin() + 1, req.shape.end(),
                    first.shape.begin() + 1)) {
      std::ostringstream os;
      os << "Mismatched allgather tensor shapes: all dimensions except the "
            "first must match; rank "
         << first.request_rank << " has shape " << shape_str(first.shape)
         << " for tensor " << name << ", but rank " << req.request_rank
         << " has shape " << shape_str(req.shape) << ".";
      err.error_message = os.str();
      return err;
    }
  }
  if (first.shape.empty()) {
    std::ostringstream os;
    os << "Allgather of scalar tensor " << name
       << " is not possible: tensors must have at least one dimension.";
    err.error_message = os.str();
    return err;
  }
  Response r;
  r.response_type = RESP_ALLGATHER;
  r.tensor_names.push_back(name);
  r.tensor_sizes.resize(size);
  for (int i = 0; i < size; i++) r.tensor_sizes[i] = requests[i].shape[0];
  return r;
}

}  // namespace hvd

#endif  // HVD_TPU_MESSAGE_H_
