// TensorFlow custom-op binding for the port's native eager engine — the
// port's copy of horovod_tpu/tensorflow/src/tf_ops.cc.
//
// Reference: horovod/tensorflow/mpi_ops.cc (466 lines) — three AsyncOpKernels
// (HorovodAllreduce/Allgather/Broadcast, registered at mpi_ops.cc:306-463)
// that enqueue into the background coordinator and fire TF's `done` callback
// from the completion path. The kernels enqueue through the C ABI of the
// port's core (horovod_tpu_torch/core/src/engine.cc: `hvd_eng_enqueue`/
// `hvd_eng_wait`), and a small waiter pool joins engine handles and resumes
// the TF executor off the hot path.
//
// These ops are real graph nodes: no GIL on the data path,
// SavedModel-serializable, and usable from any TF executor thread.
//
// What differs from the JAX package's library, so that both load in one
// process:
//   * the ops carry names of their own (HorovodTpuTorch*): TF refuses a
//     second registration of an op name;
//   * everything lives in the namespace hvd_tpu_torch;
//   * the core library is attached explicitly, once, by the
//     HorovodTpuTorchAttach op (tensorflow/tf_ops.py runs it eagerly after
//     tf.load_op_library with the path of the core .so the ctypes tier
//     loaded), never read from the environment: the JAX library reads
//     HOROVOD_TPU_CORE_LIB, and a shared variable would let one package's
//     ops drive the other's engine. dlopen of an already-mapped library
//     returns the same handle, so both tiers drive one engine.

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "tensorflow/core/framework/op.h"
#include "tensorflow/core/framework/op_kernel.h"
#include "tensorflow/core/framework/shape_inference.h"
#include "tensorflow/core/platform/errors.h"

namespace hvd_tpu_torch {

using ::tensorflow::AsyncOpKernel;
using ::tensorflow::DataType;
using ::tensorflow::OpKernel;
using ::tensorflow::OpKernelConstruction;
using ::tensorflow::OpKernelContext;
using ::tensorflow::Tensor;
using ::tensorflow::TensorShape;
using ::tensorflow::errors::FailedPrecondition;
using ::tensorflow::errors::InvalidArgument;
using ::tensorflow::errors::Unknown;

// ---------------------------------------------------------------------------
// Core-engine C ABI, resolved at attach time (see the header comment).

struct CoreApi {
  // Trailing void* is the int8 error-feedback residual slot;
  // the TF tier never compensates (no per-tensor residual store here),
  // so it always passes nullptr — but the POINTER TYPE must match the
  // core's 9-arg ABI or the callee reads a garbage residual off the
  // stack (hvdabi pins every fn-pointer type here against engine.cc).
  long long (*enqueue)(int, const char*, void*, const long long*, int, int,
                       int, void*, int) = nullptr;
  int (*wait)(long long) = nullptr;
  int (*result_ndim)(long long) = nullptr;
  void (*result_shape)(long long, long long*) = nullptr;
  int (*result_dtype)(long long) = nullptr;
  int (*result_copy)(long long, void*) = nullptr;
  int (*result_in_place)(long long) = nullptr;
  const char* (*handle_error)(long long) = nullptr;
  void (*release)(long long) = nullptr;
  const char* (*last_error)() = nullptr;
  std::string init_error;
  bool ok = false;
};

// Resolve every engine entry point from the core library at `path`. The
// result is never freed: kernels may still hold it on waiter threads.
CoreApi* Resolve(const std::string& path) {
  auto* a = new CoreApi();
  void* h = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (h == nullptr) {
    a->init_error = std::string("dlopen of core library failed: ") +
                    dlerror();
    return a;
  }
  auto sym = [&](const char* name) -> void* {
    void* s = dlsym(h, name);
    if (s == nullptr && a->init_error.empty())
      a->init_error = std::string("missing core symbol ") + name;
    return s;
  };
  a->enqueue = reinterpret_cast<decltype(a->enqueue)>(sym("hvd_eng_enqueue"));
  a->wait = reinterpret_cast<decltype(a->wait)>(sym("hvd_eng_wait"));
  a->result_ndim =
      reinterpret_cast<decltype(a->result_ndim)>(sym("hvd_eng_result_ndim"));
  a->result_shape = reinterpret_cast<decltype(a->result_shape)>(
      sym("hvd_eng_result_shape"));
  a->result_dtype = reinterpret_cast<decltype(a->result_dtype)>(
      sym("hvd_eng_result_dtype"));
  a->result_copy =
      reinterpret_cast<decltype(a->result_copy)>(sym("hvd_eng_result_copy"));
  a->result_in_place = reinterpret_cast<decltype(a->result_in_place)>(
      sym("hvd_eng_result_in_place"));
  a->handle_error = reinterpret_cast<decltype(a->handle_error)>(
      sym("hvd_eng_handle_error"));
  a->release =
      reinterpret_cast<decltype(a->release)>(sym("hvd_eng_release"));
  a->last_error =
      reinterpret_cast<decltype(a->last_error)>(sym("hvd_eng_last_error"));
  a->ok = a->init_error.empty();
  return a;
}

CoreApi* Unattached() {
  static CoreApi* a = [] {
    auto* u = new CoreApi();
    u->init_error =
        "the op library is not attached to the port's core library; load "
        "it through horovod_tpu_torch.tensorflow (tf_ops.load runs "
        "HorovodTpuTorchAttach)";
    return u;
  }();
  return a;
}

std::atomic<CoreApi*> g_api{nullptr};

CoreApi* Api() {
  CoreApi* a = g_api.load(std::memory_order_acquire);
  return a != nullptr ? a : Unattached();
}

// Attach once; a second attach must name the same library (one engine per
// process), else it fails and the first stays.
::tensorflow::Status Attach(const std::string& path) {
  static std::mutex mu;
  static std::string attached;
  std::lock_guard<std::mutex> l(mu);
  if (g_api.load(std::memory_order_acquire) != nullptr) {
    if (path == attached) return ::tensorflow::OkStatus();
    return FailedPrecondition("the op library is attached to ", attached,
                              ", not ", path);
  }
  CoreApi* a = Resolve(path);
  if (!a->ok) return FailedPrecondition(a->init_error);
  attached = path;
  g_api.store(a, std::memory_order_release);
  return ::tensorflow::OkStatus();
}

// Engine dtype codes (must match DType in core/src/ring.cc and
// core/bindings.py DTYPE_CODES).
int DtypeCode(DataType d) {
  switch (d) {
    case ::tensorflow::DT_FLOAT: return 0;
    case ::tensorflow::DT_DOUBLE: return 1;
    case ::tensorflow::DT_INT32: return 2;
    case ::tensorflow::DT_INT64: return 3;
    case ::tensorflow::DT_UINT8: return 4;
    case ::tensorflow::DT_HALF: return 5;
    case ::tensorflow::DT_BFLOAT16: return 6;
    case ::tensorflow::DT_INT8: return 7;
    case ::tensorflow::DT_INT16: return 8;
    case ::tensorflow::DT_UINT16: return 9;
    case ::tensorflow::DT_BOOL: return 10;
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// Waiter pool: the completion side of the reference's AsyncOpKernel design.
// ComputeAsync enqueues into the engine and returns immediately; these
// threads block in hvd_eng_wait (engine cv, no polling), then run the
// finalizer (copy result / set status) and fire TF's `done`. FIFO matches
// the engine's cycle-ordered completion closely enough; a head-of-line wait
// never deadlocks because engine progress doesn't depend on waiters.

class Waiter {
 public:
  static Waiter& Get() {
    static Waiter* w = new Waiter();  // leaked: process-lifetime threads
    return *w;
  }

  // `finalize(rc)` runs on a waiter thread after the engine resolves the
  // handle; it must release the handle itself (so it can read the result
  // slot first) and must end by calling the op's done callback.
  void Submit(long long handle, std::function<void(int)> finalize) {
    {
      std::lock_guard<std::mutex> l(mu_);
      queue_.push_back({handle, std::move(finalize)});
    }
    cv_.notify_one();
  }

 private:
  struct Item {
    long long handle;
    std::function<void(int)> finalize;
  };

  Waiter() {
    for (int i = 0; i < 2; i++) {
      std::thread([this] { Loop(); }).detach();
    }
  }

  void Loop() {
    for (;;) {
      Item item;
      {
        std::unique_lock<std::mutex> l(mu_);
        cv_.wait(l, [this] { return !queue_.empty(); });
        item = std::move(queue_.front());
        queue_.pop_front();
      }
      int rc = Api()->wait(item.handle);
      item.finalize(rc);
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Item> queue_;
};

// Shared ComputeAsync plumbing. `op` is the engine op code (0 allreduce,
// 1 allgather, 2 broadcast).
constexpr int kAllreduce = 0;
constexpr int kAllgather = 1;
constexpr int kBroadcast = 2;

long long EnqueueOrFail(OpKernelContext* ctx,
                        AsyncOpKernel::DoneCallback& done, int op,
                        const std::string& name, void* data,
                        const Tensor& shaped_like, int root_rank) {
  CoreApi* api = Api();
  if (!api->ok) {
    ctx->SetStatus(FailedPrecondition(api->init_error));
    done();
    return -1;
  }
  int code = DtypeCode(shaped_like.dtype());
  if (code < 0) {
    ctx->SetStatus(InvalidArgument(
        "dtype ", ::tensorflow::DataTypeString(shaped_like.dtype()),
        " is not supported by the native engine"));
    done();
    return -1;
  }
  int ndim = shaped_like.dims();
  std::vector<long long> dims(std::max(ndim, 1), 0);
  for (int i = 0; i < ndim; i++) dims[i] = shaped_like.dim_size(i);
  long long h = api->enqueue(op, name.c_str(), data, dims.data(), ndim, code,
                             root_rank, nullptr, /*priority=*/0);
  if (h == -2) {
    ctx->SetStatus(InvalidArgument(
        "Duplicate tensor name '", name,
        "': a collective with this name is already pending; names must be "
        "unique until the operation completes."));
    done();
    return -1;
  }
  if (h == -3) {
    // Engine enqueue's closed/shutdown code (engine.cc enqueue); the
    // ctypes tier maps this to ShutdownError the same way (native.py).
    ctx->SetStatus(FailedPrecondition("Horovod has been shut down"));
    done();
    return -1;
  }
  if (h < 0) {
    ctx->SetStatus(FailedPrecondition(
        "engine enqueue failed (", api->last_error(),
        "); has hvd.init() run with the native engine?"));
    done();
    return -1;
  }
  return h;
}

// Finalizer for the in-place ops (allreduce/broadcast): the engine wrote the
// result directly into the output tensor's buffer, so success needs no copy.
void FinishInPlace(OpKernelContext* ctx, AsyncOpKernel::DoneCallback done,
                   long long handle, int rc) {
  CoreApi* api = Api();
  if (rc != 0) {
    ctx->SetStatus(Unknown(api->handle_error(handle)));
  }
  api->release(handle);
  done();
}

class AllreduceKernel : public AsyncOpKernel {
 public:
  explicit AllreduceKernel(OpKernelConstruction* ctx) : AsyncOpKernel(ctx) {
    OP_REQUIRES_OK(ctx, ctx->GetAttr("tensor_name", &tensor_name_));
  }

  void ComputeAsync(OpKernelContext* ctx, DoneCallback done) override {
    const Tensor& input = ctx->input(0);
    Tensor* output = nullptr;
    // Reuse the input buffer when TF lets us (refcount 1): the engine
    // reduces in place, so forwarding makes the whole op zero-copy
    // (reference fused-buffer memcpy avoidance, mpi_operations.cc:40-49).
    OP_REQUIRES_OK_ASYNC(
        ctx,
        ctx->forward_input_or_allocate_output({0}, 0, input.shape(), &output),
        done);
    if (output->data() != input.data() && input.TotalBytes() > 0) {
      std::memcpy(output->data(), input.data(), input.TotalBytes());
    }
    const std::string name =
        tensor_name_.empty() ? std::string(this->name()) : tensor_name_;
    long long h =
        EnqueueOrFail(ctx, done, kAllreduce, name, output->data(), *output,
                      /*root_rank=*/-1);
    if (h < 0) return;  // status set + done called
    Waiter::Get().Submit(h, [ctx, done, h](int rc) {
      FinishInPlace(ctx, done, h, rc);
    });
  }

 private:
  std::string tensor_name_;
};

class AllgatherKernel : public AsyncOpKernel {
 public:
  explicit AllgatherKernel(OpKernelConstruction* ctx) : AsyncOpKernel(ctx) {
    OP_REQUIRES_OK(ctx, ctx->GetAttr("tensor_name", &tensor_name_));
  }

  void ComputeAsync(OpKernelContext* ctx, DoneCallback done) override {
    // The engine reads the input buffer asynchronously; capturing the
    // Tensor (refcounted) in the finalizer keeps it alive until the handle
    // resolves, as the ctypes tier pins a tensor until its handle is
    // waited on.
    Tensor input = ctx->input(0);
    const std::string name =
        tensor_name_.empty() ? std::string(this->name()) : tensor_name_;
    long long h = EnqueueOrFail(ctx, done, kAllgather, name, input.data(),
                                input, /*root_rank=*/-1);
    if (h < 0) return;
    Waiter::Get().Submit(h, [ctx, done, h, input](int rc) {
      CoreApi* api = Api();
      if (rc != 0) {
        ctx->SetStatus(Unknown(api->handle_error(h)));
        api->release(h);
        done();
        return;
      }
      // Output first-dim is only known after negotiation (the response
      // carries every rank's first dim, message.h Response): allocate the
      // TF output now, from the completion thread — exactly how the
      // reference allocates through TFOpContext from the coordinator
      // (tensorflow/mpi_ops.cc:225-258).
      int ndim = api->result_ndim(h);
      std::vector<long long> dims(std::max(ndim, 1), 0);
      api->result_shape(h, dims.data());
      TensorShape shape;
      for (int i = 0; i < ndim; i++) shape.AddDim(dims[i]);
      Tensor* output = nullptr;
      ::tensorflow::Status s = ctx->allocate_output(0, shape, &output);
      if (s.ok() && output->TotalBytes() > 0) {
        api->result_copy(h, output->data());
      }
      if (!s.ok()) ctx->SetStatus(s);
      api->release(h);
      done();
    });
  }

 private:
  std::string tensor_name_;
};

class BroadcastKernel : public AsyncOpKernel {
 public:
  explicit BroadcastKernel(OpKernelConstruction* ctx) : AsyncOpKernel(ctx) {
    OP_REQUIRES_OK(ctx, ctx->GetAttr("tensor_name", &tensor_name_));
    OP_REQUIRES_OK(ctx, ctx->GetAttr("root_rank", &root_rank_));
  }

  void ComputeAsync(OpKernelContext* ctx, DoneCallback done) override {
    const Tensor& input = ctx->input(0);
    Tensor* output = nullptr;
    OP_REQUIRES_OK_ASYNC(
        ctx,
        ctx->forward_input_or_allocate_output({0}, 0, input.shape(), &output),
        done);
    if (output->data() != input.data() && input.TotalBytes() > 0) {
      std::memcpy(output->data(), input.data(), input.TotalBytes());
    }
    const std::string name =
        tensor_name_.empty() ? std::string(this->name()) : tensor_name_;
    long long h = EnqueueOrFail(ctx, done, kBroadcast, name, output->data(),
                                *output, root_rank_);
    if (h < 0) return;
    Waiter::Get().Submit(h, [ctx, done, h](int rc) {
      FinishInPlace(ctx, done, h, rc);
    });
  }

 private:
  std::string tensor_name_;
  int root_rank_;
};

class AttachKernel : public OpKernel {
 public:
  explicit AttachKernel(OpKernelConstruction* ctx) : OpKernel(ctx) {
    OP_REQUIRES_OK(ctx, ctx->GetAttr("core_path", &core_path_));
  }

  void Compute(OpKernelContext* ctx) override {
    OP_REQUIRES_OK(ctx, Attach(core_path_));
  }

 private:
  std::string core_path_;
};

// ---------------------------------------------------------------------------
// Op registry. Same surface as the reference (tensorflow/mpi_ops.cc:313-463)
// — allreduce is SUM (averaging is a graph-level divide, reference
// tensorflow/__init__.py:36-87) — widened to every engine dtype (the
// reference's MPI type table stops at the MPI basics; the ring kernels
// cover int8/uint16/bool/bfloat16 too, ring.cc DType).

#define HVD_NUMERIC_TYPES \
  "{int8, int16, int32, int64, uint8, uint16, float16, bfloat16, float32, " \
  "float64, bool}"

REGISTER_OP("HorovodTpuTorchAllreduce")
    .Attr("T: " HVD_NUMERIC_TYPES)
    .Attr("tensor_name: string = ''")
    .Input("tensor: T")
    .Output("sum: T")
    .SetShapeFn([](::tensorflow::shape_inference::InferenceContext* c) {
      c->set_output(0, c->input(0));
      return ::tensorflow::OkStatus();
    })
    .Doc("Sum `tensor` across all horovod_tpu ranks (bool: logical OR).");

REGISTER_OP("HorovodTpuTorchAllgather")
    .Attr("T: " HVD_NUMERIC_TYPES)
    .Attr("tensor_name: string = ''")
    .Input("tensor: T")
    .Output("output: T")
    .SetShapeFn([](::tensorflow::shape_inference::InferenceContext* c) {
      ::tensorflow::shape_inference::ShapeHandle output;
      TF_RETURN_IF_ERROR(
          c->ReplaceDim(c->input(0), 0, c->UnknownDim(), &output));
      c->set_output(0, output);
      return ::tensorflow::OkStatus();
    })
    .Doc("Concatenate `tensor` from all ranks along dimension 0; ranks may "
         "differ in the first dimension only.");

REGISTER_OP("HorovodTpuTorchBroadcast")
    .Attr("T: " HVD_NUMERIC_TYPES)
    .Attr("tensor_name: string = ''")
    .Attr("root_rank: int")
    .Input("tensor: T")
    .Output("output: T")
    .SetShapeFn([](::tensorflow::shape_inference::InferenceContext* c) {
      c->set_output(0, c->input(0));
      return ::tensorflow::OkStatus();
    })
    .Doc("Broadcast `tensor` from `root_rank` to all ranks.");

REGISTER_OP("HorovodTpuTorchAttach")
    .Attr("core_path: string")
    .SetIsStateful()
    .SetShapeFn([](::tensorflow::shape_inference::InferenceContext*) {
      return ::tensorflow::OkStatus();
    })
    .Doc("Attach the op library to the port's core library at `core_path` "
         "(once per process; the collective ops fail until it ran).");

// One registration per op covers every allowed T: the kernels branch on the
// runtime dtype (DtypeCode), so no TypeConstraint fan-out is needed.
REGISTER_KERNEL_BUILDER(
    Name("HorovodTpuTorchAllreduce").Device(::tensorflow::DEVICE_CPU),
    AllreduceKernel);
REGISTER_KERNEL_BUILDER(
    Name("HorovodTpuTorchAllgather").Device(::tensorflow::DEVICE_CPU),
    AllgatherKernel);
REGISTER_KERNEL_BUILDER(
    Name("HorovodTpuTorchBroadcast").Device(::tensorflow::DEVICE_CPU),
    BroadcastKernel);
REGISTER_KERNEL_BUILDER(
    Name("HorovodTpuTorchAttach").Device(::tensorflow::DEVICE_CPU),
    AttachKernel);

}  // namespace hvd_tpu_torch
