// Copied from horovod_tpu/native/wire.h, unchanged apart from this note.
// The port's ops/wire.py packs the same bytes (tests/test_torch_native.py).
//
// Wire format for control messages — C++ twin of horovod_tpu/ops/wire.py.
//
// TPU-native re-design of the reference's flatbuffers control layer
// (horovod/common/mpi_message.{h,cc}, wire/mpi_message.fbs): hand-rolled
// little-endian structs, since the messages are tiny and only travel the
// dynamic path (eager ops / variable allgather / error negotiation).
#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace hvdtpu {

// ≙ MPIDataType (mpi_message.h:26-36) + bfloat16/float16 for TPU.
enum class DataType : uint8_t {
  kUint8 = 0, kInt8 = 1, kUint16 = 2, kInt16 = 3, kInt32 = 4, kInt64 = 5,
  kFloat32 = 6, kFloat64 = 7, kBool = 8, kBfloat16 = 9, kFloat16 = 10,
  kUint32 = 11, kUint64 = 12,
};

const char* DataTypeName(DataType t);
int DataTypeSize(DataType t);  // bytes per element (≙ wire.dtype_size)

// ≙ MPIRequestType / MPIResponseType (mpi_message.h); JOIN is the
// post-v0.13 uneven-workload barrier (see ops/wire.py).
enum class RequestType : uint8_t { kAllreduce = 0, kAllgather = 1,
                                   kBroadcast = 2, kJoin = 3,
                                   kReducescatter = 4, kAlltoall = 5 };
// kCacheFlush is the response-cache epoch marker (ops/cache.py): the
// cache itself layers ABOVE both coordinator implementations in the
// Python facade (ops/coordinator.py Coordinator), so the native
// coordinator never produces or consumes it — the value is mirrored
// here only to keep the wire enum spaces identical.
enum class ResponseType : uint8_t { kAllreduce = 0, kAllgather = 1,
                                    kBroadcast = 2, kError = 3, kDone = 4,
                                    kShutdown = 5, kJoin = 6,
                                    kReducescatter = 7, kAlltoall = 8,
                                    kCacheFlush = 9 };

// Allreduce reduction operator (post-v0.13 Horovod op= API; the v0.13
// reference hard-codes MPI_SUM).  ≙ ops/wire.py ReduceOp.
enum class ReduceOp : uint8_t { kAverage = 0, kSum = 1, kAdasum = 2,
                                kMin = 3, kMax = 4, kProduct = 5 };

const char* ReduceOpName(ReduceOp op);

constexpr int kCpuDeviceId = -1;  // ≙ CPU_DEVICE_ID (common.h:28)

// ≙ MPIRequest (mpi_message.h:43-85).
struct Request {
  RequestType request_type;
  DataType tensor_type;
  int32_t request_rank;
  int32_t root_rank;
  int32_t device;
  // ALLREDUCE only; coordinator-validated for cross-rank agreement.
  ReduceOp reduce_op = ReduceOp::kAverage;
  // Process set (0 = global); ranks are set-local for non-global sets.
  uint16_t process_set_id = 0;
  std::string tensor_name;
  std::vector<int64_t> tensor_shape;
  // ALLTOALL only: dim-0 rows sent to each destination (empty = even).
  std::vector<int64_t> splits;

  std::string Pack() const;
  // Returns bytes consumed, or -1 on malformed input.
  static ssize_t Unpack(const uint8_t* buf, size_t len, Request* out);
};

// ≙ MPIResponse (mpi_message.h:112-157).
struct Response {
  ResponseType response_type;
  std::vector<std::string> tensor_names;
  std::string error_message;
  std::vector<int32_t> devices;
  // ALLGATHER: dim-0 per rank (0 for joined ranks); BROADCAST:
  // [root_rank]; JOIN: [last joining rank].
  std::vector<int64_t> tensor_sizes;
  // hvd.join support: validated dtype (-1 = absent, 255 on the wire)
  // and per-fused-tensor shapes, for joined ranks' zero contributions.
  int tensor_type = -1;
  std::vector<std::vector<int64_t>> tensor_shapes;
  // ALLREDUCE: validated reduction operator (fusion is homogeneous in it).
  ReduceOp reduce_op = ReduceOp::kAverage;
  // Process set the response belongs to (0 = global).
  uint16_t process_set_id = 0;

  std::string Pack() const;
};

std::string PackResponseList(const std::vector<Response>& rs);

}  // namespace hvdtpu
