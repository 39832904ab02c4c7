// Copied from horovod_tpu/native/wire.cc, unchanged apart from this note.
//
// See wire.h. Layouts must stay byte-identical with ops/wire.py.

#include "wire.h"

namespace hvdtpu {

namespace {

template <typename T>
void Append(std::string* out, T v) {
  out->append(reinterpret_cast<const char*>(&v), sizeof(T));
}

template <typename T>
bool ReadLE(const uint8_t* buf, size_t len, size_t* off, T* out) {
  if (*off + sizeof(T) > len) return false;
  std::memcpy(out, buf + *off, sizeof(T));
  *off += sizeof(T);
  return true;
}

}  // namespace

int DataTypeSize(DataType t) {
  switch (t) {
    case DataType::kUint8: case DataType::kInt8: case DataType::kBool:
      return 1;
    case DataType::kUint16: case DataType::kInt16:
    case DataType::kBfloat16: case DataType::kFloat16:
      return 2;
    case DataType::kInt32: case DataType::kFloat32: case DataType::kUint32:
      return 4;
    case DataType::kInt64: case DataType::kFloat64: case DataType::kUint64:
      return 8;
  }
  return 4;
}

const char* ReduceOpName(ReduceOp op) {
  switch (op) {
    case ReduceOp::kAverage: return "average";
    case ReduceOp::kSum: return "sum";
    case ReduceOp::kAdasum: return "adasum";
    case ReduceOp::kMin: return "min";
    case ReduceOp::kMax: return "max";
    case ReduceOp::kProduct: return "product";
  }
  return "unknown";
}

const char* DataTypeName(DataType t) {
  switch (t) {
    case DataType::kUint8: return "uint8";
    case DataType::kInt8: return "int8";
    case DataType::kUint16: return "uint16";
    case DataType::kInt16: return "int16";
    case DataType::kInt32: return "int32";
    case DataType::kInt64: return "int64";
    case DataType::kFloat32: return "float32";
    case DataType::kFloat64: return "float64";
    case DataType::kBool: return "bool";
    case DataType::kBfloat16: return "bfloat16";
    case DataType::kFloat16: return "float16";
    case DataType::kUint32: return "uint32";
    case DataType::kUint64: return "uint64";
  }
  return "unknown";
}

std::string Request::Pack() const {
  std::string out;
  Append<uint8_t>(&out, static_cast<uint8_t>(request_type));
  Append<uint8_t>(&out, static_cast<uint8_t>(tensor_type));
  Append<int32_t>(&out, request_rank);
  Append<int32_t>(&out, root_rank);
  Append<int32_t>(&out, device);
  Append<uint8_t>(&out, static_cast<uint8_t>(reduce_op));
  Append<uint16_t>(&out, process_set_id);
  Append<uint16_t>(&out, static_cast<uint16_t>(tensor_name.size()));
  out.append(tensor_name);
  Append<uint8_t>(&out, static_cast<uint8_t>(tensor_shape.size()));
  for (int64_t d : tensor_shape) Append<int64_t>(&out, d);
  Append<uint16_t>(&out, static_cast<uint16_t>(splits.size()));
  for (int64_t s : splits) Append<int64_t>(&out, s);
  return out;
}

ssize_t Request::Unpack(const uint8_t* buf, size_t len, Request* out) {
  size_t off = 0;
  uint8_t rt, tt, rop, ndim;
  uint16_t nlen;
  if (!ReadLE(buf, len, &off, &rt)) return -1;
  if (!ReadLE(buf, len, &off, &tt)) return -1;
  if (!ReadLE(buf, len, &off, &out->request_rank)) return -1;
  if (!ReadLE(buf, len, &off, &out->root_rank)) return -1;
  if (!ReadLE(buf, len, &off, &out->device)) return -1;
  if (!ReadLE(buf, len, &off, &rop)) return -1;
  if (!ReadLE(buf, len, &off, &out->process_set_id)) return -1;
  if (!ReadLE(buf, len, &off, &nlen)) return -1;
  if (off + nlen > len) return -1;
  out->tensor_name.assign(reinterpret_cast<const char*>(buf + off), nlen);
  off += nlen;
  if (!ReadLE(buf, len, &off, &ndim)) return -1;
  out->tensor_shape.clear();
  for (uint8_t i = 0; i < ndim; ++i) {
    int64_t d;
    if (!ReadLE(buf, len, &off, &d)) return -1;
    out->tensor_shape.push_back(d);
  }
  uint16_t nspl;
  if (!ReadLE(buf, len, &off, &nspl)) return -1;
  out->splits.clear();
  for (uint16_t i = 0; i < nspl; ++i) {
    int64_t s;
    if (!ReadLE(buf, len, &off, &s)) return -1;
    out->splits.push_back(s);
  }
  out->request_type = static_cast<RequestType>(rt);
  out->tensor_type = static_cast<DataType>(tt);
  out->reduce_op = static_cast<ReduceOp>(rop);
  return static_cast<ssize_t>(off);
}

std::string Response::Pack() const {
  std::string out;
  Append<uint8_t>(&out, static_cast<uint8_t>(response_type));
  Append<uint16_t>(&out, static_cast<uint16_t>(tensor_names.size()));
  for (const auto& n : tensor_names) {
    Append<uint16_t>(&out, static_cast<uint16_t>(n.size()));
    out.append(n);
  }
  Append<uint32_t>(&out, static_cast<uint32_t>(error_message.size()));
  out.append(error_message);
  Append<uint16_t>(&out, static_cast<uint16_t>(devices.size()));
  for (int32_t d : devices) Append<int32_t>(&out, d);
  Append<uint16_t>(&out, static_cast<uint16_t>(tensor_sizes.size()));
  for (int64_t s : tensor_sizes) Append<int64_t>(&out, s);
  Append<uint8_t>(&out, tensor_type < 0 ? 255
                                        : static_cast<uint8_t>(tensor_type));
  Append<uint16_t>(&out, static_cast<uint16_t>(tensor_shapes.size()));
  for (const auto& shape : tensor_shapes) {
    Append<uint8_t>(&out, static_cast<uint8_t>(shape.size()));
    for (int64_t d : shape) Append<int64_t>(&out, d);
  }
  Append<uint8_t>(&out, static_cast<uint8_t>(reduce_op));
  Append<uint16_t>(&out, process_set_id);
  return out;
}

std::string PackResponseList(const std::vector<Response>& rs) {
  std::string out;
  Append<uint16_t>(&out, static_cast<uint16_t>(rs.size()));
  for (const auto& r : rs) out.append(r.Pack());
  return out;
}

}  // namespace hvdtpu
