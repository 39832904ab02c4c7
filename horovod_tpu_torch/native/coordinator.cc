// Copied from horovod_tpu/native/coordinator.cc with two repairs, so that
// its responses are byte for byte the Python coordinator's:
//
// 1. Submit lists a tensor as ready once.  A rank's request for a tensor
//    that a JOIN already made ready would otherwise enter ready_ a second
//    time, and the next PollResponses would construct it twice from an
//    erased entry (the fault the port's PyCoordinator repairs too,
//    ROADMAP.md C.1).
// 2. The request table keeps its insertion order (order_), as the Python
//    twin's dict does.  A JOIN that completes several tensors lists them
//    ready in that order, and the stall report walks it; the copied code
//    walked the std::map in name order, so such a JOIN fused and ordered
//    its responses differently from the Python coordinator.
//
// Native coordinator: negotiation, validation, fusion planning, stall watch.
//
// C++ twin of horovod_tpu/ops/coordinator.py (the executable spec), itself
// the TPU-native re-design of the reference coordinator inside
// BackgroundThreadLoop (horovod/common/operations.cc:222-461, :1072-1115,
// :1328-1374). The reference keeps this machinery in C++ because it sits on
// the latency floor of every collective; ours does the same for the dynamic
// (eager) path while the static pjit path bypasses it entirely.
//
// The steady-state response cache (ops/cache.py) deliberately layers ABOVE
// this implementation, in the Python Coordinator facade: a cache hit skips
// hvd_coord_submit / response construction here entirely, so both the
// native and the Python twin profit identically and the wire parity
// contract (fuzzed in tests/test_coordinator.py) stays about negotiation
// alone. The submit-time nbytes bookkeeping added to the Python twin's
// _PendingTensor mirrors kPayloadBytes accounting here: both resolve a
// response's fusion size once, never per drain tick.

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

#include "wire.h"

namespace hvdtpu {
namespace {

double MonotonicSeconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

std::string ShapeStr(const std::vector<int64_t>& s) {
  std::ostringstream os;
  os << "[";
  for (size_t i = 0; i < s.size(); ++i) {
    if (i) os << ", ";
    os << s[i];
  }
  os << "]";
  return os.str();
}

const char* OpName(RequestType t) {
  switch (t) {
    case RequestType::kAllreduce: return "allreduce";
    case RequestType::kAllgather: return "allgather";
    case RequestType::kBroadcast: return "broadcast";
    case RequestType::kJoin: return "join";
    case RequestType::kReducescatter: return "reducescatter";
    case RequestType::kAlltoall: return "alltoall";
  }
  return "?";
}

struct Pending {
  std::vector<Request> requests;
  std::set<int32_t> ranks;
  double first_seen = 0;
};

// Shared ERROR text for an abandoned collective — byte-identical with
// ops/coordinator.py::_withdraw_message (parity fuzz-tested).
std::string WithdrawMessage(const std::string& name, int32_t rank) {
  std::ostringstream os;
  os << "Collective " << name << " was abandoned: rank " << rank
     << " timed out waiting for the remaining ranks; the operation fails"
     << " on all ranks.";
  return os.str();
}

class Coordinator {
 public:
  Coordinator(int size, int64_t fusion_threshold)
      : size_(size), fusion_threshold_(fusion_threshold) {}

  // ≙ IncrementTensorCount (operations.cc:222-247).
  // Returns 1 when all replicas reported, 0 pending, -1 duplicate rank.
  // Joined ranks (hvd.join) count as ready for every tensor; the last
  // JOIN queues the release response (after this batch's data).
  int Submit(const Request& req) {
    std::lock_guard<std::mutex> g(mu_);
    if (req.request_type == RequestType::kJoin) {
      joined_.insert(req.request_rank);
      last_joined_ = req.request_rank;
      for (const auto& name : order_) {
        if (Complete(table_.at(name)) &&
            std::find(ready_.begin(), ready_.end(), name) == ready_.end())
          ready_.push_back(name);
      }
      if (static_cast<int>(joined_.size()) == size_) {
        Response rel;
        rel.response_type = ResponseType::kJoin;
        rel.tensor_sizes.push_back(last_joined_);
        join_release_.push_back(std::move(rel));
        joined_.clear();
        return 1;
      }
      return 0;
    }
    if (table_.find(req.tensor_name) == table_.end())
      order_.push_back(req.tensor_name);
    Pending& p = table_[req.tensor_name];
    if (p.requests.empty()) p.first_seen = MonotonicSeconds();
    if (p.ranks.count(req.request_rank)) return -1;
    p.ranks.insert(req.request_rank);
    p.requests.push_back(req);
    if (Complete(p)) {
      // A JOIN may already have made it ready (the guard of the JOIN
      // branch above).
      if (std::find(ready_.begin(), ready_.end(), req.tensor_name) ==
          ready_.end())
        ready_.push_back(req.tensor_name);
      return 1;
    }
    return 0;
  }

  bool Complete(const Pending& p) const {
    std::set<int32_t> u = p.ranks;
    u.insert(joined_.begin(), joined_.end());
    return static_cast<int>(u.size()) == size_;
  }

  // ≙ ConstructMPIResponse (operations.cc:255-461).
  Response ConstructResponse(const std::string& name) {
    Pending p = std::move(table_[name]);
    Erase(name);
    std::sort(p.requests.begin(), p.requests.end(),
              [](const Request& a, const Request& b) {
                return a.request_rank < b.request_rank;
              });
    const Request& first = p.requests[0];
    std::string error;

    for (size_t i = 1; i < p.requests.size() && error.empty(); ++i) {
      const Request& r = p.requests[i];
      if (r.tensor_type != first.tensor_type) {
        std::ostringstream os;
        os << "Mismatched data types: One rank had type "
           << DataTypeName(first.tensor_type) << ", but another rank had type "
           << DataTypeName(r.tensor_type) << ".";
        error = os.str();
      }
    }
    for (size_t i = 1; i < p.requests.size() && error.empty(); ++i) {
      const Request& r = p.requests[i];
      if (r.request_type != first.request_type) {
        std::ostringstream os;
        os << "Mismatched collective operations: One rank did an "
           << OpName(first.request_type) << ", but another rank did an "
           << OpName(r.request_type) << ".";
        error = os.str();
      }
    }
    RequestType op = first.request_type;
    std::vector<int64_t> tensor_sizes;
    if (error.empty() && op == RequestType::kAllreduce) {
      for (size_t i = 1; i < p.requests.size() && error.empty(); ++i) {
        const Request& r = p.requests[i];
        if (r.tensor_shape != first.tensor_shape) {
          std::ostringstream os;
          os << "Mismatched allreduce tensor shapes: One rank sent a tensor "
             << "of shape " << ShapeStr(first.tensor_shape)
             << ", but another rank sent a tensor of shape "
             << ShapeStr(r.tensor_shape) << ".";
          error = os.str();
        }
      }
    }
    // Reducescatter (post-v0.13): full shape agreement; never completes
    // via joins (the joined rank must participate for its chunk).
    if (error.empty() && op == RequestType::kReducescatter) {
      for (size_t i = 1; i < p.requests.size() && error.empty(); ++i) {
        const Request& r = p.requests[i];
        if (r.tensor_shape != first.tensor_shape) {
          std::ostringstream os;
          os << "Mismatched reducescatter tensor shapes: One rank sent a "
             << "tensor of shape " << ShapeStr(first.tensor_shape)
             << ", but another rank sent a tensor of shape "
             << ShapeStr(r.tensor_shape) << ".";
          error = os.str();
        }
      }
      if (error.empty() && static_cast<int>(p.requests.size()) < size_) {
        error = "Reducescatter cannot complete after a rank has joined: "
                "every rank must participate to receive its chunk of the "
                "result.";
      }
    }
    // Reduce-op agreement (post-v0.13 hvd op= API; v0.13 hard-codes
    // MPI_SUM).  Must stay message-identical with ops/coordinator.py.
    if (error.empty() && (op == RequestType::kAllreduce ||
                          op == RequestType::kReducescatter)) {
      for (size_t i = 1; i < p.requests.size() && error.empty(); ++i) {
        const Request& r = p.requests[i];
        if (r.reduce_op != first.reduce_op) {
          std::ostringstream os;
          os << "Mismatched reduce operations: One rank specified reduce op "
             << ReduceOpName(first.reduce_op)
             << ", but another rank specified reduce op "
             << ReduceOpName(r.reduce_op) << ".";
          error = os.str();
        }
      }
      if (error.empty() && op == RequestType::kAllreduce &&
          static_cast<int>(p.requests.size()) < size_ &&
          first.reduce_op != ReduceOp::kSum &&
          first.reduce_op != ReduceOp::kAverage) {
        std::ostringstream os;
        os << "Allreduce with reduce op " << ReduceOpName(first.reduce_op)
           << " cannot complete after a rank has joined: a joined rank's "
           << "zero contribution is only an identity for sum/average.";
        error = os.str();
      }
    }
    if (error.empty() && op == RequestType::kAllgather) {
      if (first.tensor_shape.empty()) {
        error = "Rank zero tried to gather a rank-zero tensor.";
      }
      for (size_t i = 1; i < p.requests.size() && error.empty(); ++i) {
        const Request& r = p.requests[i];
        if (r.tensor_shape.size() != first.tensor_shape.size()) {
          std::ostringstream os;
          os << "Mismatched allgather tensor shapes: One rank sent a tensor "
             << "of rank " << first.tensor_shape.size()
             << ", but another rank sent a tensor of rank "
             << r.tensor_shape.size() << ".";
          error = os.str();
          break;
        }
        for (size_t dim = 1; dim < first.tensor_shape.size(); ++dim) {
          if (r.tensor_shape[dim] != first.tensor_shape[dim]) {
            std::ostringstream os;
            os << "Mismatched allgather tensor shapes: One rank sent a tensor "
               << "with dimension " << dim << " equal to "
               << first.tensor_shape[dim]
               << ", but another rank sent a tensor with dimension " << dim
               << " equal to " << r.tensor_shape[dim] << ".";
            error = os.str();
            break;
          }
        }
      }
      if (error.empty()) {
        // RANK-indexed extents: joined ranks contribute 0 rows.
        std::map<int32_t, int64_t> by_rank;
        for (const Request& r : p.requests)
          by_rank[r.request_rank] =
              r.tensor_shape.empty() ? 0 : r.tensor_shape[0];
        for (int32_t r = 0; r < size_; ++r) {
          auto it = by_rank.find(r);
          tensor_sizes.push_back(it == by_rank.end() ? 0 : it->second);
        }
      }
    }
    // Alltoall (post-v0.13): trailing-dim agreement; per-rank splits
    // must cover dim 0; never completes via joins.  tensor_sizes will
    // carry the full split matrix row-major by sender.  Must stay
    // message-identical with ops/coordinator.py.
    std::vector<int64_t> alltoall_sizes;
    if (error.empty() && op == RequestType::kAlltoall) {
      if (first.tensor_shape.empty())
        error = "An alltoall tensor needs at least one dimension.";
      for (size_t i = 1; i < p.requests.size() && error.empty(); ++i) {
        const Request& r = p.requests[i];
        bool trailing_ok =
            r.tensor_shape.size() == first.tensor_shape.size() &&
            std::equal(r.tensor_shape.begin() + 1, r.tensor_shape.end(),
                       first.tensor_shape.begin() + 1);
        if (!trailing_ok) {
          std::ostringstream os;
          os << "Mismatched alltoall tensor shapes: One rank sent a tensor "
             << "of shape " << ShapeStr(first.tensor_shape)
             << ", but another rank sent a tensor of shape "
             << ShapeStr(r.tensor_shape) << ".";
          error = os.str();
        }
      }
      if (error.empty() && static_cast<int>(p.requests.size()) < size_) {
        error = "Alltoall cannot complete after a rank has joined: every "
                "rank must both send and receive.";
      }
      if (error.empty()) {
        for (const Request& r : p.requests) {
          int64_t d0 = r.tensor_shape[0];
          if (r.splits.empty()) {
            if (d0 % size_ != 0) {
              std::ostringstream os;
              os << "Alltoall without splits needs dim 0 divisible by the "
                 << "rank count (" << size_ << "); rank " << r.request_rank
                 << " sent " << d0 << " rows.";
              error = os.str();
              break;
            }
            for (int i = 0; i < size_; ++i)
              alltoall_sizes.push_back(d0 / size_);
          } else {
            int64_t total = 0;
            bool neg = false;
            for (int64_t s : r.splits) {
              total += s;
              if (s < 0) neg = true;
            }
            if (static_cast<int>(r.splits.size()) != size_ || total != d0 ||
                neg) {
              std::ostringstream os;
              os << "Invalid alltoall splits from rank " << r.request_rank
                 << ": " << ShapeStr(r.splits)
                 << " must have one non-negative entry per rank (" << size_
                 << ") summing to its dim 0 (" << d0 << ").";
              error = os.str();
              break;
            }
            for (int64_t s : r.splits) alltoall_sizes.push_back(s);
          }
        }
      }
    }
    if (error.empty() && op == RequestType::kBroadcast) {
      for (size_t i = 1; i < p.requests.size() && error.empty(); ++i) {
        const Request& r = p.requests[i];
        if (r.root_rank != first.root_rank) {
          std::ostringstream os;
          os << "Mismatched broadcast root ranks: One rank specified root "
             << "rank " << first.root_rank
             << ", but another rank specified root rank " << r.root_rank
             << ".";
          error = os.str();
        }
      }
      for (size_t i = 1; i < p.requests.size() && error.empty(); ++i) {
        const Request& r = p.requests[i];
        if (r.tensor_shape != first.tensor_shape) {
          std::ostringstream os;
          os << "Mismatched broadcast tensor shapes: One rank sent a tensor "
             << "of shape " << ShapeStr(first.tensor_shape)
             << ", but another rank sent a tensor of shape "
             << ShapeStr(r.tensor_shape) << ".";
          error = os.str();
        }
      }
      if (error.empty() && static_cast<int>(p.requests.size()) < size_) {
        bool root_present = false;
        for (const Request& r : p.requests)
          if (r.request_rank == first.root_rank) root_present = true;
        if (!root_present) {
          std::ostringstream os;
          os << "Broadcast root rank " << first.root_rank
             << " has joined; a joined rank cannot be the source of a "
             << "broadcast.";
          error = os.str();
        }
      }
    }
    // Host/device placement agreement (≙ operations.cc:418-440).
    for (size_t i = 1; i < p.requests.size() && error.empty(); ++i) {
      const Request& r = p.requests[i];
      if ((r.device == kCpuDeviceId) != (first.device == kCpuDeviceId)) {
        std::ostringstream os;
        os << "Mismatched host/device selection: One rank specified device "
           << first.device << ", but another rank specified device "
           << r.device << ".";
        error = os.str();
      }
    }

    Response resp;
    resp.tensor_names = {name};
    resp.process_set_id = first.process_set_id;
    if (!error.empty()) {
      resp.response_type = ResponseType::kError;
      resp.error_message = error;
      return resp;
    }
    dtype_by_name_[name] = first.tensor_type;
    for (const Request& r : p.requests) resp.devices.push_back(r.device);
    // dtype + shape ride every data response for joined ranks' zero
    // contributions; BROADCAST also carries its root in tensor_sizes.
    resp.tensor_type = static_cast<int>(first.tensor_type);
    resp.tensor_shapes.push_back(first.tensor_shape);
    switch (op) {
      case RequestType::kAllreduce:
        resp.response_type = ResponseType::kAllreduce;
        resp.reduce_op = first.reduce_op;
        break;
      case RequestType::kReducescatter:
        resp.response_type = ResponseType::kReducescatter;
        resp.reduce_op = first.reduce_op;
        break;
      case RequestType::kAlltoall:
        resp.response_type = ResponseType::kAlltoall;
        resp.tensor_sizes = std::move(alltoall_sizes);
        break;
      case RequestType::kAllgather:
        resp.response_type = ResponseType::kAllgather;
        resp.tensor_sizes = std::move(tensor_sizes);
        break;
      case RequestType::kBroadcast:
        resp.response_type = ResponseType::kBroadcast;
        resp.tensor_sizes.push_back(first.root_rank);
        break;
      case RequestType::kJoin:
        break;  // unreachable: JOIN never enters the tensor table
    }
    return resp;
  }

  // Round 4; no reference equivalent — the reference can only hang when
  // a rank gives up (operations.cc:1290-1326).  Drops the pending entry
  // and queues an ERROR response so every rank fails the op promptly.
  // No-op when negotiation already completed (the op is about to finish).
  void Withdraw(const std::string& name, int32_t rank) {
    std::lock_guard<std::mutex> g(mu_);
    if (std::find(ready_.begin(), ready_.end(), name) != ready_.end())
      return;
    Erase(name);
    Response resp;
    resp.response_type = ResponseType::kError;
    resp.tensor_names.push_back(name);
    resp.error_message = WithdrawMessage(name, rank);
    withdrawn_.push_back(std::move(resp));
  }

  // Bytes of one replica's tensor for a response: the queue-side size
  // table when present, else shape × dtype from the response itself (a
  // process set excluding the controller has no entries in ITS queue;
  // an unbounded 0 fallback would defeat the threshold).  Must mirror
  // ops/coordinator.py::nbytes_of.
  int64_t NBytesOf(const Response& r,
                   const std::unordered_map<std::string, int64_t>& sizes) {
    auto it = sizes.find(r.tensor_names.empty() ? std::string()
                                                : r.tensor_names[0]);
    if (it != sizes.end()) return it->second;
    int64_t n = 1;
    if (!r.tensor_shapes.empty())
      for (int64_t d : r.tensor_shapes[0]) n *= d;
    DataType dt = DataType::kFloat32;
    auto dit = dtype_by_name_.find(r.tensor_names.empty()
                                       ? std::string()
                                       : r.tensor_names[0]);
    if (dit != dtype_by_name_.end()) dt = dit->second;
    return n * DataTypeSize(dt);
  }

  // ≙ the response fusion loop (operations.cc:1328-1374): same-device,
  // same-dtype ALLREDUCE responses merge under the byte threshold.
  // `sizes` maps tensor name → payload bytes of one replica's tensor.
  int PollResponses(const std::unordered_map<std::string, int64_t>& sizes) {
    std::lock_guard<std::mutex> g(mu_);
    std::vector<Response> responses;
    for (const auto& n : ready_) responses.push_back(ConstructResponse(n));
    ready_.clear();
    std::vector<Response> fused = std::move(withdrawn_);
    withdrawn_.clear();
    for (size_t i = 0; i < responses.size(); ++i) {
      Response r = std::move(responses[i]);
      // Adasum never fuses: its dot products are per-tensor scale
      // adaptations, not elementwise reductions.
      if (r.response_type != ResponseType::kAllreduce ||
          r.reduce_op == ReduceOp::kAdasum) {
        fused.push_back(std::move(r));
        continue;
      }
      int64_t total = NBytesOf(r, sizes);
      DataType dt = dtype_by_name_[r.tensor_names[0]];
      for (size_t j = i + 1; j < responses.size();) {
        Response& nxt = responses[j];
        int64_t nbytes = NBytesOf(nxt, sizes);
        if (nxt.response_type == ResponseType::kAllreduce &&
            nxt.devices == r.devices && nxt.reduce_op == r.reduce_op &&
            nxt.process_set_id == r.process_set_id &&
            !nxt.tensor_names.empty() &&
            dtype_by_name_[nxt.tensor_names[0]] == dt &&
            total + nbytes <= fusion_threshold_) {
          r.tensor_names.push_back(nxt.tensor_names[0]);
          r.tensor_shapes.insert(r.tensor_shapes.end(),
                                 nxt.tensor_shapes.begin(),
                                 nxt.tensor_shapes.end());
          total += nbytes;
          responses.erase(responses.begin() + j);
        } else {
          ++j;
        }
      }
      fused.push_back(std::move(r));
    }
    for (const auto& r : fused)
      for (const auto& n : r.tensor_names) dtype_by_name_.erase(n);
    // JOIN release LAST: joined ranks execute this batch's data
    // responses (zero contributions) before being released.
    for (auto& jr : join_release_) fused.push_back(std::move(jr));
    join_release_.clear();
    out_buffer_ = PackResponseList(fused);
    return static_cast<int>(fused.size());
  }

  ssize_t FetchResponses(char* out, size_t cap) {
    std::lock_guard<std::mutex> g(mu_);
    if (out_buffer_.size() > cap) return -1;
    std::memcpy(out, out_buffer_.data(), out_buffer_.size());
    return static_cast<ssize_t>(out_buffer_.size());
  }

  // Autotune hook: the fusion threshold is runtime-adjustable (≙ the
  // post-v0.13 HOROVOD_AUTOTUNE subsystem re-tuning
  // TensorFusionThresholdBytes between cycles).
  void SetFusionThreshold(int64_t v) {
    std::lock_guard<std::mutex> g(mu_);
    fusion_threshold_ = v;
  }

  // ≙ CheckForStalledTensors (operations.cc:1072-1115).
  std::string CheckStalled(double threshold_seconds) {
    std::lock_guard<std::mutex> g(mu_);
    double now = MonotonicSeconds();
    std::ostringstream os;
    for (const auto& name : order_) {
      const Pending& p = table_.at(name);
      double waited = now - p.first_seen;
      if (waited > threshold_seconds) {
        std::set<int32_t> missing;
        for (int32_t r = 0; r < size_; ++r)
          if (!p.ranks.count(r)) missing.insert(r);
        os << "Tensor " << name << " has been pending for "
           << static_cast<long>(waited) << "s; ready replicas: [";
        bool f = true;
        for (int32_t r : p.ranks) {
          if (!f) os << ", ";
          os << r;
          f = false;
        }
        os << "]; waiting on replicas: [";
        f = true;
        for (int32_t r : missing) {
          if (!f) os << ", ";
          os << r;
          f = false;
        }
        os << "]. One or more replicas submitted this collective and are "
           << "waiting for the remaining replicas to do the same.\n";
      }
    }
    return os.str();
  }

 private:
  void Erase(const std::string& name) {
    table_.erase(name);
    order_.erase(std::remove(order_.begin(), order_.end(), name),
                 order_.end());
  }

  int size_;
  int64_t fusion_threshold_;
  std::mutex mu_;
  std::map<std::string, Pending> table_;
  std::vector<std::string> order_;  // table_'s names, in insertion order
  std::vector<std::string> ready_;
  std::vector<Response> withdrawn_;
  std::set<int32_t> joined_;
  int32_t last_joined_ = -1;
  std::vector<Response> join_release_;
  std::unordered_map<std::string, DataType> dtype_by_name_;
  std::string out_buffer_;
};

// Side-table parser: u16 count, then (u16 klen, key, i64 bytes)*.
bool ParseSizes(const uint8_t* buf, size_t len,
                std::unordered_map<std::string, int64_t>* out) {
  size_t off = 0;
  uint16_t n;
  if (off + 2 > len) return false;
  std::memcpy(&n, buf + off, 2);
  off += 2;
  for (uint16_t i = 0; i < n; ++i) {
    uint16_t klen;
    if (off + 2 > len) return false;
    std::memcpy(&klen, buf + off, 2);
    off += 2;
    if (off + klen + 8 > len) return false;
    std::string key(reinterpret_cast<const char*>(buf + off), klen);
    off += klen;
    int64_t v;
    std::memcpy(&v, buf + off, 8);
    off += 8;
    (*out)[key] = v;
  }
  return true;
}

}  // namespace
}  // namespace hvdtpu

extern "C" {

void* hvd_coord_create(int size, long long fusion_threshold) {
  return new hvdtpu::Coordinator(size, fusion_threshold);
}

void hvd_coord_destroy(void* c) {
  delete static_cast<hvdtpu::Coordinator*>(c);
}

int hvd_coord_submit(void* c, const char* buf, int len) {
  hvdtpu::Request req;
  if (hvdtpu::Request::Unpack(reinterpret_cast<const uint8_t*>(buf), len,
                              &req) < 0)
    return -2;
  return static_cast<hvdtpu::Coordinator*>(c)->Submit(req);
}

int hvd_coord_poll_responses(void* c, const char* sizes_buf, int sizes_len,
                             double now_unused) {
  (void)now_unused;
  std::unordered_map<std::string, int64_t> sizes;
  if (!hvdtpu::ParseSizes(reinterpret_cast<const uint8_t*>(sizes_buf),
                          sizes_len, &sizes))
    return -1;
  return static_cast<hvdtpu::Coordinator*>(c)->PollResponses(sizes);
}

int hvd_coord_fetch_responses(void* c, char* out, int cap) {
  return static_cast<int>(
      static_cast<hvdtpu::Coordinator*>(c)->FetchResponses(out, cap));
}

void hvd_coord_withdraw(void* c, const char* name, int len, int rank) {
  static_cast<hvdtpu::Coordinator*>(c)->Withdraw(std::string(name, len),
                                                 rank);
}

void hvd_coord_set_fusion_threshold(void* c, long long v) {
  static_cast<hvdtpu::Coordinator*>(c)->SetFusionThreshold(v);
}

int hvd_coord_check_stalled(void* c, double threshold, char* out, int cap) {
  std::string s =
      static_cast<hvdtpu::Coordinator*>(c)->CheckStalled(threshold);
  if (static_cast<int>(s.size()) > cap) return -1;
  std::memcpy(out, s.data(), s.size());
  return static_cast<int>(s.size());
}

}  // extern "C"
