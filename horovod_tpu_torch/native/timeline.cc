// Copied from horovod_tpu/native/timeline.cc, unchanged apart from this
// note.  The port's utils/timeline.py writes through it when the native
// library is active.
//
// Chrome-tracing timeline writer — C++ twin of utils/timeline.py, itself
// the TPU-native equivalent of the reference Timeline
// (horovod/common/timeline.{h,cc}): per-tensor trace rows ("processes"
// with pid metadata, timeline.cc:59-76), mutex-guarded writes, 1 s flush
// cadence (timeline.h:32).

#include <chrono>
#include <cstdio>
#include <mutex>
#include <string>
#include <unordered_map>

namespace hvdtpu {
namespace {

double NowUs(double start) {
  double t = std::chrono::duration<double>(
                 std::chrono::steady_clock::now().time_since_epoch())
                 .count();
  return (t - start) * 1e6;
}

// Event phase codes shared with the Python binding:
// 0 = "B" (begin), 1 = "E" (end), 2 = "i" (instant), 3 = "M" (metadata).
const char* PhChar(int ph) {
  switch (ph) {
    case 0: return "B";
    case 1: return "E";
    case 2: return "i";
    default: return "M";
  }
}

std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

class Timeline {
 public:
  explicit Timeline(const std::string& path)
      : start_(std::chrono::duration<double>(
                   std::chrono::steady_clock::now().time_since_epoch())
                   .count()),
        last_flush_(start_) {
    file_ = std::fopen(path.c_str(), "w");
    if (file_) std::fputs("[\n", file_);
  }

  ~Timeline() { Close(); }

  void Event(int ph, const std::string& tensor, const std::string& name,
             const std::string& args_json) {
    std::lock_guard<std::mutex> g(mu_);
    if (!file_) return;
    int pid = Pid(tensor);
    std::fprintf(file_, "{\"ph\": \"%s\", \"ts\": %.3f, \"pid\": %d",
                 PhChar(ph), NowUs(start_), pid);
    if (!name.empty())
      std::fprintf(file_, ", \"name\": \"%s\"", JsonEscape(name).c_str());
    if (!args_json.empty() && args_json != "{}")
      std::fprintf(file_, ", \"args\": %s", args_json.c_str());
    std::fputs("},\n", file_);
    MaybeFlush();
  }

  void Close() {
    std::lock_guard<std::mutex> g(mu_);
    if (!file_) return;
    std::fprintf(file_,
                 "{\"ph\": \"i\", \"ts\": %.3f, \"pid\": 0, \"name\": "
                 "\"shutdown\"}\n]\n",
                 NowUs(start_));
    std::fclose(file_);
    file_ = nullptr;
  }

 private:
  int Pid(const std::string& tensor) {
    auto it = pids_.find(tensor);
    if (it != pids_.end()) return it->second;
    int pid = next_pid_++;
    pids_[tensor] = pid;
    // Name the per-tensor trace row (≙ timeline.cc:59-76).
    std::fprintf(file_,
                 "{\"name\": \"process_name\", \"ph\": \"M\", \"pid\": %d, "
                 "\"args\": {\"name\": \"%s\"}},\n",
                 pid, JsonEscape(tensor).c_str());
    std::fprintf(file_,
                 "{\"name\": \"process_sort_index\", \"ph\": \"M\", "
                 "\"pid\": %d, \"args\": {\"sort_index\": %d}},\n",
                 pid, pid);
    return pid;
  }

  void MaybeFlush() {
    // 1 s flush cadence (≙ TIMELINE_FLUSH_TIME, timeline.h:32).
    double now = std::chrono::duration<double>(
                     std::chrono::steady_clock::now().time_since_epoch())
                     .count();
    if (now - last_flush_ > 1.0) {
      std::fflush(file_);
      last_flush_ = now;
    }
  }

  std::FILE* file_ = nullptr;
  double start_;
  double last_flush_;
  std::mutex mu_;
  std::unordered_map<std::string, int> pids_;
  int next_pid_ = 1;
};

}  // namespace
}  // namespace hvdtpu

extern "C" {

void* hvd_timeline_create(const char* path) {
  return new hvdtpu::Timeline(path);
}

void hvd_timeline_event(void* t, int ph, const char* tensor, const char* name,
                        const char* args_json, double ts_unused) {
  (void)ts_unused;
  static_cast<hvdtpu::Timeline*>(t)->Event(ph, tensor ? tensor : "",
                                           name ? name : "",
                                           args_json ? args_json : "");
}

void hvd_timeline_close(void* t) {
  auto* tl = static_cast<hvdtpu::Timeline*>(t);
  tl->Close();
  delete tl;
}

}  // extern "C"
