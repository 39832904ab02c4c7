// Copied from horovod_tpu/native/handle_manager.cc, unchanged apart from
// this note.  In the port the in-flight tensors, events and keep-alives
// stay on the Python side (ops/handles.py); this owns the ids.
//
// Async-handle bookkeeping — TPU-native equivalent of the reference's
// HandleManager (horovod/torch/handle_manager.{h,cc}): an atomic handle
// counter plus a mutex-guarded done-map backing the Python-visible
// poll/synchronize API. The in-flight payloads (JAX array futures) stay on
// the Python side; this owns only identity and completion state, exactly
// like the reference owns only handle→Status.

#include <atomic>
#include <mutex>
#include <unordered_map>

namespace hvdtpu {
namespace {

class HandleManager {
 public:
  int Allocate() {
    int h = next_.fetch_add(1);
    std::lock_guard<std::mutex> g(mu_);
    done_[h] = false;
    return h;
  }
  void MarkDone(int h) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = done_.find(h);
    if (it != done_.end()) it->second = true;
  }
  bool Poll(int h) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = done_.find(h);
    return it != done_.end() && it->second;
  }
  void Release(int h) {
    std::lock_guard<std::mutex> g(mu_);
    done_.erase(h);
  }

 private:
  std::atomic<int> next_{0};
  std::mutex mu_;
  std::unordered_map<int, bool> done_;
};

}  // namespace
}  // namespace hvdtpu

extern "C" {

void* hvd_handle_manager_create() { return new hvdtpu::HandleManager(); }
void hvd_handle_manager_destroy(void* hm) {
  delete static_cast<hvdtpu::HandleManager*>(hm);
}
int hvd_handle_manager_allocate(void* hm) {
  return static_cast<hvdtpu::HandleManager*>(hm)->Allocate();
}
void hvd_handle_manager_mark_done(void* hm, int h) {
  static_cast<hvdtpu::HandleManager*>(hm)->MarkDone(h);
}
int hvd_handle_manager_poll(void* hm, int h) {
  return static_cast<hvdtpu::HandleManager*>(hm)->Poll(h) ? 1 : 0;
}
void hvd_handle_manager_release(void* hm, int h) {
  static_cast<hvdtpu::HandleManager*>(hm)->Release(h);
}

}  // extern "C"
