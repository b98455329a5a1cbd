// Asynchronous PNG recorder: background worker threads encode + write frames so the
// simulation/render loop never blocks on IO (a copy of
// yasph2d_tpu/native/recorder.cpp).
//
// The reference records synchronously (GPU screenshot -> PNG on the frame thread,
// src/main.rs:380-397), which stalls the sim during recording. Here `submit` copies
// the RGB frame into a bounded queue and returns; workers zlib-encode and write.
// Bounded queue: if encoding falls behind, submit blocks (backpressure) rather than
// growing without limit.
//
// C ABI (ctypes):
//   void* yasph_recorder_create(const char* dir, int32_t w, int32_t h,
//                               int32_t num_workers, int32_t queue_capacity);
//   int32_t yasph_recorder_submit(void* rec, int64_t frame_index, const uint8_t* rgb);
//   int32_t yasph_recorder_flush(void* rec);     // wait until queue drains
//   int32_t yasph_recorder_destroy(void* rec);   // flush + join workers

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// PNG writer from render.cpp (same shared object)
extern "C" int32_t yasph_write_png(const char* path, const uint8_t* image,
                                   int32_t w, int32_t h);

namespace {

struct Frame {
  int64_t index;
  std::vector<uint8_t> rgb;
};

struct Recorder {
  std::string dir;
  int32_t w, h;
  size_t capacity;

  std::mutex mu;
  std::condition_variable not_full, not_empty, drained;
  std::deque<Frame> queue;
  size_t in_flight = 0;  // queued + currently encoding
  bool stopping = false;
  int32_t errors = 0;
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      Frame frame;
      {
        std::unique_lock<std::mutex> lock(mu);
        not_empty.wait(lock, [&] { return stopping || !queue.empty(); });
        if (queue.empty()) return;  // stopping and drained
        frame = std::move(queue.front());
        queue.pop_front();
        not_full.notify_one();
      }
      const std::string path =
          dir + "/" + std::to_string(frame.index) + ".png";
      const int32_t rc = yasph_write_png(path.c_str(), frame.rgb.data(), w, h);
      {
        std::unique_lock<std::mutex> lock(mu);
        if (rc != 0) ++errors;
        --in_flight;
        if (in_flight == 0) drained.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* yasph_recorder_create(const char* dir, int32_t w, int32_t h,
                            int32_t num_workers, int32_t queue_capacity) {
  auto* rec = new Recorder();
  rec->dir = dir;
  rec->w = w;
  rec->h = h;
  rec->capacity = queue_capacity > 0 ? queue_capacity : 8;
  const int n = num_workers > 0 ? num_workers : 2;
  for (int i = 0; i < n; ++i)
    rec->workers.emplace_back([rec] { rec->worker(); });
  return rec;
}

int32_t yasph_recorder_submit(void* handle, int64_t frame_index,
                              const uint8_t* rgb) {
  auto* rec = static_cast<Recorder*>(handle);
  const size_t bytes = static_cast<size_t>(rec->w) * rec->h * 3;
  Frame frame;
  frame.index = frame_index;
  frame.rgb.assign(rgb, rgb + bytes);
  {
    std::unique_lock<std::mutex> lock(rec->mu);
    rec->not_full.wait(lock, [&] { return rec->queue.size() < rec->capacity; });
    if (rec->stopping) return -1;
    rec->queue.push_back(std::move(frame));
    ++rec->in_flight;
    rec->not_empty.notify_one();
  }
  return 0;
}

int32_t yasph_recorder_flush(void* handle) {
  auto* rec = static_cast<Recorder*>(handle);
  std::unique_lock<std::mutex> lock(rec->mu);
  rec->drained.wait(lock, [&] { return rec->in_flight == 0; });
  return rec->errors;
}

int32_t yasph_recorder_destroy(void* handle) {
  auto* rec = static_cast<Recorder*>(handle);
  {
    std::unique_lock<std::mutex> lock(rec->mu);
    rec->drained.wait(lock, [&] { return rec->in_flight == 0; });
    rec->stopping = true;
    rec->not_empty.notify_all();
  }
  for (auto& t : rec->workers) t.join();
  const int32_t errors = rec->errors;
  delete rec;
  return errors;
}

}  // extern "C"
