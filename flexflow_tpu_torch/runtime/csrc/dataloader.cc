// Native data loader: threaded shuffle + gather + prefetch (the port's
// copy of the JAX package's runtime/csrc/dataloader.cc; the same
// std::mt19937_64 permutation, so for one seed both packages shuffle
// alike).
//
// The reference's native dataloader (python/flexflow_dataloader.{h,cc,cu})
// keeps the dataset resident in zero-copy memory and copies per-shard
// sample slices with index launches. Here the host-side part — the
// shuffled per-sample gather into a contiguous batch buffer — runs in
// worker threads that fill a ring of prefetch slots, overlapped with the
// device's step; the copy to the device is the caller's
// (runtime/native_loader.py: on the card from each slot straight into a
// pinned buffer, then a non-blocking copy on a side stream).
//
// A loader owns a *group* of parallel arrays (input(s) + label) so one
// index permutation stays consistent across all of them, like the
// reference's SampleIdxs argmap shared by the input and label loaders
// (flexflow_dataloader.h:88-141).
//
// C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<std::vector<uint8_t>> buffers;  // one per array
  int64_t batch_index = -1;
  int64_t epoch = -1;
};

struct Loader {
  // dataset
  std::vector<const uint8_t*> data;      // base pointer per array
  std::vector<int64_t> sample_bytes;     // bytes per sample per array
  int64_t num_samples = 0;
  int64_t batch_size = 0;
  bool shuffle = false;
  std::mt19937_64 rng;

  // epoch state (guarded by mu; `order` is only mutated while no fill is in
  // flight — see reset())
  std::vector<int64_t> order;
  int64_t num_batches = 0;
  int64_t epoch = 0;

  // prefetch ring
  std::vector<Slot> slots;
  std::queue<int> free_slots;            // slots available for filling
  std::queue<int> ready_slots;           // filled slots (any order)
  int64_t next_fill = 0;                 // next batch index to assign a filler
  int64_t next_serve = 0;                // next batch index to hand to caller
  int in_flight = 0;                     // fills currently executing
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void fill_slot(int slot_idx, int64_t batch_index) {
    Slot& s = slots[slot_idx];
    const int64_t start = batch_index * batch_size;
    for (size_t a = 0; a < data.size(); ++a) {
      const int64_t sb = sample_bytes[a];
      uint8_t* dst = s.buffers[a].data();
      for (int64_t i = 0; i < batch_size; ++i) {
        const int64_t src_idx = order[start + i];
        std::memcpy(dst + i * sb, data[a] + src_idx * sb, sb);
      }
    }
  }

  void worker() {
    for (;;) {
      int slot_idx;
      int64_t batch_index, fill_epoch;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return stop.load() ||
                 (!free_slots.empty() && next_fill < num_batches);
        });
        if (stop.load()) return;
        slot_idx = free_slots.front();
        free_slots.pop();
        batch_index = next_fill++;
        fill_epoch = epoch;
        ++in_flight;
      }
      fill_slot(slot_idx, batch_index);
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[slot_idx].batch_index = batch_index;
        slots[slot_idx].epoch = fill_epoch;
        ready_slots.push(slot_idx);
        --in_flight;
      }
      cv_ready.notify_all();
    }
  }

  // Caller side: block until the slot holding batch `next_serve` of the
  // current epoch is ready. Batch indices are handed to workers
  // monotonically, but with >1 worker completion order can differ, so scan
  // the ready queue for the exact (epoch, batch) pair; slots from a previous
  // epoch (possible after a mid-epoch reset) are recycled.
  int next() {
    std::unique_lock<std::mutex> lk(mu);
    if (next_serve >= num_batches) return -1;
    for (;;) {
      size_t n = ready_slots.size();
      bool recycled = false;
      for (size_t i = 0; i < n; ++i) {
        int idx = ready_slots.front();
        ready_slots.pop();
        if (slots[idx].epoch != epoch) {  // stale: from before a reset
          free_slots.push(idx);
          recycled = true;
          continue;
        }
        if (slots[idx].batch_index == next_serve) {
          next_serve++;
          return idx;
        }
        ready_slots.push(idx);
      }
      if (recycled) cv_free.notify_all();
      size_t have = ready_slots.size();
      cv_ready.wait(lk, [&] { return ready_slots.size() > have || stop.load(); });
      if (stop.load()) return -1;
    }
  }

  void release(int slot_idx) {
    {
      std::lock_guard<std::mutex> lk(mu);
      slots[slot_idx].batch_index = -1;
      slots[slot_idx].epoch = -1;
      free_slots.push(slot_idx);
    }
    cv_free.notify_all();
  }

  void reset() {
    std::unique_lock<std::mutex> lk(mu);
    // stop handing out new fills, then wait for in-flight fills (they read
    // `order`) to drain before reshuffling
    next_fill = num_batches;
    cv_ready.wait(lk, [&] { return in_flight == 0 || stop.load(); });
    if (stop.load()) return;
    // recycle filled-but-unserved slots; their contents are stale
    while (!ready_slots.empty()) {
      free_slots.push(ready_slots.front());
      ready_slots.pop();
    }
    ++epoch;
    next_fill = 0;
    next_serve = 0;
    reshuffle();
    lk.unlock();
    cv_free.notify_all();
  }

  void reshuffle() {
    if (!shuffle) return;
    for (int64_t i = num_samples - 1; i > 0; --i) {
      std::uniform_int_distribution<int64_t> d(0, i);
      std::swap(order[i], order[d(rng)]);
    }
  }
};

}  // namespace

extern "C" {

void* ffdl_create(int num_arrays, const void** data_ptrs,
                  const int64_t* sample_bytes, int64_t num_samples,
                  int64_t batch_size, int shuffle, uint64_t seed,
                  int num_slots, int num_threads) {
  if (num_arrays <= 0 || num_samples <= 0 || batch_size <= 0 ||
      batch_size > num_samples)
    return nullptr;
  Loader* L = new Loader();
  for (int a = 0; a < num_arrays; ++a) {
    L->data.push_back(static_cast<const uint8_t*>(data_ptrs[a]));
    L->sample_bytes.push_back(sample_bytes[a]);
  }
  L->num_samples = num_samples;
  L->batch_size = batch_size;
  L->shuffle = shuffle != 0;
  L->rng.seed(seed);
  L->num_batches = num_samples / batch_size;
  L->order.resize(num_samples);
  std::iota(L->order.begin(), L->order.end(), 0);
  L->reshuffle();

  if (num_slots < 2) num_slots = 2;
  L->slots.resize(num_slots);
  for (int s = 0; s < num_slots; ++s) {
    for (int a = 0; a < num_arrays; ++a)
      L->slots[s].buffers.emplace_back(batch_size * sample_bytes[a]);
    L->free_slots.push(s);
  }
  if (num_threads < 1) num_threads = 1;
  for (int t = 0; t < num_threads; ++t)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

int64_t ffdl_num_batches(void* handle) {
  return static_cast<Loader*>(handle)->num_batches;
}

// Blocks until the next batch (in order) is prefetched; returns slot id or -1
// at end of epoch.
int ffdl_next(void* handle) { return static_cast<Loader*>(handle)->next(); }

// Pointer to the gathered batch buffer for array `array_idx` in `slot`.
const void* ffdl_buffer(void* handle, int slot, int array_idx) {
  Loader* L = static_cast<Loader*>(handle);
  return L->slots[slot].buffers[array_idx].data();
}

void ffdl_release(void* handle, int slot) {
  static_cast<Loader*>(handle)->release(slot);
}

// New epoch: reshuffles (if enabled) and restarts prefetching from batch 0.
void ffdl_reset(void* handle) { static_cast<Loader*>(handle)->reset(); }

void ffdl_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
