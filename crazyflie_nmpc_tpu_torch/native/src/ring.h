// Lock-free single-producer/single-consumer ring buffer.
//
// The host I/O boundary between the solver loop and the per-vehicle link
// thread (replacing the reference's ROS topic pub/sub, SURVEY.md section
// 2.6 "comm backend"): the solver thread pushes setpoints / pops state
// estimates without taking locks, so the control path never blocks on the
// radio path.
#pragma once

#include <atomic>
#include <cstddef>

namespace cfl {

template <typename T, std::size_t N>
class SpscRing {
  static_assert((N & (N - 1)) == 0, "capacity must be a power of two");

 public:
  // Returns false when full (drop-newest policy; caller decides).
  bool Push(const T& item) {
    const auto head = head_.load(std::memory_order_relaxed);
    const auto next = (head + 1) & (N - 1);
    if (next == tail_.load(std::memory_order_acquire)) return false;
    buf_[head] = item;
    head_.store(next, std::memory_order_release);
    return true;
  }

  // Returns false when empty.
  bool Pop(T* out) {
    const auto tail = tail_.load(std::memory_order_relaxed);
    if (tail == head_.load(std::memory_order_acquire)) return false;
    *out = buf_[tail];
    tail_.store((tail + 1) & (N - 1), std::memory_order_release);
    return true;
  }

  // Drain everything, keeping only the most recent element (the pattern
  // for state estimates: the controller only ever wants the latest).
  bool PopLatest(T* out) {
    bool got = false;
    while (Pop(out)) got = true;
    return got;
  }

  std::size_t SizeApprox() const {
    const auto h = head_.load(std::memory_order_acquire);
    const auto t = tail_.load(std::memory_order_acquire);
    return (h - t) & (N - 1);
  }

 private:
  T buf_[N];
  alignas(64) std::atomic<std::size_t> head_{0};
  alignas(64) std::atomic<std::size_t> tail_{0};
};

}  // namespace cfl
