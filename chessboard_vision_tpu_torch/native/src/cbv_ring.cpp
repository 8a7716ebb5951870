// Host runtime of chessboard_vision_tpu_torch: the frame ring.
//
// A lock-free single-producer single-consumer frame ring buffer for the
// camera-thread -> pipeline-thread handoff, with copy-in slots and
// drop-oldest semantics. The ring of chessboard_vision_tpu/native/src/
// cbv_native.cpp, copied so that the port builds it from its own source
// (its host resampler and HWC->planar helpers are in cbv_resample.cpp).
//
// Built with g++ at first use by chessboard_vision_tpu_torch/native/
// __init__.py (ctypes binding).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC frame ring buffer (drop-oldest when full).
//
// Lap-tolerant seqlock design: the producer writes unconditionally (it may
// lap a slow consumer) and NEVER touches consumer state; the consumer owns
// `tail` exclusively and detects laps/torn slots via per-slot sequence
// words. Each slot's state word holds 2*frame_idx+1 while the producer is
// copying into it and 2*frame_idx+2 once the frame is complete; a reader
// that observes a state change across its copy (or a state that does not
// match the frame index it expected) knows the slot was overwritten
// mid-copy and skips forward. Frames skipped this way are counted in
// `dropped` by the consumer.
// ---------------------------------------------------------------------------

struct CbvRing {
  std::vector<uint8_t> data;
  std::vector<std::atomic<int64_t>> state;  // per-slot seqlock word
  int64_t slot_bytes;
  int64_t n_slots;
  std::atomic<int64_t> head;     // frames pushed (producer-owned)
  std::atomic<int64_t> tail;     // frames consumed/skipped (consumer-owned)
  std::atomic<int64_t> dropped;  // consumer-counted overwritten frames

  CbvRing(int64_t sb, int64_t n)
      : data(sb * n), state(n), slot_bytes(sb), n_slots(n),
        head(0), tail(0), dropped(0) {
    for (auto& s : state) s.store(0, std::memory_order_relaxed);
  }
};

void* cbv_ring_create(int64_t slot_bytes, int64_t n_slots) {
  return new CbvRing(slot_bytes, n_slots);
}

void cbv_ring_destroy(void* ring) { delete (CbvRing*)ring; }

// Producer: copy a frame in (overwrites the oldest slot when full).
// Returns its sequence number (frame index + 1).
int64_t cbv_ring_push(void* ring, const uint8_t* frame) {
  CbvRing* r = (CbvRing*)ring;
  const int64_t n = r->head.load(std::memory_order_relaxed);
  const int64_t slot = n % r->n_slots;
  r->state[slot].store(2 * n + 1, std::memory_order_relaxed);  // writing
  std::atomic_thread_fence(std::memory_order_seq_cst);
  std::memcpy(&r->data[slot * r->slot_bytes], frame, r->slot_bytes);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  r->state[slot].store(2 * n + 2, std::memory_order_release);  // complete
  r->head.store(n + 1, std::memory_order_release);
  return n + 1;
}

// Consumer: copy the next surviving frame out. Returns its sequence number
// (frame index + 1), 0 if empty.
int64_t cbv_ring_pop(void* ring, uint8_t* out) {
  CbvRing* r = (CbvRing*)ring;
  int64_t t = r->tail.load(std::memory_order_relaxed);
  for (;;) {
    const int64_t h = r->head.load(std::memory_order_acquire);
    if (t >= h) {
      r->tail.store(t, std::memory_order_release);
      return 0;
    }
    if (h - t > r->n_slots) {  // producer lapped us: frames gone for good
      const int64_t skip = (h - r->n_slots) - t;
      r->dropped.fetch_add(skip, std::memory_order_relaxed);
      t = h - r->n_slots;
    }
    const int64_t slot = t % r->n_slots;
    const int64_t s1 = r->state[slot].load(std::memory_order_acquire);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    std::memcpy(out, &r->data[slot * r->slot_bytes], r->slot_bytes);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    const int64_t s2 = r->state[slot].load(std::memory_order_acquire);
    if (s1 == s2 && s1 == 2 * t + 2) {  // clean read of the expected frame
      r->tail.store(t + 1, std::memory_order_release);
      return t + 1;
    }
    // Slot was overwritten mid-copy (or holds a newer frame already):
    // frame t is unrecoverable; count it and move on.
    r->dropped.fetch_add(1, std::memory_order_relaxed);
    ++t;
  }
}

// Consumer: skip to the most recent frame (drop backlog), like the
// reference's SKIP_FRAMES polling. Returns frames skipped.
int64_t cbv_ring_skip_to_latest(void* ring) {
  CbvRing* r = (CbvRing*)ring;
  const int64_t t = r->tail.load(std::memory_order_relaxed);
  const int64_t h = r->head.load(std::memory_order_acquire);
  if (h - t <= 1) return 0;
  const int64_t skipped = h - 1 - t;
  r->tail.store(h - 1, std::memory_order_release);
  return skipped;
}

int64_t cbv_ring_size(void* ring) {
  CbvRing* r = (CbvRing*)ring;
  const int64_t t = r->tail.load(std::memory_order_acquire);
  const int64_t h = r->head.load(std::memory_order_acquire);
  const int64_t sz = h - t;
  return sz > r->n_slots ? r->n_slots : (sz < 0 ? 0 : sz);
}

int64_t cbv_ring_dropped(void* ring) {
  return ((CbvRing*)ring)->dropped.load();
}

}  // extern "C"
