// Native host-I/O tier: frame packing, pixel swizzles, and pipe reads.
//
// The reference's host data path is Python: cv2 per-frame decode, numpy
// channel swizzles, and frame.tobytes() writes into the ffmpeg pipe
// (reference PredictAndGenerate.py:222-246). At 4K60 SBS the raw traffic is
// ~1.5 GB/s, where per-frame Python allocation + GIL-held memcpy become the
// bottleneck (SURVEY.md §7 "Host I/O throughput"). These C routines run
// GIL-free under ctypes:
//
//   * read_full / write_full — EINTR-safe full-buffer pipe transfers
//   * bgr_to_rgb            — channel swizzle (cv2 decode order -> RGB)
//   * pack_batch            — gather N decoded frames into one contiguous
//                             batch buffer (the device_put staging buffer)
//   * FrameRing             — lock-free single-producer single-consumer
//                             ring of reusable frame slots
//
// Build: vr_video_generator_tpu_torch/native/build.py (g++ -O3 -shared).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cerrno>
#include <unistd.h>

extern "C" {

// Read exactly n bytes from fd (blocking); returns bytes read (< n on EOF).
long read_full(int fd, uint8_t* buf, long n) {
    long got = 0;
    while (got < n) {
        ssize_t r = read(fd, buf + got, n - got);
        if (r < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        if (r == 0) break;  // EOF
        got += r;
    }
    return got;
}

// Write exactly n bytes to fd; returns n or -1.
long write_full(int fd, const uint8_t* buf, long n) {
    long put = 0;
    while (put < n) {
        ssize_t w = write(fd, buf + put, n - put);
        if (w < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        put += w;
    }
    return put;
}

// In-place-safe BGR<->RGB swizzle over n pixels (3 bytes each).
void bgr_to_rgb(const uint8_t* src, uint8_t* dst, long n_pixels) {
    for (long i = 0; i < n_pixels; ++i) {
        uint8_t b = src[3 * i], g = src[3 * i + 1], r = src[3 * i + 2];
        dst[3 * i] = r;
        dst[3 * i + 1] = g;
        dst[3 * i + 2] = b;
    }
}

// Packed-uint32 SBS (r | g<<8 | b<<16, little-endian bytes [r,g,b,x]) ->
// tightly-packed rgb24. The device emits packed frames (one u32 lane per
// pixel — the pallas warp/blur kernels' native layout); this strips every
// 4th byte on the host at memcpy-like speed (auto-vectorized).
void u32_to_rgb24(const uint8_t* src, uint8_t* dst, long n_pixels) {
    for (long i = 0; i < n_pixels; ++i) {
        dst[3 * i] = src[4 * i];
        dst[3 * i + 1] = src[4 * i + 1];
        dst[3 * i + 2] = src[4 * i + 2];
    }
}

// Copy n_frames source frames (frame_bytes each, given as an array of
// pointers) into one contiguous batch buffer.
void pack_batch(const uint8_t* const* frames, uint8_t* batch, long n_frames,
                long frame_bytes) {
    for (long i = 0; i < n_frames; ++i) {
        memcpy(batch + i * frame_bytes, frames[i], frame_bytes);
    }
}

// --- single-producer single-consumer frame ring -------------------------

struct FrameRing {
    uint8_t* storage;
    long frame_bytes;
    long capacity;               // number of slots
    std::atomic<long> head;      // next slot to write (producer)
    std::atomic<long> tail;      // next slot to read (consumer)
};

FrameRing* ring_create(long capacity, long frame_bytes) {
    FrameRing* r = new FrameRing();
    r->storage = new uint8_t[capacity * frame_bytes];
    r->frame_bytes = frame_bytes;
    r->capacity = capacity;
    r->head.store(0);
    r->tail.store(0);
    return r;
}

void ring_destroy(FrameRing* r) {
    delete[] r->storage;
    delete r;
}

// Producer: pointer to the next free slot, or nullptr when full.
uint8_t* ring_acquire_write(FrameRing* r) {
    long head = r->head.load(std::memory_order_relaxed);
    long tail = r->tail.load(std::memory_order_acquire);
    if (head - tail >= r->capacity) return nullptr;
    return r->storage + (head % r->capacity) * r->frame_bytes;
}

void ring_commit_write(FrameRing* r) {
    r->head.fetch_add(1, std::memory_order_release);
}

// Consumer: pointer to the oldest filled slot, or nullptr when empty.
uint8_t* ring_acquire_read(FrameRing* r) {
    long tail = r->tail.load(std::memory_order_relaxed);
    long head = r->head.load(std::memory_order_acquire);
    if (tail >= head) return nullptr;
    return r->storage + (tail % r->capacity) * r->frame_bytes;
}

void ring_commit_read(FrameRing* r) {
    r->tail.fetch_add(1, std::memory_order_release);
}

long ring_size(FrameRing* r) {
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_acquire);
}

}  // extern "C"
