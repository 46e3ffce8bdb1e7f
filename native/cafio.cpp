// libcafio — native signal I/O for the CAF engine.
//
// The reference's native layer is FFTW plus hand-rolled byte codecs
// (caf_rust/src/utils.rs:10-63, caf_go/caf.go:31-93: interleaved
// little-endian f32 I/Q files read into language-native complex
// vectors).  The engine's native analog has one extra job: the
// device engines take *planar* split-complex (separate re/im planes,
// see caf_cookoff_tpu/ops/splitfft.py), so the hot path here is a
// single-pass mmap + deinterleave straight from the page cache into the
// planes that get device_put — no intermediate complex array, no numpy
// temporary.  Large files deinterleave across threads.
//
// C ABI only (consumed via ctypes from Python); errors return -errno.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int64_t kParallelThreshold = 1 << 20;  // samples

int num_io_threads(int64_t n) {
  if (n < kParallelThreshold) return 1;
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw > 16 ? 16 : hw) : 4;
}

void deinterleave_range(const float* in, float* re, float* im,
                        int64_t begin, int64_t end) {
  for (int64_t i = begin; i < end; ++i) {
    re[i] = in[2 * i];
    im[i] = in[2 * i + 1];
  }
}

void interleave_range(const float* re, const float* im, float* out,
                      int64_t begin, int64_t end) {
  for (int64_t i = begin; i < end; ++i) {
    out[2 * i] = re[i];
    out[2 * i + 1] = im[i];
  }
}

template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  int threads = num_io_threads(n);
  if (threads == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = begin + chunk < n ? begin + chunk : n;
    if (begin >= end) break;
    pool.emplace_back([=] { fn(begin, end); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Number of complex64 samples in a file (bytes / 8), or -errno.
int64_t cafio_file_samples(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -static_cast<int64_t>(errno);
  return st.st_size / 8;
}

// mmap `path` and deinterleave `count` complex64 samples starting at
// sample `offset` into planar float32 re/im. Returns samples read or
// -errno. Matches utils.rs:10-35 semantics (f32 I/Q pairs, LE host).
int64_t cafio_load_c64_split(const char* path, float* re, float* im,
                             int64_t count, int64_t offset) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return -static_cast<int64_t>(errno);
  struct stat st;
  if (fstat(fd, &st) != 0) {
    int err = errno;
    close(fd);
    return -static_cast<int64_t>(err);
  }
  int64_t total = st.st_size / 8;
  if (offset < 0 || offset > total) {
    close(fd);
    return -static_cast<int64_t>(EINVAL);
  }
  int64_t n = total - offset;
  if (count >= 0 && count < n) n = count;
  if (n == 0) {
    close(fd);
    return 0;
  }
  void* map = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                   MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return -static_cast<int64_t>(errno);
  madvise(map, static_cast<size_t>(st.st_size), MADV_SEQUENTIAL);
  const float* in = reinterpret_cast<const float*>(map) + 2 * offset;
  parallel_for(n, [&](int64_t b, int64_t e) {
    deinterleave_range(in, re, im, b, e);
  });
  munmap(map, static_cast<size_t>(st.st_size));
  return n;
}

// In-memory planar <-> interleaved converters (split_array fast path).
void cafio_deinterleave_c64(const float* interleaved, float* re, float* im,
                            int64_t n) {
  parallel_for(n, [&](int64_t b, int64_t e) {
    deinterleave_range(interleaved, re, im, b, e);
  });
}

void cafio_interleave_c64(const float* re, const float* im, float* out,
                          int64_t n) {
  parallel_for(n, [&](int64_t b, int64_t e) {
    interleave_range(re, im, out, b, e);
  });
}

// Write planar planes as interleaved .c64 (utils.rs:39-63 analog, f32).
int64_t cafio_write_c64(const char* path, const float* re, const float* im,
                        int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -static_cast<int64_t>(errno);
  constexpr int64_t kBuf = 1 << 16;
  std::vector<float> buf(2 * kBuf);
  for (int64_t off = 0; off < n; off += kBuf) {
    int64_t m = n - off < kBuf ? n - off : kBuf;
    interleave_range(re + off, im + off, buf.data(), 0, m);
    if (fwrite(buf.data(), sizeof(float) * 2, static_cast<size_t>(m), f) !=
        static_cast<size_t>(m)) {
      int err = errno;
      fclose(f);
      return -static_cast<int64_t>(err);
    }
  }
  if (fclose(f) != 0) return -static_cast<int64_t>(errno);
  return n;
}

// Raw little-endian f64 surface dump (caf_go/caf.go:14-29 parity).
int64_t cafio_write_f64(const char* path, const double* data, int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -static_cast<int64_t>(errno);
  size_t wrote = fwrite(data, sizeof(double), static_cast<size_t>(n), f);
  int err = errno;
  if (fclose(f) != 0 && wrote == static_cast<size_t>(n))
    return -static_cast<int64_t>(errno);
  return wrote == static_cast<size_t>(n) ? n : -static_cast<int64_t>(err);
}

}  // extern "C"
