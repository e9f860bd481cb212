// Native frame writer: multithreaded encode + write of enhanced frames.
//
// The output half of the streaming runtime (the loader half is
// frameloader.cpp).  The reference's save path is cv2.imwrite inside the
// per-image Python loop (SURVEY.md §3.5); here worker threads encode and
// write frames behind the consumer so disk IO overlaps device compute —
// `pipeline.stream_frames` keeps batches in flight on the chip while
// finished frames drain to disk through this pool.
//
// Formats by extension: .pgm/.ppm (P5/P6, maxval 255 or 65535 with 2-byte
// big-endian samples per the PNM spec), .png (zlib-deflated, filter "Up",
// 8/16-bit gray/RGB/RGBA), .jpg/.jpeg (libjpeg, 8-bit gray/RGB, quality
// knob), anything else = raw bytes.  16-bit input buffers are host-endian
// uint16 sample bytes (the FrameLoader convention, depth = 16).
//
// C ABI (ctypes-friendly):
//   void* fw_create(int threads, long max_queue_bytes)
//   long  fw_submit(void* h, const char* path, const unsigned char* data,
//                   int w, int hgt, int ch, int depth, int quality)
//         // copies data and returns 0 once queued (blocks while the queue
//         // holds more than max_queue_bytes); <0 = immediate argument error
//   long  fw_flush(void* h)  // wait for all queued writes; total failures so far
//   long  fw_failure(void* h, long k, long* code, char* path_out, long cap)
//         // fetch the k-th failure record; returns path length or <0
//   void  fw_destroy(void* h)
//
// Failure codes: -2 open failed, -3 bad args, -4 too large, -5 short write,
// -10 jpeg error, -8 zlib error, -7 unsupported channels for the format.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#include <csetjmp>
#include <jpeglib.h>

namespace {

struct Job {
  std::string path;
  std::vector<uint8_t> data;  // host-endian sample bytes
  int w = 0, h = 0, ch = 0, depth = 8, quality = 95;
};

struct Failure {
  std::string path;
  long code;
};

struct Writer {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done, cv_space;
  std::deque<Job> queue;
  std::vector<Failure> failures;
  long queued_bytes = 0;
  long max_queue_bytes;
  int in_flight = 0;
  bool stopping = false;
};

// Host-endian uint16 bytes -> big-endian, appended to out.
static void append_be16(std::vector<uint8_t>& out, const uint8_t* data, size_t n) {
  const uint16_t one = 1;
  const bool le = *reinterpret_cast<const uint8_t*>(&one) != 0;
  size_t base = out.size();
  out.resize(base + n);
  if (!le) {
    memcpy(out.data() + base, data, n);
    return;
  }
  for (size_t i = 0; i + 1 < n; i += 2) {
    out[base + i] = data[i + 1];
    out[base + i + 1] = data[i];
  }
}

static long write_file(const std::string& path, const uint8_t* a, size_t na,
                       const uint8_t* b = nullptr, size_t nb = 0) {
  FILE* f = fopen(path.c_str(), "wb");
  if (!f) return -2;
  bool ok = fwrite(a, 1, na, f) == na;
  if (ok && nb) ok = fwrite(b, 1, nb, f) == nb;
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : -5;
}

static long encode_pnm(const Job& j) {
  if (j.ch != 1 && j.ch != 3) return -7;
  char header[64];
  int maxv = j.depth == 16 ? 65535 : 255;
  int n = snprintf(header, sizeof(header), "P%c\n%d %d\n%d\n",
                   j.ch == 3 ? '6' : '5', j.w, j.h, maxv);
  if (j.depth == 16) {
    std::vector<uint8_t> be;
    be.reserve(j.data.size());
    append_be16(be, j.data.data(), j.data.size());
    return write_file(j.path, reinterpret_cast<uint8_t*>(header), n, be.data(),
                      be.size());
  }
  return write_file(j.path, reinterpret_cast<uint8_t*>(header), n, j.data.data(),
                    j.data.size());
}

static void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(v >> 24);
  out.push_back(v >> 16);
  out.push_back(v >> 8);
  out.push_back(v);
}

static void put_chunk(std::vector<uint8_t>& out, const char* type,
                      const uint8_t* data, size_t n) {
  put_be32(out, static_cast<uint32_t>(n));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), data, data + n);
  uint32_t crc = crc32(0, out.data() + start, static_cast<uInt>(4 + n));
  put_be32(out, crc);
}

static long encode_png(const Job& j) {
  int color;
  switch (j.ch) {
    case 1: color = 0; break;
    case 2: color = 4; break;
    case 3: color = 2; break;
    case 4: color = 6; break;
    default: return -7;
  }
  const size_t bytes_per_sample = j.depth / 8;
  const size_t stride = static_cast<size_t>(j.w) * j.ch * bytes_per_sample;
  // raw scanlines: filter byte + big-endian samples; filter "Up" (2) makes
  // flat regions zero-heavy, helping deflate at negligible encode cost
  std::vector<uint8_t> be;
  if (j.depth == 16) {
    be.reserve(j.data.size());
    append_be16(be, j.data.data(), j.data.size());
  }
  const uint8_t* samples = j.depth == 16 ? be.data() : j.data.data();
  std::vector<uint8_t> raw;
  raw.reserve((stride + 1) * j.h);
  for (int y = 0; y < j.h; ++y) {
    const uint8_t* row = samples + static_cast<size_t>(y) * stride;
    if (y == 0) {
      raw.push_back(0);  // None
      raw.insert(raw.end(), row, row + stride);
    } else {
      const uint8_t* up = row - stride;
      raw.push_back(2);  // Up
      size_t base = raw.size();
      raw.resize(base + stride);
      for (size_t x = 0; x < stride; ++x)
        raw[base + x] = static_cast<uint8_t>(row[x] - up[x]);
    }
  }
  uLongf zcap = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> zbuf(zcap);
  if (compress2(zbuf.data(), &zcap, raw.data(), static_cast<uLong>(raw.size()),
                6) != Z_OK)
    return -8;
  std::vector<uint8_t> out;
  out.reserve(zcap + 128);
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = j.w >> 24; ihdr[1] = j.w >> 16; ihdr[2] = j.w >> 8; ihdr[3] = j.w;
  ihdr[4] = j.h >> 24; ihdr[5] = j.h >> 16; ihdr[6] = j.h >> 8; ihdr[7] = j.h;
  ihdr[8] = static_cast<uint8_t>(j.depth);
  ihdr[9] = static_cast<uint8_t>(color);
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", zbuf.data(), zcap);
  put_chunk(out, "IEND", nullptr, 0);
  return write_file(j.path, out.data(), out.size());
}

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

static long encode_jpeg(const Job& j) {
  if (j.depth != 8 || (j.ch != 1 && j.ch != 3)) return -7;
  jpeg_compress_struct cinfo;
  JpegErr err;
  unsigned char* outbuf = nullptr;
  unsigned long outsize = 0;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    free(outbuf);
    return -10;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &outbuf, &outsize);
  cinfo.image_width = j.w;
  cinfo.image_height = j.h;
  cinfo.input_components = j.ch;
  cinfo.in_color_space = j.ch == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  int q = j.quality < 1 ? 1 : (j.quality > 100 ? 100 : j.quality);
  jpeg_set_quality(&cinfo, q, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = static_cast<size_t>(j.w) * j.ch;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(j.data.data()) +
                   cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  long rc = write_file(j.path, outbuf, outsize);
  free(outbuf);
  return rc;
}

static long encode_and_write(const Job& j) {
  size_t dot = j.path.rfind('.');
  std::string ext = dot == std::string::npos ? "" : j.path.substr(dot);
  for (auto& c : ext) c = static_cast<char>(tolower(c));
  if (ext == ".pgm" || ext == ".ppm" || ext == ".pnm") return encode_pnm(j);
  if (ext == ".png") return encode_png(j);
  if (ext == ".jpg" || ext == ".jpeg") return encode_jpeg(j);
  return write_file(j.path, j.data.data(), j.data.size());  // raw bytes
}

static void worker(Writer* W) {
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(W->mu);
      W->cv_work.wait(lk, [&] { return W->stopping || !W->queue.empty(); });
      if (W->queue.empty()) return;  // stopping and drained
      job = std::move(W->queue.front());
      W->queue.pop_front();
      W->queued_bytes -= static_cast<long>(job.data.size());
      W->in_flight++;
    }
    W->cv_space.notify_all();
    long rc = encode_and_write(job);
    {
      std::lock_guard<std::mutex> lk(W->mu);
      if (rc < 0) W->failures.push_back({job.path, rc});
      W->in_flight--;
    }
    W->cv_done.notify_all();
  }
}

}  // namespace

extern "C" {

void* fw_create(int threads, long max_queue_bytes) {
  if (threads < 1) return nullptr;
  auto* W = new Writer();
  W->max_queue_bytes = max_queue_bytes > 0 ? max_queue_bytes : (256L << 20);
  for (int i = 0; i < threads; ++i) W->workers.emplace_back(worker, W);
  return W;
}

long fw_submit(void* handle, const char* path, const unsigned char* data,
               int w, int h, int ch, int depth, int quality) {
  auto* W = static_cast<Writer*>(handle);
  if (!path || !data || w <= 0 || h <= 0 || ch < 1 || ch > 4 ||
      (depth != 8 && depth != 16) || w > (1 << 24) || h > (1 << 24))
    return -3;
  long long bytes = static_cast<long long>(w) * h * ch * (depth / 8);
  if (bytes > (1LL << 33)) return -4;
  Job job;
  job.path = path;
  job.data.assign(data, data + bytes);
  job.w = w;
  job.h = h;
  job.ch = ch;
  job.depth = depth;
  job.quality = quality;
  {
    std::unique_lock<std::mutex> lk(W->mu);
    W->cv_space.wait(lk, [&] {
      return W->stopping || W->queued_bytes <= W->max_queue_bytes;
    });
    if (W->stopping) return -3;
    W->queued_bytes += static_cast<long>(job.data.size());
    W->queue.push_back(std::move(job));
  }
  W->cv_work.notify_one();
  return 0;
}

long fw_flush(void* handle) {
  auto* W = static_cast<Writer*>(handle);
  std::unique_lock<std::mutex> lk(W->mu);
  W->cv_done.wait(lk, [&] { return W->queue.empty() && W->in_flight == 0; });
  return static_cast<long>(W->failures.size());
}

long fw_failure(void* handle, long k, long* code, char* path_out, long cap) {
  auto* W = static_cast<Writer*>(handle);
  std::lock_guard<std::mutex> lk(W->mu);
  if (k < 0 || k >= static_cast<long>(W->failures.size())) return -1;
  const Failure& f = W->failures[k];
  *code = f.code;
  long n = static_cast<long>(f.path.size());
  if (path_out && cap > 0) {
    long m = n < cap - 1 ? n : cap - 1;
    memcpy(path_out, f.path.data(), m);
    path_out[m] = 0;
  }
  return n;
}

void fw_destroy(void* handle) {
  auto* W = static_cast<Writer*>(handle);
  {
    std::lock_guard<std::mutex> lk(W->mu);
    W->stopping = true;
  }
  W->cv_work.notify_all();
  W->cv_space.notify_all();
  for (auto& t : W->workers) t.join();
  delete W;
}

}  // extern "C"
