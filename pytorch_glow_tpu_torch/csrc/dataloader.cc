// Native batch decoder of pytorch_glow_tpu_torch (data/native_loader.py).
//
// A copy of the JAX package's native/dataloader.cc, built with g++ (not
// nvcc) into the port's _build/ directory: C++ threads decode JPEG/PNG
// (libjpeg/libpng), center-crop, bilinear-resize (half-pixel centres, no
// antialias) and write the uint8 NHWC batch into a caller-provided buffer,
// without touching the GIL.  Same C ABI, same bytes.
//
// C ABI (ctypes-friendly):
//   int gdl_decode_batch(const char* const* paths, int n, int size,
//                        int threads, unsigned char* out, char* err, int errlen);
//     out: n * size * size * 3 bytes, NHWC RGB.  Returns 0 on success,
//     k>0 = number of failed images (failed slots are zero-filled,
//     first error message in err).
//   int gdl_image_dims(const char* path, int* w, int* h);  // peek dims
//   const char* gdl_version();
//
// Async pool API (persistent workers; submit batch i+1 while batch i is
// consumed — double-buffered decode without re-spawning threads):
//   void* gdl_pool_create(int threads);
//   int   gdl_pool_submit(pool, const char* const* paths, int n, int size,
//                         unsigned char* out);   // -> job id; paths are
//                         copied at submit, `out` must stay alive to wait
//   int   gdl_pool_wait(pool, int job);          // -> failures; frees job
//   void  gdl_pool_destroy(pool);                // joins workers

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Image {
  std::vector<unsigned char> data;  // HWC, RGB
  int w = 0, h = 0;
};

// ---------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(FILE* f, Image* img) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img->w = cinfo.output_width;
  img->h = cinfo.output_height;
  img->data.resize(size_t(img->w) * img->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = img->data.data() + size_t(cinfo.output_scanline) * img->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG ----

bool decode_png(FILE* f, Image* img) {
  png_byte header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  img->w = png_get_image_width(png, info);
  img->h = png_get_image_height(png, info);
  img->data.resize(size_t(img->w) * img->h * 3);
  std::vector<png_bytep> rows(img->h);
  for (int y = 0; y < img->h; ++y)
    rows[y] = img->data.data() + size_t(y) * img->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* img) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[2] = {0, 0};
  if (fread(magic, 1, 2, f) != 2) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  if (magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, img);
  } else if (magic[0] == 0x89 && magic[1] == 0x50) {
    ok = decode_png(f, img);
  }
  fclose(f);
  return ok;
}

// ------------------------------------------------ crop + bilinear resize --

// Center-crop to square, then bilinear-resize to (size, size).
// Half-pixel-centers bilinear, no antialias.
void crop_resize(const Image& src, int size, unsigned char* out) {
  int s = std::min(src.w, src.h);
  int x0 = (src.w - s) / 2;
  int y0 = (src.h - s) / 2;
  float scale = float(s) / size;
  for (int oy = 0; oy < size; ++oy) {
    float fy = (oy + 0.5f) * scale - 0.5f;
    int iy = int(std::floor(fy));
    float wy = fy - iy;
    int y_lo = std::clamp(iy, 0, s - 1) + y0;
    int y_hi = std::clamp(iy + 1, 0, s - 1) + y0;
    for (int ox = 0; ox < size; ++ox) {
      float fx = (ox + 0.5f) * scale - 0.5f;
      int ix = int(std::floor(fx));
      float wx = fx - ix;
      int x_lo = std::clamp(ix, 0, s - 1) + x0;
      int x_hi = std::clamp(ix + 1, 0, s - 1) + x0;
      const unsigned char* p00 = &src.data[(size_t(y_lo) * src.w + x_lo) * 3];
      const unsigned char* p01 = &src.data[(size_t(y_lo) * src.w + x_hi) * 3];
      const unsigned char* p10 = &src.data[(size_t(y_hi) * src.w + x_lo) * 3];
      const unsigned char* p11 = &src.data[(size_t(y_hi) * src.w + x_hi) * 3];
      unsigned char* o = out + (size_t(oy) * size + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                  wy * ((1 - wx) * p10[c] + wx * p11[c]);
        o[c] = (unsigned char)std::lround(std::clamp(v, 0.0f, 255.0f));
      }
    }
  }
}

// ------------------------------------------------------- async decode pool

struct Job {
  std::vector<std::string> paths;
  int size = 0;
  unsigned char* out = nullptr;
  std::atomic<int> next{0};       // next unclaimed image index
  std::atomic<int> remaining{0};  // images not yet finished
  std::atomic<int> failures{0};
};

void run_task(Job& job, int i) {
  const size_t stride = size_t(job.size) * job.size * 3;
  Image img;
  if (decode_file(job.paths[i].c_str(), &img)) {
    crop_resize(img, job.size, job.out + size_t(i) * stride);
  } else {
    std::memset(job.out + size_t(i) * stride, 0, stride);
    job.failures.fetch_add(1);
  }
}

}  // namespace

struct gdl_pool {
  std::mutex mu;
  std::condition_variable cv_work;  // workers: a job has unclaimed tasks
  std::condition_variable cv_done;  // waiters: some job finished
  std::deque<std::shared_ptr<Job>> open;              // jobs with unclaimed tasks
  std::unordered_map<int, std::shared_ptr<Job>> jobs;  // all unwaited jobs
  std::vector<std::thread> workers;
  int next_id = 0;
  bool stop = false;

  void worker() {
    for (;;) {
      std::shared_ptr<Job> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || !open.empty(); });
        if (stop) return;
        job = open.front();
      }
      int i = job->next.fetch_add(1);
      if (i >= int(job->paths.size())) {
        // Exhausted: retire from the open queue (whoever sees it first).
        std::lock_guard<std::mutex> lk(mu);
        if (!open.empty() && open.front() == job) open.pop_front();
        continue;
      }
      run_task(*job, i);
      if (job->remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(mu);
        cv_done.notify_all();
      }
    }
  }
};

extern "C" {

const char* gdl_version() { return "glowdata-1.1"; }

gdl_pool* gdl_pool_create(int threads) {
  if (threads < 1) threads = 1;
  auto* p = new gdl_pool();
  p->workers.reserve(threads);
  for (int t = 0; t < threads; ++t)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

void gdl_pool_destroy(gdl_pool* p) {
  if (!p) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_work.notify_all();
  for (auto& th : p->workers) th.join();
  delete p;
}

int gdl_pool_submit(gdl_pool* p, const char* const* paths, int n, int size,
                    unsigned char* out) {
  if (!p || n < 0 || size <= 0 || (n > 0 && !out)) return -1;
  auto job = std::make_shared<Job>();
  job->paths.reserve(n);
  for (int i = 0; i < n; ++i) job->paths.emplace_back(paths[i]);
  job->size = size;
  job->out = out;
  job->remaining.store(n);
  int id;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    id = p->next_id++;
    p->jobs.emplace(id, job);
    if (n > 0) p->open.push_back(job);
  }
  if (n > 0) p->cv_work.notify_all();
  return id;
}

int gdl_pool_wait(gdl_pool* p, int job_id) {
  if (!p) return -1;
  std::shared_ptr<Job> job;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    auto it = p->jobs.find(job_id);
    if (it == p->jobs.end()) return -1;
    job = it->second;
    p->cv_done.wait(lk, [&] { return job->remaining.load() == 0; });
    p->jobs.erase(job_id);
  }
  return job->failures.load();
}

int gdl_image_dims(const char* path, int* w, int* h) {
  Image img;
  if (!decode_file(path, &img)) return -1;
  *w = img.w;
  *h = img.h;
  return 0;
}

int gdl_decode_batch(const char* const* paths, int n, int size, int threads,
                     unsigned char* out, char* err, int errlen) {
  std::atomic<int> failures(0);
  std::atomic<int> next(0);
  if (threads < 1) threads = 1;
  threads = std::min(threads, n);
  const size_t stride = size_t(size) * size * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img;
      if (decode_file(paths[i], &img)) {
        crop_resize(img, size, out + size_t(i) * stride);
      } else {
        std::memset(out + size_t(i) * stride, 0, stride);
        if (failures.fetch_add(1) == 0 && err && errlen > 0) {
          std::snprintf(err, errlen, "decode failed: %s", paths[i]);
        }
      }
    }
  };

  if (threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

}  // extern "C"
