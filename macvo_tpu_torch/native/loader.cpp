// Native data-loading engine: threaded PNG decode into float32 RGB arrays
// (the port's copy of macvo_tpu/native/loader.cpp, same code).
//
// Image decode is the host's per-frame cost at target frame rates (two PNGs
// per stereo frame). This engine decodes on a C++ worker pool with no GIL
// involvement and writes straight into caller-provided (numpy) buffers, so
// Python only orchestrates. Values are the PNG's 8-bit samples times
// 1.0f/255.0f (cv2's path divides by 255.0: the two differ in the last bit
// for some values).
//
// Exposed via a minimal C ABI consumed with ctypes. Build: see
// macvo_tpu_torch/native/__init__.py (g++ -O3 -shared -lpng).

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// Decode one 8/16-bit PNG into float32 RGB [0,1], channel-last.
// Returns 0 on success; fills *out_h/*out_w. Fails (-1) on IO/format errors
// or when the image exceeds the caller's buffer.
int decode_png_rgb(const char* path, float* out, int max_h, int max_w,
                   int* out_h, int* out_w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return -1;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -1;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  if ((int)height > max_h || (int)width > max_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -1;
  }

  // Normalize every input to 8-bit RGB.
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  std::vector<uint8_t> row(png_get_rowbytes(png, info));
  const float scale = 1.0f / 255.0f;
  for (png_uint_32 y = 0; y < height; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out + (size_t)y * width * 3;
    for (png_uint_32 x = 0; x < width * 3; ++x) dst[x] = row[x] * scale;
  }
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *out_h = (int)height;
  *out_w = (int)width;
  return 0;
}

// Fixed worker pool draining a job queue (one job = one image decode).
class DecodePool {
 public:
  explicit DecodePool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { this->worker(); });
  }

  ~DecodePool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void submit(std::function<void()> job) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

  void wait_empty() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return jobs_.empty() && active_ == 0; });
  }

 private:
  void worker() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop();
        ++active_;
      }
      job();
      {
        std::unique_lock<std::mutex> lk(mu_);
        --active_;
        if (jobs_.empty() && active_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  int active_ = 0;
  bool stop_;
};

}  // namespace

extern "C" {

int mvo_decode_png(const char* path, float* out, int max_h, int max_w,
                   int* out_h, int* out_w) {
  return decode_png_rgb(path, out, max_h, max_w, out_h, out_w);
}

void* mvo_pool_create(int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  return new DecodePool(n_threads);
}

void mvo_pool_destroy(void* pool) { delete static_cast<DecodePool*>(pool); }

// Decode n images concurrently into out[n, h, w, 3] (each path's image must
// be exactly (h, w)). Returns the number of failed decodes (0 = all good).
int mvo_pool_decode_batch(void* pool_ptr, const char** paths, int n,
                          float* out, int h, int w) {
  auto* pool = static_cast<DecodePool*>(pool_ptr);
  std::atomic<int> failures{0};
  for (int i = 0; i < n; ++i) {
    const char* path = paths[i];
    float* dst = out + (size_t)i * h * w * 3;
    pool->submit([path, dst, h, w, &failures] {
      int gh = 0, gw = 0;
      if (decode_png_rgb(path, dst, h, w, &gh, &gw) != 0 || gh != h || gw != w)
        failures.fetch_add(1, std::memory_order_relaxed);
    });
  }
  pool->wait_empty();
  return failures.load();
}

}  // extern "C"
