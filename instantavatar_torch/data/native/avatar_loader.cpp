// Native data engine: an in-RAM sequence cache and patch sampling, the
// host input pipeline for avatar training.
//
// Adapted from instantavatar_tpu/data/native/avatar_loader.cpp. There the
// engine decodes the PNG and npy files itself (libpng); here the caller
// decodes them (utils/image_io.read_png, whose uint8 values equal
// libpng's, and native_loader.decode_mask, whose values equal the JAX
// engine's npy reader and PNG-mask rule) and hands the frames over through
// avatar_load_decoded, so the engine needs no libpng on any host. The
// conversion, downscale, patch sampling (std::mt19937_64) and compositing
// are the JAX engine's, so the batches are equal bit for bit.
//
// Plain C ABI, driven from Python through ctypes
// (instantavatar_torch/data/native_loader.py).
//
// Build: g++ -O3 -ffp-contract=off -shared -fPIC avatar_loader.cpp
//        -o libavatar_loader.so -lpthread

#include <atomic>
#include <cstdint>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> rgb;   // H*W*3 in [0,1]
  std::vector<float> mask;  // H*W in [0,1]
  int height = 0;
  int width = 0;
};

struct Sequence {
  int height = 0;
  int width = 0;
  std::vector<Frame> frames;
};

// --------------------------------------------------------------- resize

// Box-filter downscale by an integer factor (matches cv2.resize area-ish
// behavior closely enough for training data).
void downscale(const std::vector<float>& src, int h, int w, int c, int f,
               std::vector<float>* dst, int* oh, int* ow) {
  if (f <= 1) {
    *dst = src;
    *oh = h;
    *ow = w;
    return;
  }
  int H = h / f, W = w / f;
  dst->assign(size_t(H) * W * c, 0.0f);
  float inv = 1.0f / float(f * f);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++)
      for (int k = 0; k < c; k++) {
        float acc = 0.0f;
        for (int dy = 0; dy < f; dy++)
          for (int dx = 0; dx < f; dx++)
            acc += src[((size_t(y) * f + dy) * w + (size_t(x) * f + dx)) * c
                       + k];
        (*dst)[(size_t(y) * W + x) * c + k] = acc * inv;
      }
  *oh = H;
  *ow = W;
}

}  // namespace

extern "C" {

// Load a sequence the caller decoded: images (n_frames, height, width, 3)
// uint8 in cv2's BGR order, masks (n_frames, height, width) float32 in
// [0, 1], both C-contiguous. The frames are converted (x * (1/255)) and
// downscaled as the JAX engine's avatar_load_sequence does.
// Returns an opaque handle (0 on failure).
void* avatar_load_decoded(const uint8_t* images, const float* masks,
                          int n_frames, int height, int width,
                          int downscale_f, int n_threads) {
  if (n_frames <= 0 || height <= 0 || width <= 0) return nullptr;
  auto* seq = new Sequence();
  seq->frames.resize(n_frames);
  const size_t px = size_t(height) * width;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_frames) return;
      const uint8_t* src = images + px * 3 * size_t(i);
      std::vector<float> rgb(px * 3);
      for (size_t p = 0; p < px * 3; p++) rgb[p] = src[p] * (1.0f / 255.0f);
      std::vector<float> mask(masks + px * size_t(i),
                              masks + px * size_t(i + 1));
      Frame& f = seq->frames[i];
      int oh, ow;
      downscale(rgb, height, width, 3, downscale_f, &f.rgb, &oh, &ow);
      downscale(mask, height, width, 1, downscale_f, &f.mask, &oh, &ow);
      f.height = oh;
      f.width = ow;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < (n_threads > 0 ? n_threads : 1); t++)
    pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  seq->height = seq->frames[0].height;
  seq->width = seq->frames[0].width;
  return seq;
}

int avatar_seq_height(void* handle) {
  return static_cast<Sequence*>(handle)->height;
}
int avatar_seq_width(void* handle) {
  return static_cast<Sequence*>(handle)->width;
}

// Sample P patches of size S from frame `idx`: composite over a random
// background, pick patch centers inside the (optionally dilated) mask with
// probability ratio_mask else uniform. Fills rgb (P*S*S*3), alpha (P*S*S),
// bg (P*S*S*3), and patch corner coords (P*2, row/col) for ray lookup.
// Returns 0 on success.
int avatar_sample_patches(void* handle, int idx, int n_patches,
                          int patch_size, float ratio_mask, int dilate,
                          uint64_t seed, float* rgb_out, float* alpha_out,
                          float* bg_out, int32_t* coords_out) {
  auto* seq = static_cast<Sequence*>(handle);
  if (idx < 0 || idx >= int(seq->frames.size())) return 1;
  const Frame& f = seq->frames[idx];
  const int H = seq->height, W = seq->width, S = patch_size;
  if (S > H || S > W) return 2;
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> unif(0.0f, 1.0f);

  // collect valid centers (mask > 0, optionally dilated) with the patch
  // fully inside the image
  std::vector<int> centers;
  const int o = S / 2;
  bool use_mask = unif(rng) < ratio_mask;
  if (use_mask) {
    int r = dilate > 0 ? dilate : 0;
    for (int y = o; y < H - o; y++)
      for (int x = o; x < W - o; x++) {
        bool on = f.mask[size_t(y) * W + x] > 0.0f;
        if (!on && r > 0) {
          for (int dy = -r; dy <= r && !on; dy++)
            for (int dx = -r; dx <= r && !on; dx++) {
              int yy = y + dy, xx = x + dx;
              if (yy >= 0 && yy < H && xx >= 0 && xx < W)
                on = f.mask[size_t(yy) * W + xx] > 0.0f;
            }
        }
        if (on) centers.push_back(y * W + x);
      }
  }
  std::uniform_int_distribution<int> rand_y(0, H - S - 1);
  std::uniform_int_distribution<int> rand_x(0, W - S - 1);

  for (int p = 0; p < n_patches; p++) {
    int y0, x0;
    if (use_mask && !centers.empty()) {
      int c = centers[std::uniform_int_distribution<size_t>(
          0, centers.size() - 1)(rng)];
      y0 = c / W - o;
      x0 = c % W - o;
    } else {
      y0 = rand_y(rng);
      x0 = rand_x(rng);
    }
    coords_out[p * 2 + 0] = y0;
    coords_out[p * 2 + 1] = x0;
    for (int y = 0; y < S; y++)
      for (int x = 0; x < S; x++) {
        size_t src = size_t(y0 + y) * W + (x0 + x);
        size_t dst = (size_t(p) * S + y) * S + x;
        float m = f.mask[src];
        alpha_out[dst] = m;
        for (int k = 0; k < 3; k++) {
          float bgv = unif(rng);
          float img = f.rgb[src * 3 + k];
          bg_out[dst * 3 + k] = bgv;
          rgb_out[dst * 3 + k] = img * m + (1.0f - m) * bgv;
        }
      }
  }
  return 0;
}

// Full-frame composite over white (val/test path). rgb/alpha sized H*W.
int avatar_full_frame(void* handle, int idx, float* rgb_out,
                      float* alpha_out) {
  auto* seq = static_cast<Sequence*>(handle);
  if (idx < 0 || idx >= int(seq->frames.size())) return 1;
  const Frame& f = seq->frames[idx];
  size_t n = size_t(seq->height) * seq->width;
  for (size_t p = 0; p < n; p++) {
    float m = f.mask[p];
    alpha_out[p] = m;
    for (int k = 0; k < 3; k++)
      rgb_out[p * 3 + k] = f.rgb[p * 3 + k] * m + (1.0f - m);
  }
  return 0;
}

void avatar_free_sequence(void* handle) {
  delete static_cast<Sequence*>(handle);
}

}  // extern "C"
