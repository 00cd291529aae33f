// Native point-cloud data pipeline: load + filter + augment + pad.
//
// The reference delegates its data path to mmdet3d's Python pipeline backed by
// CUDA/numba ops (SURVEY.md §2b 'Data pipeline ops'); here the host-side work
// (velodyne .bin IO, range filtering, global rot/scale/flip augmentation,
// fixed-size padding) is native C++ with a threaded batch assembler, so the
// feeding path keeps up with a fused TPU train step. Exposed via a C ABI for
// ctypes (no pybind11 in the image).
//
// Layout conventions match the Python pipeline (data/kitti.py): points are
// [N, stride] float32 with xyz in the leading 3; boxes are 7-DoF
// (x, y, z_center, dx, dy, dz, yaw).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// Read a velodyne .bin (float32 records of `stride` values). Returns the
// number of points written (<= max_points), or -1 on IO error.
int rpc_load_points(const char* path, float* out, int max_points, int stride) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  size_t n = std::fread(out, sizeof(float) * stride, (size_t)max_points, f);
  std::fclose(f);
  return (int)n;
}

// In-place range filter. Returns the new count; compacted to the front.
int rpc_range_filter(float* pts, int n, int stride, const float* pcr) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const float* p = pts + (size_t)i * stride;
    if (p[0] >= pcr[0] && p[0] < pcr[3] && p[1] >= pcr[1] && p[1] < pcr[4] &&
        p[2] >= pcr[2] && p[2] < pcr[5]) {
      if (m != i) std::memcpy(pts + (size_t)m * stride, p, sizeof(float) * stride);
      ++m;
    }
  }
  return m;
}

// Global rotate (around +z) + scale + optional BEV flip (y -> -y), applied to
// points and boxes together — the GlobalRotScaleTrans / RandomFlip3D pair.
void rpc_global_transform(float* pts, int n, int stride, float* boxes,
                          int n_boxes, float theta, float scale, int flip) {
  const float c = std::cos(theta), s = std::sin(theta);
  for (int i = 0; i < n; ++i) {
    float* p = pts + (size_t)i * stride;
    float y = flip ? -p[1] : p[1];
    float x = p[0];
    p[0] = (x * c - y * s) * scale;
    p[1] = (x * s + y * c) * scale;
    p[2] = p[2] * scale;
  }
  for (int i = 0; i < n_boxes; ++i) {
    float* b = boxes + (size_t)i * 7;
    float y = flip ? -b[1] : b[1];
    float yaw = flip ? -b[6] : b[6];
    float x = b[0];
    b[0] = (x * c - y * s) * scale;
    b[1] = (x * s + y * c) * scale;
    b[2] *= scale;
    b[3] *= scale;
    b[4] *= scale;
    b[5] *= scale;
    b[6] = yaw + theta;
  }
}

// Fisher-Yates shuffle + pad/subsample to exactly max_points.
// mask_out[i] = 1 for real points. Returns the real count.
int rpc_shuffle_pad(float* pts, int n, int stride, unsigned seed,
                    float* out, uint8_t* mask_out, int max_points) {
  std::mt19937 rng(seed);
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  for (int i = n - 1; i > 0; --i) {
    std::uniform_int_distribution<int> d(0, i);
    std::swap(order[i], order[d(rng)]);
  }
  int keep = n < max_points ? n : max_points;
  for (int i = 0; i < keep; ++i) {
    std::memcpy(out + (size_t)i * stride, pts + (size_t)order[i] * stride,
                sizeof(float) * stride);
    mask_out[i] = 1;
  }
  for (int i = keep; i < max_points; ++i) {
    std::memset(out + (size_t)i * stride, 0, sizeof(float) * stride);
    mask_out[i] = 0;
  }
  return keep;
}

// One sample end to end: load -> (augment) -> filter -> shuffle/pad.
// boxes [n_boxes, 7] are transformed in place and range-filtered via
// box_keep_out (caller drops boxes whose centers left the BEV range).
// Returns the point count, or -1 on IO error.
int rpc_prepare_sample(const char* path, int stride, const float* pcr,
                       unsigned seed, int augment, float rot_range,
                       float scale_min, float scale_max,
                       float* boxes, int n_boxes, uint8_t* box_keep_out,
                       float* out_points, uint8_t* out_mask, int max_points,
                       float* scratch, int scratch_cap) {
  int n = rpc_load_points(path, scratch, scratch_cap, stride);
  if (n < 0) return -1;
  if (augment) {
    std::mt19937 rng(seed);
    std::uniform_real_distribution<float> uth(-rot_range, rot_range);
    std::uniform_real_distribution<float> usc(scale_min, scale_max);
    std::uniform_real_distribution<float> ufl(0.f, 1.f);
    float theta = uth(rng), scale = usc(rng);
    int flip = ufl(rng) < 0.5f;
    rpc_global_transform(scratch, n, stride, boxes, n_boxes, theta, scale, flip);
  }
  n = rpc_range_filter(scratch, n, stride, pcr);
  for (int i = 0; i < n_boxes; ++i) {
    const float* b = boxes + (size_t)i * 7;
    box_keep_out[i] =
        (b[0] >= pcr[0] && b[0] < pcr[3] && b[1] >= pcr[1] && b[1] < pcr[4]) ? 1 : 0;
  }
  return rpc_shuffle_pad(scratch, n, stride, seed ^ 0x9e3779b9u, out_points,
                         out_mask, max_points);
}

// Threaded batch assembly: prepares B samples in parallel.
// paths: B concatenated zero-terminated strings. Outputs are [B, ...] blocks.
// counts_out[b] = point count or -1 on error.
void rpc_prepare_batch(const char** paths, int batch, int stride,
                       const float* pcr, unsigned seed, int augment,
                       float rot_range, float scale_min, float scale_max,
                       float* boxes, const int* n_boxes, int max_boxes,
                       uint8_t* box_keep_out,
                       float* out_points, uint8_t* out_mask, int max_points,
                       int* counts_out, int scratch_cap) {
  std::vector<std::thread> threads;
  threads.reserve(batch);
  for (int b = 0; b < batch; ++b) {
    threads.emplace_back([=]() {
      std::vector<float> scratch((size_t)scratch_cap * stride);
      counts_out[b] = rpc_prepare_sample(
          paths[b], stride, pcr, seed + 977u * (unsigned)b, augment, rot_range,
          scale_min, scale_max, boxes + (size_t)b * max_boxes * 7, n_boxes[b],
          box_keep_out + (size_t)b * max_boxes,
          out_points + (size_t)b * max_points * stride,
          out_mask + (size_t)b * max_points, max_points, scratch.data(),
          scratch_cap);
    });
  }
  for (auto& t : threads) t.join();
}

// Load one lidar sweep and bring it into the key frame: xyz' = R*xyz + T
// (rt = 12 floats row-major [R|T], or null for identity), channel `ts_ch`
// set to the sweep's time lag. Returns the point count or -1 on IO error.
int rpc_load_sweep(const char* path, float* out, int max_points, int stride,
                   const float* rt, float lag, int ts_ch) {
  int n = rpc_load_points(path, out, max_points, stride);
  if (n < 0) return -1;
  for (int i = 0; i < n; ++i) {
    float* p = out + (size_t)i * stride;
    if (rt) {
      float x = p[0], y = p[1], z = p[2];
      p[0] = rt[0] * x + rt[1] * y + rt[2] * z + rt[3];
      p[1] = rt[4] * x + rt[5] * y + rt[6] * z + rt[7];
      p[2] = rt[8] * x + rt[9] * y + rt[10] * z + rt[11];
    }
    if (ts_ch >= 0 && ts_ch < stride) p[ts_ch] = lag;
  }
  return n;
}

// Threaded multi-sweep assembly (NuScenes LoadPointsFromMultiSweeps): loads
// `n_sweeps` files in parallel into per-sweep slots of `out`
// [n_sweeps, max_points, stride]. rts: [n_sweeps, 12] row-major [R|T] per
// sweep (rt_valid[s] == 0 -> identity). counts_out[s] = points or -1.
void rpc_load_sweeps(const char** paths, int n_sweeps, int stride,
                     const float* rts, const uint8_t* rt_valid,
                     const float* lags, int ts_ch,
                     float* out, int max_points, int* counts_out) {
  std::vector<std::thread> threads;
  threads.reserve(n_sweeps);
  for (int s = 0; s < n_sweeps; ++s) {
    threads.emplace_back([=]() {
      counts_out[s] = rpc_load_sweep(
          paths[s], out + (size_t)s * max_points * stride, max_points, stride,
          rt_valid[s] ? rts + (size_t)s * 12 : nullptr, lags[s], ts_ch);
    });
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
