// Deformable 2D convolution (DCNv1) forward, for Hopper (sm_90a): bilinear
// sampling fused into the grouped product, one launch a convolution.
//
// Replaces no Pallas kernel: the JAX package's DeformConv2d
// (robustpointclouds_tpu/nn/deform_conv.py) is plain XLA, four gathers and
// one matmul a group. The port's plain twin (kernels/deform_conv.
// deform_conv2d_ref) does the same in eager torch: it writes a float32 col of
// [B*H*W, K, C] through some twenty passes of tensor ops, then an einsum. This
// kernel keeps col out of device memory.
//
//     out[b, o, h, w] = sum_{c in o's group, t < K} weight[o, c, t] *
//         bilinear(x[b, c], h + t / k - pad + dy[b, d(c), t, h, w],
//                           w + t % k - pad + dx[b, d(c), t, h, w])
//
// x [B, C, H, W], offset [B, dg * 2 * K, H, W] (mmcv's channel order [deform
// group, tap, (dy, dx)]), weight [Cout, C / groups, k, k] and out [B, Cout,
// H, W] are contiguous float32; K = k * k, pad = (k - 1) / 2, stride 1,
// d(c) = c / (C / dg). A corner of the bilinear sample outside the map reads
// zero (mmcv's border rule, as the twin's); a non-finite offset gives NaN
// bilinear weights, so NaN outputs at its own pixel and nowhere else.
//
// What bounds it on this card: the operations. At CenterPoint's head (x [4,
// 64, 128, 128], groups 4, 3x3) the product is 2 * B*H*W * Cout * C/g * K =
// 1.21 GFLOP, 18 us at the 67 TFLOP/s of float32 on the CUDA cores, while x,
// the offsets and the output are 38 MB, 11.4 us at 3.35 TB/s; the arithmetic
// stays float32 (no TF32: the head is float32-stated). The design:
//  * one block takes a tile of kPixels consecutive output pixels (flattened
//    h * W + w, so a tile covers one row of a 128-wide map) of one sample
//    and every output channel, one conv group after another;
//  * the group's contraction rows (tap, channel) are taken a chunk at a
//    time (all the group's channels and as many taps as kRows holds: two
//    chunks of 80 and 64 rows at C/g = 16). A thread samples its own pixel:
//    per tap it reads the two offsets, computes the four corners' indices,
//    validity and bilinear weights once, and applies them to every channel
//    of the chunk (recomputed only where the deform group changes), storing
//    col[row][pixel] in shared memory. x (16.8 MB there) stays in the 50 MB
//    L2, so the corners' re-reads across taps and tiles are cache hits;
//  * the chunk's weights, [row][16 outputs], are staged beside it; each
//    thread then accumulates a 4-pixel x 4-output tile in float32 registers
//    with CUDA-core FMAs: per row one 16-byte col read (consecutive across a
//    warp) and one broadcast 16-byte weight read feed 16 FMAs;
//  * the sums are stored NCHW, 16 bytes a lane along W, coalesced.
// It launches on the caller's stream, never synchronises, allocates nothing,
// and returns the launch's cudaError_t.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps: one pixel a thread while sampling
constexpr int kPixels = 128;   // a tile; 4 a lane in the product
constexpr int kOutBlock = 16;  // outputs a pass: 4 a warp
constexpr int kRows = 80;      // contraction rows staged at once: kRows * (kPixels + kOutBlock) floats
constexpr int kMinBlocks = 4;  // blocks an SM holds: 46 KB of shared memory each

struct Corners {  // value-initialised: no corner inside the map, every weight 0
  int idx[4];     // y * W + x of (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
  bool ok[4];     // inside the map
  float wt[4];    // bilinear weights
};

__device__ __forceinline__ Corners corners(float py, float px, int H, int W) {
  Corners r;
  const float y0 = floorf(py), x0 = floorf(px);
  const float wy = py - y0, wx = px - x0;
  // clamp before the conversion: an offset may pass any int, and NaN goes to
  // -2 (fmaxf returns the other operand), outside the map
  const int yi = static_cast<int>(fminf(fmaxf(y0, -2.f), static_cast<float>(H)));
  const int xi = static_cast<int>(fminf(fmaxf(x0, -2.f), static_cast<float>(W)));
  const bool y_lo = yi >= 0 && yi < H, y_hi = yi + 1 >= 0 && yi + 1 < H;
  const bool x_lo = xi >= 0 && xi < W, x_hi = xi + 1 >= 0 && xi + 1 < W;
  r.ok[0] = y_lo && x_lo;
  r.ok[1] = y_lo && x_hi;
  r.ok[2] = y_hi && x_lo;
  r.ok[3] = y_hi && x_hi;
  r.idx[0] = yi * W + xi;
  r.idx[1] = r.idx[0] + 1;
  r.idx[2] = r.idx[0] + W;
  r.idx[3] = r.idx[2] + 1;
  r.wt[0] = (1.f - wy) * (1.f - wx);
  r.wt[1] = (1.f - wy) * wx;
  r.wt[2] = wy * (1.f - wx);
  r.wt[3] = wy * wx;
  return r;
}

__device__ __forceinline__ float sample(const float* __restrict__ plane, const Corners& cr) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = cr.ok[i] ? __ldg(plane + cr.idx[i]) : 0.f;
    s += v * cr.wt[i];
  }
  return s;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
deform_conv_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                   const float* __restrict__ weight, float* __restrict__ out, int C, int H,
                   int W, int cout, int k, int groups, int deform_groups, int chunk_taps) {
  __shared__ __align__(16) float col[kRows * kPixels];
  __shared__ __align__(16) float wts[kRows * kOutBlock];
  const int hw = H * W;
  const int K = k * k, pad = (k - 1) / 2;
  const int cg = C / groups, og = cout / groups, cdg = C / deform_groups;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kPixels;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the pixel this thread samples
  const int p = p0 + tid;
  const bool in_map = p < hw;
  const int h = in_map ? p / W : 0, w = in_map ? p - (p / W) * W : 0;
  const float* xb = x + static_cast<int64_t>(b) * C * hw;
  const float* offb = offset + static_cast<int64_t>(b) * deform_groups * 2 * K * hw + (in_map ? p : 0);
  float* outb = out + static_cast<int64_t>(b) * cout * hw;
  const int q = p0 + 4 * lane;  // the first of the 4 pixels this lane accumulates
  const bool vec_store = (hw & 3) == 0 && q < hw;

  for (int gi = 0; gi < groups; ++gi) {
    for (int ob0 = 0; ob0 < og; ob0 += kOutBlock) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      for (int t0 = 0; t0 < K; t0 += chunk_taps) {
        const int tc = min(chunk_taps, K - t0);
        // with one tap a chunk, the group's channels may outnumber kRows
        for (int c0 = 0; c0 < cg; c0 += kRows) {
          const int cc = min(cg - c0, kRows / tc);
          const int rows = tc * cc;
          __syncthreads();  // the previous chunk's product has read col and wts
          // (a) sample: row tl * cc + cl holds channel c0 + cl at tap t0 + tl;
          // the channels of one deform group share their corners, and their
          // samples are independent, so their loads overlap
          for (int tl = 0; tl < tc; ++tl) {
            const int t = t0 + tl;
            const float py = static_cast<float>(h + t / k - pad);
            const float px = static_cast<float>(w + t % k - pad);
            float* dst = col + tl * cc * kPixels + tid;
            for (int cl = 0; cl < cc;) {
              const int c = gi * cg + c0 + cl;
              const int d = c / cdg;
              const int run = min(cc - cl, (d + 1) * cdg - c);  // channels of deform group d
              const float* o = offb + static_cast<int64_t>((d * K + t) * 2) * hw;
              const Corners cr = in_map ? corners(py + __ldg(o), px + __ldg(o + hw), H, W)
                                        : Corners{};
              const float* plane = xb + static_cast<int64_t>(c) * hw;
#pragma unroll 4
              for (int i = 0; i < run; ++i)
                dst[(cl + i) * kPixels] = sample(plane + static_cast<int64_t>(i) * hw, cr);
              cl += run;
            }
          }
          // (b) the chunk's weights: wts[row][o] = weight[gi * og + ob0 + o, c, t]
          for (int e = tid; e < rows * kOutBlock; e += kThreads) {
            const int r = e / kOutBlock, o = ob0 + e % kOutBlock;
            const int tl = r / cc, cl = r - tl * cc;
            wts[e] = o < og ? __ldg(weight + (static_cast<int64_t>(gi * og + o) * cg + c0 + cl) * K +
                                    t0 + tl)
                            : 0.f;
          }
          __syncthreads();
          // (c) the product: 4 outputs (this warp's) x 4 pixels (this lane's)
#pragma unroll 4
          for (int r = 0; r < rows; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(col + r * kPixels + 4 * lane);
            const float4 wv = *reinterpret_cast<const float4*>(wts + r * kOutBlock + 4 * warp);
            const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[j][0] = fmaf(wj[j], a.x, acc[j][0]);
              acc[j][1] = fmaf(wj[j], a.y, acc[j][1]);
              acc[j][2] = fmaf(wj[j], a.z, acc[j][2]);
              acc[j][3] = fmaf(wj[j], a.w, acc[j][3]);
            }
          }
        }
      }
      // (d) store NCHW: a warp's lanes write 4 consecutive pixels each
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = ob0 + 4 * warp + j;
        if (o >= og) continue;
        float* dst = outb + static_cast<int64_t>(gi * og + o) * hw;
        if (vec_store) {
          *reinterpret_cast<float4*>(dst + q) = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (q + i < hw) dst[q + i] = acc[j][i];
        }
      }
    }
  }
}

// Taps a chunk of contraction rows holds for C / groups channels: as many as
// fit kRows, spread evenly over the chunks (5 + 4 at C/g = 16, 3x3), or 1
// when a tap's channels alone pass kRows (they are then split).
int64_t chunk_taps_for(int64_t channels_a_group, int64_t taps) {
  const int64_t fit = kRows / channels_a_group;
  if (fit <= 1) return 1;
  const int64_t chunks = (taps + fit - 1) / fit;
  return (taps + chunks - 1) / chunks;
}

}  // namespace

extern "C" {

// x [b, c, h, w], offset [b, deform_groups * 2 * k * k, h, w], weight
// [cout, c / groups, k, k] and out [b, cout, h, w]: contiguous float32 on one
// device. Returns the cudaError_t of the launch (0 = success). The caller has
// checked shapes, types and devices.
int rpc_deform_conv2d(const void* x, const void* offset, const void* weight, void* out, int64_t b,
                      int64_t c, int64_t h, int64_t w, int64_t cout, int64_t k, int64_t groups,
                      int64_t deform_groups, void* stream) {
  if (b < 1 || b > 65535 || c < 1 || h < 1 || w < 1 || cout < 1 || k < 1 ||
      groups < 1 || deform_groups < 1 || c % groups || cout % groups || c % deform_groups ||
      (h + 2) * (w + 2) > INT32_MAX - kPixels || c * h * w > INT32_MAX || cout > INT32_MAX / 4 ||
      deform_groups * 2 * k * k > INT32_MAX / (h * w))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk_taps = chunk_taps_for(c / groups, k * k);
  const dim3 grid(static_cast<unsigned>((h * w + kPixels - 1) / kPixels), static_cast<unsigned>(b));
  deform_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(weight), static_cast<float*>(out), static_cast<int>(c),
      static_cast<int>(h), static_cast<int>(w), static_cast<int>(cout), static_cast<int>(k),
      static_cast<int>(groups), static_cast<int>(deform_groups), static_cast<int>(chunk_taps));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
