// Masked per-channel statistics, their VJP, and MaskedBatchNorm's forward and
// backward fused around them, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `masked_stats` of robustpointclouds_tpu/kernels/
// masked_stats.py (`_kernel` :32, `_masked_moments` with its pallas_call at
// :63, the wrapper `masked_stats` :113) and its analytic VJP `_stats_bwd`
// (:102), and takes in the elementwise work that follows the statistics in
// MaskedBatchNorm (robustpointclouds_tpu/nn/layers.py:45; the port's
// nn/layers.py), ReLU and the row mask of SparseConvBlock.
//
// Five kernels, each one launch of one ctypes call (kernels/masked_stats.py):
//  * stats_kernel: (mean, biased var, count) over the rows where mask is set.
//    Each thread keeps (count, mean, M2) of its channels in registers, merging
//    each batch of rows into it with Chan's formula; the block merges its
//    threads with Chan's k-way form over warp shuffles and its warps in
//    shared memory, in a fixed order. Each block writes its
//    partial to a workspace, fences, and takes a ticket; the last block merges
//    the partials in block order with Chan's k-way form (the mean as the
//    count-weighted sum of the partial means; M2 as the sum of the partial
//    M2s plus n_b (mean_b - mean)^2, both in fixed slices and a fixed tree),
//    so the result is bit-identical from call to call and never takes
//    E[x^2] - mean^2 (the Pallas form, :92). The last block writes mean, var
//    and count, updates the running statistics in place when asked (as
//    nn/layers.py does: momentum m, the biased var, rm * (1 - m) + m * mean
//    with each product and the sum rounded once), and resets the ticket.
//  * apply_kernel: y = ((x - mean) * rsqrt(var + eps)) * gamma + beta in
//    float32, in the order of the eager composition, with no FMA contraction,
//    then ReLU and the row mask when asked, stored in the output's type.
//  * bwd_reduce_kernel: recomputes xhat and y from x (no activation is
//    saved), gates g_eff = g * [y > 0] * [row kept] and sums over all rows
//    S1 = sum g_eff (d beta) and S2 = sum g_eff * xhat (d gamma), with the
//    stats kernel's ticketed, fixed-order last-block merge.
//  * dx_kernel: train mode dx = gamma r (g_eff - m (S1 + xhat S2) / n),
//    r = rsqrt(var + eps), n = max(count, 1) (rows with m = 0 get
//    gamma r g_eff); eval mode dx = gamma r g_eff. dx in x's type.
//  * vjp_kernel: the statistics' own VJP, dx = m (g_mean + 2 g_var (x - mean))
//    / max(count, 1), either cotangent possibly absent.
//
// What bounds them on this card: a few flops a byte and no tensor-core work,
// so bytes. Every kernel streams [N, C] rows with 16-byte loads (one float4 a
// thread at C = 4 float32, 8 channels a load for bfloat16; 8-byte loads for
// 4-channel bfloat16 rows), C / VEC threads a row, each thread's channels
// fixed for its whole grid-stride walk so its per-channel coefficients stay
// in registers; several rows are loaded before any is used, so each thread
// keeps several loads in flight. Rows outside the mask are not read where
// they cannot contribute. Every grid is at most one wave of kMinBlocks
// blocks on each SM, so no block waits for a second wave. A reduction keeps
// its chains short: each thread takes its rows kStatsUnroll at a time
// two-pass in registers, the block merges its threads with Chan's k-way form
// as plain sums (warp shuffles, then its warps in order), and the last block
// reads the partials from L2 kMerge at a time; a small input gets fewer
// blocks (a whole batch of rows a thread), so fewer partials to merge.
//
// Contract: x [N, C] row-major, N >= 1, C a power of two in [4, 128], float32
// or bfloat16; mask [N] bytes 0/1; statistics, parameters and running
// statistics float32. The workspace and ticket belong to one (device,
// stream): the port runs on one stream, so two reductions never share them
// at once, and each leaves the ticket at 0 for the next. Every entry point
// returns the cudaError_t of its launch (0 = success); the caller has checked
// devices, types, shapes, contiguity and alignment. Nothing synchronises or
// allocates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // blocks resident on each SM: the grids are one wave of them
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 128;
constexpr int kUnroll = 4;       // rows a thread loads before it uses any
constexpr int kStatsUnroll = 8;  // the same for the statistics (one input, few registers)
constexpr int kMerge = 8;        // partials the last block loads before it sums any

// ---- 16-byte (or 8-byte) vectors of VEC values, converted to float32

template <int W>  // W 32-bit words: 2 (one 8-byte load) or a multiple of 4
__device__ __forceinline__ void load_words(const void* p, uint32_t (&u)[W]) {
  if constexpr (W == 2) {
    const uint2 t = __ldg(static_cast<const uint2*>(p));
    u[0] = t.x;
    u[1] = t.y;
  } else {
    static_assert(W % 4 == 0, "whole 16-byte pieces");
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 t = __ldg(static_cast<const uint4*>(p) + i);
      u[4 * i] = t.x;
      u[4 * i + 1] = t.y;
      u[4 * i + 2] = t.z;
      u[4 * i + 3] = t.w;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&u)[W]) {
  if constexpr (W == 2) {
    *static_cast<uint2*>(p) = make_uint2(u[0], u[1]);
  } else {
    static_assert(W % 4 == 0, "whole 16-byte pieces");
#pragma unroll
    for (int i = 0; i < W / 4; ++i)
      static_cast<uint4*>(p)[i] = make_uint4(u[4 * i], u[4 * i + 1], u[4 * i + 2], u[4 * i + 3]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  uint32_t u[VEC];
  load_words<VEC>(p, u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = __uint_as_float(u[j]);
}

// bfloat16 is the high half of a float32: element 2j is the low half of word j
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[VEC]) {
  uint32_t u[VEC / 2];
  load_words<VEC / 2>(p, u);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) {
    v[2 * j] = __uint_as_float(u[j] << 16);
    v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  uint32_t u[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) u[j] = __float_as_uint(v[j]);
  store_words<VEC>(p, u);
}

template <int VEC>  // round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[VEC]) {
  uint32_t u[VEC / 2];
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1]));
    u[j] = lo | (hi << 16);
  }
  store_words<VEC / 2>(p, u);
}

template <int VEC>
__device__ __forceinline__ void zero(float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = 0.0f;
}

// ---- the row walk: thread (slot, lane) owns channels lane*VEC.. of rows
// slot + k * step (step = gridDim.x * rows a block). U rows are loaded before
// any is used, the last ones too: load(u, row, in) sees rows past the end
// with in = false and must not read them; use(u, row) sees only rows in range.

template <int U = kUnroll, typename Load, typename Use>
__device__ __forceinline__ void walk_rows(int64_t row, int64_t step, int64_t n_rows, Load load,
                                          Use use) {
  for (; row < n_rows; row += U * step) {
#pragma unroll
    for (int u = 0; u < U; ++u) load(u, row + u * step, row + u * step < n_rows);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row + u * step < n_rows) use(u, row + u * step);
  }
}

// the backward's kernels read two inputs: 8-channel rows take two rows at a
// time, which keeps them under the 128 registers of two resident blocks
template <int VEC>
struct BwdUnroll {
  static constexpr int value = VEC >= 8 ? 2 : kUnroll;
};

struct Layout {
  int lanes;  // threads a row: C / VEC
  int lane;   // this thread's channel group
  int64_t row0, step;
};

template <int VEC>
__device__ __forceinline__ Layout layout(int c) {
  Layout l;
  l.lanes = c / VEC;
  const int rows = kThreads / l.lanes;
  l.lane = threadIdx.x % l.lanes;
  l.row0 = static_cast<int64_t>(blockIdx.x) * rows + threadIdx.x / l.lanes;
  l.step = static_cast<int64_t>(gridDim.x) * rows;
  return l;
}

// per-channel coefficients of the normalisation: mean, r = rsqrt(var + eps),
// gamma, beta
template <int VEC>
struct Affine {
  float mu[VEC], r[VEC], ga[VEC], be[VEC];
  __device__ __forceinline__ Affine(const float* mean, const float* var, const float* gamma,
                                    const float* beta, int ch0, float eps) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mu[j] = mean[ch0 + j];
      r[j] = rsqrtf(__fadd_rn(var[ch0 + j], eps));
      ga[j] = gamma[ch0 + j];
      be[j] = beta[ch0 + j];
    }
  }
  __device__ __forceinline__ float xhat(float x, int j) const {
    return __fmul_rn(__fsub_rn(x, mu[j]), r[j]);
  }
  __device__ __forceinline__ float y(float xh, int j) const {
    return __fadd_rn(__fmul_rn(xh, ga[j]), be[j]);
  }
};

// the cotangent that reaches the affine output: ReLU's gate on y (a NaN y
// passes, as torch's threshold_backward passes it) and the row mask
__device__ __forceinline__ float gate(float g, float y, bool relu, bool drop) {
  return (drop || (relu && y <= 0.0f)) ? 0.0f : g;
}

// ---- Chan's merges

// (n, mean, m2) <- merge((n, mean, m2), (nb, mb, qb)); exact copy when n == 0
template <int VEC>
__device__ __forceinline__ void chan(float& n, float (&mean)[VEC], float (&m2)[VEC], float nb,
                                     const float (&mb)[VEC], const float (&qb)[VEC]) {
  const float nn = n + nb;
  const float f = nn > 0.0f ? nb / nn : 0.0f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float d = mb[j] - mean[j];
    mean[j] = fmaf(d, f, mean[j]);
    m2[j] = m2[j] + qb[j] + d * d * n * f;
  }
  n = nn;
}

// (n, mean, m2) of U rows held in registers, two-pass (the rows outside the
// mask are zeros with m = false), merged into the thread's running triple
template <int U, int VEC>
__device__ __forceinline__ void merge_rows(float& n, float (&mean)[VEC], float (&m2)[VEC],
                                           const float (&v)[U][VEC], const bool (&m)[U]) {
  float nb = 0.0f;
#pragma unroll
  for (int u = 0; u < U; ++u) nb += m[u] ? 1.0f : 0.0f;
  if (nb == 0.0f) return;
  const float inv = 1.0f / nb;
  float mb[VEC], qb[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float sum = 0.0f, q = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) sum += v[u][j];
    mb[j] = sum * inv;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float d = m[u] ? v[u][j] - mb[j] : 0.0f;
      q = fmaf(d, d, q);
    }
    qb[j] = q;
  }
  chan(n, mean, m2, nb, mb, qb);
}

// sum over the rows of a warp that hold one channel group (`lanes` threads
// apart); the result lands in the threads wl < lanes
__device__ __forceinline__ float warp_rows_sum(float v, int lanes) {
  for (int off = 16; off >= lanes; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The ticket: every block but the last returns false; the last block sees
// every other block's partial (written before the fence) through L2.
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  return s_last;
}

// Fixed-order tree over the kThreads / c slices of s (s[slice * c + ch]);
// the sum lands in s[ch]. Every thread calls it.
__device__ __forceinline__ void slice_tree(float* s, int c) {
  __syncthreads();
  const int sl = threadIdx.x / c;
  for (int half = kThreads / c / 2; half > 0; half >>= 1) {
    if (sl < half) s[threadIdx.x] += s[threadIdx.x + half * c];
    __syncthreads();
  }
}

// ---- 1. statistics

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stats_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask, float* __restrict__ out,
             float* __restrict__ ws, unsigned int* __restrict__ ticket,
             float* __restrict__ running_mean, float* __restrict__ running_var, float momentum,
             float keep, int64_t n_rows, int c) {
  const Layout l = layout<VEC>(c);
  float n = 0.0f, mean[VEC], m2[VEC];
  zero(mean);
  zero(m2);
  for (int64_t row = l.row0; row < n_rows; row += kStatsUnroll * l.step) {
    float v[kStatsUnroll][VEC];
    bool m[kStatsUnroll];
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u) {
      const int64_t r = row + u * l.step;
      m[u] = r < n_rows && mask[r] != 0;
      if (m[u])
        load_vec(x + r * c + l.lane * VEC, v[u]);
      else
        zero(v[u]);
    }
    merge_rows(n, mean, m2, v, m);
  }

  // the block: Chan's k-way form over its threads, as sums in a fixed order:
  // first the count and the count-weighted means, then the M2s plus
  // n_t (mean_t - mean)^2 about the block's mean
  __shared__ float s_cnt[kWarps];
  __shared__ float s_sum[kWarps][kMaxC];
  __shared__ float s_mu[kMaxC];
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float t[VEC];
  const float cw = warp_rows_sum(n, l.lanes);  // every channel group counts the same rows
#pragma unroll
  for (int j = 0; j < VEC; ++j) t[j] = warp_rows_sum(n * mean[j], l.lanes);
  if (wl < l.lanes) {
    if (wl == 0) s_cnt[warp] = cw;
#pragma unroll
    for (int j = 0; j < VEC; ++j) s_sum[warp][wl * VEC + j] = t[j];
  }
  __syncthreads();
  float n_blk = 0.0f;
  for (int w = 0; w < kWarps; ++w) n_blk += s_cnt[w];
  if (threadIdx.x < c) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum += s_sum[w][threadIdx.x];
    s_mu[threadIdx.x] = n_blk > 0.0f ? sum / n_blk : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float d = mean[j] - s_mu[l.lane * VEC + j];
    t[j] = warp_rows_sum(m2[j] + n * d * d, l.lanes);
  }
  if (wl < l.lanes) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) s_sum[warp][wl * VEC + j] = t[j];
  }
  __syncthreads();
  const int stride = 2 * c + 1;  // a partial: count, mean [C], M2 [C]
  if (threadIdx.x < c) {
    float q = 0.0f;
    for (int w = 0; w < kWarps; ++w) q += s_sum[w][threadIdx.x];
    float* p = ws + static_cast<int64_t>(blockIdx.x) * stride;
    if (threadIdx.x == 0) p[0] = n_blk;
    p[1 + threadIdx.x] = s_mu[threadIdx.x];
    p[1 + c + threadIdx.x] = q;
  }
  if (!last_block(ticket)) return;

  // the last block: Chan's k-way merge of the partials, block order within
  // each slice, slices summed by a fixed tree
  __shared__ float s_a[kThreads];
  __shared__ float s_b[kThreads];
  const int ch = threadIdx.x % c, sl = threadIdx.x / c, slices = kThreads / c;
  const int nb_blocks = static_cast<int>(gridDim.x);
  float cnt = 0.0f, sum = 0.0f;
  for (int b0 = sl; b0 < nb_blocks; b0 += kMerge * slices) {
    float nb[kMerge], mb[kMerge];
#pragma unroll
    for (int i = 0; i < kMerge; ++i) {  // absent partials count as (0, 0, 0)
      const int b = b0 + i * slices;
      const float* p = ws + static_cast<int64_t>(b) * stride;
      nb[i] = b < nb_blocks ? __ldcg(p) : 0.0f;
      mb[i] = b < nb_blocks ? __ldcg(p + 1 + ch) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kMerge; ++i) {
      cnt += nb[i];
      sum = fmaf(nb[i], mb[i], sum);
    }
  }
  s_a[threadIdx.x] = cnt;
  s_b[threadIdx.x] = sum;
  slice_tree(s_a, c);
  slice_tree(s_b, c);
  const float total = s_a[ch];
  const float mu = s_b[ch] / fmaxf(total, 1.0f);
  __syncthreads();
  float q = 0.0f;
  for (int b0 = sl; b0 < nb_blocks; b0 += kMerge * slices) {
    float nb[kMerge], mb[kMerge], qb[kMerge];
#pragma unroll
    for (int i = 0; i < kMerge; ++i) {
      const int b = b0 + i * slices;
      const float* p = ws + static_cast<int64_t>(b) * stride;
      nb[i] = b < nb_blocks ? __ldcg(p) : 0.0f;
      mb[i] = b < nb_blocks ? __ldcg(p + 1 + ch) : mu;
      qb[i] = b < nb_blocks ? __ldcg(p + 1 + c + ch) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kMerge; ++i) {
      const float d = mb[i] - mu;
      q += qb[i] + nb[i] * d * d;
    }
  }
  s_a[threadIdx.x] = q;
  slice_tree(s_a, c);
  if (sl == 0) {
    const float var = total > 0.0f ? s_a[ch] / total : 0.0f;
    out[ch] = mu;
    out[c + ch] = var;
    if (ch == 0) out[2 * c] = total;
    if (running_mean != nullptr) {
      running_mean[ch] = __fadd_rn(__fmul_rn(running_mean[ch], keep), __fmul_rn(momentum, mu));
      running_var[ch] = __fadd_rn(__fmul_rn(running_var[ch], keep), __fmul_rn(momentum, var));
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// ---- 2. normalise + affine (+ ReLU, + row mask)

template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apply_kernel(const Tin* __restrict__ x, const uint8_t* __restrict__ mask,
             const float* __restrict__ mean, const float* __restrict__ var,
             const float* __restrict__ gamma, const float* __restrict__ beta, Tout* __restrict__ y,
             int64_t n_rows, int c, float eps, int relu, int row_mask) {
  const Layout l = layout<VEC>(c);
  const Affine<VEC> a(mean, var, gamma, beta, l.lane * VEC, eps);
  float v[kUnroll][VEC];
  bool m[kUnroll];
  walk_rows(
      l.row0, l.step, n_rows,
      [&](int u, int64_t row, bool in) {
        m[u] = in && (!row_mask || mask[row] != 0);
        if (m[u]) load_vec(x + row * c + l.lane * VEC, v[u]);
      },
      [&](int u, int64_t row) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float t = a.y(a.xhat(v[u][j], j), j);
          if (relu && t < 0.0f) t = 0.0f;  // a NaN stays NaN, as torch.relu keeps it
          o[j] = m[u] ? t : 0.0f;
        }
        store_vec(y + row * c + l.lane * VEC, o);
      });
}

// ---- 3. the backward's two per-channel sums

template <typename Tin, typename Tg, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bwd_reduce_kernel(const Tin* __restrict__ x, const Tg* __restrict__ g,
                  const uint8_t* __restrict__ mask, const float* __restrict__ mean,
                  const float* __restrict__ var, const float* __restrict__ gamma,
                  const float* __restrict__ beta, float* __restrict__ out, float* __restrict__ ws,
                  unsigned int* __restrict__ ticket, int64_t n_rows, int c, float eps, int relu,
                  int row_mask) {
  const Layout l = layout<VEC>(c);
  const Affine<VEC> a(mean, var, gamma, beta, l.lane * VEC, eps);
  float s1[VEC], s2[VEC];
  zero(s1);
  zero(s2);
  constexpr int U = BwdUnroll<VEC>::value;
  float v[U][VEC], gv[U][VEC];
  bool keep[U];
  walk_rows<U>(
      l.row0, l.step, n_rows,
      [&](int u, int64_t row, bool in) {
        keep[u] = in && (!row_mask || mask[row] != 0);
        if (keep[u]) {
          load_vec(x + row * c + l.lane * VEC, v[u]);
          load_vec(g + row * c + l.lane * VEC, gv[u]);
        }
      },
      [&](int u, int64_t) {
        if (!keep[u]) return;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = a.xhat(v[u][j], j);
          const float ge = gate(gv[u][j], a.y(xh, j), relu, false);
          s1[j] += ge;
          s2[j] = fmaf(ge, xh, s2[j]);
        }
      });

  for (int off = 16; off >= l.lanes; off >>= 1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s1[j] += __shfl_down_sync(0xffffffffu, s1[j], off);
      s2[j] += __shfl_down_sync(0xffffffffu, s2[j], off);
    }
  }
  __shared__ float s_s1[kWarps][kMaxC];
  __shared__ float s_s2[kWarps][kMaxC];
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (wl < l.lanes) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s_s1[warp][wl * VEC + j] = s1[j];
      s_s2[warp][wl * VEC + j] = s2[j];
    }
  }
  __syncthreads();
  const int stride = 2 * c;  // a partial: S1 [C], S2 [C]
  if (threadIdx.x < c) {  // the block's warps in order, one channel a thread
    float t1 = 0.0f, t2 = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      t1 += s_s1[w][threadIdx.x];
      t2 += s_s2[w][threadIdx.x];
    }
    float* p = ws + static_cast<int64_t>(blockIdx.x) * stride;
    p[threadIdx.x] = t1;
    p[c + threadIdx.x] = t2;
  }
  if (!last_block(ticket)) return;

  __shared__ float s_a[kThreads];
  __shared__ float s_b[kThreads];
  const int ch = threadIdx.x % c, sl = threadIdx.x / c, slices = kThreads / c;
  const int nb_blocks = static_cast<int>(gridDim.x);
  float t1 = 0.0f, t2 = 0.0f;
  for (int b0 = sl; b0 < nb_blocks; b0 += kMerge * slices) {
    float a1[kMerge], a2[kMerge];
#pragma unroll
    for (int i = 0; i < kMerge; ++i) {
      const int b = b0 + i * slices;
      const float* p = ws + static_cast<int64_t>(b) * stride;
      a1[i] = b < nb_blocks ? __ldcg(p + ch) : 0.0f;
      a2[i] = b < nb_blocks ? __ldcg(p + c + ch) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kMerge; ++i) {
      t1 += a1[i];
      t2 += a2[i];
    }
  }
  s_a[threadIdx.x] = t1;
  s_b[threadIdx.x] = t2;
  slice_tree(s_a, c);
  slice_tree(s_b, c);
  if (sl == 0) {
    out[ch] = s_a[ch];
    out[c + ch] = s_b[ch];
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// ---- 4. dx

template <typename Tin, typename Tg, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dx_kernel(const Tin* __restrict__ x, const Tg* __restrict__ g, const uint8_t* __restrict__ mask,
          const float* __restrict__ mean, const float* __restrict__ var,
          const float* __restrict__ count, const float* __restrict__ gamma,
          const float* __restrict__ beta, const float* __restrict__ sums, Tin* __restrict__ dx,
          int64_t n_rows, int c, float eps, int relu, int row_mask, int train) {
  const Layout l = layout<VEC>(c);
  const int ch0 = l.lane * VEC;
  const Affine<VEC> a(mean, var, gamma, beta, ch0, eps);
  float k[VEC], c1[VEC], c2[VEC];  // gamma r, S1 / n, S2 / n
  const float nrm = train ? fmaxf(*count, 1.0f) : 1.0f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    k[j] = __fmul_rn(a.ga[j], a.r[j]);
    c1[j] = train ? sums[ch0 + j] / nrm : 0.0f;
    c2[j] = train ? sums[c + ch0 + j] / nrm : 0.0f;
  }
  constexpr int U = BwdUnroll<VEC>::value;
  float v[U][VEC], gv[U][VEC];
  bool m[U];
  walk_rows<U>(
      l.row0, l.step, n_rows,
      [&](int u, int64_t row, bool in) {
        m[u] = in && mask[row] != 0;
        if (in && (m[u] || !row_mask)) {
          load_vec(x + row * c + ch0, v[u]);
          load_vec(g + row * c + ch0, gv[u]);
        } else {
          zero(v[u]);
          zero(gv[u]);
        }
      },
      [&](int u, int64_t row) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = a.xhat(v[u][j], j);
          float t = gate(gv[u][j], a.y(xh, j), relu, row_mask && !m[u]);
          if (train && m[u]) t = t - (c1[j] + xh * c2[j]);
          o[j] = k[j] * t;
        }
        store_vec(dx + row * c + ch0, o);
      });
}

// ---- 5. the statistics' VJP

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
vjp_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
           const float* __restrict__ mean, const float* __restrict__ count,
           const float* __restrict__ g_mean, const float* __restrict__ g_var, T* __restrict__ dx,
           int64_t n_rows, int c) {
  const Layout l = layout<VEC>(c);
  const int ch0 = l.lane * VEC;
  float mu[VEC], gm[VEC], gv2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = mean[ch0 + j];
    gm[j] = g_mean != nullptr ? g_mean[ch0 + j] : 0.0f;
    gv2[j] = g_var != nullptr ? __fmul_rn(2.0f, g_var[ch0 + j]) : 0.0f;
  }
  const float nrm = fmaxf(*count, 1.0f);
  float v[kUnroll][VEC];
  bool m[kUnroll];
  walk_rows(
      l.row0, l.step, n_rows,
      [&](int u, int64_t row, bool in) {
        m[u] = in && mask[row] != 0;
        if (m[u]) load_vec(x + row * c + ch0, v[u]);
      },
      [&](int u, int64_t row) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o[j] = m[u] ? __fdiv_rn(__fadd_rn(gm[j], __fmul_rn(gv2[j], __fsub_rn(v[u][j], mu[j]))),
                                  nrm)
                      : 0.0f;
        store_vec(dx + row * c + ch0, o);
      });
}

// ---- launch checks and type dispatch

bool bad_shape(int64_t n_rows, int c, int dtype, int vec, int blocks) {
  const bool pow2 = c >= 4 && c <= kMaxC && (c & (c - 1)) == 0;
  const int want = (dtype == 0 || c == 4) ? 4 : 8;
  return !pow2 || (dtype != 0 && dtype != 1) || vec != want || n_rows < 1 || blocks < 1;
}

cudaError_t invalid() { return cudaErrorInvalidValue; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. IN_CASES binds Tin and VEC (4 for
// float32; 8 for bfloat16, 4 at C = 4), OUT_CASES binds To.
#define IN_CASES(dtype, vec, ...)                  \
  if ((dtype) == 0 && (vec) == 4) {                \
    using Tin = float;                             \
    constexpr int VEC = 4;                         \
    __VA_ARGS__;                                   \
  } else if ((dtype) == 1 && (vec) == 8) {         \
    using Tin = __nv_bfloat16;                     \
    constexpr int VEC = 8;                         \
    __VA_ARGS__;                                   \
  } else if ((dtype) == 1 && (vec) == 4) {         \
    using Tin = __nv_bfloat16;                     \
    constexpr int VEC = 4;                         \
    __VA_ARGS__;                                   \
  } else {                                         \
    return static_cast<int>(invalid());            \
  }

#define OUT_CASES(dtype, ...)                      \
  if ((dtype) == 0) {                              \
    using To = float;                              \
    __VA_ARGS__;                                   \
  } else if ((dtype) == 1) {                       \
    using To = __nv_bfloat16;                      \
    __VA_ARGS__;                                   \
  } else {                                         \
    return static_cast<int>(invalid());            \
  }

extern "C" {

// out [2C + 1]: mean, var, count. ws: blocks * (2C + 1) floats; ticket 0 on
// entry (and on exit). running_mean / running_var may be null (no update).
int rpc_masked_stats(const void* x, const uint8_t* mask, float* out, float* ws,
                     unsigned int* ticket, float* running_mean, float* running_var,
                     float momentum, float keep, int64_t n_rows, int c, int dtype, int vec,
                     int blocks, void* stream) {
  if (bad_shape(n_rows, c, dtype, vec, blocks) || (running_mean == nullptr) != (running_var == nullptr))
    return static_cast<int>(invalid());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  IN_CASES(dtype, vec,
           stats_kernel<Tin, VEC><<<blocks, kThreads, 0, s>>>(
               static_cast<const Tin*>(x), mask, out, ws, ticket, running_mean, running_var,
               momentum, keep, n_rows, c))
  return static_cast<int>(cudaGetLastError());
}

// y [N, C] in out_dtype.
int rpc_masked_bn_apply(const void* x, const uint8_t* mask, const float* mean, const float* var,
                        const float* gamma, const float* beta, void* y, int64_t n_rows, int c,
                        float eps, int dtype, int out_dtype, int vec, int relu, int row_mask,
                        int blocks, void* stream) {
  if (bad_shape(n_rows, c, dtype, vec, blocks)) return static_cast<int>(invalid());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  IN_CASES(dtype, vec,
           OUT_CASES(out_dtype,
                     apply_kernel<Tin, To, VEC><<<blocks, kThreads, 0, s>>>(
                         static_cast<const Tin*>(x), mask, mean, var, gamma, beta,
                         static_cast<To*>(y), n_rows, c, eps, relu, row_mask)))
  return static_cast<int>(cudaGetLastError());
}

// out [2C]: S1 (d beta), S2 (d gamma). g [N, C] in g_dtype; ws: blocks * 2C.
int rpc_masked_bn_bwd_reduce(const void* x, const void* g, const uint8_t* mask, const float* mean,
                             const float* var, const float* gamma, const float* beta, float* out,
                             float* ws, unsigned int* ticket, int64_t n_rows, int c, float eps,
                             int dtype, int g_dtype, int vec, int relu, int row_mask, int blocks,
                             void* stream) {
  if (bad_shape(n_rows, c, dtype, vec, blocks)) return static_cast<int>(invalid());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  IN_CASES(dtype, vec,
           OUT_CASES(g_dtype,
                     bwd_reduce_kernel<Tin, To, VEC><<<blocks, kThreads, 0, s>>>(
                         static_cast<const Tin*>(x), static_cast<const To*>(g), mask, mean, var,
                         gamma, beta, out, ws, ticket, n_rows, c, eps, relu, row_mask)))
  return static_cast<int>(cudaGetLastError());
}

// dx [N, C] in x's type. train: count [1] and sums [2C] (bwd_reduce's out);
// eval: both may be null.
int rpc_masked_bn_dx(const void* x, const void* g, const uint8_t* mask, const float* mean,
                     const float* var, const float* count, const float* gamma, const float* beta,
                     const float* sums, void* dx, int64_t n_rows, int c, float eps, int dtype,
                     int g_dtype, int vec, int relu, int row_mask, int train, int blocks,
                     void* stream) {
  if (bad_shape(n_rows, c, dtype, vec, blocks) || (train && (count == nullptr || sums == nullptr)))
    return static_cast<int>(invalid());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  IN_CASES(dtype, vec,
           OUT_CASES(g_dtype,
                     dx_kernel<Tin, To, VEC><<<blocks, kThreads, 0, s>>>(
                         static_cast<const Tin*>(x), static_cast<const To*>(g), mask, mean, var,
                         count, gamma, beta, sums, static_cast<Tin*>(dx), n_rows, c, eps, relu,
                         row_mask, train)))
  return static_cast<int>(cudaGetLastError());
}

// dx [N, C] in x's type; g_mean / g_var [C] may be null (a zero cotangent).
int rpc_masked_stats_vjp(const void* x, const uint8_t* mask, const float* mean,
                         const float* count, const float* g_mean, const float* g_var, void* dx,
                         int64_t n_rows, int c, int dtype, int vec, int blocks, void* stream) {
  if (bad_shape(n_rows, c, dtype, vec, blocks)) return static_cast<int>(invalid());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  IN_CASES(dtype, vec,
           vjp_kernel<Tin, VEC><<<blocks, kThreads, 0, s>>>(
               static_cast<const Tin*>(x), mask, mean, count, g_mean, g_var,
               static_cast<Tin*>(dx), n_rows, c))
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
