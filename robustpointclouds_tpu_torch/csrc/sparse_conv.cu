// Sparse 3D convolution as gather-GEMMs, for Hopper (sm_90a): the forward,
// its input gradient (dgrad) and its weight gradient (wgrad).
//
// Replaces the Pallas merge-path kernel `mp_gather_conv`
// (robustpointclouds_tpu/kernels/mp_gather.py:192) in its three modes, which
// the JAX package drives under every sparse conv of the SECOND encoder
// (robustpointclouds_tpu/ops/mp_conv.py:502 `out`, :540 `bwd`, :554/:703
// `col` + the d_W einsum). That kernel selects neighbour rows with one-hot
// matmuls only because Mosaic could not lower vector gathers; a GPU gathers
// natively, so these kernels compute the convolution itself:
//
//     forward: out[i, :] = sum_k feats[idx[i, k], :] @ W[k*Cin:(k+1)*Cin, :]
//     dgrad:   the same kernel on (g, W^T per tap, backward index) -- the
//              wrapper (kernels/sparse_conv.py) builds the operands;
//     wgrad:   dW[k*Cin + c, o] = sum_i feats[idx[i, k], c] * g[i, o].
//
// idx [M, K] int32 with K in {27, 3} (tap order of ops/sparse.kernel_offsets);
// an index outside [0, N) is a miss and reads a zero row. W is [K*Cin, Cout]
// in the JAX img2col order (tap-major, channel-minor). feats, W, g and out
// share one type, float32 or bfloat16; products accumulate in float32 and
// dW is float32.
//
// What bounds them on the card: the useful work is 2*hits*Cin*Cout
// operations over bytes that are mostly the index (4*M*K), the activations
// and the output; for the widths of the SECOND encoder (Cin <= 64,
// Cout <= 128) that is well below the tensor cores' ridge, so an ideal kernel
// is bound by bytes. These first designs are simple instead: float32 FMAs on
// the CUDA cores, tiles staged in shared memory, and only the neighbour
// pairs that exist are computed, which is where the sparsity of the 27-tap
// neighbourhood pays.
//  * forward / dgrad: one block per tile of output rows, all Cout columns per
//    block. Per tap the block stages the tile's indices, its gathered input
//    rows (as float32) and the tap's weights; every thread then accumulates
//    kRowsPerThread outputs of one column in registers. A tap that no row of
//    the tile hits is skipped as a whole (__syncthreads_or).
//  * wgrad: a grid over (row chunk, tap), so no [M, K*Cin] im2col is ever
//    written (332 MB in bf16 for one 96000-row 64-channel conv). A block
//    compacts the rows of its chunk that hit its tap into a list, in row
//    order, until the list is at least half full; then it stages the listed
//    hits' gathered input rows and g rows, and each thread accumulates a
//    PC x PO register tile of the [Cin, Cout] partial in float32 (PC + PO
//    shared loads per PC*PO FMAs). So every barrier pays for at least half
//    a list of real products, whatever the tap's hit rate. Each block writes its
//    partial; a second kernel sums the partials over chunks in a fixed
//    order, so dW is deterministic. The tap's index column is read with a
//    stride of K words (the 27 blocks of one chunk read the same lines, which
//    stay in L2).
// Tensor cores (mma/wgmma) and TMA are left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_conv_fwd_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                       const int32_t* __restrict__ idx, T* __restrict__ out,
                       int64_t n, int64_t m, int k_taps, int cin, int cout) {
  extern __shared__ float smem[];
  const int row_groups = kThreads / cout;
  const int tile_m = kRowsPerThread * row_groups;
  float* a_s = smem;                                   // [tile_m, cin]
  float* w_s = a_s + tile_m * cin;                     // [cin, cout]
  int32_t* i_s = reinterpret_cast<int32_t*>(w_s + cin * cout);  // [tile_m]

  const int t = threadIdx.x;
  const int col = t % cout;
  const int rg = t / cout;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * tile_m;

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  for (int k = 0; k < k_taps; ++k) {
    int hit = 0;
    for (int r = t; r < tile_m; r += kThreads) {
      const int64_t row = m0 + r;
      int32_t id = -1;
      if (row < m) {
        const int32_t v = idx[row * k_taps + k];
        if (v >= 0 && v < n) {
          id = v;
          hit = 1;
        }
      }
      i_s[r] = id;
    }
    if (!__syncthreads_or(hit)) continue;  // uniform: no row of the tile reads this tap

    for (int e = t; e < tile_m * cin; e += kThreads) {
      const int r = e / cin;
      const int c = e - r * cin;
      const int32_t id = i_s[r];
      a_s[e] = id >= 0 ? to_f32(feats[static_cast<int64_t>(id) * cin + c]) : 0.f;
    }
    const T* wk = w + static_cast<int64_t>(k) * cin * cout;
    for (int e = t; e < cin * cout; e += kThreads) w_s[e] = to_f32(wk[e]);
    __syncthreads();

    for (int c = 0; c < cin; ++c) {
      const float wv = w_s[c * cout + col];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = fmaf(a_s[(rg + i * row_groups) * cin + c], wv, acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = m0 + rg + i * row_groups;
    if (row < m) store(out + row * cout + col, acc[i]);
  }
}

template <typename T>
int launch(const void* feats, const void* w, const int32_t* idx, void* out,
           int64_t n, int64_t m, int k_taps, int cin, int cout, cudaStream_t stream) {
  const int tile_m = kRowsPerThread * (kThreads / cout);
  const size_t smem = sizeof(float) * (static_cast<size_t>(tile_m) * cin +
                                       static_cast<size_t>(cin) * cout) +
                      sizeof(int32_t) * tile_m;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sparse_conv_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (m + tile_m - 1) / tile_m;
  if (blocks > 0) {
    sparse_conv_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<const T*>(feats), static_cast<const T*>(w), idx, static_cast<T*>(out),
        n, m, k_taps, cin, cout);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairsPerThread = 32;  // Cin*Cout <= 8192
constexpr int kMaxCap = 1024;

// One block per (row chunk, tap k). The block scans its chunk's rows, `step`
// at a time (one index per thread), and appends the rows that hit tap k to
// a list in shared memory, in row order (warp ballots and a fixed prefix over
// the warps, so the order and the sums are deterministic). Once one more
// scan step could overflow the list's `cap` entries -- or the chunk ends --
// the block gathers the listed hits' input rows and g rows into shared
// memory, every thread accumulates its PC x PO entries of the [Cin, Cout]
// partial over all of them, and the list starts empty again. With
// step <= cap/2 each barrier pays for at least cap/2 real hits instead of a
// fixed number of rows, of which most miss the tap. The 256 threads own
// (c, o) = (ci + i*tc, oi + j*to) with to = Cout/PO threads along o; when
// Cin*Cout < 256, `groups` thread groups split the hits and are merged in a
// fixed order at the end.
template <typename T, int PC, int PO>
__global__ void __launch_bounds__(kThreads)
sparse_conv_wgrad_kernel(const T* __restrict__ feats, const T* __restrict__ g,
                         const int32_t* __restrict__ idx, float* __restrict__ partial,
                         int64_t n, int64_t m, int k_taps, int cin, int cout,
                         int64_t rows_per_chunk, int cap, int step) {
  extern __shared__ float smem[];
  float* a_s = smem;                                                // [cap, cin]
  float* g_s = a_s + cap * cin;                                     // [cap, cout]
  float* red = g_s + cap * cout;                                    // [kThreads]
  int32_t* hit_row = reinterpret_cast<int32_t*>(red + kThreads);    // [cap]
  int32_t* hit_id = hit_row + cap;                                  // [cap]
  int32_t* warp_cnt = hit_id + cap;                                 // [kWarps]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int k = blockIdx.y;
  const int pairs = cin * cout;
  const int tpg = pairs / (PC * PO);  // threads per group
  const int groups = kThreads / tpg;
  const int grp = t / tpg;
  const int lt = t - grp * tpg;
  const int to = cout / PO;
  const int tc = tpg / to;
  const int oi = lt % to;
  const int ci = lt / to;

  float acc[PC][PO];
#pragma unroll
  for (int i = 0; i < PC; ++i)
#pragma unroll
    for (int j = 0; j < PO; ++j) acc[i][j] = 0.f;

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_chunk;
  const int64_t r1 = min(m, r0 + rows_per_chunk);
  for (int64_t s = r0; s < r1;) {
    int count = 0;  // hits in the list; the same value in every thread
    for (; s < r1 && count + step <= cap; s += step) {
      const int64_t row = s + t;
      int32_t id = -1;
      if (t < step && row < r1) {
        const int32_t v = idx[row * k_taps + k];
        if (v >= 0 && v < n) id = v;
      }
      const unsigned ball = __ballot_sync(0xffffffffu, id >= 0);
      if (lane == 0) warp_cnt[warp] = __popc(ball);
      __syncthreads();
      int off = count, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_cnt[w];
        off += w < warp ? c : 0;
        total += c;
      }
      if (id >= 0) {
        const int pos = off + __popc(ball & ((1u << lane) - 1u));
        hit_row[pos] = static_cast<int32_t>(row - r0);
        hit_id[pos] = id;
      }
      count += total;
      __syncthreads();  // the list is complete; warp_cnt may be rewritten
    }
    if (count == 0) continue;  // uniform: no row of these steps hits the tap

    for (int e = t; e < count * cin; e += kThreads) {
      const int r = e / cin;
      a_s[e] = to_f32(feats[static_cast<int64_t>(hit_id[r]) * cin + (e - r * cin)]);
    }
    for (int e = t; e < count * cout; e += kThreads) {
      const int r = e / cout;
      g_s[e] = to_f32(g[(r0 + hit_row[r]) * cout + (e - r * cout)]);
    }
    __syncthreads();

    for (int r = grp; r < count; r += groups) {
      float av[PC], gv[PO];
#pragma unroll
      for (int i = 0; i < PC; ++i) av[i] = a_s[r * cin + ci + i * tc];
#pragma unroll
      for (int j = 0; j < PO; ++j) gv[j] = g_s[r * cout + oi + j * to];
#pragma unroll
      for (int i = 0; i < PC; ++i)
#pragma unroll
        for (int j = 0; j < PO; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
    __syncthreads();  // a_s, g_s and the list are free again
  }

  float* out = partial + (static_cast<int64_t>(blockIdx.x) * k_taps + k) * pairs;
  if (groups == 1) {
#pragma unroll
    for (int i = 0; i < PC; ++i)
#pragma unroll
      for (int j = 0; j < PO; ++j) out[(ci + i * tc) * cout + oi + j * to] = acc[i][j];
  } else {  // PC = PO = 1: thread lt of each group owns pair lt
    red[t] = acc[0][0];
    __syncthreads();
    if (t < pairs) {
      float v = 0.f;
      for (int q = 0; q < groups; ++q) v += red[q * pairs + t];  // fixed order
      out[t] = v;
    }
  }
}

// dW[q] = sum over chunks of partial[chunk][q], chunks in order.
__global__ void sparse_conv_wgrad_reduce_kernel(const float* __restrict__ partial,
                                                float* __restrict__ dw, int64_t size,
                                                int chunks) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= size) return;
  float v = 0.f;
  for (int ch = 0; ch < chunks; ++ch) v += partial[static_cast<int64_t>(ch) * size + q];
  dw[q] = v;
}

// Launches the (PC, PO) instance; cudaErrorInvalidValue when that register
// tile does not fit [Cin, Cout] (Cout not a multiple of PO, or the threads
// along o not dividing a thread group).
template <typename T, int PC, int PO>
int launch_wgrad_tiled(const void* feats, const void* g, const int32_t* idx, float* partial,
                       int64_t n, int64_t m, int k_taps, int cin, int cout,
                       int64_t rows_per_chunk, int chunks, int cap, cudaStream_t stream) {
  if (cout % PO != 0 || (cin * cout / (PC * PO)) % (cout / PO) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (static_cast<size_t>(cap) * (cin + cout) + kThreads) +
                      sizeof(int32_t) * (2 * static_cast<size_t>(cap) + kWarps);
  const int step = min(kThreads, cap / 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sparse_conv_wgrad_kernel<T, PC, PO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(k_taps));
  sparse_conv_wgrad_kernel<T, PC, PO><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(g), idx, partial, n, m, k_taps, cin,
      cout, rows_per_chunk, cap, step);
  return static_cast<int>(cudaGetLastError());
}

// The partials, then their sum. A thread's register tile holds
// PC*PO = max(1, Cin*Cout/256) entries.
template <typename T>
int launch_wgrad(const void* feats, const void* g, const int32_t* idx, float* partial, float* dw,
                 int64_t n, int64_t m, int k_taps, int cin, int cout, int64_t rows_per_chunk,
                 int chunks, int cap, cudaStream_t stream) {
  const int pairs = cin * cout;
  int rc;
#define RPC_WGRAD(PC_, PO_)                                                               \
  launch_wgrad_tiled<T, PC_, PO_>(feats, g, idx, partial, n, m, k_taps, cin, cout,       \
                                  rows_per_chunk, chunks, cap, stream)
  switch (pairs >= kThreads ? pairs / kThreads : 1) {
    case 1: rc = RPC_WGRAD(1, 1); break;
    case 2: rc = RPC_WGRAD(1, 2); break;
    case 4: rc = RPC_WGRAD(2, 2); break;
    case 8: rc = RPC_WGRAD(2, 4); break;
    case 16: rc = RPC_WGRAD(4, 4); break;
    case 32: rc = RPC_WGRAD(4, 8); break;
    default: rc = static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPC_WGRAD
  if (rc != 0) return rc;
  const int64_t size = static_cast<int64_t>(k_taps) * pairs;
  const int threads = 256;
  sparse_conv_wgrad_reduce_kernel<<<static_cast<unsigned>((size + threads - 1) / threads),
                                    threads, 0, stream>>>(partial, dw, size, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 = success). The caller has checked shapes, types and that Cout divides
// 256; the kernel never synchronises and allocates nothing.
int rpc_sparse_conv_fwd(const void* feats, const void* w, const int32_t* idx, void* out,
                        int64_t n, int64_t m, int k_taps, int cin, int cout, int dtype,
                        void* stream) {
  if (cout <= 0 || cout > kThreads || kThreads % cout != 0 || cin <= 0 || k_taps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(feats, w, idx, out, n, m, k_taps, cin, cout, s);
  if (dtype == 1) return launch<__nv_bfloat16>(feats, w, idx, out, n, m, k_taps, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype as above. partial is float32 scratch [chunks, K, Cin, Cout], dw the
// float32 [K*Cin, Cout] result; chunks * rows_per_chunk must cover M; cap
// is the most hits staged per barrier, a power of two in [2, 1024] (shared
// memory holds cap * (Cin + Cout) floats). The caller has checked shapes and
// types, that Cout divides 256 and that Cin*Cout is a power of two, at most
// 8192.
int rpc_sparse_conv_wgrad(const void* feats, const void* g, const int32_t* idx, float* partial,
                          float* dw, int64_t n, int64_t m, int k_taps, int cin, int cout,
                          int64_t rows_per_chunk, int chunks, int cap, int dtype, void* stream) {
  const int pairs = cin * cout;
  if (cout <= 0 || cout > kThreads || kThreads % cout != 0 || cin <= 0 || k_taps <= 0 ||
      pairs > kThreads * kMaxPairsPerThread || (pairs & (pairs - 1)) != 0 ||
      chunks <= 0 || rows_per_chunk <= 0 || rows_per_chunk > (int64_t{1} << 30) ||
      static_cast<int64_t>(chunks) * rows_per_chunk < m || cap < 2 || cap > kMaxCap ||
      (cap & (cap - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_wgrad<float>(feats, g, idx, partial, dw, n, m, k_taps, cin, cout,
                               rows_per_chunk, chunks, cap, s);
  if (dtype == 1)
    return launch_wgrad<__nv_bfloat16>(feats, g, idx, partial, dw, n, m, k_taps, cin, cout,
                                       rows_per_chunk, chunks, cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
