// Row gathers out[i, :] = x[idx[i], :] written four ways, for Hopper (sm_90a):
// the gather-rate probe that sets the tiles of the sparse-conv kernels.
//
// Replaces the Pallas probe kernels of robustpointclouds_tpu/tools/
// probe_mosaic_gather.py: `k_take` (:40, launched :65) and the tiled `kg`
// (:113, :118) -> rpc_gather_rows; `k_tal` (:43) -> rpc_gather_elems;
// `k_loop` (:47) -> rpc_gather_row_loop; `k_onehot` (:54) ->
// rpc_gather_onehot. The TPU kernels asked which gather forms Mosaic could
// lower at all; on a GPU every form lowers, so the four kernels here measure
// what each form costs.
//
// Contract of all four: x [N, C] row-major, idx [M] int32; an index outside
// [0, N) -- N itself in the callers -- reads a zero row, as the zero-padded
// table of the probe's XLA yardstick (:132) and the sparse conv's miss index
// do. The copies move raw 2- or 4-byte words, so they are exact for float32
// and bfloat16; the one-hot product sums one non-zero product in float32,
// exact too.
//
// What bounds them: a gather does no arithmetic, so the bound is bytes: the
// output written once, the indices read once and at most the table read once.
// At the probe's timed shape (the sparse conv's [96000, 64] bf16 table at 9
// lookups a row: 864000 indices) that is 110.6 + 3.5 + 12.3 MB = 126.3 MB.
// The 12.3 MB table fits the 50 MB L2, Hopper's counterpart of the TPU's
// VMEM-resident table; a block's 227 KB of shared memory holds neither
// table, so no kernel stages the table in shared memory.
//  * rows: a group of C*size/16 threads owns a row and moves 16 bytes per
//    thread (one warp per 512-byte f32 row; four rows per warp at 128-byte
//    bf16 rows), so every load and store is a full, coalesced vector.
//  * elems: one thread per output element with scalar loads
//    (take_along_axis on an index broadcast to [M, C]).
//  * row loop: one block stages the indices in shared memory and copies rows
//    one after another, its threads spread over the channels (the TPU's
//    SMEM-indexed fori_loop); it uses one SM, so it is a probe of latency.
//  * one-hot: out = onehot(idx)[M, N] @ x[N, C], a tiled float32 product on
//    the CUDA cores with the one-hot tile built in shared memory from the
//    indices (the matrix-unit form the TPU used before it could gather). It
//    reads the whole table once per 32 output rows and does 2*M*N*C
//    operations, so it is defined for the probe's small shape only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoopStage = 4096;  // indices staged per pass of the row loop
constexpr int kTile = 32;         // one-hot product: 32 x 32 output tile, K step 32
constexpr int kTileRowsPerThread = 4;

__device__ __forceinline__ bool hit(int32_t j, int64_t n) {
  return j >= 0 && static_cast<int64_t>(j) < n;
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ x, const int32_t* __restrict__ idx,
                   uint4* __restrict__ out, int64_t m, int64_t n, int vec_per_row) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = t / vec_per_row;
  if (row >= m) return;
  const int lane = static_cast<int>(t - row * vec_per_row);
  const int32_t j = __ldg(idx + row);  // one word for the whole group: a broadcast
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (hit(j, n)) v = __ldg(x + static_cast<int64_t>(j) * vec_per_row + lane);
  out[t] = v;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_elems_kernel(const W* __restrict__ x, const int32_t* __restrict__ idx,
                    W* __restrict__ out, int64_t m, int64_t n, int64_t c) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= m * c) return;
  const int64_t row = t / c;
  const int64_t col = t - row * c;
  const int32_t j = __ldg(idx + row);
  out[t] = hit(j, n) ? x[static_cast<int64_t>(j) * c + col] : W(0);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_row_loop_kernel(const W* __restrict__ x, const int32_t* __restrict__ idx,
                       W* __restrict__ out, int64_t m, int64_t n, int64_t c) {
  __shared__ int32_t s_idx[kLoopStage];
  for (int64_t r0 = 0; r0 < m; r0 += kLoopStage) {
    const int rows = static_cast<int>(m - r0 < kLoopStage ? m - r0 : kLoopStage);
    for (int i = threadIdx.x; i < rows; i += kThreads) s_idx[i] = idx[r0 + i];
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const int32_t j = s_idx[r];
      W* dst = out + (r0 + r) * c;
      for (int64_t col = threadIdx.x; col < c; col += kThreads)
        dst[col] = hit(j, n) ? x[static_cast<int64_t>(j) * c + col] : W(0);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// blockDim (32, 8): thread (tx, ty) owns column col0 + tx of rows ty + 8*i.
template <typename T>
__global__ void __launch_bounds__(kTile * kTile / kTileRowsPerThread)
gather_onehot_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                     T* __restrict__ out, int64_t m, int64_t n, int64_t c) {
  __shared__ float s_oh[kTile][kTile + 1];  // [row][k] one-hot tile
  __shared__ float s_x[kTile][kTile + 1];   // [k][col] table tile
  __shared__ int32_t s_idx[kTile];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTile + tx;
  if (ty == 0) s_idx[tx] = row0 + tx < m ? idx[row0 + tx] : -1;
  __syncthreads();
  float acc[kTileRowsPerThread] = {};
  for (int64_t k0 = 0; k0 < n; k0 += kTile) {
    for (int r = ty; r < kTile; r += kTile / kTileRowsPerThread) {
      s_oh[r][tx] = static_cast<int64_t>(s_idx[r]) == k0 + tx ? 1.0f : 0.0f;
      const int64_t k = k0 + r;
      s_x[r][tx] = (k < n && col < c) ? to_f32(x[k * c + col]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float xv = s_x[kk][tx];
#pragma unroll
      for (int i = 0; i < kTileRowsPerThread; ++i)
        acc[i] = fmaf(s_oh[ty + i * (kTile / kTileRowsPerThread)][kk], xv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTileRowsPerThread; ++i) {
    const int64_t row = row0 + ty + i * (kTile / kTileRowsPerThread);
    if (row < m && col < c) store(out + row * c + col, acc[i]);
  }
}

int blocks_for(int64_t threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Every function returns the cudaError_t of its launch (0 = success); the
// caller (kernels/gather.py) has checked devices, types, shapes, contiguity
// and alignment, and passes M > 0. Nothing synchronises or allocates.

// vec_per_row = C * elem_size / 16; x and out 16-byte aligned.
int rpc_gather_rows(const void* x, const int32_t* idx, void* out, int64_t m, int64_t n,
                    int vec_per_row, void* stream) {
  const int64_t threads = m * vec_per_row;
  if (vec_per_row <= 0 || threads / kThreads >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<<<blocks_for(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), idx, static_cast<uint4*>(out), m, n, vec_per_row);
  return static_cast<int>(cudaGetLastError());
}

// elem_bytes: 2 (bfloat16) or 4 (float32); the words are copied as they are.
int rpc_gather_elems(const void* x, const int32_t* idx, void* out, int64_t m, int64_t n,
                     int64_t c, int elem_bytes, void* stream) {
  const int64_t threads = m * c;
  if (c <= 0 || threads / kThreads >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    gather_elems_kernel<uint32_t><<<blocks_for(threads), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), idx, static_cast<uint32_t*>(out), m, n, c);
  else if (elem_bytes == 2)
    gather_elems_kernel<uint16_t><<<blocks_for(threads), kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), idx, static_cast<uint16_t*>(out), m, n, c);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int rpc_gather_row_loop(const void* x, const int32_t* idx, void* out, int64_t m, int64_t n,
                        int64_t c, int elem_bytes, void* stream) {
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    gather_row_loop_kernel<uint32_t><<<1, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), idx, static_cast<uint32_t*>(out), m, n, c);
  else if (elem_bytes == 2)
    gather_row_loop_kernel<uint16_t><<<1, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), idx, static_cast<uint16_t*>(out), m, n, c);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (float32 accumulation either way).
int rpc_gather_onehot(const void* x, const int32_t* idx, void* out, int64_t m, int64_t n,
                      int64_t c, int dtype, void* stream) {
  const int64_t row_tiles = (m + kTile - 1) / kTile;
  const int64_t col_tiles = (c + kTile - 1) / kTile;
  if (c <= 0 || row_tiles >= 65536 || col_tiles >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(row_tiles));
  const dim3 block(kTile, kTile / kTileRowsPerThread);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gather_onehot_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), idx, static_cast<float*>(out), m, n, c);
  else if (dtype == 1)
    gather_onehot_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), idx, static_cast<__nv_bfloat16*>(out), m, n, c);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
