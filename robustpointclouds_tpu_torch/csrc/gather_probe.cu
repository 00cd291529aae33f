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
// and bfloat16; the one-hot product carries the words through the tensor
// cores as exact integer planes (below), exact too.
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
//  * row loop: each block stages the indices of its rows in shared memory
//    and loops over them (the TPU's SMEM-indexed fori_loop), but a grid
//    sized to the card walks the rows in strided chunks, every thread moves
//    16-byte vectors where the row bytes and the base allow it (8, 4 or 2
//    bytes otherwise, so any C is taken), and each thread issues the loads
//    of kLoopUnroll rows before their stores, so one row's latency hides
//    behind the next. The plan (vector width, threads per row, rows per
//    block, grid) is kernels/gather.row_loop_plan; the entry point refuses
//    a plan the inputs' alignment does not allow.
//  * one-hot: out = onehot(idx)[M, N] @ x[N, C] as a dense product on the
//    tensor cores (mma.sync m16n8k16, fp16 operands, float32 sums). A block
//    of four warps owns one, two or four 16 x 16 output tiles (stacked along
//    the rows) and splits the k range of each tile among the rest of its
//    warps, so a small output still keeps four warps per SM; the partial
//    sums meet in shared memory at the end. A warp's one-hot A fragment is
//    built in registers by comparing its rows' indices with the k
//    coordinate; x comes through shared memory in 64-row stages of a 4-deep
//    cp.async ring. For exactness x is not multiplied as a float: its word
//    is cut into integer planes of 10 bits (10 + 10 + 10 + 2 for float32,
//    10 + 6 for bfloat16), and plane value v rides as the fp16 1024 + v,
//    whose bits are 0x6400 | v: exact, normal, and made by one OR with no
//    conversion instruction. A product with the one-hot 1 and a float32
//    sum of zeros give back 1024 + v exactly, or 0 where the row has no
//    index in range (or only selects a zero-filled padding row), and the
//    low 10 bits of the sum are v either way; the epilogue joins the
//    planes into the word. So the output is x[idx] bit for bit for every
//    word x holds: subnormals, -0, +-Inf and NaN included, and the tensor
//    cores never see a subnormal operand, whose handling mma leaves
//    unspecified. Contract for non-finite x: a row that selects an Inf or
//    NaN gets it as it is, and no other row is touched; the plain float
//    product (gather_onehot_ref) instead gives NaN in every other row of a
//    column that holds an Inf or NaN (0 * Inf). It does 2*M*N*C operations
//    per plane and reads its x column slab once per output tile, so it is
//    defined for the probe's small shape.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoopStage = 4096;  // indices a row-loop block stages at once
constexpr int kLoopUnroll = 4;    // rows whose loads a thread has in flight
constexpr int kOhTile = 16;       // one-hot: a warp's output tile is 16 x 16
constexpr int kOhWarps = 4;       // warps per block: row tiles x k splits
constexpr int kOhPlaneBits = 10;  // bits of x's word per plane
constexpr int kOhStageRows = 64;  // table rows per stage of the ring
constexpr int kOhStages = 4;
constexpr int kOhPitch = 80;      // bytes of a staged row: 16 columns + padding,
                                  // so a warp's B-fragment reads hit 32 banks

__device__ __forceinline__ bool hit(int32_t j, int64_t n) {
  return j >= 0 && static_cast<int64_t>(j) < n;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d[16x8] += a[16x16] . b[16x8], fp16 operands, float32 sums
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Rows [r0, r0 + rows) of chunk after chunk, `lanes` threads per row, each
// thread moving one V (16, 8, 4 or 2 bytes) per load; x and out hold vpr V
// per row. A thread first loads its column of kLoopUnroll rows (slots apart),
// then stores them.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_row_loop_kernel(const V* __restrict__ x, const int32_t* __restrict__ idx,
                       V* __restrict__ out, int64_t m, int64_t n, int vpr, int lanes, int slots,
                       int rows_per_block) {
  __shared__ int32_t s_idx[kLoopStage];
  const int lane = threadIdx.x % lanes;
  const int slot = threadIdx.x / lanes;  // >= slots: this thread only stages indices
  const int64_t chunks = (m + rows_per_block - 1) / rows_per_block;
  for (int64_t ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const int64_t r0 = ch * rows_per_block;
    const int rows = static_cast<int>(m - r0 < rows_per_block ? m - r0 : rows_per_block);
    __syncthreads();  // the previous chunk's indices are no longer read
    for (int i = threadIdx.x; i < rows; i += blockDim.x) s_idx[i] = __ldg(idx + r0 + i);
    __syncthreads();
    if (slot >= slots) continue;
    for (int base = slot; base < rows; base += slots * kLoopUnroll) {
      int32_t j[kLoopUnroll];
#pragma unroll
      for (int u = 0; u < kLoopUnroll; ++u) {
        const int r = base + u * slots;
        j[u] = r < rows ? s_idx[r] : -1;
      }
      for (int v = lane; v < vpr; v += lanes) {
        V val[kLoopUnroll];
#pragma unroll
        for (int u = 0; u < kLoopUnroll; ++u)
          val[u] = hit(j[u], n) ? __ldg(x + static_cast<int64_t>(j[u]) * vpr + v) : V{};
#pragma unroll
        for (int u = 0; u < kLoopUnroll; ++u) {
          const int r = base + u * slots;
          if (r < rows) out[(r0 + r) * vpr + v] = val[u];
        }
      }
    }
  }
}

// Two fp16 one-hot entries packed as the A operand wants them: row index j
// against the columns k and k + 1 (fp16 1.0 is 0x3C00).
__device__ __forceinline__ uint32_t onehot2(int32_t j, int64_t k) {
  return (j == k ? 0x3C00u : 0u) | (j == k + 1 ? 0x3C000000u : 0u);
}

// Plane p of two table words as the B operand pair: fp16 1024 + v for each
// 10-bit plane value v (bits 0x6400 | v).
template <typename W>
__device__ __forceinline__ uint32_t plane2(W lo, W hi, int p) {
  constexpr uint32_t kMask = (1u << kOhPlaneBits) - 1u;
  const uint32_t a = (uint32_t(lo) >> (p * kOhPlaneBits)) & kMask;
  const uint32_t b = (uint32_t(hi) >> (p * kOhPlaneBits)) & kMask;
  return 0x64006400u | a | (b << 16);
}

// Stage table rows [k0, k0 + kOhStageRows) x columns [col0, col0 + 16) into
// buf; rows past N and columns past C are zeros. kVec: 16-byte cp.async
// pieces (C * sizeof(W) and the base are 16-byte multiples, so a piece is
// wholly inside C or wholly outside); otherwise word by word.
template <typename W, bool kVec>
__device__ __forceinline__ void stage_table(unsigned char* buf, const W* __restrict__ x,
                                            int64_t k0, int64_t col0, int64_t n, int64_t c) {
  if (kVec) {
    constexpr int kPieces = sizeof(W);  // 16 columns of W in 16-byte pieces
    for (int e = threadIdx.x; e < kOhStageRows * kPieces; e += blockDim.x) {
      const int r = e / kPieces;
      const int q = e % kPieces;
      const int64_t k = k0 + r;
      const int64_t col = col0 + q * (16 / sizeof(W));
      const bool ok = k < n && col < c;
      cp_async16(smem_u32(buf + r * kOhPitch + q * 16), ok ? x + k * c + col : x, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kOhStageRows * kOhTile; e += blockDim.x) {
      const int r = e / kOhTile;
      const int q = e % kOhTile;
      const int64_t k = k0 + r;
      const int64_t col = col0 + q;
      *reinterpret_cast<W*>(buf + r * kOhPitch + q * sizeof(W)) =
          k < n && col < c ? x[k * c + col] : W(0);
    }
  }
}

// grid (row tiles of 16 * row_warps rows, column tiles of 16). Warp w of a
// block owns output rows [16 * (blockIdx.x * row_warps + w % row_warps), +16)
// and, of each stage's four k steps, those congruent to w / row_warps
// modulo 4 / row_warps.
template <typename W, bool kVec>
__global__ void __launch_bounds__(kOhWarps * 32)
gather_onehot_kernel(const W* __restrict__ x, const int32_t* __restrict__ idx,
                     W* __restrict__ out, int64_t m, int64_t n, int64_t c, int row_warps) {
  constexpr int kPlanes = sizeof(W) == 4 ? 4 : 2;
  constexpr int kSteps = kOhStageRows / 16;
  __shared__ __align__(16) unsigned char s_x[kOhStages][kOhStageRows * kOhPitch];
  static_assert(kOhWarps * kPlanes * 8 * 32 * 4 <= sizeof(s_x), "the partial sums reuse the ring");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragments' row (A, C) and column (B) group
  const int t = lane & 3;
  const int split = kOhWarps / row_warps;
  const int part = warp / row_warps;  // this warp's share of the k steps
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * row_warps + warp % row_warps) * kOhTile;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kOhTile;
  const int32_t ja = row0 + g < m ? __ldg(idx + row0 + g) : -1;
  const int32_t jb = row0 + g + 8 < m ? __ldg(idx + row0 + g + 8) : -1;
  float acc[kPlanes][2][4] = {};
  const int64_t stages = (n + kOhStageRows - 1) / kOhStageRows;
#pragma unroll
  for (int s = 0; s < kOhStages - 1; ++s) {
    if (s < stages) stage_table<W, kVec>(s_x[s], x, s * kOhStageRows, col0, n, c);
    cp_async_commit();  // possibly empty: keeps the group count uniform
  }
  for (int64_t st = 0; st < stages; ++st) {
    cp_async_wait<kOhStages - 2>();  // this thread's pieces of stage st landed
    __syncthreads();                 // everyone's; and stage st - 1 is consumed
    const int64_t next = st + kOhStages - 1;
    if (next < stages)
      stage_table<W, kVec>(s_x[next % kOhStages], x, next * kOhStageRows, col0, n, c);
    cp_async_commit();
    const unsigned char* buf = s_x[st % kOhStages];
    for (int ks = part; ks < kSteps; ks += split) {
      const int64_t kk = st * kOhStageRows + ks * 16 + 2 * t;
      const uint32_t a[4] = {onehot2(ja, kk), onehot2(jb, kk), onehot2(ja, kk + 8),
                             onehot2(jb, kk + 8)};
      const unsigned char* rows = buf + (ks * 16 + 2 * t) * kOhPitch;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (8 * h + g) * static_cast<int>(sizeof(W));
        const W w0 = *reinterpret_cast<const W*>(rows + off);
        const W w1 = *reinterpret_cast<const W*>(rows + kOhPitch + off);
        const W w8 = *reinterpret_cast<const W*>(rows + 8 * kOhPitch + off);
        const W w9 = *reinterpret_cast<const W*>(rows + 9 * kOhPitch + off);
#pragma unroll
        for (int p = 0; p < kPlanes; ++p)
          mma_f16(acc[p][h], a, plane2(w0, w1, p), plane2(w8, w9, p));
      }
    }
  }
  cp_async_wait<0>();
  if (split > 1) {  // the k splits' partial sums meet in the (consumed) ring
    float* partial = reinterpret_cast<float*>(&s_x[0][0]);
    __syncthreads();
    if (part > 0) {
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          partial[((warp * kPlanes + p) * 8 + i) * 32 + lane] = acc[p][i >> 2][i & 3];
    }
    __syncthreads();
    if (part > 0) return;
    for (int s = 1; s < split; ++s) {  // one sum holds the plane, the rest 0: exact
      const int w = s * row_warps + warp;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[p][i >> 2][i & 3] += partial[((w * kPlanes + p) * 8 + i) * 32 + lane];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = row0 + g + (i >> 1) * 8;
      const int64_t col = col0 + 8 * h + 2 * t + (i & 1);
      uint32_t word = 0;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)  // each sum is 1024 + v, or 0: v is its low bits
        word |= (static_cast<uint32_t>(acc[p][h][i]) & ((1u << kOhPlaneBits) - 1u))
                << (p * kOhPlaneBits);
      if (row < m && col < c) out[row * c + col] = static_cast<W>(word);
    }
  }
}

int blocks_for(int64_t threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

template <typename V>
void launch_row_loop(const void* x, const int32_t* idx, void* out, int64_t m, int64_t n,
                     int vpr, int lanes, int slots, int rows_per_block, int blocks,
                     cudaStream_t s) {
  gather_row_loop_kernel<V><<<blocks, kThreads, 0, s>>>(
      static_cast<const V*>(x), idx, static_cast<V*>(out), m, n, vpr, lanes, slots,
      rows_per_block);
}

template <typename W>
void launch_onehot(const void* x, const int32_t* idx, void* out, int64_t m, int64_t n,
                   int64_t c, dim3 grid, int row_warps, bool vec, cudaStream_t s) {
  if (vec)
    gather_onehot_kernel<W, true><<<grid, kOhWarps * 32, 0, s>>>(
        static_cast<const W*>(x), idx, static_cast<W*>(out), m, n, c, row_warps);
  else
    gather_onehot_kernel<W, false><<<grid, kOhWarps * 32, 0, s>>>(
        static_cast<const W*>(x), idx, static_cast<W*>(out), m, n, c, row_warps);
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

// plan: C, the element bytes (2: bfloat16, 4: float32), then
// kernels/gather.row_loop_plan's fields: vec bytes per load (16, 8, 4 or 2,
// dividing the row's bytes and both bases), lanes threads per row, slots rows
// at once (lanes * slots <= 256), rows_per_block (<= 4096) staged per chunk,
// blocks in the grid. A plan the inputs do not allow is refused.
int rpc_gather_row_loop(const void* x, const int32_t* idx, void* out, int64_t m, int64_t n,
                        const int64_t* plan, void* stream) {
  const int64_t c = plan[0], elem_bytes = plan[1], vec = plan[2], lanes = plan[3],
                slots = plan[4], rows_per_block = plan[5], blocks = plan[6];
  const int64_t row_bytes = c * elem_bytes;
  if (c <= 0 || (elem_bytes != 2 && elem_bytes != 4) ||
      (vec != 2 && vec != 4 && vec != 8 && vec != 16) || row_bytes % vec ||
      reinterpret_cast<uintptr_t>(x) % vec || reinterpret_cast<uintptr_t>(out) % vec ||
      row_bytes / vec >= (int64_t{1} << 31) || lanes <= 0 || slots <= 0 ||
      lanes * slots > kThreads || rows_per_block <= 0 || rows_per_block > kLoopStage ||
      blocks <= 0 || blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vpr = static_cast<int>(row_bytes / vec);
  const int l = static_cast<int>(lanes), sl = static_cast<int>(slots);
  const int rows = static_cast<int>(rows_per_block), b = static_cast<int>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16)
    launch_row_loop<uint4>(x, idx, out, m, n, vpr, l, sl, rows, b, s);
  else if (vec == 8)
    launch_row_loop<uint2>(x, idx, out, m, n, vpr, l, sl, rows, b, s);
  else if (vec == 4)
    launch_row_loop<uint32_t>(x, idx, out, m, n, vpr, l, sl, rows, b, s);
  else
    launch_row_loop<uint16_t>(x, idx, out, m, n, vpr, l, sl, rows, b, s);
  return static_cast<int>(cudaGetLastError());
}

// plan: C, the element bytes, then kernels/gather.onehot_plan's fields:
// row_warps (1, 2 or 4) output tiles per block of four warps, the rest of
// the warps splitting k; the grid's row and column tiles; vec 16 for 16-byte
// cp.async stages (C * elem_bytes and x 16-byte multiples) or 0 for
// word-by-word stages; the planes a word takes (4 for float32, 2 for
// bfloat16). A plan that disagrees with these rules is refused.
int rpc_gather_onehot(const void* x, const int32_t* idx, void* out, int64_t m, int64_t n,
                      const int64_t* plan, void* stream) {
  const int64_t c = plan[0], elem_bytes = plan[1], row_warps = plan[2], row_tiles = plan[3],
                col_tiles = plan[4], vec = plan[5], planes = plan[6];
  if (c <= 0 || (elem_bytes != 2 && elem_bytes != 4) ||
      (row_warps != 1 && row_warps != 2 && row_warps != 4) || (vec != 0 && vec != 16) ||
      (vec == 16 && ((c * elem_bytes) % 16 || reinterpret_cast<uintptr_t>(x) % 16)) ||
      planes != (elem_bytes == 4 ? 4 : 2) ||
      row_tiles != (m + kOhTile * row_warps - 1) / (kOhTile * row_warps) ||
      col_tiles != (c + kOhTile - 1) / kOhTile || row_tiles >= (int64_t{1} << 31) ||
      col_tiles >= 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  const int rw = static_cast<int>(row_warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    launch_onehot<uint32_t>(x, idx, out, m, n, c, grid, rw, vec == 16, s);
  else
    launch_onehot<uint16_t>(x, idx, out, m, n, c, grid, rw, vec == 16, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
