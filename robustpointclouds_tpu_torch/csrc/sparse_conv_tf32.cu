// Sparse 3D convolution as 3xTF32 tensor-core gather-GEMMs, for Hopper (sm_90a):
// the forward (which also serves the dgrad) and the weight gradient (wgrad)
// of the float32 route. The bfloat16 route is sparse_conv_tc.cu.
//
// Replaces the Pallas merge-path kernel `mp_gather_conv`
// (robustpointclouds_tpu/kernels/mp_gather.py:192) in its `out`, `bwd` and
// `col` modes for float32 operands, with the contract of sparse_conv.cu:
//
//     forward: out[i, :] = sum_k feats[idx[i, k], :] @ W[k*Cin:(k+1)*Cin, :]
//     dgrad:   the forward on (g, W^T per tap, backward index);
//     wgrad:   dW[k*Cin + c, o] = sum_i feats[idx[i, k], c] * g[i, o].
//
// idx [M, K] int32, K <= 32, tap order of ops/sparse.kernel_offsets; an index
// outside [0, N) is a miss and reads a zero row. feats, W, g, out and dW are
// float32; dW is deterministic.
//
// Precision. The TF32 tensor cores multiply 11-bit significands, and an mma
// fed raw float32 words drops their low 13 bits without rounding. So every
// operand x is split in registers into big = tf32(x) (cvt.rna: nearest, ties
// away from zero) and small = tf32(x - big) (the subtraction is exact), and a
// product x * w is taken as big*big + big*small + small*big: three m16n8k8
// tf32 mma with float32 sums. What is left out, small*small and the rounding
// of small, is about 2^-21 of each product, near float32's own rounding. An
// mma rounds every sum it returns, so the products of one tap (forward) or
// of one hit list (wgrad) are summed in fresh registers and only then added
// to the float32 total: no chain of mma roundings is longer than one tap's
// Cin/8 steps (three mma each) or one list's hits/8 steps.
// Non-finite inputs: the split of +-Inf has a NaN small part, so an output
// row that a +-Inf or NaN input reaches is NaN, and no other row is touched.
// A finite |x| >= (2 - 2^-11) * 2^127 rounds its big part to Inf and gives a
// NaN row the same way.
//
// What bounds them: 3 * 2*hits*Cin*Cout tensor-core operations against the
// index, the activations and the output in float32. At the SECOND encoder's
// widths that is below the tensor cores' ridge, so the work that matters is
// moving neighbour rows, as in the bf16 route:
//  * forward / dgrad: one block per tile of tile_m output rows, all Cout
//    columns. The block reads its [tile_m, K] index slice once and skips the
//    taps that no row of the tile hits. A live tap's neighbour rows and its
//    [Cin, Cout] weights are copied into one stage of a ring (2 or 3 stages,
//    the plan's) as 16-byte cp.async pieces, zero-filled for misses, pad
//    rows and pad columns, so the next taps' copies are in flight while the
//    warps multiply this one. Each warp owns 16 rows and 64 columns (all of
//    them when Cout <= 64): per 8-channel step it loads its A fragment (four
//    words a lane) and, per 8 columns, its B fragment (two words a lane) from
//    shared memory, splits them and issues the three mma. The float32 sums
//    are stored once, as 8-byte pairs straight from the fragments.
//  * wgrad: the bf16 wgrad's (row chunk, tap) grid, hit lists (warp ballots,
//    a fixed prefix, row order) and fixed-order reduce of float32 partials.
//    The listed hits' feats and g rows are copied by cp.async, the list
//    padded to a multiple of 8 with zero rows, and the [Cin, Cout] partial is
//    A^T[Cin, hits] . G[hits, Cout] in 16x16 tiles over 8 warps; with fewer
//    than 8 tiles, warps split a list's 8-hit blocks in a fixed pattern and
//    their sums are merged in a fixed order.
// Shared pitches keep a warp's fragment loads on 32 distinct banks. A
// fragment that reads 8 rows x 4 consecutive columns (the forward's A) needs
// a pitch of 4 mod 8 words: width + 4. One that reads 4 rows x 8 consecutive
// columns (the forward's W, both wgrad operands) needs 8 or 24 mod 32 words:
// width + 8, or width + 16 at width 8. Widths are zero-padded to the
// template's (a power of two: at least 8 in the forward, 16 in the wgrad).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 3;  // the forward's ring of taps: 2 or 3 stages
constexpr int kMaxTaps = 32;
constexpr int kMaxTileM = 128;
constexpr int kMaxThreads = 256;
constexpr int kWarpN = 64;  // forward: output columns a warp owns
constexpr int kWgradThreads = 256;
constexpr int kWgradWarps = kWgradThreads / 32;
constexpr int kMaxCap = 1024;

__host__ __device__ constexpr int row_pitch(int width) { return width + 4; }
__host__ __device__ constexpr int col_pitch(int width) {
  return (width + 8) % 32 == 8 || (width + 8) % 32 == 24 ? width + 8 : width + 16;
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

// x = big + small, both tf32 words: big = tf32(x) with its low 13 bits
// cleared, so x - big is exact; small = tf32(x - big), whose low bits the
// mma ignores
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  uint32_t b;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(x));
  b &= 0xffffe000u;
  const float rest = x - __uint_as_float(b);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
  big = b;
}

// d[16x8] += a[16x8] . b[8x8], tf32 operands, float32 sums. Fragments
// (PTX ISA, mma.m16n8k8 .tf32), g = lane/4, t = lane%4: a0 (g, t), a1
// (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (k=t, n=g), b1 (k=t+4, n=g);
// d0, d1 (g, 2t and 2t+1), d2, d3 (g+8, the same columns)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b with a and b split: the small products first, then big . big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

// Copy `rows` shared rows of `width_pad` floats (pitch `pitch`) from global
// rows of `width` floats (a multiple of 4) as 16-byte pieces: row r's source
// is src_row(r), or none (zero fill) where it returns nullptr; columns past
// `width` are zero fills.
template <typename RowFn>
__device__ __forceinline__ void stage_rows(float* dst, int rows, int width_pad, int pitch,
                                           const float* base, int width, RowFn src_row) {
  const int per_row = width_pad / 4;  // a power of two
  const int shift = __ffs(per_row) - 1;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e >> shift;
    const int c = (e & (per_row - 1)) * 4;
    const float* row = c < width ? src_row(r) : nullptr;
    cp_async16(smem_u32(dst + r * pitch + c), row ? row + c : base, row ? 16 : 0);
  }
}

// ---------------------------------------------------------------- forward

template <int CIN, int COUT>
struct FwdShape {
  static constexpr int AP = row_pitch(CIN);
  static constexpr int WP = col_pitch(COUT);
  static constexpr int WN = COUT < kWarpN ? COUT : kWarpN;  // columns a warp owns
  static constexpr int COL_GROUPS = COUT / WN;
  __host__ __device__ static constexpr int threads(int tile_m) {
    return tile_m / 16 * COL_GROUPS * 32;
  }
  __host__ __device__ static constexpr int stage_floats(int tile_m) {
    return tile_m * AP + CIN * WP;
  }
  __host__ __device__ static constexpr int smem_bytes(int tile_m, int k_taps, int stages) {
    return (tile_m * k_taps * 4 + 15) / 16 * 16 + 4 * stages * stage_floats(tile_m);
  }
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(kMaxThreads)
sparse_conv_tf32_fwd_kernel(const float* __restrict__ feats, const float* __restrict__ w,
                            const int32_t* __restrict__ idx, float* __restrict__ out, int64_t n,
                            int64_t m, int k_taps, int cin, int cout, int tile_m, int stages) {
  typedef FwdShape<CIN, COUT> S;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t live_s;
  int32_t* i_s = reinterpret_cast<int32_t*>(smem);  // [tile_m, K], misses as -1
  float* ring = reinterpret_cast<float*>(smem + (tile_m * k_taps * 4 + 15) / 16 * 16);
  const int stage_floats = S::stage_floats(tile_m);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warp_r = warp / S::COL_GROUPS;  // 16-row slab
  const int warp_c = warp % S::COL_GROUPS;  // 64-column slab
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * tile_m;
  const int rows = static_cast<int>(min(static_cast<int64_t>(tile_m), m - m0));

  // 1. the tile's index slice, once, and the taps that any of its rows hits
  if (t == 0) live_s = 0;
  __syncthreads();
  uint32_t live = 0;
  const int32_t* ib = idx + m0 * k_taps;
  for (int e = t; e < tile_m * k_taps; e += blockDim.x) {
    int32_t v = -1;
    if (e < rows * k_taps) {
      v = ib[e];
      if (v < 0 || v >= n) v = -1;
    }
    i_s[e] = v;
    if (v >= 0) live |= 1u << (e % k_taps);
  }
  live = __reduce_or_sync(0xffffffffu, live);
  if (lane == 0 && live) atomicOr(&live_s, live);
  __syncthreads();
  live = live_s;

  // 2. a live tap's neighbour rows and weights into one stage of the ring
  auto stage_tap = [&](int k, int buf) {
    float* a_s = ring + buf * stage_floats;
    stage_rows(a_s, tile_m, CIN, S::AP, feats, cin, [&](int r) -> const float* {
      const int32_t id = i_s[r * k_taps + k];
      return id >= 0 ? feats + static_cast<int64_t>(id) * cin : nullptr;
    });
    const float* wk = w + static_cast<int64_t>(k) * cin * cout;
    stage_rows(a_s + tile_m * S::AP, CIN, COUT, S::WP, w, cout, [&](int c) -> const float* {
      return c < cin ? wk + static_cast<int64_t>(c) * cout : nullptr;
    });
  };

  float acc[S::WN / 8][4];
#pragma unroll
  for (int j = 0; j < S::WN / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  const int n_live = __popc(live);
  uint32_t pending = live;  // taps not yet staged, lowest first
  for (int s = 0; s < stages - 1; ++s) {
    if (pending) {
      stage_tap(__ffs(pending) - 1, s);
      pending &= pending - 1;
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
  }
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // this lane's words of the A fragment (rows warp_r*16 + gq, columns tq)
  // and of the B fragment (rows tq, columns warp_c*WN + gq)
  const int a_off = (warp_r * 16 + gq) * S::AP + tq;
  const int w_off = tile_m * S::AP + tq * S::WP + warp_c * S::WN + gq;
  const bool busy = warp_r * 16 < rows;
  for (int i = 0; i < n_live; ++i) {
    if (stages == 3)
      cp_async_wait<1>();  // this thread's copies of tap i landed
    else
      cp_async_wait<0>();
    __syncthreads();  // everyone's; and tap i-1's stage is free
    if (pending) {
      stage_tap(__ffs(pending) - 1, (i + stages - 1) % stages);
      pending &= pending - 1;
    }
    cp_async_commit();
    if (busy) {
      const float* st = ring + (i % stages) * stage_floats;
      const float* a_p = st + a_off;
      const float* w_p = st + w_off;
      float part[S::WN / 8][4];
#pragma unroll
      for (int j = 0; j < S::WN / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < CIN / 8; ++kk) {
        uint32_t a_big[4], a_small[4];
        split_tf32(a_p[kk * 8], a_big[0], a_small[0]);
        split_tf32(a_p[kk * 8 + 8 * S::AP], a_big[1], a_small[1]);
        split_tf32(a_p[kk * 8 + 4], a_big[2], a_small[2]);
        split_tf32(a_p[kk * 8 + 8 * S::AP + 4], a_big[3], a_small[3]);
#pragma unroll
        for (int j = 0; j < S::WN / 8; ++j) {
          uint32_t b_big[2], b_small[2];
          split_tf32(w_p[kk * 8 * S::WP + j * 8], b_big[0], b_small[0]);
          split_tf32(w_p[(kk * 8 + 4) * S::WP + j * 8], b_big[1], b_small[1]);
          mma_3xtf32(part[j], a_big, a_small, b_big, b_small);
        }
      }
#pragma unroll
      for (int j = 0; j < S::WN / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
    }
  }
  cp_async_wait<0>();

  // 3. the float32 sums, as 8-byte pairs: rows gq and gq + 8 of the slab,
  // columns 2*tq and 2*tq + 1 of each 8-column tile (cout % 4 == 0, so a
  // pair is wholly inside cout or wholly outside)
  const int r0 = warp_r * 16 + gq;
#pragma unroll
  for (int j = 0; j < S::WN / 8; ++j) {
    const int c = warp_c * S::WN + j * 8 + tq * 2;
    if (c >= cout) continue;
    if (r0 < rows)
      *reinterpret_cast<float2*>(out + (m0 + r0) * cout + c) = make_float2(acc[j][0], acc[j][1]);
    if (r0 + 8 < rows)
      *reinterpret_cast<float2*>(out + (m0 + r0 + 8) * cout + c) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

template <int CIN, int COUT>
int launch_fwd(const float* feats, const float* w, const int32_t* idx, float* out, int64_t n,
               int64_t m, int k_taps, int cin, int cout, int tile_m, int threads, int stages,
               int smem, cudaStream_t stream) {
  typedef FwdShape<CIN, COUT> S;
  if (threads != S::threads(tile_m) || threads > kMaxThreads ||
      smem != S::smem_bytes(tile_m, k_taps, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  // always: the kernel's static shared word counts against the default 48 KB
  // too, so a plan of exactly 48 KB would be refused without it
  cudaError_t e = cudaFuncSetAttribute(sparse_conv_tf32_fwd_kernel<CIN, COUT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = (m + tile_m - 1) / tile_m;
  if (blocks > 0)
    sparse_conv_tf32_fwd_kernel<CIN, COUT><<<static_cast<unsigned>(blocks), threads, smem,
                                             stream>>>(feats, w, idx, out, n, m, k_taps, cin,
                                                       cout, tile_m, stages);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ wgrad

template <int CIN, int COUT>
struct WgradShape {
  static constexpr int AP = col_pitch(CIN);
  static constexpr int GP = col_pitch(COUT);
  static constexpr int UNITS = (CIN / 16) * (COUT / 16);  // 16x16 tiles of [Cin, Cout]
  static constexpr int TPW = UNITS >= kWgradWarps ? UNITS / kWgradWarps : 1;  // tiles a warp
  static constexpr int GROUPS = UNITS >= kWgradWarps ? 1 : kWgradWarps / UNITS;
  __host__ __device__ static constexpr int smem_bytes(int cap) {
    return (4 * cap * (AP + GP) + 4 * (2 * cap + kWgradWarps)) >
                   (GROUPS > 1 ? 4 * GROUPS * CIN * COUT : 0)
               ? 4 * cap * (AP + GP) + 4 * (2 * cap + kWgradWarps)
               : 4 * GROUPS * CIN * COUT;
  }
};

// One block per (row chunk, tap k), as in the bf16 wgrad: the block scans
// its chunk `step` rows at a time and appends the rows that hit tap k to a
// list in row order; when one more step could overflow `cap` entries, or
// the chunk ends, it stages the listed hits and multiplies them.
template <int CIN, int COUT>
__global__ void __launch_bounds__(kWgradThreads)
sparse_conv_tf32_wgrad_kernel(const float* __restrict__ feats, const float* __restrict__ g,
                              const int32_t* __restrict__ idx, float* __restrict__ partial,
                              int64_t n, int64_t m, int k_taps, int cin, int cout,
                              int64_t rows_per_chunk, int cap, int step) {
  typedef WgradShape<CIN, COUT> S;
  extern __shared__ __align__(16) unsigned char smem[];
  float* a_s = reinterpret_cast<float*>(smem);                 // [cap, AP]
  float* g_s = a_s + cap * S::AP;                              // [cap, GP]
  int32_t* hit_row = reinterpret_cast<int32_t*>(g_s + cap * S::GP);  // [cap]
  int32_t* hit_id = hit_row + cap;                             // [cap]
  int32_t* warp_cnt = hit_id + cap;                            // [kWgradWarps]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int k = blockIdx.y;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // this warp's tiles: unit = warp + u*8 (all of a list's 8-hit blocks), or,
  // with fewer than 8 tiles, unit = warp % UNITS over the blocks
  // j = grp, grp + GROUPS, ...
  const int grp = S::GROUPS > 1 ? warp / S::UNITS : 0;
  // A^T fragment word (c = gq, hit = tq) and G fragment word (hit = tq, o = gq)
  const int a_lane = tq * S::AP + gq;
  const int g_lane = tq * S::GP + gq;

  float acc[S::TPW][2][4];
#pragma unroll
  for (int u = 0; u < S::TPW; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[u][h][q] = 0.f;

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
      for (int q = 0; q < kWgradWarps; ++q) {
        const int c = warp_cnt[q];
        off += q < warp ? c : 0;
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

    // the hits' feats and g rows, zero rows up to a multiple of 8
    const int count8 = (count + 7) & ~7;
    stage_rows(a_s, count8, CIN, S::AP, feats, cin, [&](int r) -> const float* {
      return r < count ? feats + static_cast<int64_t>(hit_id[r]) * cin : nullptr;
    });
    stage_rows(g_s, count8, COUT, S::GP, g, cout, [&](int r) -> const float* {
      return r < count ? g + (r0 + hit_row[r]) * cout : nullptr;
    });
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int u = 0; u < S::TPW; ++u) {
      const int unit = S::GROUPS > 1 ? warp % S::UNITS : warp + u * kWgradWarps;
      const int c0 = (unit / (COUT / 16)) * 16;
      const int o0 = (unit % (COUT / 16)) * 16;
      const float* a_p = a_s + a_lane + c0;
      const float* g_p = g_s + g_lane + o0;
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int j = grp; j < count8 / 8; j += S::GROUPS) {
        const float* a_j = a_p + j * 8 * S::AP;
        const float* g_j = g_p + j * 8 * S::GP;
        uint32_t a_big[4], a_small[4];
        split_tf32(a_j[0], a_big[0], a_small[0]);                  // (c0 + gq, hit tq)
        split_tf32(a_j[8], a_big[1], a_small[1]);                  // (c0 + gq + 8, tq)
        split_tf32(a_j[4 * S::AP], a_big[2], a_small[2]);          // (c0 + gq, tq + 4)
        split_tf32(a_j[4 * S::AP + 8], a_big[3], a_small[3]);      // (c0 + gq + 8, tq + 4)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b_big[2], b_small[2];
          split_tf32(g_j[h * 8], b_big[0], b_small[0]);              // (hit tq, o0 + 8h + gq)
          split_tf32(g_j[4 * S::GP + h * 8], b_big[1], b_small[1]);  // (hit tq + 4, ...)
          mma_3xtf32(part[h], a_big, a_small, b_big, b_small);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[u][h][q] += part[h][q];
    }
    __syncthreads();  // a_s, g_s and the list are free again
  }

  // fragment of tile `unit`, half h: rows c0 + lane/4 (+8 for q >= 2),
  // columns o0 + 8h + 2*(lane%4) + (q%2)
  float* out = partial + (static_cast<int64_t>(blockIdx.x) * k_taps + k) * cin * cout;
  float* red = reinterpret_cast<float*>(smem);  // [GROUPS, CIN, COUT] over the free list
#pragma unroll
  for (int u = 0; u < S::TPW; ++u) {
    const int unit = S::GROUPS > 1 ? warp % S::UNITS : warp + u * kWgradWarps;
    const int c0 = (unit / (COUT / 16)) * 16;
    const int o0 = (unit % (COUT / 16)) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int c = c0 + gq + (q ? 8 : 0);
        const int o = o0 + h * 8 + tq * 2;
        if (S::GROUPS > 1) {
          red[(grp * CIN + c) * COUT + o] = acc[u][h][q];
          red[(grp * CIN + c) * COUT + o + 1] = acc[u][h][q + 1];
        } else if (c < cin && o < cout) {  // cout % 4 == 0: o + 1 < cout
          *reinterpret_cast<float2*>(out + c * cout + o) =
              make_float2(acc[u][h][q], acc[u][h][q + 1]);
        }
      }
  }
  if (S::GROUPS > 1) {
    __syncthreads();
    for (int e = t; e < cin * cout; e += kWgradThreads) {
      const int c = e / cout;
      const int o = e - c * cout;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < S::GROUPS; ++q) v += red[(q * CIN + c) * COUT + o];  // fixed order
      out[e] = v;
    }
  }
}

// dW[q] = sum over chunks of partial[chunk][q], chunks in order.
__global__ void sparse_conv_tf32_wgrad_reduce_kernel(const float* __restrict__ partial,
                                                     float* __restrict__ dw, int64_t size,
                                                     int chunks) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= size) return;
  float v = 0.f;
  for (int ch = 0; ch < chunks; ++ch) v += partial[static_cast<int64_t>(ch) * size + q];
  dw[q] = v;
}

template <int CIN, int COUT>
int launch_wgrad(const float* feats, const float* g, const int32_t* idx, float* partial,
                 float* dw, int64_t n, int64_t m, int k_taps, int cin, int cout,
                 int64_t rows_per_chunk, int chunks, int cap, int step, int smem,
                 cudaStream_t stream) {
  if constexpr (CIN < 16 || COUT < 16) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wgrad's tiles are 16 x 16
  } else {
    if (smem != WgradShape<CIN, COUT>::smem_bytes(cap))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(sparse_conv_tf32_wgrad_kernel<CIN, COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(k_taps));
    sparse_conv_tf32_wgrad_kernel<CIN, COUT><<<grid, kWgradThreads, smem, stream>>>(
        feats, g, idx, partial, n, m, k_taps, cin, cout, rows_per_chunk, cap, step);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t size = static_cast<int64_t>(k_taps) * cin * cout;
    sparse_conv_tf32_wgrad_reduce_kernel<<<static_cast<unsigned>((size + 255) / 256), 256, 0,
                                           stream>>>(partial, dw, size, chunks);
    return static_cast<int>(cudaGetLastError());
  }
}

// The padded widths the kernels are instantiated for: 8, 16, 32, 64, 128.
int pad_index(int width) {
  return width == 8 ? 0 : width == 16 ? 1 : width == 32 ? 2 : width == 64 ? 3
       : width == 128 ? 4 : -1;
}

// width a multiple of 4 (16-byte pieces), padded to the smallest instance
// of at least `least` columns that holds it
bool width_ok(int width, int pad, int least) {
  int want = least;
  while (want < width) want *= 2;
  return width > 0 && width % 4 == 0 && pad == want && pad_index(pad) >= 0;
}

}  // namespace

#define RPC_DISPATCH(FN, CIN_PAD, COUT_PAD, ...)                                          \
  switch (pad_index(CIN_PAD) * 5 + pad_index(COUT_PAD)) {                                \
    case 0: return FN<8, 8>(__VA_ARGS__);                                                \
    case 1: return FN<8, 16>(__VA_ARGS__);                                               \
    case 2: return FN<8, 32>(__VA_ARGS__);                                               \
    case 3: return FN<8, 64>(__VA_ARGS__);                                               \
    case 4: return FN<8, 128>(__VA_ARGS__);                                              \
    case 5: return FN<16, 8>(__VA_ARGS__);                                               \
    case 6: return FN<16, 16>(__VA_ARGS__);                                              \
    case 7: return FN<16, 32>(__VA_ARGS__);                                              \
    case 8: return FN<16, 64>(__VA_ARGS__);                                              \
    case 9: return FN<16, 128>(__VA_ARGS__);                                             \
    case 10: return FN<32, 8>(__VA_ARGS__);                                              \
    case 11: return FN<32, 16>(__VA_ARGS__);                                             \
    case 12: return FN<32, 32>(__VA_ARGS__);                                             \
    case 13: return FN<32, 64>(__VA_ARGS__);                                             \
    case 14: return FN<32, 128>(__VA_ARGS__);                                            \
    case 15: return FN<64, 8>(__VA_ARGS__);                                              \
    case 16: return FN<64, 16>(__VA_ARGS__);                                             \
    case 17: return FN<64, 32>(__VA_ARGS__);                                             \
    case 18: return FN<64, 64>(__VA_ARGS__);                                             \
    case 19: return FN<64, 128>(__VA_ARGS__);                                            \
    case 20: return FN<128, 8>(__VA_ARGS__);                                             \
    case 21: return FN<128, 16>(__VA_ARGS__);                                            \
    case 22: return FN<128, 32>(__VA_ARGS__);                                            \
    case 23: return FN<128, 64>(__VA_ARGS__);                                            \
    case 24: return FN<128, 128>(__VA_ARGS__);                                           \
    default: return static_cast<int>(cudaErrorInvalidValue);                             \
  }

extern "C" {

// float32 gather-GEMM (forward and dgrad). The launch plan comes from the
// wrapper (kernels/sparse_conv.tf32_gemm_plan): cin_pad/cout_pad the padded
// widths (powers of two from 8), tile_m rows a block (a multiple of 16),
// threads (32 per 16 rows and 64 columns), stages of the ring (2 or 3) and
// smem its dynamic shared memory, which must equal the layout's size.
// Pointers 16-byte aligned; returns the cudaError_t of the launch (0 =
// success).
int rpc_sparse_conv_tf32_fwd(const float* feats, const float* w, const int32_t* idx, float* out,
                             int64_t n, int64_t m, int k_taps, int cin, int cout, int cin_pad,
                             int cout_pad, int tile_m, int threads, int stages, int smem,
                             void* stream) {
  if (!width_ok(cin, cin_pad, 8) || !width_ok(cout, cout_pad, 8) || k_taps <= 0 ||
      k_taps > kMaxTaps || tile_m < 16 || tile_m > kMaxTileM || tile_m % 16 != 0 ||
      stages < 2 || stages > kMaxStages || n < 0 || m < 0 || n >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RPC_DISPATCH(launch_fwd, cin_pad, cout_pad, feats, w, idx, out, n, m, k_taps, cin, cout,
               tile_m, threads, stages, smem, s)
}

// float32 wgrad. partial: float32 scratch [chunks, K, Cin, Cout]; dw:
// float32 [K*Cin, Cout]; chunks * rows_per_chunk covers M; widths padded to
// powers of two from 16; cap a power of two in [16, 1024], step <=
// min(256, cap/2); smem as the wrapper's plan
// (kernels/sparse_conv.wgrad_plan, elem_bytes 4) computes it.
int rpc_sparse_conv_tf32_wgrad(const float* feats, const float* g, const int32_t* idx,
                               float* partial, float* dw, int64_t n, int64_t m, int k_taps,
                               int cin, int cout, int cin_pad, int cout_pad,
                               int64_t rows_per_chunk, int chunks, int cap, int step, int smem,
                               void* stream) {
  if (!width_ok(cin, cin_pad, 16) || !width_ok(cout, cout_pad, 16) || k_taps <= 0 ||
      chunks <= 0 || rows_per_chunk <= 0 || rows_per_chunk > (int64_t{1} << 30) ||
      static_cast<int64_t>(chunks) * rows_per_chunk < m || cap < 16 || cap > kMaxCap ||
      (cap & (cap - 1)) != 0 || step <= 0 || step > kWgradThreads || 2 * step > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RPC_DISPATCH(launch_wgrad, cin_pad, cout_pad, feats, g, idx, partial, dw, n, m, k_taps, cin,
               cout, rows_per_chunk, chunks, cap, step, smem, s)
}

}  // extern "C"
