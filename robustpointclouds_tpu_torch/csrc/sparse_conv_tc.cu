// Sparse 3D convolution as bf16 tensor-core gather-GEMMs, for Hopper (sm_90a):
// the forward (which also serves the dgrad) and the weight gradient (wgrad)
// of the bfloat16 route. The float32 route keeps the CUDA-core kernels of
// sparse_conv.cu.
//
// Replaces the Pallas merge-path kernel `mp_gather_conv`
// (robustpointclouds_tpu/kernels/mp_gather.py:192) in its `out`, `bwd` and
// `col` modes, as sparse_conv.cu does, with the same contract:
//
//     forward: out[i, :] = sum_k feats[idx[i, k], :] @ W[k*Cin:(k+1)*Cin, :]
//     dgrad:   the forward on (g, W^T per tap, backward index);
//     wgrad:   dW[k*Cin + c, o] = sum_i feats[idx[i, k], c] * g[i, o].
//
// idx [M, K] int32, K <= 32, tap order of ops/sparse.kernel_offsets; an index
// outside [0, N) is a miss and reads a zero row. feats, W, g and out are
// bfloat16; products are exact in float32 and summed in float32 (mma.sync
// m16n8k16 bf16 -> f32); dW is float32 and deterministic.
//
// What bounds them: 2*hits*Cin*Cout operations over bytes that are mostly
// the index and the activations. At the SECOND encoder's widths (Cin, Cout
// <= 128) that is far below the tensor cores' ridge, so the work that
// matters is moving neighbour rows: these kernels gather them as 16-byte
// cp.async pieces (8-byte pieces for a width of 4 channels), several threads
// a row, and keep the products off the CUDA cores.
//  * forward / dgrad: one block of tile_m/16 warps per tile of tile_m output
//    rows, all Cout columns. The block reads its [tile_m, K] index slice
//    once (contiguous, coalesced) and finds which taps any row of the tile
//    hits; dead taps are skipped as a whole. For each live tap it gathers
//    the tile's neighbour rows and the tap's [Cin, Cout] weights into one
//    stage of a kStages ring by cp.async (a miss is a zero-fill copy: source
//    size 0 against the tensor's base address, nothing is read), so the next
//    taps' gathers are in flight while the warps run this tap's mma. Each
//    warp owns 16 rows: per 16-channel step one ldmatrix.x4 of A and, per
//    16 output columns, one ldmatrix.x4.trans of the row-major W feed two
//    m16n8k16 products. The float32 sums stay in registers across taps and
//    are rounded to bf16 once, staged in shared memory and stored as 16-byte
//    row pieces.
//  * wgrad: the CUDA-core wgrad's (row chunk, tap) grid, hit lists (warp
//    ballots, a fixed prefix, row order) and fixed-order reduce of float32
//    partials. The
//    listed hits' feats rows and g rows are staged as bf16 by cp.async, the
//    list padded to a multiple of 16 with zero rows, and the [Cin, Cout]
//    partial is A^T[Cin, hits] . G[hits, Cout]: ldmatrix.trans gives both
//    operands from their row-major hit rows. Each list's products are
//    summed in fresh registers and then added to the block's float32 sum,
//    so no mma chain is longer than one list. When Cin*Cout has fewer than
//    eight 16x16 tiles, warps split a list's 16-hit blocks in a fixed
//    pattern and their sums are merged in a fixed order.
// Shared rows hold their width plus kPad bf16 (16 bytes), so the eight rows
// an ldmatrix phase reads start on distinct 16-byte bank groups; widths are
// zero-padded to the template's (a power of two, at least 16) in shared
// memory, where the copies of pad columns are zero fills.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPad = 8;      // bf16 appended to every shared row (16 bytes)
constexpr int kStages = 3;   // the forward's ring of taps
constexpr int kMaxTaps = 32;
constexpr int kMaxTileM = 128;
constexpr int kWgradThreads = 256;
constexpr int kWgradWarps = kWgradThreads / 32;
constexpr int kMaxCap = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copy of `bytes` (16 or 8); src_bytes < bytes fills the
// rest of the destination with zeros (0: nothing is read from src)
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes, int src_bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d[16x8] += a[16x16] . b[16x8], bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `rows` shared rows of `width_pad` bf16 (pitch `pitch`) from global
// rows of `width` bf16: row r's source is src_row(r), or none (zero fill)
// where it returns nullptr. Pieces are 16 bytes, 8 when width % 8 != 0.
template <typename RowFn>
__device__ __forceinline__ void stage_rows(bf16* dst, int rows, int width_pad, int pitch,
                                           const bf16* base, int width, RowFn src_row) {
  const int gran = width % 8 == 0 ? 8 : 4;  // bf16 per piece
  const int per_row = width_pad / gran;     // a power of two
  const int shift = __ffs(per_row) - 1;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e >> shift;
    const int c = (e & (per_row - 1)) * gran;
    const bf16* row = c < width ? src_row(r) : nullptr;
    cp_async(smem_u32(dst + r * pitch + c), row ? row + c : base, gran * 2, row ? gran * 2 : 0);
  }
}

// ---------------------------------------------------------------- forward

template <int CIN, int COUT>
__host__ __device__ constexpr int fwd_stage_elems(int tile_m) {
  return tile_m * (CIN + kPad) + CIN * (COUT + kPad);
}

template <int CIN, int COUT>
__host__ __device__ constexpr int fwd_smem_bytes(int tile_m, int k_taps) {
  return (tile_m * k_taps * 4 + 15) / 16 * 16 +
         2 * (kStages * fwd_stage_elems<CIN, COUT>(tile_m) > tile_m * (COUT + kPad)
                  ? kStages * fwd_stage_elems<CIN, COUT>(tile_m)
                  : tile_m * (COUT + kPad));
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(2 * kMaxTileM)
sparse_conv_tc_fwd_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ w,
                          const int32_t* __restrict__ idx, bf16* __restrict__ out, int64_t n,
                          int64_t m, int k_taps, int cin, int cout, int tile_m) {
  constexpr int AP = CIN + kPad;
  constexpr int WP = COUT + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t live_s;
  int32_t* i_s = reinterpret_cast<int32_t*>(smem);  // [tile_m, K], misses as -1
  bf16* ring = reinterpret_cast<bf16*>(smem + (tile_m * k_taps * 4 + 15) / 16 * 16);
  const int a_elems = tile_m * AP;
  const int stage_elems = fwd_stage_elems<CIN, COUT>(tile_m);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
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
    bf16* a_s = ring + buf * stage_elems;
    stage_rows(a_s, tile_m, CIN, AP, feats, cin, [&](int r) -> const bf16* {
      const int32_t id = i_s[r * k_taps + k];
      return id >= 0 ? feats + static_cast<int64_t>(id) * cin : nullptr;
    });
    const bf16* wk = w + static_cast<int64_t>(k) * cin * cout;
    stage_rows(a_s + a_elems, CIN, COUT, WP, w, cout, [&](int c) -> const bf16* {
      return c < cin ? wk + static_cast<int64_t>(c) * cout : nullptr;
    });
  };

  float acc[COUT / 8][4];
#pragma unroll
  for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  const int n_live = __popc(live);
  uint32_t pending = live;  // taps not yet staged, lowest first
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (pending) {
      stage_tap(__ffs(pending) - 1, s);
      pending &= pending - 1;
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
  }
  // ldmatrix row addresses of this lane (see the fragment layouts of
  // mma.m16n8k16): A rows warp*16 + lane%16, columns +8 for lanes 16-31;
  // W rows (k) lane%8 + 8*((lane/8)%2), columns +8 for lanes 16-31
  const int a_off = (warp * 16 + (lane & 15)) * AP + (lane >> 4) * 8;
  const int w_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * WP + (lane >> 4) * 8;
  const bool busy = warp * 16 < rows;
  for (int i = 0; i < n_live; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tap i landed
    __syncthreads();               // everyone's; and tap i-1's stage is free
    if (pending) {
      stage_tap(__ffs(pending) - 1, (i + kStages - 1) % kStages);
      pending &= pending - 1;
    }
    cp_async_commit();
    if (busy) {
      const bf16* a_s = ring + (i % kStages) * stage_elems;
      const uint32_t a_addr = smem_u32(a_s + a_off);
      const uint32_t w_addr = smem_u32(a_s + a_elems + w_off);
#pragma unroll
      for (int kk = 0; kk < CIN / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a_addr + kk * 32, a);
#pragma unroll
        for (int j = 0; j < COUT / 16; ++j) {
          uint32_t b[4];
          ldsm_x4_t(w_addr + (kk * 16 * WP + j * 16) * 2, b);
          mma_bf16(acc[2 * j], a, b[0], b[1]);
          mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the bf16 output tile there

  // 3. one rounding to bf16; rows of 16-byte pieces (8 when cout % 8 != 0)
  bf16* o_s = ring;  // [tile_m, COUT + kPad]
  const int gr = lane >> 2;
  const int gc = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < COUT / 8; ++j) {
    bf16* p = o_s + (warp * 16 + gr) * WP + j * 8 + gc;
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(p + 8 * WP) = __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  const int gran = cout % 8 == 0 ? 8 : 4;
  const int per_row = cout / gran;
  for (int e = t; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * gran;
    bf16* dst = out + (m0 + r) * cout + c;
    const bf16* src = o_s + r * WP + c;
    if (gran == 8)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  }
}

template <int CIN, int COUT>
int launch_fwd(const void* feats, const void* w, const int32_t* idx, void* out, int64_t n,
               int64_t m, int k_taps, int cin, int cout, int tile_m, int smem,
               cudaStream_t stream) {
  if (smem != fwd_smem_bytes<CIN, COUT>(tile_m, k_taps))
    return static_cast<int>(cudaErrorInvalidValue);
  // always: the kernel's static shared word counts against the default 48 KB
  // too, so a plan of exactly 48 KB would be refused without it
  cudaError_t e = cudaFuncSetAttribute(sparse_conv_tc_fwd_kernel<CIN, COUT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = (m + tile_m - 1) / tile_m;
  if (blocks > 0)
    sparse_conv_tc_fwd_kernel<CIN, COUT><<<static_cast<unsigned>(blocks), 2 * tile_m, smem,
                                           stream>>>(
        static_cast<const bf16*>(feats), static_cast<const bf16*>(w), idx,
        static_cast<bf16*>(out), n, m, k_taps, cin, cout, tile_m);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ wgrad

template <int CIN, int COUT>
struct WgradShape {
  static constexpr int AP = CIN + kPad;
  static constexpr int GP = COUT + kPad;
  static constexpr int UNITS = (CIN / 16) * (COUT / 16);  // 16x16 tiles of [Cin, Cout]
  static constexpr int TPW = UNITS >= kWgradWarps ? UNITS / kWgradWarps : 1;  // tiles a warp
  static constexpr int GROUPS = UNITS >= kWgradWarps ? 1 : kWgradWarps / UNITS;
  static constexpr int smem_bytes(int cap) {
    return (2 * cap * (AP + GP) + 4 * (2 * cap + kWgradWarps)) >
                   (GROUPS > 1 ? 4 * GROUPS * CIN * COUT : 0)
               ? 2 * cap * (AP + GP) + 4 * (2 * cap + kWgradWarps)
               : 4 * GROUPS * CIN * COUT;
  }
};

// One block per (row chunk, tap k), as in sparse_conv.cu: the block scans
// its chunk `step` rows at a time and appends the rows that hit tap k to a
// list in row order; when one more step could overflow `cap` entries, or
// the chunk ends, it stages the listed hits and multiplies them.
template <int CIN, int COUT>
__global__ void __launch_bounds__(kWgradThreads)
sparse_conv_tc_wgrad_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ g,
                            const int32_t* __restrict__ idx, float* __restrict__ partial,
                            int64_t n, int64_t m, int k_taps, int cin, int cout,
                            int64_t rows_per_chunk, int cap, int step) {
  typedef WgradShape<CIN, COUT> S;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);                   // [cap, CIN + kPad]
  bf16* g_s = a_s + cap * S::AP;                               // [cap, COUT + kPad]
  int32_t* hit_row = reinterpret_cast<int32_t*>(g_s + cap * S::GP);  // [cap]
  int32_t* hit_id = hit_row + cap;                             // [cap]
  int32_t* warp_cnt = hit_id + cap;                            // [kWgradWarps]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int k = blockIdx.y;
  // this warp's tiles: unit = warp + u*8 (all of a list's 16-hit blocks),
  // or, with fewer than 8 tiles, unit = warp % UNITS over the blocks
  // j = grp, grp + GROUPS, ...
  const int grp = S::GROUPS > 1 ? warp / S::UNITS : 0;
  const int a_lane = ((lane & 7) + (lane >> 4) * 8) * S::AP + ((lane >> 3) & 1) * 8;
  const int g_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * S::GP + (lane >> 4) * 8;

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

    // the hits' feats and g rows as bf16, zero rows up to a multiple of 16
    const int count16 = (count + 15) & ~15;
    stage_rows(a_s, count16, CIN, S::AP, feats, cin, [&](int r) -> const bf16* {
      return r < count ? feats + static_cast<int64_t>(hit_id[r]) * cin : nullptr;
    });
    stage_rows(g_s, count16, COUT, S::GP, g, cout, [&](int r) -> const bf16* {
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
      const uint32_t a_addr = smem_u32(a_s + a_lane + c0);
      const uint32_t g_addr = smem_u32(g_s + g_lane + o0);
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int j = grp; j < count16 / 16; j += S::GROUPS) {
        uint32_t a[4], b[4];
        ldsm_x4_t(a_addr + j * 16 * S::AP * 2, a);
        ldsm_x4_t(g_addr + j * 16 * S::GP * 2, b);
        mma_bf16(part[0], a, b[0], b[1]);
        mma_bf16(part[1], a, b[2], b[3]);
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
        const int c = c0 + (lane >> 2) + (q ? 8 : 0);
        const int o = o0 + h * 8 + (lane & 3) * 2;
        if (S::GROUPS > 1) {
          red[(grp * CIN + c) * COUT + o] = acc[u][h][q];
          red[(grp * CIN + c) * COUT + o + 1] = acc[u][h][q + 1];
        } else if (c < cin && o < cout) {  // cout % 4 == 0: o + 1 < cout
          *reinterpret_cast<float2*>(out + c * cout + o) = make_float2(acc[u][h][q], acc[u][h][q + 1]);
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
__global__ void sparse_conv_tc_wgrad_reduce_kernel(const float* __restrict__ partial,
                                                   float* __restrict__ dw, int64_t size,
                                                   int chunks) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= size) return;
  float v = 0.f;
  for (int ch = 0; ch < chunks; ++ch) v += partial[static_cast<int64_t>(ch) * size + q];
  dw[q] = v;
}

template <int CIN, int COUT>
int launch_wgrad(const void* feats, const void* g, const int32_t* idx, float* partial,
                 float* dw, int64_t n, int64_t m, int k_taps, int cin, int cout,
                 int64_t rows_per_chunk, int chunks, int cap, int step, int smem,
                 cudaStream_t stream) {
  if (smem != WgradShape<CIN, COUT>::smem_bytes(cap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(sparse_conv_tc_wgrad_kernel<CIN, COUT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(k_taps));
  sparse_conv_tc_wgrad_kernel<CIN, COUT><<<grid, kWgradThreads, smem, stream>>>(
      static_cast<const bf16*>(feats), static_cast<const bf16*>(g), idx, partial, n, m, k_taps,
      cin, cout, rows_per_chunk, cap, step);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t size = static_cast<int64_t>(k_taps) * cin * cout;
  sparse_conv_tc_wgrad_reduce_kernel<<<static_cast<unsigned>((size + 255) / 256), 256, 0,
                                       stream>>>(partial, dw, size, chunks);
  return static_cast<int>(cudaGetLastError());
}

// The padded widths the kernels are instantiated for: 16, 32, 64, 128.
int pad_index(int width) {
  return width <= 16 ? 0 : width <= 32 ? 1 : width <= 64 ? 2 : width <= 128 ? 3 : -1;
}

bool widths_ok(int cin, int cin_pad, int cout, int cout_pad) {
  const int pi = pad_index(cin), po = pad_index(cout);
  return cin > 0 && cout > 0 && cin % 4 == 0 && cout % 4 == 0 && pi >= 0 && po >= 0 &&
         cin_pad == (16 << pi) && cout_pad == (16 << po);
}

}  // namespace

#define RPC_DISPATCH(FN, CIN_PAD, COUT_PAD, ...)                                          \
  switch (pad_index(CIN_PAD) * 4 + pad_index(COUT_PAD)) {                                \
    case 0: return FN<16, 16>(__VA_ARGS__);                                              \
    case 1: return FN<16, 32>(__VA_ARGS__);                                              \
    case 2: return FN<16, 64>(__VA_ARGS__);                                              \
    case 3: return FN<16, 128>(__VA_ARGS__);                                             \
    case 4: return FN<32, 16>(__VA_ARGS__);                                              \
    case 5: return FN<32, 32>(__VA_ARGS__);                                              \
    case 6: return FN<32, 64>(__VA_ARGS__);                                              \
    case 7: return FN<32, 128>(__VA_ARGS__);                                             \
    case 8: return FN<64, 16>(__VA_ARGS__);                                              \
    case 9: return FN<64, 32>(__VA_ARGS__);                                              \
    case 10: return FN<64, 64>(__VA_ARGS__);                                             \
    case 11: return FN<64, 128>(__VA_ARGS__);                                            \
    case 12: return FN<128, 16>(__VA_ARGS__);                                            \
    case 13: return FN<128, 32>(__VA_ARGS__);                                            \
    case 14: return FN<128, 64>(__VA_ARGS__);                                            \
    case 15: return FN<128, 128>(__VA_ARGS__);                                           \
    default: return static_cast<int>(cudaErrorInvalidValue);                             \
  }

extern "C" {

// bf16 gather-GEMM (forward and dgrad). The launch plan comes from the
// wrapper (kernels/sparse_conv.gather_gemm_plan): cin_pad/cout_pad the
// padded widths, tile_m rows a block (2*tile_m threads), smem its dynamic
// shared memory, which must equal the layout's size. Pointers 16-byte
// aligned; returns the cudaError_t of the launch (0 = success).
int rpc_sparse_conv_tc_fwd(const void* feats, const void* w, const int32_t* idx, void* out,
                           int64_t n, int64_t m, int k_taps, int cin, int cout, int cin_pad,
                           int cout_pad, int tile_m, int smem, void* stream) {
  if (!widths_ok(cin, cin_pad, cout, cout_pad) || k_taps <= 0 || k_taps > kMaxTaps ||
      tile_m < 16 || tile_m > kMaxTileM || tile_m % 16 != 0 || n < 0 || m < 0 ||
      n >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RPC_DISPATCH(launch_fwd, cin_pad, cout_pad, feats, w, idx, out, n, m, k_taps, cin, cout,
               tile_m, smem, s)
}

// bf16 wgrad. partial: float32 scratch [chunks, K, Cin, Cout]; dw: float32
// [K*Cin, Cout]; chunks * rows_per_chunk covers M; cap a power of two in
// [16, 1024], step <= min(256, cap/2); smem as the wrapper's plan
// (kernels/sparse_conv.wgrad_plan) computes it.
int rpc_sparse_conv_tc_wgrad(const void* feats, const void* g, const int32_t* idx,
                             float* partial, float* dw, int64_t n, int64_t m, int k_taps,
                             int cin, int cout, int cin_pad, int cout_pad,
                             int64_t rows_per_chunk, int chunks, int cap, int step, int smem,
                             void* stream) {
  if (!widths_ok(cin, cin_pad, cout, cout_pad) || k_taps <= 0 || chunks <= 0 ||
      rows_per_chunk <= 0 || rows_per_chunk > (int64_t{1} << 30) ||
      static_cast<int64_t>(chunks) * rows_per_chunk < m || cap < 16 || cap > kMaxCap ||
      (cap & (cap - 1)) != 0 || step <= 0 || step > kWgradThreads || 2 * step > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RPC_DISPATCH(launch_wgrad, cin_pad, cout_pad, feats, g, idx, partial, dw, n, m, k_taps, cin,
               cout, rows_per_chunk, chunks, cap, step, smem, s)
}

}  // extern "C"
