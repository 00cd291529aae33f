// The greedy NMS keep-mask, for Hopper (sm_90a): the sweep that ends every
// NMS of the port (rotated, circle, the per-task circle NMS of CenterPoint,
// flip-TTA's class-aware merge), one launch for all the rows of a call.
//
// Replaces no Pallas kernel: the JAX package sweeps in a `lax.fori_loop`
// (robustpointclouds_tpu/ops/nms.py:36, `_suppression_sweep`), which XLA
// compiles into one device loop. Eager PyTorch has no such loop, and the
// port's plain version (kernels/greedy_nms.greedy_keep_ref) launches about
// seven small kernels for each of the N steps; this kernel puts the loop back
// on the device.
//
//     keep[r, i] = valid[r, i] and not any(keep[r, j] and over[r, j, i], j < i)
//
// over [R, N, N] and valid [R, N] are contiguous bool (one byte, 0 or 1),
// boxes in descending score order; over[r, j, i] means "j suppresses i" and
// is read row by row of j, so an asymmetric relation gives the loop's answer.
// A box that is not kept suppresses nothing. keep [R, N] is written whole.
// The relation is built outside (IoU or squared distance against the limit,
// by the torch ops of ops/nms.py), so every comparison rounds as the plain
// version's does.
//
// What bounds it on this card: the serial chain of N decisions, not bytes
// (R*N*N bytes are read once, 6 MB at CenterPoint's [24, 500, 500], 2 us
// at 3.35 TB/s). The design packs the relation once, then walks the chain
// in a warp:
//  (a) one block per row r: its warps pack the part of over[r] on and above
//      the diagonal into 64-bit words with __ballot_sync (word w of box j
//      holds over[r, j, 64w .. 64w+63]; the words below j's are never read),
//      and valid[r] likewise. The words go in shared memory when they fit
//      the 48 KB a block gets without opting in (N up to 612), else in a
//      global scratch buffer the wrapper allocates, so any N >= 1 runs.
//  (b) warp 0 walks the words in order. The candidates of word w are its
//      valid bits less the `removed` bits of the kept boxes of earlier
//      words; the warp takes the lowest candidate (__ffsll), keeps it, drops
//      the candidates its word suppresses, and its lanes OR its later words
//      into `removed` (lane u % 32 owns word u). So the chain costs a step a
//      kept box, not a step a candidate, and every branch is the same on
//      all lanes.
// It launches on the caller's stream, never synchronises, allocates nothing,
// and returns the launch's cudaError_t.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPack = 4;  // words a lane loads before it ballots them
constexpr int64_t kSmemBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
greedy_keep_kernel(const uint8_t* __restrict__ over, const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, uint64_t* scratch, int n, int words) {
  extern __shared__ uint64_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r = blockIdx.x;
  // [removed: words][valid, then kept: words][relation: n x words]
  uint64_t* base = scratch ? scratch + r * (int64_t)words * (n + 2) : smem;
  uint64_t* removed = base;
  uint64_t* bits = base + words;
  uint64_t* rows = base + 2 * words;
  const uint8_t* rel = over + r * n * (int64_t)n;
  const uint8_t* v = valid + r * n;

  // (a) pack: a warp a box j, words from j's own onwards
  for (int j = warp; j < n; j += kWarps) {
    const uint8_t* src = rel + (int64_t)j * n;
    for (int w0 = j >> 6; w0 < words; w0 += kPack) {
      bool lo[kPack], hi[kPack];
#pragma unroll
      for (int k = 0; k < kPack; ++k) {  // i < n implies w0 + k < words
        const int i = (w0 + k) * 64 + lane;
        lo[k] = i < n && src[i] != 0;
        hi[k] = i + 32 < n && src[i + 32] != 0;
      }
#pragma unroll
      for (int k = 0; k < kPack; ++k) {
        const uint32_t a = __ballot_sync(0xffffffffu, lo[k]);
        const uint32_t b = __ballot_sync(0xffffffffu, hi[k]);
        if (lane == 0 && w0 + k < words) rows[(int64_t)j * words + w0 + k] = (uint64_t)b << 32 | a;
      }
    }
  }
  for (int w = warp; w < words; w += kWarps) {
    const int i = w * 64 + lane;
    const uint32_t a = __ballot_sync(0xffffffffu, i < n && v[i] != 0);
    const uint32_t b = __ballot_sync(0xffffffffu, i + 32 < n && v[i + 32] != 0);
    if (lane == 0) {
      bits[w] = (uint64_t)b << 32 | a;
      removed[w] = 0;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // (b) the chain, one warp
  for (int w = 0; w < words; ++w) {
    uint64_t cand = bits[w] & ~removed[w];
    uint64_t kept = 0;
    while (cand) {
      const int b = __ffsll(static_cast<long long>(cand)) - 1;
      const uint64_t* row = rows + ((int64_t)w * 64 + b) * words;
      kept |= 1ull << b;
      cand &= ~(row[w] | (1ull << b));
      for (int u = lane; u < words; u += 32)
        if (u > w) removed[u] |= row[u];
    }
    if (lane == 0) bits[w] = kept;
    __syncwarp();  // removed[w + 1] and bits[w] are read by every lane
  }
  uint8_t* out = keep + r * n;
  for (int i = lane; i < n; i += 32) out[i] = static_cast<uint8_t>((bits[i >> 6] >> (i & 63)) & 1);
}

}  // namespace

extern "C" {

// 64-bit words the kernel keeps for one row: removed, valid / kept and the
// relation. When words * 8 bytes fit kSmemBytes the caller passes scratch =
// null and they live in shared memory; else scratch holds rows times them.
int64_t rpc_greedy_keep_words(int64_t n) { return ((n + 63) / 64) * (n + 2); }

// over [rows, n, n], valid [rows, n] and keep [rows, n]: contiguous bool.
// Returns the cudaError_t of the launch (0 = success). The caller has checked
// shapes, types and devices, and that rows and n are at least 1.
int rpc_greedy_keep(const void* over, const void* valid, void* keep, void* scratch, int64_t rows,
                    int64_t n, void* stream) {
  if (rows < 1 || rows > INT32_MAX || n < 1 || n > INT32_MAX - 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = scratch ? 0 : rpc_greedy_keep_words(n) * 8;
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  greedy_keep_kernel<<<static_cast<unsigned>(rows), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(over), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), static_cast<uint64_t*>(scratch), static_cast<int>(n),
      static_cast<int>((n + 63) / 64));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
