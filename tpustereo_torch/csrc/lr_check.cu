// Left-right consistency from a precomputed right-view index map, alone or
// with the epipolar-intersection map of the Hirschmueller fill.
//
// Replaces: tpustereo/kernels/lr_pallas.py, dr_consistency_pallas: kernel
// body `_kernel` (lr_check_kernel) and, with with_hits=True, `_kernel_hits`
// (lr_hits_kernel).
//
// ok[i] = |dl - res| <= max_diff, with dl = rint(disp[i]) - d_start (round
// half to even) and res = d_r[row, x - dl] when 0 <= dl < min(D, W) and the
// lookup column is >= d_start (and >= 0); otherwise res = 1 << 20, which
// fails. d_r is the index map of the fused bwd+WTA kernel, in its shifted-
// column convention, so its first d_start columns hold right columns < 0.
// hits[x] = some j < min(D, W) has x - j >= d_start and
// |d_r[x - j] - j| <= max_diff.
// Inputs d_r int32 and disp float32, (rows, W); outputs bool (rows, W).
//
// Bound on this card: bytes (4 + 4 read and 1 written per pixel, 1 more for
// hits). The arithmetic is a handful of integer operations per pixel, and
// for hits about 40 more a column and 2 * max_diff + 1 flag stores: on the
// H100 that scatter takes about half of lr_hits_kernel's time.
//
// Design: lr_check_kernel is one thread per pixel doing a direct gather.
// The TPU kernels needed a loop of D lane rolls because the TPU has no
// cheap gather; this card has one. For hits, the TPU loop asks each pixel x
// about all D of its lookups; here each right-view column c instead sets
// the flags of the pixels that its value v = d_r[c] hits, x = c + j for j
// in [v - max_diff, v + max_diff], so a pixel costs O(max_diff), not O(D).
// lr_hits_kernel takes tiles of HITS_TILE pixels of the flattened (rows, W)
// map, a block each, so any W runs (a tile may span rows):
//   * the block stages d_r over [i0 - min(D, W) + 1, i0 + T), clipped to
//     the tile's first row, in shared memory by 16-byte loads: the tile and
//     its halo, every column whose hits can reach the tile. A halo past
//     LR_HALO columns is staged in turns, so shared memory is O(T + LR_HALO)
//     for any D (one turn for D <= 512);
//   * each staged column scatters its hits into the tile's T byte flags
//     in shared memory (racing stores all write 1), with 32-bit indices
//     relative to the tile and no sum that can overflow;
//   * the staging is cp.async, issued after the thread's disparity loads,
//     so the two overlap; each pixel then takes its ok lookup from the
//     staged columns (from d_r itself where the halo was staged in an
//     earlier turn);
//   * a thread handles groups of 4 pixels: disp by one 16-byte load, ok
//     and hits by one 4-byte store each (scalar at the map's ragged end).
//     The wrapper passes 16-byte aligned d_r and disp.
#include "common.cuh"

constexpr int LR_BIG = 1 << 20;

__device__ __forceinline__ bool lr_ok(const int32_t* d_r, float disp, long i,
                                      int x, int d_real, int max_diff,
                                      int d_start) {
  const int dl = __float2int_rn(disp) - d_start;
  int res = LR_BIG;
  if (dl >= 0 && dl < d_real) {
    const int col = x - dl;
    if (col >= d_start && col >= 0) res = d_r[i - dl];
  }
  return abs(dl - res) <= max_diff;
}

__global__ void lr_check_kernel(const int32_t* __restrict__ d_r,
                                const float* __restrict__ disp,
                                uint8_t* __restrict__ ok, long n, int W,
                                int d_real, int max_diff, int d_start) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ok[i] = lr_ok(d_r, disp[i], i, (int)(i % W), d_real, max_diff, d_start);
}

#ifndef LR_THREADS
#define LR_THREADS 256  // threads a hits block
#endif
#ifndef LR_GROUPS
#define LR_GROUPS 2  // groups of 4 pixels a thread
#endif
constexpr int HITS_TILE = LR_THREADS * LR_GROUPS * 4;
constexpr int LR_HALO = 512;  // halo columns staged in one turn (4 | it)
constexpr int HITS_WIN = HITS_TILE + LR_HALO + 4;  // int32 staged a turn

__global__ void __launch_bounds__(LR_THREADS)
    lr_hits_kernel(const int32_t* __restrict__ d_r,
                   const float* __restrict__ disp, uint8_t* __restrict__ ok,
                   uint8_t* __restrict__ hits, long n, int W, int d_real,
                   int max_diff, int d_start) {
  __shared__ __align__(16) int32_t win[HITS_WIN];
  __shared__ __align__(16) uint8_t flag[HITS_TILE];
  // indices below are relative to the tile's first pixel i0, in 32 bits:
  // the tile is [0, e), its first row starts at row0 <= 0, and the halo
  // at h0 = max(1 - d_real, row0)
  const long i0 = (long)blockIdx.x * HITS_TILE;
  const int e = (int)llmin(HITS_TILE, n - i0);
  const int row0 = -(int)(i0 % W);
  const int h0 = max(1 - d_real, row0);

  // this thread's disparities, loaded while the tile is staged
  float4 dv[LR_GROUPS];
#pragma unroll
  for (int g = 0; g < LR_GROUPS; ++g) {
    const int p = (g * LR_THREADS + threadIdx.x) * 4;
    reinterpret_cast<uint32_t*>(flag)[p / 4] = 0;
    if (p + 3 < e) {
      dv[g] = *reinterpret_cast<const float4*>(disp + i0 + p);
    } else {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; p + k < e; ++k) t[k] = disp[i0 + p + k];
      dv[g] = make_float4(t[0], t[1], t[2], t[3]);
    }
  }

  // the staged turns [a, b) from a 16-byte aligned start: d_r into win by
  // cp.async (scalar loads at the map's ragged end)
  int a = h0 - (int)((i0 + h0) & 3);
  for (;; a += HITS_WIN) {
    const int b = min(a + HITS_WIN, e);
    __syncthreads();  // flags clear; the last turn's scatter done with win
    for (int c = a + 4 * (int)threadIdx.x; c < b; c += 4 * LR_THREADS) {
      if (i0 + c + 3 < n) {
        cp_async<16>(win + (c - a), d_r + i0 + c);
      } else {
        for (int k = 0; i0 + c + k < n; ++k) win[c - a + k] = d_r[i0 + c + k];
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // each staged column's hits in the tile: x = c + j for j in
    // [v - max_diff, v + max_diff], [0, min(d_real, W - xc)) and
    // [-c, e - c), with no sum that overflows for any int32 v
    const int c0 = max(a, h0) + (int)threadIdx.x;
    int xc = (c0 - row0) % W;
    for (int c = c0; c < b; c += LR_THREADS) {
      if (xc >= d_start && max_diff >= 0) {
        const int v = win[c - a];
        const int top = min(d_real - 1, W - 1 - xc);
        const int lo = max(v < max_diff ? 0 : v - max_diff, -c);
        const int hi = min(v > top - max_diff ? top : v + max_diff,
                           e - 1 - c);
        for (int j = lo; j <= hi; ++j) flag[c + j] = 1;
      }
      xc += LR_THREADS;  // the next column's, wrapped into [0, W)
      if (xc >= W) {
        xc -= W;
        if (xc >= W) xc %= W;
      }
    }
    if (b == e) break;
  }
  __syncthreads();  // every scatter is in the flags

  // ok by the lookup into the last staged turn [a, e), or, for a halo
  // staged in an earlier turn, into d_r itself; 4 pixels a store
#pragma unroll
  for (int g = 0; g < LR_GROUPS; ++g) {
    const int p = (g * LR_THREADS + threadIdx.x) * 4;
    if (p >= e) break;
    const float d4[4] = {dv[g].x, dv[g].y, dv[g].z, dv[g].w};
    int x = (p - row0) % W;
    uint32_t okw = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k, x = x + 1 == W ? 0 : x + 1) {
      const int dl = __float2int_rn(d4[k]) - d_start;
      int res = LR_BIG;
      if (dl >= 0 && dl < d_real && x - dl >= d_start && x - dl >= 0) {
        const int at = p + k - dl;
        res = at >= a ? win[at - a] : d_r[i0 + at];
      }
      okw |= (uint32_t)(abs(dl - res) <= max_diff) << (8 * k);
    }
    const uint32_t hw = reinterpret_cast<const uint32_t*>(flag)[p / 4];
    if (p + 3 < e) {
      *reinterpret_cast<uint32_t*>(ok + i0 + p) = okw;
      *reinterpret_cast<uint32_t*>(hits + i0 + p) = hw;
    } else {
      for (int k = 0; p + k < e; ++k) {
        ok[i0 + p + k] = (uint8_t)(okw >> (8 * k));
        hits[i0 + p + k] = (uint8_t)(hw >> (8 * k));
      }
    }
  }
}

TPS_EXPORT int lr_check_launch(const int32_t* d_r, const float* disp,
                               uint8_t* ok, long n, int W, int D,
                               int max_diff, int d_start, void* stream) {
  const int threads = 256;
  const long blocks = (n + threads - 1) / threads;
  lr_check_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      d_r, disp, ok, n, W, min(D, W), max_diff, d_start);
  return (int)cudaGetLastError();
}

// One block a tile of HITS_TILE pixels; d_r and disp 16-byte aligned.
TPS_EXPORT int lr_hits_launch(const int32_t* d_r, const float* disp,
                              uint8_t* ok, uint8_t* hits, int rows, int W,
                              int D, int max_diff, int d_start, void* stream) {
  if (((uintptr_t)d_r | (uintptr_t)disp) % 16 != 0 ||
      ((uintptr_t)ok | (uintptr_t)hits) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long n = (long)rows * W;
  const long blocks = (n + HITS_TILE - 1) / HITS_TILE;
  lr_hits_kernel<<<(unsigned)blocks, LR_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      d_r, disp, ok, hits, n, W, min(D, W), max_diff, d_start);
  return (int)cudaGetLastError();
}
