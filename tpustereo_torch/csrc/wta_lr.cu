// WTA, uniqueness, subpixel and the left-right check over a cost volume.
//
// Replaces: tpustereo/kernels/wta_pallas.py, wta_lr_pallas (kernel body
// `_kernel`).
//
// For each pixel of S (B, H, W, D), uint8, int16 or int32 (the SAD volume
// of a block over 11; its costs, at most 255 * block^2, must stay below
// 2^20 so that the packed min fits in an int and the right map's fill of
// 1 << 20 exceeds every real cost), it computes `ops.wta`:
//   * d* by one packed min (S * next_pow2(D) + d), ties to the lowest d;
//   * valid = !(second * 100 < best * (100 + ratio)), second the min over
//     |d - d*| > 1 (when the ratio is > 0);
//   * disp = float(d* + d_start) + the parabola offset from S[d*-1],
//     S[d*+1] (clamped reads), only for interior d*, in the reference's
//     float32 op order;
// and, when max_diff >= 0, `ops.lr_check`: the right-view map d_R[x_r] =
// d_start + argmin_j S(x_r + d_start + j, j) (columns past the image read
// 1 << 20, so a right column no left pixel reaches gets d_start) in true
// right-column units, then valid &= |dl - d_R[x - dl]| <= max_diff with dl =
// rint(disp) (half to even); lookups left of column 0 and dl outside
// [d_start, d_start + D) fail. Outputs disp f32 and valid bool, (B, H, W),
// and, when asked (dR not null), the right-view map d_R itself as int32
// (B, H, W), for the hits map of the Hirschmueller fill.
//
// Bound on this card: bytes. It reads S once (1, 2 or 4 bytes per cost) and
// writes 5 bytes per pixel, against about 4 integer operations per cost
// (pack, min, second min; the right map adds a pack and a min).
//
// Design: tiles of up to WTA_TX pixels of one image row, so any width
// runs; blocks of one thread a pixel, as many as fit on the card at once,
// each walk every gridDim.x-th tile.
//   * A block's warps copy a tile's costs (contiguous in S) into shared
//     memory by 4-byte cp.async, all in flight together, at a pixel stride
//     of an odd number of words. A volume whose pixel is not a whole
//     number of words, or whose base is not 4-aligned, is copied by plain
//     loads instead. Other blocks on the SM select while one copies (a
//     second buffer, to copy the next tile ahead, measured no faster).
//   * Selection: one thread per pixel reads its costs a word at a time
//     (conflict-free at the odd stride). The card's integer pipe, at half
//     the rate of its float pipe, bounds this kernel's arithmetic, so where
//     a pixel is 32 or 64 words (the presets' volumes) `select_pixel`
//     takes minima of 16-bit pairs, three a DPX instruction, over groups
//     of 8 words, and reads single costs only in the groups around d*.
//     Other D take the packed min and the second min in two passes.
//   * Right map: one thread per right column of the tile's diagonals,
//     x_r = x - d_start - j for x in the tile, takes the packed min (one
//     IMAD, on the float pipe, and one min a cost) of its
//     S(x_r + d_start + j, j) from shared memory (lanes on neighbouring
//     pixels: conflict-free) and folds it once into a row map in device
//     memory by atomicMin (a column's diagonal crosses up to D - 1 tiles;
//     ties go to the lowest j as in the plain argmin). The launch fills the
//     map with 0x7f7f7f7f first, and a second kernel then reads it for the
//     LR check and d_R. Without the LR check and d_R there is one kernel.
#include "common.cuh"

#include <climits>

#ifndef WTA_TX
#define WTA_TX 128  // pixels a tile, at most
#endif
static_assert(WTA_TX <= 256, "a block is at most 256 threads");
constexpr int TILE_BYTES = 100 * 1024;  // shared memory a tile may take
constexpr int MAP_EMPTY = 0x7f7f7f7f;   // the fill; above every packed value

// Element e of a 32-bit word of shared memory holding 4 / sizeof(T) costs.
template <typename T>
__device__ __forceinline__ int elt(uint32_t w, int e) {
  if constexpr (sizeof(T) == 1) return (w >> (8 * e)) & 0xff;
  else if constexpr (sizeof(T) == 2)
    return e == 0 ? (int)(int16_t)(w & 0xffff) : (int)w >> 16;
  else return (int)w;
}

// Words of one pixel's D costs, and its odd stride in shared memory.
__host__ __device__ inline int pixel_words(int D, int size) {
  return (D * size + 3) / 4;
}
__host__ __device__ inline int pixel_stride(int D, int size) {
  return pixel_words(D, size) | 1;
}

// `ops.wta` of the pixel whose D costs lie at w (word k holds planes
// k * N .. k * N + N - 1, N = 4 / sizeof(T)) in shared memory: the packed
// min, the uniqueness flag and the disparity. NW > 0: the pixel is exactly
// NW words, in groups of 8. Each group's minimum comes from 16-bit pair
// mins (int16 words are pairs; uint8 words two pairs of bytes; int32 plain
// mins), the first group holding the least value gives d* by one scan of
// its 8 words, and the second min is the other groups' minima and a scan
// of the (at most two) groups holding d* - 1 .. d* + 1. NW = 0: any D,
// two passes over the costs.
template <typename T, int NW>
__device__ __forceinline__ void select_pixel(const uint32_t* w, int D, int ps,
                                             int uniq, int subpixel,
                                             int d_start, float& dv,
                                             bool& ok) {
  constexpr int N = 4 / sizeof(T);  // costs a word
  const int mask = (1 << ps) - 1;
  const T* c = reinterpret_cast<const T*>(w);
  int m;
  if constexpr (NW > 0) {
    constexpr int NG = NW / 8, GC = 8 * N;  // groups, costs a group
    static_assert(NW % 8 == 0, "groups of 8 words");
    int gmin[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      uint32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = w[g * 8 + i];
      if constexpr (N == 1) {
        int a = (int)v[0];
#pragma unroll
        for (int i = 1; i < 8; ++i) a = min(a, (int)v[i]);
        gmin[g] = a;
      } else {
        unsigned q;
        if constexpr (N == 2) {
          q = __vimin3_s16x2(__vimin3_s16x2(v[0], v[1], v[2]),
                             __vimin3_s16x2(v[3], v[4], v[5]),
                             min_s16x2(v[6], v[7]));
        } else {  // bytes 0, 2 and bytes 1, 3 of each word as s16 pairs
          q = min_s16x2(__byte_perm(v[0], 0, 0x4240),
                        __byte_perm(v[0], 0, 0x4341));
#pragma unroll
          for (int i = 1; i < 8; ++i)
            q = __vimin3_s16x2(q, __byte_perm(v[i], 0, 0x4240),
                               __byte_perm(v[i], 0, 0x4341));
        }
        gmin[g] = min((int)(int16_t)(q & 0xffff), (int)q >> 16);
      }
    }
    int best = gmin[0];
#pragma unroll
    for (int g = 1; g < NG; ++g) best = min(best, gmin[g]);
    int gs = 0;  // the first group holding the least value
#pragma unroll
    for (int g = NG - 1; g >= 0; --g)
      if (gmin[g] == best) gs = g;
    int js = 0;  // its first plane of that value
    const uint32_t* wg = w + gs * 8;
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      const uint32_t v = wg[i];
#pragma unroll
      for (int e = N - 1; e >= 0; --e)
        if (elt<T>(v, e) == best) js = gs * GC + i * N + e;
    }
    m = best * (1 << ps) + js;
    ok = true;
    if (uniq > 0) {
      // groups ga .. gb hold the excluded planes js - 1 .. js + 1
      const int ga = max(js - 1, 0) / GC, gb = min(js + 1, D - 1) / GC;
      int sec = WTA_BIG;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        if (g < ga || g > gb) sec = min(sec, gmin[g]);
      for (int g = ga; g <= gb; ++g) {
        const uint32_t* wn = w + g * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t v = wn[i];
#pragma unroll
          for (int e = 0; e < N; ++e)
            if ((unsigned)(g * GC + i * N + e - js + 1) > 2u)
              sec = min(sec, elt<T>(v, e));
        }
      }
      ok = !(sec * 100 < best * (100 + uniq));
    }
  } else {
    const int nfull = D / N, tail = D - nfull * N;
    int m0 = INT_MAX, m1 = INT_MAX;
#pragma unroll 4
    for (int k = 0; k < nfull; ++k) {
      const uint32_t v = w[k];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int pk = elt<T>(v, e) * (1 << ps) + k * N + e;
        if (e % 2 == 0) m0 = min(m0, pk);
        else m1 = min(m1, pk);
      }
    }
    for (int j = nfull * N; j < nfull * N + tail; ++j)
      m0 = min(m0, (int)c[j] * (1 << ps) + j);
    m = min(m0, m1);
    const int best = m >> ps, js = m & mask;
    ok = true;
    if (uniq > 0) {
      int sec = WTA_BIG;
#pragma unroll 4
      for (int k = 0; k < nfull; ++k) {
        const uint32_t v = w[k];
#pragma unroll
        for (int e = 0; e < N; ++e)
          if ((unsigned)(k * N + e - js + 1) > 2u)
            sec = min(sec, elt<T>(v, e));
      }
      for (int j = nfull * N; j < nfull * N + tail; ++j)
        if ((unsigned)(j - js + 1) > 2u) sec = min(sec, (int)c[j]);
      ok = !(sec * 100 < best * (100 + uniq));
    }
  }
  const int best = m >> ps, js = m & mask;
  int sm = 0, sp = 0;
  if (subpixel) {
    sm = c[max(js - 1, 0)];
    sp = c[min(js + 1, D - 1)];
  }
  dv = subpixel_disp(js, d_start, D, subpixel, sm, best, sp);
}

// Copy tile `tile` of S (the pixels x0 .. x0 + npix - 1 of one row) into
// buf at the pixel stride SW, one pixel a warp at a time, and commit it as
// one cp.async group.
template <typename T, bool ASYNC, int NW>
__device__ __forceinline__ void copy_tile(const T* __restrict__ S,
                                          uint32_t* buf, size_t tile, int W,
                                          int D, int tx, int xtiles, int SW) {
  constexpr int N = 4 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t row = tile / xtiles;
  const int x0 = (int)(tile - row * xtiles) * tx;
  const int npix = min(tx, W - x0);
  const T* src = S + (row * W + x0) * D;
  if constexpr (ASYNC) {
    const int WP = NW > 0 ? NW : D / N;  // a pixel is WP whole words
    const uint32_t* g = reinterpret_cast<const uint32_t*>(src);
    for (int p = warp; p < npix; p += nwarps)
      for (int k = lane; k < WP; k += 32)
        cp_async<4>(buf + p * SW + k, g + (size_t)p * WP + k);
  } else {
    for (int p = warp; p < npix; p += nwarps) {
      T* dst = reinterpret_cast<T*>(buf + p * SW);
      for (int j = lane; j < D; j += 32) dst[j] = src[(size_t)p * D + j];
    }
  }
  cp_async_commit();
}

// NW > 0: D * sizeof(T) is 4 * NW bytes. Each block walks tiles
// blockIdx.x, + gridDim.x, ...: copies one, selects one pixel a thread,
// then takes the tile's diagonals of the right map.
template <typename T, bool ASYNC, int NW>
__global__ void __launch_bounds__(256)
    wta_select_kernel(const T* __restrict__ S, float* __restrict__ disp,
                      uint8_t* __restrict__ valid, int* __restrict__ map,
                      int rows, int W, int D, int tx, int xtiles, int mul,
                      int uniq, int subpixel, int d_start) {
  extern __shared__ __align__(16) uint32_t sh[];
  const int SW = pixel_stride(D, sizeof(T));
  const int tid = threadIdx.x;
  const size_t ntiles = (size_t)rows * xtiles;
  int ps = 0;
  while ((1 << ps) < max(D, 2)) ++ps;

  for (size_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    copy_tile<T, ASYNC, NW>(S, sh, tile, W, D, tx, xtiles, SW);
    cp_async_wait<0>();  // this thread's copies have landed
    __syncthreads();     // and every thread's
    const size_t row = tile / xtiles;
    const int x0 = (int)(tile - row * xtiles) * tx;
    const int npix = min(tx, W - x0);
    for (int p = tid; p < npix; p += blockDim.x) {
      float dv;
      bool ok;
      select_pixel<T, NW>(sh + p * SW, D, ps, uniq, subpixel, d_start, dv,
                          ok);
      const size_t o = row * W + x0 + p;
      disp[o] = dv;
      valid[o] = ok;
    }
    if (map != nullptr) {
      // diagonal t holds pixel t - (D - 1) + j at plane j: right column
      // x0 - d_start - (D - 1) + t
      const int step = SW * 4 + (int)sizeof(T);
      for (int t = tid; t < npix + D - 1; t += blockDim.x) {
        const int xr = x0 - d_start - (D - 1) + t;
        if (xr < 0) continue;
        const int jlo = max(0, D - 1 - t), jhi = min(D, npix + D - 1 - t);
        const uint8_t* a = reinterpret_cast<const uint8_t*>(sh) +
                           (t - (D - 1) + jlo) * SW * 4 + jlo * sizeof(T);
        // two chains for the latency; mul = 2^ps comes from the host, so
        // that the pack stays one IMAD
        auto cost = [&](const uint8_t* at) {
          return (int)*reinterpret_cast<const T*>(at);
        };
        int m0 = INT_MAX, m1 = INT_MAX;
        int j = jlo;
#pragma unroll 2
        for (; j + 1 < jhi; j += 2, a += 2 * step) {
          m0 = min(m0, cost(a) * mul + j);
          m1 = min(m1, cost(a + step) * mul + j + 1);
        }
        if (j < jhi) m0 = min(m0, cost(a) * mul + j);
        atomicMin(&map[row * W + xr], min(m0, m1));
      }
    }
    __syncthreads();  // the buffer is free for the next tile's copy
  }
}

// The LR check from the finished row maps, and d_R in true units.
__global__ void wta_lr_finish_kernel(const float* __restrict__ disp,
                                     uint8_t* __restrict__ valid,
                                     const int* __restrict__ map,
                                     int32_t* __restrict__ dR, size_t n,
                                     int W, int D, int d_start, int max_diff,
                                     int mask) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / W;
    const int x = (int)(i - row * W);
    if (max_diff >= 0 && valid[i]) {
      const int dl = __float2int_rn(disp[i]);
      const int col = x - dl;
      int G = WTA_BIG;
      if (col >= 0) {
        const int v = map[row * W + min(col, W - 1)];
        G = d_start + (v == MAP_EMPTY ? 0 : v & mask);
      }
      const int jl = dl - d_start;
      const int diff = jl >= 0 && jl < D ? abs(dl - G) : WTA_BIG;
      if (diff > max_diff) valid[i] = 0;
    }
    if (dR != nullptr) {
      const int v = map[i];
      dR[i] = d_start + (v == MAP_EMPTY ? 0 : v & mask);
    }
  }
}

// cudaFuncSetAttribute once per process and device for each build of the
// selection kernel (a block may take up to TILE_BYTES of shared memory),
// and the resident blocks for a grid that fills the card, cached by the
// block's threads and shared memory.
template <typename T, bool ASYNC, int NW>
static int configure(int threads, size_t smem, int* blocks) {
  static int done[64], sms[64];
  static size_t seen_smem[64][4];  // threads * 2^24 + smem
  static int seen_blocks[64][4];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidValue;
  auto kernel = wta_select_kernel<T, ASYNC, NW>;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TILE_BYTES);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return (int)e;
    done[dev] = 1;
  }
  const size_t key = ((size_t)threads << 24) + smem;
  for (int i = 0; i < 4; ++i)
    if (seen_smem[dev][i] == key) {
      *blocks = seen_blocks[dev][i];
      return 0;
    }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = max(per_sm, 1) * sms[dev];
  for (int i = 0; i < 4; ++i)
    if (seen_smem[dev][i] == 0) {
      seen_smem[dev][i] = key;
      seen_blocks[dev][i] = *blocks;
      break;
    }
  return 0;
}

template <typename T>
static int launch(const void* Sv, float* disp, uint8_t* valid, int32_t* dR,
                  int* map, int rows, int W, int D, int uniq, int subpixel,
                  int d_start, int max_diff, cudaStream_t s) {
  const T* S = static_cast<const T*>(Sv);
  const int stride = pixel_stride(D, sizeof(T)) * 4;
  const int tx = min(WTA_TX, TILE_BYTES / stride);
  if (tx < 1) return (int)cudaErrorInvalidValue;
  const int xtiles = (W + tx - 1) / tx;
  const size_t ntiles = (size_t)rows * xtiles;
  const size_t smem = (size_t)tx * stride;
  const bool need_map = max_diff >= 0 || dR != nullptr;
  const size_t n = (size_t)rows * W;
  const int threads = (tx + 31) / 32 * 32;  // one a pixel
  // the presets' pixels (uint8 and int16 D = 128, int32 D = 64) are 32
  // or 64 words: those run from registers
  const bool async = (D * sizeof(T)) % 4 == 0 && (uintptr_t)S % 4 == 0;
  const int words = (int)(D * sizeof(T) / 4);
  auto kernel = !async          ? wta_select_kernel<T, false, 0>
                : words == 32 ? wta_select_kernel<T, true, 32>
                : words == 64 ? wta_select_kernel<T, true, 64>
                              : wta_select_kernel<T, true, 0>;
  int resident = 0;
  const int rc =
      !async          ? configure<T, false, 0>(threads, smem, &resident)
      : words == 32 ? configure<T, true, 32>(threads, smem, &resident)
      : words == 64 ? configure<T, true, 64>(threads, smem, &resident)
                    : configure<T, true, 0>(threads, smem, &resident);
  if (rc != 0) return rc;
  if (need_map) {
    const cudaError_t e = cudaMemsetAsync(map, 0x7f, n * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t blocks = ntiles < (size_t)resident ? ntiles : resident;
  // mul = 2^ps as a value the compiler cannot see: packing stays one IMAD
  int ps = 0;
  while ((1 << ps) < (D > 2 ? D : 2)) ++ps;
  kernel<<<(unsigned)blocks, threads, smem, s>>>(
      S, disp, valid, need_map ? map : nullptr, rows, W, D, tx, xtiles,
      1 << ps, uniq, subpixel, d_start);
  if (need_map) {
    const size_t g = (n + 255) / 256;
    wta_lr_finish_kernel<<<(unsigned)(g < 8192 ? g : 8192), 256, 0, s>>>(
        disp, valid, map, dR, n, W, D, d_start, max_diff, (1 << ps) - 1);
  }
  return (int)cudaGetLastError();
}

// S is (rows, W, D) of elt-byte costs: uint8 (1), int16 (2) or int32 (4);
// dR may be null; map is rows x W int32 scratch, used when max_diff >= 0 or
// dR is wanted.
TPS_EXPORT int wta_lr_launch(const void* S, float* disp, uint8_t* valid,
                             int32_t* dR, int32_t* map, int rows, int W,
                             int D, int elt, int uniq, int subpixel,
                             int d_start, int max_diff, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 1024) return (int)cudaErrorInvalidValue;
  if (elt == 1)
    return launch<uint8_t>(S, disp, valid, dR, map, rows, W, D, uniq,
                           subpixel, d_start, max_diff, s);
  if (elt == 2)
    return launch<int16_t>(S, disp, valid, dR, map, rows, W, D, uniq,
                           subpixel, d_start, max_diff, s);
  if (elt == 4)
    return launch<int32_t>(S, disp, valid, dR, map, rows, W, D, uniq,
                           subpixel, d_start, max_diff, s);
  return (int)cudaErrorInvalidValue;
}
