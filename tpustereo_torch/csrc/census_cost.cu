// Census transform + Hamming cost volume, fused in one pass.
//
// Replaces: tpustereo/kernels/cost_pallas.py, census_cost_volume_pallas
// (kernel body `_kernel`).
//
// Computes C[b, y, x, d] = popcount(cenL[y, x] ^ cenR[y, x - d_start - d]),
// or max_cost where x - d_start - d < 0, as a plain (B, H, W, D) uint8
// volume. Census: edge-replicated window, bits row-major with the centre
// skipped, bit set iff neighbour < centre; up to 64 bits.
//
// Bound on this card: the bytes of C written (B*H*W*D, one byte per cost);
// the inputs are 2*B*H*W bytes and the arithmetic (xor + popcount + select
// per cost) is below the card's integer rate.
//
// Design: a block takes a tile of TY image rows (of any frames) by TX
// output columns. It builds in shared memory the census words of the tile's
// left pixels and of the TX + D - 1 right columns the tile's disparities
// reach (x - d_start - D + 1 .. x - d_start), reading the image taps
// through the read-only cache (the 5x5 window of every preset unrolled);
// shared memory depends on D, not on W. Then each thread writes 16
// consecutive disparities of one pixel: it keeps the pixel's left word in
// a register, reads each right word it needs once, and stores the 16
// costs as one 16-byte streaming store. Words are 32-bit (`__popc`) when
// the window has at most 32 bits, as every preset's 5x5 does, else 64-bit.
// Where D is not a multiple of 16 (or the output is not 16-byte aligned)
// the same threads store byte by byte, the last group short.
#include "common.cuh"

#ifndef CENSUS_TX
#define CENSUS_TX 256
#endif
#ifndef CENSUS_TY
#define CENSUS_TY 2
#endif
constexpr int TX = CENSUS_TX;  // output columns per tile (a multiple of 16)
constexpr int TY = CENSUS_TY;  // image rows per tile
constexpr int THREADS = 256;

// The census word of pixel (y, x) of one frame. CH, CW > 0 fix the window
// at compile time (the presets' 5x5, so that the taps unroll); 0 takes
// ry, rx at run time.
template <typename Word, int CH, int CW>
__device__ __forceinline__ Word census_word(const uint8_t* __restrict__ img,
                                            int H, int W, int y, int x,
                                            int ry_rt, int rx_rt) {
  const int ry = CH > 0 ? CH / 2 : ry_rt, rx = CW > 0 ? CW / 2 : rx_rt;
  const uint8_t c = __ldg(img + (size_t)y * W + x);
  Word w = 0;
  int bit = 0;
#pragma unroll
  for (int dy = -ry; dy <= ry; ++dy) {
    const uint8_t* r = img + (size_t)min(max(y + dy, 0), H - 1) * W;
    Word part = 0;  // one word per tap row, so the rows' ORs run side by side
#pragma unroll
    for (int dx = -rx; dx <= rx; ++dx) {
      if (dy == 0 && dx == 0) continue;
      part |= (Word)(__ldg(r + min(max(x + dx, 0), W - 1)) < c) << bit;
      ++bit;
    }
    w |= part;
  }
  return w;
}

__device__ __forceinline__ uint32_t popc(uint32_t v) { return __popc(v); }
__device__ __forceinline__ uint32_t popc(uint64_t v) { return __popcll(v); }

// The 16 costs of d = dbase .. dbase + 15 of one pixel, packed 4 a word:
// r[15 - j] is the right word of d = dbase + j; j > lim is outside the
// right image (max_cost). EDGE = false when lim >= 15.
template <bool EDGE, typename Word>
__device__ __forceinline__ void costs16(Word wl, const Word* r, int lim,
                                        uint32_t max_cost, uint32_t (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;
      uint32_t c = popc(wl ^ r[15 - j]);
      if (EDGE && j > lim) c = max_cost;
      acc |= c << (8 * i);
    }
    v[q] = acc;
  }
}

template <typename Word, int CH, int CW, bool VEC16>
__global__ void __launch_bounds__(THREADS)
    census_cost_kernel(const uint8_t* __restrict__ left,
                       const uint8_t* __restrict__ right,
                       uint8_t* __restrict__ cost, int rows, int H, int W,
                       int D, int ry, int rx, int d_start, int max_cost) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int span = TX + D - 1;                   // right words a tile row
  // TY x span, after 16 words that the short last group of a D with
  // 16 not dividing it reads (and discards) at the first row's start
  Word* cen_r = reinterpret_cast<Word*>(smem) + 16;
  Word* cen_l = cen_r + TY * span;               // TY x TX
  const int r0 = blockIdx.x * TY, x0 = blockIdx.y * TX;
  const int rbase = x0 - d_start - (D - 1);      // right column of slot 0
  const int ntx = min(TX, W - x0);

  for (int i = threadIdx.x; i < TY * span; i += THREADS) {
    const int r = i / span, s = i - r * span;
    const int row = r0 + r, xr = rbase + s;
    if (row >= rows || xr < 0 || xr >= W) continue;
    const int b = row / H, y = row - b * H;
    cen_r[i] = census_word<Word, CH, CW>(right + (size_t)b * H * W, H, W, y,
                                         xr, ry, rx);
  }
  for (int i = threadIdx.x; i < TY * TX; i += THREADS) {
    const int r = i / TX, p = i - r * TX;
    const int row = r0 + r;
    if (row >= rows || p >= ntx) continue;
    const int b = row / H, y = row - b * H;
    cen_l[i] = census_word<Word, CH, CW>(left + (size_t)b * H * W, H, W, y,
                                         x0 + p, ry, rx);
  }
  __syncthreads();

  // a warp takes 16 pixels x 2 groups of 16 disparities: lane = pixel +
  // 16 * group, so its reads of one tap hit 32 banks and each pixel's two
  // groups fill one 32-byte sector
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pp = lane & 15, gi = lane >> 4;
  const int ng = (D + 15) >> 4, items = (TX / 16) * ((ng + 1) >> 1);
  for (int r = 0; r < TY && r0 + r < rows; ++r) {
    const Word* cr = cen_r + r * span;
#pragma unroll 2
    for (int it = warp; it < items; it += THREADS / 32) {
      const int p = (it % (TX / 16)) * 16 + pp;
      const int g = (it / (TX / 16)) * 2 + gi;
      if (p >= ntx || g >= ng) continue;
      const int dbase = 16 * g;
      const Word wl = cen_l[r * TX + p];
      const Word* rr = cr + p + D - 16 - dbase;   // slots of d = dbase + 15 ..
      const int lim = x0 + p - d_start - dbase;   // d = dbase + j real iff j <= lim
      uint8_t* out = cost + ((size_t)(r0 + r) * W + x0 + p) * D + dbase;
      uint32_t v[4];
      if (lim >= 15) costs16<false>(wl, rr, lim, max_cost, v);
      else costs16<true>(wl, rr, lim, max_cost, v);
      if constexpr (VEC16) {
        __stcs(reinterpret_cast<uint4*>(out), make_uint4(v[0], v[1], v[2],
                                                          v[3]));
      } else {
        const int nj = min(16, D - dbase);
        for (int j = 0; j < nj; ++j) out[j] = v[j >> 2] >> (8 * (j & 3));
      }
    }
  }
}

template <typename Word, int CH, int CW>
static int launch(const uint8_t* left, const uint8_t* right, uint8_t* cost,
                  int B, int H, int W, int D, int ch, int cw, int d_start,
                  int max_cost, cudaStream_t s) {
  const size_t smem = (16 + (size_t)TY * (TX + D - 1 + TX)) * sizeof(Word);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int rows = B * H;
  const dim3 grid((rows + TY - 1) / TY, (W + TX - 1) / TX);
  const bool vec = D % 16 == 0 && (uintptr_t)cost % 16 == 0;
  auto kernel = vec ? census_cost_kernel<Word, CH, CW, true>
                    : census_cost_kernel<Word, CH, CW, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, s>>>(left, right, cost, rows, H, W, D,
                                     ch / 2, cw / 2, d_start, max_cost);
  return (int)cudaGetLastError();
}

TPS_EXPORT int census_cost_launch(const uint8_t* left, const uint8_t* right,
                                  uint8_t* cost, int B, int H, int W, int D,
                                  int ch, int cw, int d_start, int max_cost,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ch == 5 && cw == 5)
    return launch<uint32_t, 5, 5>(left, right, cost, B, H, W, D, ch, cw,
                                  d_start, max_cost, s);
  if (ch * cw - 1 <= 32)
    return launch<uint32_t, 0, 0>(left, right, cost, B, H, W, D, ch, cw,
                                  d_start, max_cost, s);
  return launch<uint64_t, 0, 0>(left, right, cost, B, H, W, D, ch, cw,
                                d_start, max_cost, s);
}
