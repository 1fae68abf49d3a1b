// 3x3 median filter with edge replication, frame by frame.
//
// Replaces: tpustereo/kernels/median_pallas.py, median3_pallas (kernel body
// `_kernel`).
//
// out[f, y, x] is the median of the 3x3 window of in[f] around (y, x), with
// the window's coordinates clamped into frame f (edge replication never
// reaches into the next frame). The median of nine floats is one of them,
// chosen by min/max exchanges in float32; the -1.0 of an invalid pixel
// takes part like any value. Input and output float32 (F, H, W).
//
// Bound on this card: bytes (4 bytes read and 4 written per pixel). Paeth's
// 19-exchange network, the JAX kernel's, is 38 min/max a pixel, 30 once the
// unused halves go; at the float pipe's min/max rate that alone is close to
// the byte bound at KITTI size, so the design shares the exchanges.
//
// Design: a block takes a tile of TY rows x TX = 32 PX columns of one
// frame, a warp a row.
//   * Each lane takes PX adjacent pixels of its warp's row, starting where
//     that row's output is 16-byte aligned (up to 3 columns left of the
//     tile's own start), so a warp's results go out as contiguous 16-byte
//     stores; partial groups at the row's ends by single stores.
//   * It reads its (PX + 2) x 3 taps once, with their coordinates clamped
//     into the frame (the edge replication), straight from device memory:
//     the warps of neighbouring rows read the same lines, which L1 keeps.
//   * Each column triple of the lane's PX + 2 columns is sorted once and
//     serves the three pixels whose window holds it; each pixel then runs
//     the rest of Paeth's network on its three sorted columns (the window
//     transposed): max of the lows, min of the highs, median of the
//     middles, and the median of those three. About 12 + 6 (PX + 2) / PX
//     min/max a pixel. The result is the median under min/max, the same
//     value as the JAX kernel's (bit for bit on the card, signed zeros
//     included).
//   * Two builds are for measurement: MEDIAN_SMEM = 1 stages the tile and
//     a one-pixel halo in shared memory first (staged column c at word
//     c + c / PX of its row, so the lanes' reads, PX + 1 words apart, fall
//     in 32 banks), and MEDIAN_PAETH = 1 runs Paeth's network on each
//     pixel's window as the JAX kernel orders it. Both were slower; so was
//     staging by aligned 16-byte chunks, which rows of a width not a
//     multiple of 4 make cost more issue slots than the wide loads save.
#include "common.cuh"

#ifndef MEDIAN_PX
#define MEDIAN_PX 4  // adjacent pixels a lane (a multiple of 4)
#endif
#ifndef MEDIAN_TY
#define MEDIAN_TY 8  // rows a tile, a warp each
#endif
#ifndef MEDIAN_SMEM
#define MEDIAN_SMEM 0  // 1: the taps through a tile in shared memory
#endif
#ifndef MEDIAN_PAETH
#define MEDIAN_PAETH 0  // 1: Paeth's network on every window
#endif
constexpr int PX = MEDIAN_PX, TY = MEDIAN_TY, TX = 32 * PX;
constexpr int THREADS = 32 * TY;
constexpr int HALO = 4;            // staged columns either side of a tile
constexpr int SW = TX + 2 * HALO;  // staged columns a row
constexpr int SWP = SW + SW / PX;  // words a staged row
static_assert(PX % 4 == 0, "a lane's pixels must fill 16-byte stores");

// the word of staged column c in its row
__device__ __forceinline__ int skew(int c) { return c + c / PX; }

__device__ __forceinline__ void exch(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// The last ten exchanges of Paeth's network, on nine values whose triples
// (0, 1, 2), (3, 4, 5) and (6, 7, 8) are sorted; returns the median, t[4].
__device__ __forceinline__ float paeth_sorted(float (&t)[9]) {
  exch(t[0], t[3]); exch(t[5], t[8]); exch(t[4], t[7]);
  exch(t[3], t[6]); exch(t[1], t[4]); exch(t[2], t[5]);
  exch(t[4], t[7]); exch(t[4], t[2]); exch(t[6], t[4]);
  exch(t[4], t[2]);
  return t[4];
}

// Paeth's network, the JAX kernel's order, on t[dy * 3 + dx]
__device__ __forceinline__ float paeth(float (&t)[9]) {
  exch(t[1], t[2]); exch(t[4], t[5]); exch(t[7], t[8]);
  exch(t[0], t[1]); exch(t[3], t[4]); exch(t[6], t[7]);
  exch(t[1], t[2]); exch(t[4], t[5]); exch(t[7], t[8]);
  return paeth_sorted(t);
}

__global__ void __launch_bounds__(THREADS)
    median3_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int H, int W) {
  const int X0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const float* img = in + (long)blockIdx.z * H * W;
#if MEDIAN_SMEM
  // staged column c is image column X0 - HALO + c and staged row r image
  // row y0 - 1 + r, both clamped into the frame: a thread takes a column,
  // all its rows' loads in flight together
  __shared__ float tile[(TY + 2) * SWP];
  for (int c = threadIdx.x; c < SW; c += THREADS) {
    const int x = min(max(X0 - HALO + c, 0), W - 1);
#pragma unroll
    for (int r = 0; r < TY + 2; ++r)
      tile[r * SWP + skew(c)] =
          img[(long)min(max(y0 - 1 + r, 0), H - 1) * W + x];
  }
  __syncthreads();
#endif

  const int ty = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int y = y0 + ty;
  if (y >= H) return;
  // columns left of the tile where this row's output is 16-byte aligned
  const long row = (long)blockIdx.z * H * W + (long)y * W;
  const int sh = (int)((row + (uintptr_t)out % 16 / 4) & 3);
  const int xs = X0 - sh + PX * j;  // the lane's first column
  if (xs >= W) return;
  // v[r][i]: rows y - 1 + r, columns xs - 1 + i
  float v[3][PX + 2];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#if !MEDIAN_SMEM
    const float* src = img + (long)min(max(y - 1 + r, 0), H - 1) * W;
#endif
#pragma unroll
    for (int i = 0; i < PX + 2; ++i) {
#if MEDIAN_SMEM
      const int c = HALO - 1 - sh + i;  // staged column, less PX j
      v[r][i] = tile[(ty + r) * SWP + skew(c) + (PX + 1) * j];
#else
      v[r][i] = src[min(max(xs - 1 + i, 0), W - 1)];
#endif
    }
  }
  float res[PX];
#if MEDIAN_PAETH
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    float t[9];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) t[dy * 3 + dx] = v[dy][p + dx];
    res[p] = paeth(t);
  }
#else
#pragma unroll
  for (int i = 0; i < PX + 2; ++i) {  // sort each column: lo, mid, hi
    exch(v[1][i], v[2][i]);
    exch(v[0][i], v[1][i]);
    exch(v[1][i], v[2][i]);
  }
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    // the rest of Paeth's network on t[dx * 3 + dy], columns sorted
    float t[9];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) t[dx * 3 + dy] = v[dy][p + dx];
    res[p] = paeth_sorted(t);
  }
#endif
#pragma unroll
  for (int g = 0; g < PX; g += 4) {
    const int x = xs + g;
    if (x >= 0 && x + 3 < W) {
      *reinterpret_cast<float4*>(out + row + x) =
          make_float4(res[g], res[g + 1], res[g + 2], res[g + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x + k >= 0 && x + k < W) out[row + x + k] = res[g + k];
    }
  }
}

TPS_EXPORT int median3_launch(const float* in, float* out, int F, int H,
                              int W, void* stream) {
  if ((uintptr_t)in % 4 != 0 || (uintptr_t)out % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  // the rows' outputs start up to 3 columns left of their tile
  const dim3 blocks((W + 3 + TX - 1) / TX, (H + TY - 1) / TY, F);
  median3_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, H, W);
  return (int)cudaGetLastError();
}
