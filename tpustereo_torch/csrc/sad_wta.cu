// SAD block matching fused with WTA, uniqueness, subpixel and the right-view
// disparity; the (H, W, D) cost volume is never written to device memory.
//
// Replaces: tpustereo/kernels/sad_pallas.py, sad_wta_pallas (kernel body
// `_kernel`) and its float decode.
//
// For plane j (disparity d = d_start + j) the absolute difference is
// A(y, x) = |L(y, x) - R(y, x - d)|, or 255 where x - d < 0, and the cost
// S(y, x, j) sums A over the block x block window of rows y - r ..
// y - r + block - 1 and columns x - r .. x - r + block - 1 (r = block / 2),
// each coordinate clamped into the image: the reference edge-pads the
// filled volume, so a padded tap takes A at the replicated pixel, 255 fill
// included. From S it takes `ops.wta` (packed min, ties to the lowest j;
// uniqueness against the min over |j - j*| > 1; the parabola offset from
// the clamped neighbours S[j*-1], S[j*+1], interior j* only, in the
// reference's float32 op order) and, when d_r is wanted, the right-view
// index map in the shifted-column convention of the JAX kernel:
// d_r[x'] = argmin_k S(x' + k, k) over x' + k < W. S < 255 * block^2 <
// 2^20 (the wrapper checks), so packed values fit int32 and the 1 << 20
// fill past the image never wins.
// Inputs L, R (B, H, W) uint8; outputs disp f32, valid bool and d_r int32.
//
// Bound on this card: operations. The images are 2 bytes per pixel and the
// outputs 9, while every cost takes about 11 integer operations at least
// (difference, abs, fill select, four running-sum adds, the packed-min
// and second-min folds): over 100 times the bytes' time at D = 64. This
// kernel spends about block + 20 per cost, since it sums the horizontal
// taps directly rather than by a running sum.
//
// Design: one block per band of `ty` output rows of one frame; it stages
// the ty + block - 1 (clamped) image rows of L and R in shared memory and
// loops over the planes. Per plane, one thread per column slides a
// vertical block-row sum down the band (two A evaluations per output row),
// writing a ty x W plane of vertical sums to shared memory; then each
// thread sums `block` of those per output pixel (columns clamped) and folds
// the cost into its pixels' state, which stays in registers. The right-view
// map is ty x W packed minima in shared memory: at plane k, pixel x alone
// writes slot x - k, so no two threads touch a slot between two barriers
// and no atomic is needed.
// Uniqueness and the subpixel neighbours are folded in the same single pass
// over the planes, although d* is known only at the end: each pixel keeps
// S of the previous plane, the prefix minima of S two planes back, the min
// over the planes before d* - 1 (taken when d* moves) and the min over the
// planes after d* + 1 seen since; S[d*-1] is the previous plane's S when d*
// moves, S[d*+1] the next plane's. Storing each pixel's D costs instead
// would cap ty * W * D in shared memory; a second pass would recompute
// every cost.
// Occupancy: a one-frame launch (the presets' frames_per_step) has few
// pixels for 132 SMs, so each thread owns P = 8, 4, 2 or 1 pixels, the
// most that still leaves about 1024 threads per SM, and the band height is
// the largest of 8, 4, 2, 1 that the block's threads and shared memory
// hold.
#include "common.cuh"

#include <climits>

constexpr size_t SMEM_MAX = 232448;

// Threads per block for P pixels per thread: the register budget of eight
// pixels' state allows 512, of one or two 1024.
__host__ __device__ constexpr int max_threads(int pix) {
  return pix <= 2 ? 1024 : 512;
}

// The band's vertical sums of plane disparity d: V[y * W + x] = sum over
// block rows of A at smem rows y .. y + block - 1, column x.
__device__ __forceinline__ void vertical_sums(const uint8_t* Ls,
                                              const uint8_t* Rs, int* V,
                                              int W, int ty, int block,
                                              int d) {
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int xr = x - d;
    int acc = 0;
    if (xr < 0) {
      acc = 255 * block;
      for (int y = 0; y < ty; ++y) V[y * W + x] = acc;
      continue;
    }
    for (int i = 0; i < block; ++i)
      acc += abs((int)Ls[i * W + x] - (int)Rs[i * W + xr]);
    V[x] = acc;
    for (int y = 1; y < ty; ++y) {
      const int in = (y + block - 1) * W, out = (y - 1) * W;
      acc += abs((int)Ls[in + x] - (int)Rs[in + xr]) -
             abs((int)Ls[out + x] - (int)Rs[out + xr]);
      V[y * W + x] = acc;
    }
  }
}

// S at band pixel (row offset yW = y * W, column x) from the vertical sums.
__device__ __forceinline__ int box_sum(const int* V, int yW, int x, int W,
                                       int r, int block) {
  int s = 0;
  for (int dx = 0; dx < block; ++dx)
    s += V[yW + min(max(x - r + dx, 0), W - 1)];
  return s;
}

template <int PIX>
__global__ void __launch_bounds__(max_threads(PIX))
    sad_wta_kernel(const uint8_t* __restrict__ L,
                   const uint8_t* __restrict__ R, float* __restrict__ disp,
                   uint8_t* __restrict__ valid, int32_t* __restrict__ d_r,
                   int H, int W, int D, int block, int ty, int d_start,
                   int uniq, int subpixel, int with_dr) {
  extern __shared__ int smem[];
  const int r = block / 2, nrows = ty + block - 1, npix = ty * W;
  int* V = smem;                   // ty x W vertical sums of one plane
  int* drs = V + npix;             // ty x W packed right-view minima
  uint8_t* Ls = reinterpret_cast<uint8_t*>(drs + npix);  // nrows x W
  uint8_t* Rs = Ls + nrows * W;

  const int bands = (H + ty - 1) / ty;
  const int f = blockIdx.x / bands, y0 = (blockIdx.x % bands) * ty;
  const size_t fbase = (size_t)f * H * W;
  for (int i = threadIdx.x; i < nrows * W; i += blockDim.x) {
    const int rr = i / W, x = i - rr * W;
    const size_t src = fbase + (size_t)min(max(y0 - r + rr, 0), H - 1) * W + x;
    Ls[i] = L[src];
    Rs[i] = R[src];
  }
  if (with_dr)
    for (int i = threadIdx.x; i < npix; i += blockDim.x) drs[i] = INT_MAX;

  int ps = 0;
  while ((1 << ps) < max(D, 2)) ++ps;
  const int mask = (1 << ps) - 1;
  // per pixel: column, row offset, packed best, S[d*-1], S[d*+1], the min
  // over planes <= d*-2 and over planes >= d*+2, S of the previous plane,
  // the prefix minima up to the previous plane and the one before it
  int px[PIX], pyW[PIX], best[PIX], sm[PIX], sp[PIX], lo[PIX], hi[PIX];
  int prv[PIX], pm1[PIX], pm2[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    px[i] = p % W;
    pyW[i] = p - px[i];
    best[i] = INT_MAX;
    sm[i] = sp[i] = prv[i] = 0;
    lo[i] = hi[i] = pm1[i] = pm2[i] = WTA_BIG;
  }
  __syncthreads();

  for (int j = 0; j < D; ++j) {
    vertical_sums(Ls, Rs, V, W, ty, block, d_start + j);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      if (threadIdx.x + i * blockDim.x >= npix) break;
      const int s = box_sum(V, pyW[i], px[i], W, r, block);
      const int pk = s * (1 << ps) + j;
      const int js = best[i] & mask;
      if (pk < best[i]) {          // d* moves to j
        best[i] = pk;
        sm[i] = j > 0 ? prv[i] : s;
        sp[i] = s;                 // stays S[d*] if j is the last plane
        lo[i] = pm2[i];
        hi[i] = WTA_BIG;
      } else if (j == js + 1) {
        sp[i] = s;
      } else if (j >= js + 2) {
        hi[i] = min(hi[i], s);
      }
      pm2[i] = pm1[i];
      pm1[i] = min(pm1[i], s);
      prv[i] = s;
      if (with_dr && px[i] >= j) {
        int* slot = drs + pyW[i] + px[i] - j;
        *slot = min(*slot, pk);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    if (threadIdx.x + i * blockDim.x >= npix) break;
    const int y = y0 + pyW[i] / W;
    if (y >= H) continue;
    const size_t o = fbase + (size_t)y * W + px[i];
    const int b = best[i] >> ps, js = best[i] & mask;
    const int sec = min(lo[i], hi[i]);
    disp[o] = subpixel_disp(js, d_start, D, subpixel, sm[i], b, sp[i]);
    valid[o] = !(uniq > 0 && sec * 100 < b * (100 + uniq));
    if (with_dr) d_r[o] = drs[pyW[i] + px[i]] & mask;
  }
}

static size_t smem_bytes(int W, int block, int ty) {
  return (size_t)2 * ty * W * sizeof(int) + (size_t)2 * (ty + block - 1) * W;
}

// Whether a launch fits this width and block at all (one row per band,
// eight pixels per thread).
TPS_EXPORT int sad_wta_fits(int W, int block) {
  return W <= 8 * max_threads(8) && smem_bytes(W, block, 1) <= SMEM_MAX;
}

// Pixels per thread for B frames of H x W on `sms` SMs (see the note at the
// top), and the band height that goes with it; 0 if nothing fits.
static int plan(int B, int H, int W, int block, int sms, int* ty) {
  const long pixels = (long)B * H * W;
  int pix = 1;
  for (int p = 8; p > 1; p /= 2)
    if (pixels / p >= (long)sms * 1024) {
      pix = p;
      break;
    }
  for (; pix <= 8; pix *= 2)
    for (*ty = 8; *ty >= 1; *ty /= 2)
      if (*ty * W <= pix * max_threads(pix) &&
          smem_bytes(W, block, *ty) <= SMEM_MAX)
        return pix;
  return 0;
}

template <int PIX>
static void launch(const uint8_t* L, const uint8_t* R, float* disp,
                   uint8_t* valid, int32_t* d_r, int B, int H, int W, int D,
                   int block, int ty, int d_start, int uniq, int subpixel,
                   int with_dr, cudaStream_t s) {
  const size_t smem = smem_bytes(W, block, ty);
  const int threads = ((ty * W + PIX - 1) / PIX + 31) / 32 * 32;
  const long blocks = (long)B * ((H + ty - 1) / ty);
  cudaFuncSetAttribute(sad_wta_kernel<PIX>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  sad_wta_kernel<PIX><<<(unsigned)blocks, threads, smem, s>>>(
      L, R, disp, valid, d_r, H, W, D, block, ty, d_start, uniq, subpixel,
      with_dr);
}

TPS_EXPORT int sad_wta_launch(const uint8_t* L, const uint8_t* R,
                              float* disp, uint8_t* valid, int32_t* d_r,
                              int B, int H, int W, int D, int block,
                              int d_start, int uniq, int subpixel,
                              int with_dr, void* stream) {
  int dev = 0, sms = 0, ty = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPS_LAUNCH(P)                                                      \
  launch<P>(L, R, disp, valid, d_r, B, H, W, D, block, ty, d_start, uniq, \
            subpixel, with_dr, s)
  switch (plan(B, H, W, block, sms, &ty)) {
    case 1: TPS_LAUNCH(1); break;
    case 2: TPS_LAUNCH(2); break;
    case 4: TPS_LAUNCH(4); break;
    case 8: TPS_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TPS_LAUNCH
  return (int)cudaGetLastError();
}
