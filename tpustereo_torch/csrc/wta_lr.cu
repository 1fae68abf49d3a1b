// WTA, uniqueness, subpixel and the left-right check over a cost volume.
//
// Replaces: tpustereo/kernels/wta_pallas.py, wta_lr_pallas (kernel body
// `_kernel`).
//
// For each pixel of S (B, H, W, D), uint8 or int16, it computes `ops.wta`:
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
// [d_start, d_start + D) fail. Outputs disp f32 and valid bool, (B, H, W).
//
// Bound on this card: bytes. It reads S once (1 or 2 bytes per cost) and
// writes 5 bytes per pixel, against about 4 integer operations per cost
// (pack, min, second min; the LR check adds a shared-memory atomicMin).
//
// Design: one block per image row; each warp takes one pixel at a time, its
// lanes holding K = D/32 (rounded up to a power of two) costs each, so the
// pixel's D costs are one coalesced read. The packed min, the second min
// and the subpixel neighbours are warp reduces and shuffles (`warp_wta`).
// The right-view map lives in shared memory as W packed minima: each cost
// S(x, j) folds into slot x - d_start - j by a shared-memory atomicMin
// (distinct warps can reach one slot), so S is read once and never along
// its strided diagonals. After a barrier each thread finishes its pixels'
// LR lookups from that map. Shared memory is 9 bytes per column (map,
// disparity, flag), which bounds W.
#include "common.cuh"

#include <climits>

template <typename T, int K>
__global__ void wta_lr_kernel(const T* __restrict__ S,
                              float* __restrict__ disp,
                              uint8_t* __restrict__ valid, int W, int D,
                              int uniq, int subpixel, int d_start,
                              int max_diff) {
  extern __shared__ int smem[];
  int* dr = smem;                                   // W packed right minima
  float* dsp = reinterpret_cast<float*>(smem + W);  // W disparities
  uint8_t* ok = reinterpret_cast<uint8_t*>(smem + 2 * W);  // W flags
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool lr = max_diff >= 0;
  int ps = 0;
  while ((1 << ps) < max(D, 2)) ++ps;
  const int mask = (1 << ps) - 1;

  if (lr)
    for (int i = threadIdx.x; i < W; i += blockDim.x) dr[i] = (1 << 20) << ps;
  __syncthreads();

  const size_t row = blockIdx.x;
  const T* Srow = S + row * W * D;
  for (int x = warp; x < W; x += nwarps) {
    const T* s = Srow + (size_t)x * D;
    int v[K], packed[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      v[k] = d < D ? (int)s[d] : 0;
      packed[k] = d < D ? v[k] * (1 << ps) + d : INT_MAX;
    }
    float dv;
    bool good;
    warp_wta<K>(v, packed, lane, D, ps, uniq, subpixel, d_start, dv, good);
    if (lr) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane * K + k;
        const int xr = x - d_start - d;
        if (d < D && xr >= 0) atomicMin(&dr[xr], packed[k]);
      }
    }
    if (lane == 0) {
      dsp[x] = dv;
      ok[x] = good;
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const float dv = dsp[x];
    bool good = ok[x];
    if (lr) {
      const int dl = __float2int_rn(dv);
      const int col = x - dl;
      const int G = col >= 0 ? d_start + (dr[min(col, W - 1)] & mask)
                             : WTA_BIG;
      const int jl = dl - d_start;
      const int diff = jl >= 0 && jl < D ? abs(dl - G) : WTA_BIG;
      good = good && diff <= max_diff;
    }
    disp[row * W + x] = dv;
    valid[row * W + x] = good;
  }
}

TPS_EXPORT size_t wta_lr_smem_bytes(int W) {
  return (size_t)W * (2 * sizeof(int) + 1);
}

template <typename T, int K>
static void launch(const void* S, float* disp, uint8_t* valid, int rows,
                   int W, int D, int uniq, int subpixel, int d_start,
                   int max_diff, cudaStream_t s) {
  const size_t smem = wta_lr_smem_bytes(W);
  cudaFuncSetAttribute(wta_lr_kernel<T, K>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  wta_lr_kernel<T, K><<<rows, 256, smem, s>>>(
      static_cast<const T*>(S), disp, valid, W, D, uniq, subpixel, d_start,
      max_diff);
}

template <typename T>
static int launch_k(const void* S, float* disp, uint8_t* valid, int rows,
                    int W, int D, int uniq, int subpixel, int d_start,
                    int max_diff, cudaStream_t s) {
#define TPS_LAUNCH(KK) \
  launch<T, KK>(S, disp, valid, rows, W, D, uniq, subpixel, d_start, \
                max_diff, s)
  if (D <= 32) TPS_LAUNCH(1);
  else if (D <= 64) TPS_LAUNCH(2);
  else if (D <= 128) TPS_LAUNCH(4);
  else if (D <= 256) TPS_LAUNCH(8);
  else if (D <= 512) TPS_LAUNCH(16);
  else return (int)cudaErrorInvalidValue;
#undef TPS_LAUNCH
  return 0;
}

// S is (rows, W, D), uint8 when int16 == 0 and int16 otherwise.
TPS_EXPORT int wta_lr_launch(const void* S, float* disp, uint8_t* valid,
                             int rows, int W, int D, int int16, int uniq,
                             int subpixel, int d_start, int max_diff,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = int16 ? launch_k<int16_t>(S, disp, valid, rows, W, D, uniq,
                                           subpixel, d_start, max_diff, s)
                       : launch_k<uint8_t>(S, disp, valid, rows, W, D, uniq,
                                           subpixel, d_start, max_diff, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
