// Backward (W) SGM sweep fused with WTA, uniqueness, subpixel and the
// right-view disparity.
//
// Replaces: tpustereo/kernels/sgm_pallas.py, sweep_bwd_wta (kernel body
// `_bwd_wta_kernel`, WTA step `_wta_from_S`) and its float decode.
//
// For each pixel it completes S = S7 + L_W, where S7 holds the other seven
// (or three) directions and L_W is the W path (predecessor x + 1), and never
// stores S. From S it takes:
//   * d* by one packed min (S * next_pow2(D) + d), ties to the lowest d;
//   * valid = !(second * 100 < best * (100 + ratio)), second the min over
//     |d - d*| > 1 (when the ratio is > 0);
//   * disp = float(d* + d_start) + the parabola offset from S[d*-1], S[d*+1]
//     (clamped reads), in the float32 op order of the reference, only for
//     interior d*; IEEE division, no contraction;
//   * d_r[x] = argmin_k S(x + k, k) over x + k < W, the right-view WTA as an
//     index map in the shifted-column convention of the JAX kernel (right
//     column x - d_start), by a rolling packed-min carry: slot i collects
//     column x - i's diagonal, slot 0 is complete at step x, and the carry
//     shifts one slot per step.
// Inputs C (B, H, W, D) uint8 and S7 (B, H, W, D) int16; outputs disp f32,
// valid bool and d_r int32, each (B, H, W).
//
// Bound on this card: bytes. It reads C and S7 once (3 bytes per cost) and
// writes 9 bytes per pixel, against about 15 integer operations per cost.
//
// Design: one warp walks one image row from x = W-1 down to 0; each lane
// keeps K = D/32 (rounded up to a power of two) disparities of the W carry,
// the completed S and the d_R carry in registers. The packed min, the
// second min and minLp are warp min-reduces; S[d*+-1] and the carry shift
// come by shuffle. The next column's C and S7 are loaded before the current
// column's step. Lane 0 writes the pixel's three outputs.
#include "common.cuh"

template <int K>
__global__ void bwd_wta_kernel(const uint8_t* __restrict__ C,
                               const int16_t* __restrict__ S7,
                               float* __restrict__ disp,
                               uint8_t* __restrict__ valid,
                               int32_t* __restrict__ d_r, int rows, int W,
                               int D, int p1, int p2, int uniq, int subpixel,
                               int d_start) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  int ps = 0;
  while ((1 << ps) < max(D, 2)) ++ps;
  const int mask = (1 << ps) - 1;
  const int big_pack = (1 << 20) << ps;  // above every real packed value

  int amin[K];
#pragma unroll
  for (int k = 0; k < K; ++k) amin[k] = big_pack;

  size_t pix = (size_t)row * W + (W - 1);
  int cv[K], sv[K], Lp[K], L[K];
  load_pixel<K>(C + pix * D, S7 + pix * D, lane, D, cv, sv);
#pragma unroll
  for (int k = 0; k < K; ++k) L[k] = lane * K + k < D ? cv[k] : SGM_BIG;
  int minLp = 0;
  for (int x = W - 1; x >= 0; --x) {
    int cn[K], sn[K];
    if (x > 0) load_pixel<K>(C + (pix - 1) * D, S7 + (pix - 1) * D, lane, D,
                             cn, sn);
    if (x < W - 1) sgm_step<K>(cv, Lp, minLp, lane, D, p1, p2, L);

    int St[K], packed[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      St[k] = d < D ? sv[k] + L[k] : SGM_BIG;
      packed[k] = d < D ? St[k] * (1 << ps) + d : big_pack;
    }
    float dv;
    bool ok;
    warp_wta<K>(St, packed, lane, D, ps, uniq, subpixel, d_start, dv, ok);

    // rolling right-view min: slot i <- min(slot i, packed[i]); slot 0 is
    // column x's finished diagonal; then every slot moves down by one
    int A[K];
#pragma unroll
    for (int k = 0; k < K; ++k) A[k] = min(amin[k], packed[k]);
    int nxt = __shfl_down_sync(FULL_MASK, A[0], 1);
    if (lane == 31) nxt = big_pack;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      amin[k] = k < K - 1 ? A[k + 1] : nxt;
      if (lane * K + k >= D - 1) amin[k] = big_pack;
    }

    if (lane == 0) {
      disp[pix] = dv;
      valid[pix] = ok;
      d_r[pix] = A[0] & mask;
    }
    if (x == 0) break;
    minLp = __reduce_min_sync(FULL_MASK, lane_min<K>(L));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      Lp[k] = L[k];
      cv[k] = cn[k];
      sv[k] = sn[k];
    }
    --pix;
  }
}

template <int K>
static void launch(const uint8_t* C, const int16_t* S7, float* disp,
                   uint8_t* valid, int32_t* d_r, int rows, int W, int D,
                   int p1, int p2, int uniq, int subpixel, int d_start,
                   cudaStream_t s) {
  const int threads = 128;
  const long blocks = ((long)rows * 32 + threads - 1) / threads;
  bwd_wta_kernel<K><<<(unsigned)blocks, threads, 0, s>>>(
      C, S7, disp, valid, d_r, rows, W, D, p1, p2, uniq, subpixel, d_start);
}

TPS_EXPORT int bwd_wta_launch(const uint8_t* C, const int16_t* S7,
                              float* disp, uint8_t* valid, int32_t* d_r,
                              int rows, int W, int D, int p1, int p2,
                              int uniq, int subpixel, int d_start,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPS_LAUNCH(KK)                                                      \
  launch<KK>(C, S7, disp, valid, d_r, rows, W, D, p1, p2, uniq, subpixel, \
             d_start, s)
  if (D <= 32) TPS_LAUNCH(1);
  else if (D <= 64) TPS_LAUNCH(2);
  else if (D <= 128) TPS_LAUNCH(4);
  else if (D <= 256) TPS_LAUNCH(8);
  else if (D <= 512) TPS_LAUNCH(16);
  else return (int)cudaErrorInvalidValue;
#undef TPS_LAUNCH
  return (int)cudaGetLastError();
}
