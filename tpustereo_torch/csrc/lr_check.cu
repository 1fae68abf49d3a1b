// Left-right consistency from a precomputed right-view index map.
//
// Replaces: tpustereo/kernels/lr_pallas.py, dr_consistency_pallas (kernel
// body `_kernel`; the `with_hits` variant is not ported yet).
//
// ok[i] = |dl - res| <= max_diff, with dl = rint(disp[i]) - d_start (round
// half to even) and res = d_r[row, x - dl] when 0 <= dl < min(D, W) and the
// lookup column is >= d_start (and >= 0); otherwise res = 1 << 20, which
// fails. d_r is the index map of the fused bwd+WTA kernel, in its shifted-
// column convention, so its first d_start columns hold right columns < 0.
// Inputs d_r int32 and disp float32, (rows, W); output bool (rows, W).
//
// Bound on this card: bytes (4 + 4 read and 1 written per pixel; the gather
// hits the same row, which sits in L1/L2). The arithmetic is a handful of
// integer operations per pixel.
//
// Design: one thread per pixel doing a direct gather. The TPU kernel needed
// a loop of D lane rolls because it has no cheap gather; this card has one.
#include "common.cuh"

__global__ void lr_check_kernel(const int32_t* __restrict__ d_r,
                                const float* __restrict__ disp,
                                uint8_t* __restrict__ ok, long n, int W,
                                int d_real, int max_diff, int d_start) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % W);
  const int dl = __float2int_rn(disp[i]) - d_start;
  int res = 1 << 20;
  if (dl >= 0 && dl < d_real) {
    const int col = x - dl;
    if (col >= d_start && col >= 0) res = d_r[i - dl];
  }
  ok[i] = abs(dl - res) <= max_diff;
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
