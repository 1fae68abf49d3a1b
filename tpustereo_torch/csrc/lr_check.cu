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
// hits; the gather hits the same row, which sits in L1/L2). The arithmetic
// is a handful of integer operations per pixel, and 2 * max_diff + 1 flag
// stores per pixel for hits.
//
// Design: lr_check_kernel is one thread per pixel doing a direct gather.
// The TPU kernels needed a loop of D lane rolls because the TPU has no
// cheap gather; this card has one. For hits, the TPU loop asks each pixel x
// about all D of its lookups; here each right-view column c instead sets
// the flags of the pixels that its value v = d_r[c] hits, x = c + j for j
// in [v - max_diff, v + max_diff], in a row of W flags in shared memory
// (one block per row; racing stores all write 1), so a pixel costs
// O(max_diff) and not O(D).
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

__global__ void lr_hits_kernel(const int32_t* __restrict__ d_r,
                               const float* __restrict__ disp,
                               uint8_t* __restrict__ ok,
                               uint8_t* __restrict__ hits, int W, int d_real,
                               int max_diff, int d_start) {
  extern __shared__ uint8_t flag[];
  const long base = (long)blockIdx.x * W;
  for (int x = threadIdx.x; x < W; x += blockDim.x) flag[x] = 0;
  __syncthreads();
  for (int c = d_start + threadIdx.x; c < W; c += blockDim.x) {
    // j in [v - max_diff, v + max_diff] and [0, min(d_real, W - c)), in
    // 64 bits: v is any int32
    const long long v = d_r[base + c];
    const long long top = d_real < W - c ? d_real - 1 : W - 1 - c;
    const long long lo = v - max_diff > 0 ? v - max_diff : 0;
    const long long hi = v + max_diff < top ? v + max_diff : top;
    for (long long j = lo; j <= hi; ++j) flag[c + j] = 1;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    ok[base + x] =
        lr_ok(d_r, disp[base + x], base + x, x, d_real, max_diff, d_start);
    hits[base + x] = flag[x];
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

// One block per row of W; W bytes of shared memory.
TPS_EXPORT int lr_hits_launch(const int32_t* d_r, const float* disp,
                              uint8_t* ok, uint8_t* hits, int rows, int W,
                              int D, int max_diff, int d_start, void* stream) {
  if (W > 48 * 1024)
    cudaFuncSetAttribute(lr_hits_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, W);
  lr_hits_kernel<<<rows, 256, W, static_cast<cudaStream_t>(stream)>>>(
      d_r, disp, ok, hits, W, min(D, W), max_diff, d_start);
  return (int)cudaGetLastError();
}
