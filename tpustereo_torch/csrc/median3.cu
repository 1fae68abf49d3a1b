// 3x3 median filter with edge replication, frame by frame.
//
// Replaces: tpustereo/kernels/median_pallas.py, median3_pallas (kernel body
// `_kernel`).
//
// out[f, y, x] is the median of the 3x3 window of in[f] around (y, x), with
// the window's coordinates clamped into frame f (edge replication never
// reaches into the next frame). The median is Paeth's 19-exchange network
// of min/max pairs in the JAX kernel's order, in float32, so the result is
// the JAX kernel's bit for bit; the -1.0 of an invalid pixel takes part like
// any value. Input and output float32 (F, H, W).
//
// Bound on this card: bytes (4 bytes read and 4 written per pixel; the
// nine taps of neighbouring threads overlap and come from L1). The network
// is 38 min/max operations per pixel.
//
// Design: one thread per output pixel, 32 x 8 pixels per block, so a warp
// reads whole rows with neighbouring lanes on neighbouring addresses. The
// TPU kernel built three row-shifted copies of the image and rolled lanes
// because Mosaic cannot slice unaligned in-kernel; here each thread reads
// its taps directly with clamped indices.
#include "common.cuh"

__device__ __forceinline__ void exch(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

__global__ void median3_kernel(const float* __restrict__ in,
                               float* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long base = (long)blockIdx.z * H * W;
  const float* img = in + base;
  const int ys[3] = {max(y - 1, 0), y, min(y + 1, H - 1)};
  const int xs[3] = {max(x - 1, 0), x, min(x + 1, W - 1)};
  float t[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) t[dy * 3 + dx] = img[(long)ys[dy] * W + xs[dx]];
  exch(t[1], t[2]); exch(t[4], t[5]); exch(t[7], t[8]);
  exch(t[0], t[1]); exch(t[3], t[4]); exch(t[6], t[7]);
  exch(t[1], t[2]); exch(t[4], t[5]); exch(t[7], t[8]);
  exch(t[0], t[3]); exch(t[5], t[8]); exch(t[4], t[7]);
  exch(t[3], t[6]); exch(t[1], t[4]); exch(t[2], t[5]);
  exch(t[4], t[7]); exch(t[4], t[2]); exch(t[6], t[4]);
  exch(t[4], t[2]);
  out[base + (long)y * W + x] = t[4];
}

TPS_EXPORT int median3_launch(const float* in, float* out, int F, int H,
                              int W, void* stream) {
  const dim3 threads(32, 8);
  const dim3 blocks((W + 31) / 32, (H + 7) / 8, F);
  median3_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, H, W);
  return (int)cudaGetLastError();
}
