// (B, H, W, D) -> (B, W, H, D) volume relayouts: a plain transpose of the
// two image axes, and the same with the sum of two int16 volumes.
//
// Replaces: tpustereo/kernels/transpose_pallas.py, transpose_hw_pallas
// (kernel body `_kernel`) and transpose_sum_hw_pallas (`_kernel_sum`),
// which the JAX volume route runs to hand S and C between the vertical and
// the horizontal sweep layouts. Nothing is padded: the TPU's (8, 128)
// tiles and its trim=False padding are layout, not output.
//
//   transpose_hw:     y[b, w, h, :] = x[b, h, w, :], any element size;
//   transpose_sum_hw: y[b, w, h, :] = a[b, h, w, :] + b[b, h, w, :], int16,
//                     wrapping as int16 addition does.
//
// Bound on this card: bytes. transpose_hw reads and writes each byte once;
// transpose_sum_hw reads two volumes and writes one, with one add per
// element.
//
// Design: the relayout moves whole D-runs (one pixel's D values), each
// contiguous in both layouts, so no shared-memory tile is needed for
// coalescing: each thread moves one vector of the widest width V (16, 8,
// 4, 2 or 1 bytes) that divides the run's bytes and both base addresses,
// and a warp's lanes cover consecutive vectors of consecutive runs of one
// output row. A block's grid row is one output row (b, w), whose H runs are
// contiguous in y; its grid column is a chunk of that row. Reads are
// contiguous within each run (128-256 bytes at D = 128), writes across the
// whole chunk. When the run's bytes are odd the width falls to 1 byte per
// thread, which is slow but exact. Offsets are 64-bit: a full-size volume
// of four Middlebury frames holds more than 2^31 values.
#include "common.cuh"

constexpr int TR_THREADS = 256;
constexpr int TR_UNITS = 8;  // vectors per thread per grid column

// Per-halfword int16 sums of packed vectors (wrapping, as int16 adds do).
__device__ __forceinline__ uint4 add_s16(uint4 a, uint4 b) {
  return make_uint4(__vadd2(a.x, b.x), __vadd2(a.y, b.y), __vadd2(a.z, b.z),
                    __vadd2(a.w, b.w));
}
__device__ __forceinline__ uint2 add_s16(uint2 a, uint2 b) {
  return make_uint2(__vadd2(a.x, b.x), __vadd2(a.y, b.y));
}
__device__ __forceinline__ unsigned add_s16(unsigned a, unsigned b) {
  return __vadd2(a, b);
}
__device__ __forceinline__ unsigned short add_s16(unsigned short a,
                                                  unsigned short b) {
  return (unsigned short)(a + b);
}

// nv vectors of type V per run; rows = B * W output rows of H runs each.
template <typename V, bool SUM>
__global__ void transpose_kernel(const V* __restrict__ x,
                                 const V* __restrict__ x2, V* __restrict__ y,
                                 int H, int W, int nv) {
  const size_t orow = blockIdx.x;  // b * W + w
  const size_t b = orow / W, w = orow % W;
  const int per_row = H * nv;
  V* out = y + orow * per_row;
  const size_t in_base = b * H * W + w;  // run index of (b, 0, w)
  for (int c = blockIdx.y; c * TR_THREADS * TR_UNITS < per_row;
       c += gridDim.y) {
    const int i0 = c * TR_THREADS * TR_UNITS + threadIdx.x;
    V v[TR_UNITS];
#pragma unroll
    for (int u = 0; u < TR_UNITS; ++u) {  // all loads in flight first
      const int i = i0 + u * TR_THREADS;
      if (i < per_row) {
        const int h = i / nv, k = i % nv;
        const size_t src = (in_base + (size_t)h * W) * nv + k;
        v[u] = x[src];
        if constexpr (SUM) v[u] = add_s16(v[u], x2[src]);
      }
    }
#pragma unroll
    for (int u = 0; u < TR_UNITS; ++u) {
      const int i = i0 + u * TR_THREADS;
      if (i < per_row) out[i] = v[u];
    }
  }
}

template <typename V, bool SUM>
static void launch(const void* x, const void* x2, void* y, int B, int H,
                   int W, int run_bytes, cudaStream_t s) {
  const int nv = run_bytes / (int)sizeof(V);
  const long per_row = (long)H * nv;
  const long cols = (per_row + TR_THREADS * TR_UNITS - 1) /
                    (TR_THREADS * TR_UNITS);
  const dim3 grid((unsigned)((long)B * W), (unsigned)(cols < 65535 ? cols
                                                                   : 65535));
  transpose_kernel<V, SUM><<<grid, TR_THREADS, 0, s>>>(
      static_cast<const V*>(x), static_cast<const V*>(x2),
      static_cast<V*>(y), H, W, nv);
}

// The widest vector width that divides the run's bytes and every address.
static int vec_bytes(int run_bytes, const void* a, const void* b,
                     const void* c) {
  const uintptr_t bits = (uintptr_t)run_bytes | (uintptr_t)a | (uintptr_t)b |
                         (uintptr_t)c;
  for (int v = 16; v > 1; v /= 2)
    if (bits % v == 0) return v;
  return 1;
}

static int check_shape(int B, int H, int W, int run_bytes) {
  // per-row vector indices stay well inside int
  if (B <= 0 || H <= 0 || W <= 0 || run_bytes <= 0 ||
      (long)B * W > 0x7fffffffL || (long)H * run_bytes > (1L << 30))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// x (B, H, W, run_bytes bytes per pixel) -> y (B, W, H, run_bytes).
TPS_EXPORT int transpose_hw_launch(const void* x, void* y, int B, int H,
                                   int W, int run_bytes, void* stream) {
  if (int rc = check_shape(B, H, W, run_bytes)) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes(run_bytes, x, y, y)) {
    case 16: launch<uint4, false>(x, x, y, B, H, W, run_bytes, s); break;
    case 8: launch<uint2, false>(x, x, y, B, H, W, run_bytes, s); break;
    case 4: launch<unsigned, false>(x, x, y, B, H, W, run_bytes, s); break;
    case 2:
      launch<unsigned short, false>(x, x, y, B, H, W, run_bytes, s);
      break;
    default: launch<uint8_t, false>(x, x, y, B, H, W, run_bytes, s);
  }
  return (int)cudaGetLastError();
}

// a, b (B, H, W, D) int16 -> y (B, W, H, D) int16 = (a + b) transposed.
TPS_EXPORT int transpose_sum_hw_launch(const int16_t* a, const int16_t* b,
                                       int16_t* y, int B, int H, int W,
                                       int D, void* stream) {
  const int run_bytes = D * (int)sizeof(int16_t);
  if (int rc = check_shape(B, H, W, run_bytes)) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes(run_bytes, a, b, y)) {
    case 16: launch<uint4, true>(a, b, y, B, H, W, run_bytes, s); break;
    case 8: launch<uint2, true>(a, b, y, B, H, W, run_bytes, s); break;
    case 4: launch<unsigned, true>(a, b, y, B, H, W, run_bytes, s); break;
    default: launch<unsigned short, true>(a, b, y, B, H, W, run_bytes, s);
  }
  return (int)cudaGetLastError();
}
