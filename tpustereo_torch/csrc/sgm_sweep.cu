// One directional SGM sweep, accumulated into the partial sum S.
//
// Replaces: tpustereo/kernels/sgm_pallas.py, sgm_sweep (kernel body
// `_sweep_kernel`), which the JAX pipeline calls for the down, up and
// forward-E sweeps.
//
// For direction r = (dy, dx) it adds L_r to S in place, where
//   L_r(p) = C(p) + min(Lp, Lp(d-1) + P1, Lp(d+1) + P1, minLp + P2) - minLp
// over the predecessor p - r, and L_r(p) = C(p) where p - r lies outside
// the image (the JAX `has_prev` restart rule). C is (B, H, W, D) uint8 and
// S (B, H, W, D) int16; S stays exact because every sum of path costs is
// below paths * (census_bits + P2) < 2^15 (the pipeline refuses
// configurations where it is not).
//
// Bound on this card: bytes. Each launch reads C once and reads and writes
// S once, 5 bytes per cost, against about 8 integer operations per cost.
//
// Design (after the GPU SGM of arXiv 1610.04121): a path is a line of
// pixels whose recurrence reads only the previous pixel on the same line,
// so one warp walks one line: the rows for E/W, the columns for N/S and the
// W+H-1 diagonal lines for each diagonal. Each lane keeps K = D/32 (rounded
// up to a power of two) disparities of the carry in registers; Lp(d+-1)
// across lanes comes by shuffle and minLp by one warp min-reduce. Lines
// start at the image boundary with L = C, which is the restart rule. The
// next pixel's C and S are loaded before the current pixel's step, so the
// loads overlap the step's shuffle and reduce latency. Each pixel lies on
// exactly one line of a direction, so the read-modify-write of S needs no
// atomics.
#include "common.cuh"

template <int K>
__global__ void sgm_sweep_kernel(const uint8_t* __restrict__ C,
                                 int16_t* __restrict__ S, int B, int H, int W,
                                 int D, int dy, int dx, int p1, int p2) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int nlines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  if (warp >= B * nlines) return;  // the whole warp leaves together
  const int b = warp / nlines, li = warp % nlines;
  int y, x;
  if (dy == 0) {
    y = li;
    x = dx > 0 ? 0 : W - 1;
  } else if (dx == 0 || li < W) {
    y = dy > 0 ? 0 : H - 1;
    x = li;
  } else {  // diagonal lines that start on the first column
    const int j = li - W;
    y = dy > 0 ? 1 + j : H - 2 - j;
    x = dx > 0 ? 0 : W - 1;
  }
  const size_t base = (size_t)b * H * W;
  const size_t step = (ptrdiff_t)dy * W + dx;

  size_t pix = base + (size_t)y * W + x;
  int cv[K], sv[K], Lp[K], L[K];
  load_pixel<K>(C + pix * D, S + pix * D, lane, D, cv, sv);
#pragma unroll
  for (int k = 0; k < K; ++k) L[k] = lane * K + k < D ? cv[k] : SGM_BIG;
  int minLp = 0;
  bool first = true;
  while (true) {
    const int yn = y + dy, xn = x + dx;
    const bool more = yn >= 0 && yn < H && xn >= 0 && xn < W;
    int cn[K], sn[K];
    if (more) load_pixel<K>(C + (pix + step) * D, S + (pix + step) * D, lane,
                            D, cn, sn);
    if (!first) sgm_step<K>(cv, Lp, minLp, lane, D, p1, p2, L);
    int16_t* s = S + pix * D;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (d < D) s[d] = (int16_t)(sv[k] + L[k]);
      Lp[k] = L[k];
    }
    if (!more) break;
    minLp = __reduce_min_sync(FULL_MASK, lane_min<K>(L));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cv[k] = cn[k];
      sv[k] = sn[k];
    }
    first = false;
    pix += step;
    y = yn;
    x = xn;
  }
}

template <int K>
static void launch(const uint8_t* C, int16_t* S, int B, int H, int W, int D,
                   int dy, int dx, int p1, int p2, cudaStream_t s) {
  const int nlines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  const long warps = (long)B * nlines;
  const int threads = 128;
  const long blocks = (warps * 32 + threads - 1) / threads;
  sgm_sweep_kernel<K><<<(unsigned)blocks, threads, 0, s>>>(C, S, B, H, W, D,
                                                           dy, dx, p1, p2);
}

TPS_EXPORT int sgm_sweep_launch(const uint8_t* C, int16_t* S, int B, int H,
                                int W, int D, int dy, int dx, int p1, int p2,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) launch<1>(C, S, B, H, W, D, dy, dx, p1, p2, s);
  else if (D <= 64) launch<2>(C, S, B, H, W, D, dy, dx, p1, p2, s);
  else if (D <= 128) launch<4>(C, S, B, H, W, D, dy, dx, p1, p2, s);
  else if (D <= 256) launch<8>(C, S, B, H, W, D, dy, dx, p1, p2, s);
  else if (D <= 512) launch<16>(C, S, B, H, W, D, dy, dx, p1, p2, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
