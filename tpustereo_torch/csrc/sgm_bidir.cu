// The down and up vertical (or diagonal) SGM sweeps of one column shift, in
// one kernel.
//
// Replaces: tpustereo/kernels/sgm_pallas.py, sgm_sweep_bidir (kernel body
// `_bidir_kernel`), which the JAX `sgm_select_pallas` runs under the module
// toggle BIDIR_VERT.
//
// For the column shift dx it computes the path costs of r_d = (1, dx) and
// r_u = (-1, dx),
//   L_r(p) = C(p) + min(Lp, Lp(d-1) + P1, Lp(d+1) + P1, minLp + P2) - minLp
// over the predecessor p - r, with L_r(p) = C(p) where p - r lies outside
// the image, and writes Sd = L_rd and Su = L_ru (accumulate == 0) or adds
// them to Sd and Su (accumulate == 1). The wrapper runs one launch per dx,
// the first writing, so Sd and Su end as the sums over the dx set. C is
// (B, H, W, D) uint8, Sd and Su int16 of the same shape; int16 sums wrap,
// as the plain version's do.
//
// Bound on this card: bytes. The first launch reads C once and writes two
// int16 volumes (5 bytes per cost); each later one also reads them (9).
// About 18 integer operations per cost per launch (two chains).
//
// Design: the body of `sgm_sweep.cu` with two chains. One warp takes line
// li of direction r_d and line li of r_u; for every dx the two lines have
// the same length (one is the other flipped top to bottom), so the warp
// advances them in lockstep. The two recurrences are independent, so their
// shuffles, min-reduces and loads interleave: the instruction-level
// parallelism that the TPU kernel wanted from the same pairing. Each lane
// keeps K = D/32 (rounded up to a power of two) disparities of each carry
// in registers; the next pixel's C (and S) of both chains are loaded before
// the current step. Offsets are 64-bit.
#include "common.cuh"

template <int K, bool ACC>
__global__ void sgm_bidir_kernel(const uint8_t* __restrict__ C,
                                 int16_t* __restrict__ Sd,
                                 int16_t* __restrict__ Su, int B, int H,
                                 int W, int D, int dx, int p1, int p2) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int nlines = dx == 0 ? W : W + H - 1;
  if (warp >= B * nlines) return;  // the whole warp leaves together
  const int b = warp / nlines, li = warp % nlines;
  int yd, yu, x, n;  // start rows of the two lines, start column, length
  if (dx == 0 || li < W) {
    yd = 0;
    yu = H - 1;
    x = li;
    n = dx == 0 ? H : min(H, dx > 0 ? W - x : x + 1);
  } else {  // lines that start on the first (dx > 0) or last column
    const int j = li - W;
    yd = 1 + j;
    yu = H - 2 - j;
    x = dx > 0 ? 0 : W - 1;
    n = min(H - 1 - j, W);
  }
  const size_t base = (size_t)b * H * W;
  const size_t step_d = (ptrdiff_t)W + dx, step_u = (ptrdiff_t)dx - W;
  size_t pd = base + (size_t)yd * W + x, pu = base + (size_t)yu * W + x;

  int cd[K], sd[K], Lpd[K], Ld[K];
  int cu[K], su[K], Lpu[K], Lu[K];
  int minLd = 0, minLu = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) sd[k] = su[k] = 0;
  if (ACC) {
    load_pixel<K>(C + pd * D, Sd + pd * D, lane, D, cd, sd);
    load_pixel<K>(C + pu * D, Su + pu * D, lane, D, cu, su);
  } else {
    load_cost<K>(C + pd * D, lane, D, cd);
    load_cost<K>(C + pu * D, lane, D, cu);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool real = lane * K + k < D;
    Ld[k] = real ? cd[k] : SGM_BIG;
    Lu[k] = real ? cu[k] : SGM_BIG;
  }
  for (int t = 0; t < n; ++t) {
    const bool more = t + 1 < n;
    int cdn[K], sdn[K], cun[K], sun[K];
#pragma unroll
    for (int k = 0; k < K; ++k) sdn[k] = sun[k] = 0;
    if (more) {
      if (ACC) {
        load_pixel<K>(C + (pd + step_d) * D, Sd + (pd + step_d) * D, lane, D,
                      cdn, sdn);
        load_pixel<K>(C + (pu + step_u) * D, Su + (pu + step_u) * D, lane, D,
                      cun, sun);
      } else {
        load_cost<K>(C + (pd + step_d) * D, lane, D, cdn);
        load_cost<K>(C + (pu + step_u) * D, lane, D, cun);
      }
    }
    if (t > 0) {
      sgm_step<K>(cd, Lpd, minLd, lane, D, p1, p2, Ld);
      sgm_step<K>(cu, Lpu, minLu, lane, D, p1, p2, Lu);
    }
    int16_t* od = Sd + pd * D;
    int16_t* ou = Su + pu * D;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (d < D) {
        od[d] = (int16_t)(sd[k] + Ld[k]);
        ou[d] = (int16_t)(su[k] + Lu[k]);
      }
      Lpd[k] = Ld[k];
      Lpu[k] = Lu[k];
    }
    if (!more) break;
    minLd = __reduce_min_sync(FULL_MASK, lane_min<K>(Ld));
    minLu = __reduce_min_sync(FULL_MASK, lane_min<K>(Lu));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cd[k] = cdn[k];
      sd[k] = sdn[k];
      cu[k] = cun[k];
      su[k] = sun[k];
    }
    pd += step_d;
    pu += step_u;
  }
}

template <int K>
static void launch(const uint8_t* C, int16_t* Sd, int16_t* Su, int B, int H,
                   int W, int D, int dx, int p1, int p2, int accumulate,
                   cudaStream_t s) {
  const int nlines = dx == 0 ? W : W + H - 1;
  const long warps = (long)B * nlines;
  const int threads = 128;
  const long blocks = (warps * 32 + threads - 1) / threads;
  if (accumulate)
    sgm_bidir_kernel<K, true><<<(unsigned)blocks, threads, 0, s>>>(
        C, Sd, Su, B, H, W, D, dx, p1, p2);
  else
    sgm_bidir_kernel<K, false><<<(unsigned)blocks, threads, 0, s>>>(
        C, Sd, Su, B, H, W, D, dx, p1, p2);
}

TPS_EXPORT int sgm_bidir_launch(const uint8_t* C, int16_t* Sd, int16_t* Su,
                                int B, int H, int W, int D, int dx, int p1,
                                int p2, int accumulate, void* stream) {
  if (dx < -1 || dx > 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPS_LAUNCH(KK) \
  launch<KK>(C, Sd, Su, B, H, W, D, dx, p1, p2, accumulate, s)
  if (D <= 32) TPS_LAUNCH(1);
  else if (D <= 64) TPS_LAUNCH(2);
  else if (D <= 128) TPS_LAUNCH(4);
  else if (D <= 256) TPS_LAUNCH(8);
  else if (D <= 512) TPS_LAUNCH(16);
  else return (int)cudaErrorInvalidValue;
#undef TPS_LAUNCH
  return (int)cudaGetLastError();
}
