// Backward (W) SGM sweep fused with WTA, uniqueness, subpixel and the
// right-view disparity.
//
// Replaces: tpustereo/kernels/sgm_pallas.py, sweep_bwd_wta (kernel body
// `_bwd_wta_kernel`, WTA step `_wta_from_S`, its `p2_maps` operand) and its
// float decode.
//
// For each pixel it completes S = S7 + L_W, where S7 holds the other seven
// (or three) directions and L_W is the W path (predecessor x + 1), and never
// stores S to device memory. The W path's P2 is the scalar, or, given the
// left image I (B, H, W) uint8, P2'(x) = max(P1 + 1, P2 // max(1,
// |I(x) - I(x + 1)|)), unread at x = W - 1, where the path starts. From S it
// takes:
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
// valid bool and d_r int32, each (B, H, W). S is held as int16 between the
// sweep and the selection, exact while S7 + L_W < 2^15 (the wrapper
// requires 8 * (255 + P2) < 2^15; the fused route runs far below it).
//
// Bound on this card: bytes. It reads C and S7 once (3 bytes per cost) and
// writes 9 bytes per pixel, against about 15 integer operations per cost.
// The recurrence is a dependent chain of W steps per image row, so what
// limits a warp is the latency of a step, not instruction throughput.
//
// Design: one warp walks one image row from x = W-1 down to 0; each lane
// keeps K = D/32 (rounded up to a power of two, at least 4) disparities of
// the W carry and the d_R carry in registers.
//   * Loads run RING columns ahead: each lane copies its own K costs and K
//     partial sums of a column into a per-warp shared-memory ring by
//     cp.async (one group per column) and reads them back with one vector
//     load each. A lane reads only what it copied, so the ring needs no
//     barrier. Where D is not a multiple of K, or a base pointer is not
//     aligned, the lane fills its ring slot with plain loads instead.
//     D = 32 K (the presets' 128) has its own build with every lane full.
//   * Only sgm_step's shuffles and the minLp reduce stay on the chain. Each
//     step stores its column of S (int16) and each lane's packed min of its
//     K disparities into per-warp buffers of 32 columns, and updates the
//     d_R carry. When a chunk of 32 aligned columns is complete, lane c
//     selects column c by itself: the min of the 32 lane mins gives d*, the
//     lane mins away from d* and the few single values near it the second
//     min, two reads S[d*+-1]; then one coalesced store per output for the
//     32 pixels. The buffers' column strides are odd numbers of words, so
//     the lanes' reads of one index hit 32 banks. The sweep over a chunk
//     has no branch, so the compiler interleaves one column's selection
//     work with the next column's chain.
//   * Adaptive P2 (I given, the ADAPT build) follows the chunks: lane c
//     holds the image byte of column lo + c of the current chunk and,
//     loaded when that chunk starts, of the next chunk's column (a plain
//     load a chunk ahead). At a chunk's start each lane takes the byte of
//     its column's predecessor x + 1 by one shuffle (lane 31 the previous
//     chunk's first) and computes its column's P2'; each step takes its
//     column's P2' by one shuffle off the carry's chain.
#include "common.cuh"

#ifndef BWD_RING_DEPTH
#define BWD_RING_DEPTH 8  // columns in flight per warp (a power of two)
#endif
constexpr int RING = BWD_RING_DEPTH;
static_assert((RING & (RING - 1)) == 0, "ring depth must be a power of two");

constexpr int CHUNK = 32;  // columns selected together, one per lane
constexpr int LMW = 33;    // lane-min column stride in words (odd)

template <int K>
struct Layout {
  static constexpr int DP = 32 * K;       // disparities a warp holds
  static constexpr int SW = DP / 2 + 1;   // S column stride in words (odd)
  static constexpr size_t ring_s = (size_t)RING * DP * 2;
  static constexpr size_t ring_c = (size_t)RING * DP;
  static constexpr size_t sbuf = (size_t)CHUNK * SW * 4;
  static constexpr size_t lmbuf = (size_t)CHUNK * LMW * 4;
  static constexpr size_t warp_bytes =
      (ring_s + ring_c + sbuf + lmbuf + CHUNK * 4 + 15) / 16 * 16;
  static constexpr int warps = K == 4 ? 4 : (K == 8 ? 2 : 1);  // per block
};

// WTA, uniqueness and subpixel of one column of S, as `warp_wta` defines
// them; run by one lane. lm[l] is the packed min (S * 2^ps + d) of the K
// disparities lane l held in the sweep, col the column's D int16 values.
// The second min takes the lane mins of the lanes that hold no d within 1
// of d*, and the single values of the (at most two) lanes that do.
template <int K>
__device__ __forceinline__ void select_column(const int* lm,
                                              const int16_t* col, int D,
                                              int ps, int uniq, bool subpixel,
                                              int d_start, float& dv,
                                              bool& ok) {
  int m = lm[0];
#pragma unroll
  for (int l = 1; l < 32; ++l) m = min(m, lm[l]);
  const int best = m >> ps, j = m & ((1 << ps) - 1);
  ok = true;
  if (uniq > 0) {
    const int la = max(j - 1, 0) / K, lb = min(j + 1, D - 1) / K;
    int sec = WTA_BIG;
#pragma unroll
    for (int l = 0; l < 32; ++l)
      if ((l < la || l > lb) && l * K < D) sec = min(sec, lm[l] >> ps);
    const int d_end = min((lb + 1) * K, D);
    for (int d = la * K; d < d_end; ++d)
      if (abs(d - j) > 1) sec = min(sec, (int)col[d]);
    ok = !(sec * 100 < best * (100 + uniq));
  }
  int sm = 0, sp = 0;
  if (subpixel) {
    sm = col[max(j - 1, 0)];
    sp = col[min(j + 1, D - 1)];
  }
  dv = subpixel_disp(j, d_start, D, subpixel, sm, best, sp);
}

template <int K, bool ASYNC, bool FULL, bool ADAPT>
__global__ void __launch_bounds__(32 * Layout<K>::warps)
    bwd_wta_kernel(const uint8_t* __restrict__ C,
                   const int16_t* __restrict__ S7,
                   const uint8_t* __restrict__ I, float* __restrict__ disp,
                   uint8_t* __restrict__ valid, int32_t* __restrict__ d_r,
                   int rows, int W, int D, int p1, int p2, int uniq,
                   int subpixel, int d_start) {
  using Lay = Layout<K>;
  constexpr int DP = Lay::DP;
  if (FULL) D = DP;  // every lane full: the d < D masks fold away
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * Lay::warps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  uint8_t* mine = smem + (threadIdx.x >> 5) * Lay::warp_bytes;
  int16_t* ring_s = reinterpret_cast<int16_t*>(mine);
  uint8_t* ring_c = mine + Lay::ring_s;
  uint32_t* sbuf = reinterpret_cast<uint32_t*>(ring_c + Lay::ring_c);
  int* lmbuf = reinterpret_cast<int*>(sbuf + CHUNK * Lay::SW);
  int* dbuf = lmbuf + CHUNK * LMW;

  int ps = 0;
  while ((1 << ps) < max(D, 2)) ++ps;
  const int mask = (1 << ps) - 1;
  const int big_pack = (1 << 20) << ps;  // above every real packed value
  const int d0 = lane * K;
  const size_t row_pix = (size_t)row * W;

  // column x's costs and partial sums of this lane into its ring slot
  auto fill = [&](int x) {
    const int slot = (W - 1 - x) & (RING - 1);
    const size_t at = (row_pix + x) * D + d0;
    uint8_t* rc = ring_c + slot * DP + d0;
    int16_t* rs = ring_s + slot * DP + d0;
    if constexpr (ASYNC) {
      if (d0 < D) {
        cp_async<K>(rc, C + at);
        cp_async<2 * K>(rs, S7 + at);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        rc[k] = d0 + k < D ? C[at + k] : 0;
        rs[k] = d0 + k < D ? S7[at + k] : 0;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < RING; ++i) {
    if (W - 1 - i >= 0) fill(W - 1 - i);
    cp_async_commit();
  }

  // Lp = 0 and minLp = 0 make the first step L = C, the restart rule
  int amin[K], Lp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    amin[k] = big_pack;
    Lp[k] = 0;
  }
  int minLp = 0;
  // adaptive P2: the image byte of column lo + c of the chunk that starts
  // next (lane c), the first byte of the chunk before, the lane's P2'. The
  // next chunk's byte is loaded as the last use of the current one ends,
  // clamped into the row rather than predicated, so that it lands in the
  // register it is read from a chunk later: a copy or a select of it
  // would wait for the load where it is issued.
  auto image = [&](int x) {
    return (int)I[row_pix + min(max(x, 0), W - 1)];
  };
  int ibyte = 0, iedge = 0, p2v = p2, p2t = p2;
  if constexpr (ADAPT) ibyte = image(((W - 1) & ~(CHUNK - 1)) + lane);
  for (int hi = W - 1; hi >= 0;) {
    const int lo = hi & ~(CHUNK - 1);  // chunk of columns lo .. hi
    if constexpr (ADAPT) {
      // column W - 1 restarts: its predecessor's byte is never read
      int iright = __shfl_down_sync(FULL_MASK, ibyte, 1);
      if (lane == 31) iright = iedge;
      iedge = __shfl_sync(FULL_MASK, ibyte, 0);
      p2v = max(p1 + 1, p2 / max(1, abs(ibyte - iright)));
      ibyte = image(lo - CHUNK + lane);
    }
#pragma unroll 2
    for (int x = hi; x >= lo; --x) {
      if constexpr (ADAPT) p2t = __shfl_sync(FULL_MASK, p2v, x - lo);
      cp_async_wait<RING - 1>();  // column x's group has landed
      const int slot = (W - 1 - x) & (RING - 1);
      int cv[K], sv[K], L[K];
      load_slice<K>(ring_c + slot * DP + d0, ring_s + slot * DP + d0, cv,
                    sv);
      sgm_step<K>(cv, Lp, minLp, lane, D, p1, p2t, L);
      int St[K];
#pragma unroll
      for (int k = 0; k < K; ++k) St[k] = sv[k] + L[k];
      // the slot is read: refill it RING columns ahead
      if (x - RING >= 0) fill(x - RING);
      cp_async_commit();

      // S of column x into the chunk buffer, K / 2 words a lane, and the
      // lane's packed min
      const int c = x - lo;
#pragma unroll
      for (int i = 0; i < K / 2; ++i)
        sbuf[c * Lay::SW + d0 / 2 + i] =
            (uint32_t)(St[2 * i] & 0xffff) | ((uint32_t)St[2 * i + 1] << 16);
      int packed[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        packed[k] = d0 + k < D ? St[k] * (1 << ps) + d0 + k : big_pack;
      lmbuf[c * LMW + lane] = lane_min<K>(packed);

      // rolling right-view min: slot i <- min(slot i, packed[i]); slot 0
      // is column x's finished diagonal; then every slot moves down by one
      int A[K];
#pragma unroll
      for (int k = 0; k < K; ++k) A[k] = min(amin[k], packed[k]);
      int nxt = __shfl_down_sync(FULL_MASK, A[0], 1);
      if (lane == 31) nxt = big_pack;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        amin[k] = k < K - 1 ? A[k + 1] : nxt;
        if (d0 + k >= D - 1) amin[k] = big_pack;
      }
      if (lane == 0) dbuf[c] = A[0] & mask;

      minLp = __reduce_min_sync(FULL_MASK, lane_min<K>(L));
#pragma unroll
      for (int k = 0; k < K; ++k) Lp[k] = L[k];
    }

    // the chunk is complete: lane c selects column lo + c
    __syncwarp();
    if (lane <= hi - lo) {
      float dv;
      bool ok;
      select_column<K>(lmbuf + lane * LMW,
                       reinterpret_cast<const int16_t*>(sbuf + lane * Lay::SW),
                       D, ps, uniq, subpixel != 0, d_start, dv, ok);
      const size_t pix = row_pix + lo + lane;
      disp[pix] = dv;
      valid[pix] = ok;
      d_r[pix] = dbuf[lane];
    }
    __syncwarp();
    hi = lo - 1;
  }
}

template <int K, bool ADAPT>
static int launch(const uint8_t* C, const int16_t* S7, const uint8_t* I,
                  float* disp, uint8_t* valid, int32_t* d_r, int rows, int W,
                  int D, int p1, int p2, int uniq, int subpixel, int d_start,
                  cudaStream_t s) {
  using Lay = Layout<K>;
  const int smem = (int)(Lay::warps * Lay::warp_bytes);
  const unsigned blocks = (unsigned)((rows + Lay::warps - 1) / Lay::warps);
  const bool aligned = D % K == 0 && (uintptr_t)C % 16 == 0 &&
                       (uintptr_t)S7 % 16 == 0;
  auto kernel = !aligned       ? bwd_wta_kernel<K, false, false, ADAPT>
                : D == Lay::DP ? bwd_wta_kernel<K, true, true, ADAPT>
                               : bwd_wta_kernel<K, true, false, ADAPT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, 32 * Lay::warps, smem, s>>>(C, S7, I, disp, valid, d_r,
                                               rows, W, D, p1, p2, uniq,
                                               subpixel, d_start);
  return (int)cudaGetLastError();
}

// I, the left image (rows, W) uint8, null for the scalar P2.
TPS_EXPORT int bwd_wta_launch(const uint8_t* C, const int16_t* S7,
                              const uint8_t* I, float* disp, uint8_t* valid,
                              int32_t* d_r, int rows, int W, int D, int p1,
                              int p2, int uniq, int subpixel, int d_start,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPS_ONE(KK, ADAPT)                                                 \
  return launch<KK, ADAPT>(C, S7, I, disp, valid, d_r, rows, W, D, p1, p2, \
                           uniq, subpixel, d_start, s)
#define TPS_LAUNCH(KK)     \
  if (I) TPS_ONE(KK, true); \
  TPS_ONE(KK, false)
  if (D <= 128) { TPS_LAUNCH(4); }
  if (D <= 256) { TPS_LAUNCH(8); }
  if (D <= 512) { TPS_LAUNCH(16); }
#undef TPS_LAUNCH
#undef TPS_ONE
  return (int)cudaErrorInvalidValue;
}
