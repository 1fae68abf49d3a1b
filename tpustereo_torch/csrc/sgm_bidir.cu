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
// Bound on this card: bytes. The function reads C once and writes Sd and Su
// once, 5 bytes per cost over all its launches. This design runs one launch
// per dx: the first moves 5 bytes per cost, each later one 9 (it reads and
// rewrites Sd and Su), its floor. About 10 integer operations per cost and
// line (two lines a launch).
//
// Design: one warp walks line li of r_d and line li of r_u. For every dx the
// two lines have the same length (one is the other flipped top to bottom),
// so the warp advances them in lockstep. Each lane owns K = D/32 (rounded up
// to a power of two) contiguous disparities of both carries.
//   * Loads run RING pixels ahead: each lane copies its own K costs of both
//     lines (and its K partial sums of each, on the accumulating launches)
//     into a per-warp shared-memory ring by cp.async, one group a pixel, and
//     reads back only what it copied, so the ring needs no barrier. A lane
//     whose slice is under 4 bytes copies the aligned word that holds it.
//     Where D is not a multiple of 4 and of K, the lane fills its slot by
//     plain loads (the wrapper passes 16-byte aligned volumes).
//   * Where every lane is full (D = 32 K) and c_max + P1 + P2 < 2^15 (the
//     wrapper's `bidir_fits_s16x2`, with c_max = 255), the two lines are the
//     two signed 16-bit halves of one word, down low and up high: one
//     sgm_step_s16x2 and one warp_min_s16x2 a pixel advance both, the carry
//     renormalised (L itself is the same value as the int32 step's).
//     Elsewhere two int32 chains step side by side (sgm_step and
//     __reduce_min_sync each).
//   * Each lane writes its K int16 of each line with one vector store (8
//     bytes at K = 4); on the accumulating launches the ring's partial sums
//     are added per 16-bit half, wrapping as int16 does. Where the slice is
//     not aligned, scalar stores.
#include "common.cuh"

#ifndef BIDIR_RING_DEPTH
#define BIDIR_RING_DEPTH 8  // pixels in flight per warp (a power of two)
#endif
#ifndef BIDIR_WARPS
#define BIDIR_WARPS 4  // warps a block
#endif
#ifndef BIDIR_LINES
#define BIDIR_LINES 1  // line pairs a warp walks, one after another
#endif
#ifndef BIDIR_SCALAR_STORES
#define BIDIR_SCALAR_STORES 0  // 1: one 2-byte store per int16 (measurement)
#endif
#ifndef BIDIR_S16X2
#define BIDIR_S16X2 1  // 0: the int32 build for every request (measurement)
#endif
constexpr int RING = BIDIR_RING_DEPTH;
constexpr int WARPS = BIDIR_WARPS;
constexpr int LINES = BIDIR_LINES;
static_assert((RING & (RING - 1)) == 0, "ring depth must be a power of two");

// One ring slot of a warp: the two lines' costs (CB bytes a lane each),
// then, on the accumulating launches, their partial sums (SB bytes a lane).
template <int K, bool ACC>
struct Slot {
  static constexpr int CB = K < 4 ? 4 : K;
  static constexpr int SB = 2 * K < 4 ? 4 : 2 * K;
  static constexpr int cu = 32 * CB, sd = 64 * CB, su = 64 * CB + 32 * SB;
  static constexpr int bytes = ACC ? 64 * CB + 64 * SB : 64 * CB;
};

template <int K, bool ACC, bool PACKED, bool ALIGNED>
__global__ void __launch_bounds__(32 * WARPS)
    sgm_bidir_kernel(const uint8_t* __restrict__ C, int16_t* __restrict__ Sd,
                     int16_t* __restrict__ Su, int B, int H, int W, int D,
                     int dx, int p1, int p2) {
  using Sl = Slot<K, ACC>;
  constexpr int NW = NWORDS(K);
  constexpr bool VEC = ALIGNED && !BIDIR_SCALAR_STORES;
  if (PACKED) D = 32 * K;  // every lane full: the d < D masks fold away
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  uint8_t* ring = smem + (threadIdx.x >> 5) * RING * Sl::bytes;
  const int nlines = dx == 0 ? W : W + H - 1;
  const long total = (long)B * nlines;
  const long first =
      ((long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * LINES;
  const long last = first + LINES < total ? first + LINES : total;
  const int d0 = lane * K;
  const bool mine = d0 < D;
  // where the lane's chunks start in a pixel's costs (bytes) and sums
  // (elements), and where its own slice starts in them
  const int c_sub = ALIGNED ? (d0 & 3) : 0, s_sub = ALIGNED ? (d0 & 1) : 0;
  const int c_at = d0 - c_sub, s_at = d0 - s_sub;
  uint8_t* my_cd = ring + lane * Sl::CB;
  uint8_t* my_cu = ring + Sl::cu + lane * Sl::CB;
  uint8_t* my_sd = ring + Sl::sd + lane * Sl::SB;
  uint8_t* my_su = ring + Sl::su + lane * Sl::SB;
  const unsigned p1x2 = (unsigned)p1 * 0x10001u, p2x2 = (unsigned)p2 * 0x10001u;

  for (long line = first; line < last; ++line) {
    const int b = (int)(line / nlines), li = (int)(line % nlines);
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
    const ptrdiff_t step_d = (ptrdiff_t)W + dx, step_u = (ptrdiff_t)dx - W;
    const size_t pd = base + (size_t)yd * W + x, pu = base + (size_t)yu * W + x;

    // pixel t of both lines into ring slot t % RING
    auto fill = [&](int t) {
      if (!mine) return;
      const int o = (t & (RING - 1)) * Sl::bytes;
      const size_t ad = (pd + t * step_d) * D, au = (pu + t * step_u) * D;
      if constexpr (ALIGNED) {
        cp_async<Sl::CB>(my_cd + o, C + ad + c_at);
        cp_async<Sl::CB>(my_cu + o, C + au + c_at);
        if constexpr (ACC) {
          cp_async<Sl::SB>(my_sd + o, Sd + ad + s_at);
          cp_async<Sl::SB>(my_su + o, Su + au + s_at);
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool real = d0 + k < D;
          my_cd[o + k] = real ? C[ad + d0 + k] : 0;
          my_cu[o + k] = real ? C[au + d0 + k] : 0;
          if constexpr (ACC) {
            int16_t* rs = reinterpret_cast<int16_t*>(my_sd + o);
            int16_t* ru = reinterpret_cast<int16_t*>(my_su + o);
            rs[k] = real ? Sd[ad + d0 + k] : 0;
            ru[k] = real ? Su[au + d0 + k] : 0;
          }
        }
      }
    };

#pragma unroll
    for (int i = 0; i < RING; ++i) {
      if (i < n) fill(i);
      cp_async_commit();
    }
    // a zero carry makes the first step L = C, the restart rule
    unsigned q[K];      // packed: the renormalised carry of both lines
    int Lpd[K], Lpu[K]; // int32: the carries
    int minLd = 0, minLu = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) q[k] = Lpd[k] = Lpu[k] = 0;

    for (int t = 0; t < n; ++t) {
      cp_async_wait<RING - 1>();  // pixel t's group has landed
      const int o = (t & (RING - 1)) * Sl::bytes;
      unsigned wd[(K + 3) / 4], wu[(K + 3) / 4], sd[NW] = {}, su[NW] = {};
      read_costs<K>(my_cd + o, c_sub, wd);
      read_costs<K>(my_cu + o, c_sub, wu);
      if constexpr (ACC) {
        read_sums<K>(my_sd + o, s_sub, sd);
        read_sums<K>(my_su + o, s_sub, su);
      }
      // the slot is read: refill it RING pixels ahead
      if (t + RING < n) fill(t + RING);
      cp_async_commit();

      unsigned od[NW], ou[NW];  // this pixel's L of each line, int16 pairs
      if constexpr (PACKED) {
        unsigned c[K], L[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          c[k] = __byte_perm(wd[k / 4], wu[k / 4],
                             (k % 4) | (4 + k % 4) << 8) & 0x00ff00ffu;
        sgm_step_s16x2<K>(c, q, lane, p1x2, p2x2, L);
        if constexpr (K == 1) {
          od[0] = L[0];
          ou[0] = L[0] >> 16;
        } else {
#pragma unroll
          for (int i = 0; i < K / 2; ++i) {
            od[i] = __byte_perm(L[2 * i], L[2 * i + 1], 0x5410);
            ou[i] = __byte_perm(L[2 * i], L[2 * i + 1], 0x7632);
          }
        }
        const unsigned M = warp_min_s16x2<K>(L);
#pragma unroll
        for (int k = 0; k < K; ++k) q[k] = L[k] - M;  // no half borrows
      } else {
        int cd[K], cu[K], Ld[K], Lu[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          cd[k] = cost_byte(wd, k);
          cu[k] = cost_byte(wu, k);
        }
        sgm_step<K>(cd, Lpd, minLd, lane, D, p1, p2, Ld);
        sgm_step<K>(cu, Lpu, minLu, lane, D, p1, p2, Lu);
        if constexpr (K == 1) {
          od[0] = (unsigned)Ld[0];
          ou[0] = (unsigned)Lu[0];
        } else {
#pragma unroll
          for (int i = 0; i < K / 2; ++i) {
            od[i] = __byte_perm(Ld[2 * i], Ld[2 * i + 1], 0x5410);
            ou[i] = __byte_perm(Lu[2 * i], Lu[2 * i + 1], 0x5410);
          }
        }
        minLd = __reduce_min_sync(FULL_MASK, lane_min<K>(Ld));
        minLu = __reduce_min_sync(FULL_MASK, lane_min<K>(Lu));
#pragma unroll
        for (int k = 0; k < K; ++k) {
          Lpd[k] = Ld[k];
          Lpu[k] = Lu[k];
        }
      }
      store_line<K, ACC, VEC>(Sd + (pd + t * step_d) * D + d0, od, sd, d0,
                              D);
      store_line<K, ACC, VEC>(Su + (pu + t * step_u) * D + d0, ou, su, d0,
                              D);
    }
  }
}

template <int K, bool ACC, bool PACKED, bool ALIGNED>
static int launch_one(const uint8_t* C, int16_t* Sd, int16_t* Su, int B,
                      int H, int W, int D, int dx, int p1, int p2,
                      cudaStream_t s) {
  auto kernel = sgm_bidir_kernel<K, ACC, PACKED, ALIGNED>;
  const int smem = WARPS * RING * Slot<K, ACC>::bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long lines = (long)B * (dx == 0 ? W : W + H - 1);
  const long warps = (lines + LINES - 1) / LINES;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  kernel<<<blocks, 32 * WARPS, smem, s>>>(C, Sd, Su, B, H, W, D, dx, p1, p2);
  return (int)cudaGetLastError();
}

template <int K>
static int launch(const uint8_t* C, int16_t* Sd, int16_t* Su, int B, int H,
                  int W, int D, int dx, int p1, int p2, int accumulate,
                  int packed, cudaStream_t s) {
#define TPS_ONE(ACC, PACKED, ALIGNED)                                    \
  return launch_one<K, ACC, PACKED, ALIGNED>(C, Sd, Su, B, H, W, D, dx, p1, \
                                             p2, s)
  if (packed) {
    if (accumulate) TPS_ONE(true, true, true);
    TPS_ONE(false, true, true);
  }
  if (D % K == 0 && D % 4 == 0) {
    if (accumulate) TPS_ONE(true, false, true);
    TPS_ONE(false, false, true);
  }
  if (accumulate) TPS_ONE(true, false, false);
  TPS_ONE(false, false, false);
#undef TPS_ONE
}

// packed != 0 asks for the s16x2 build, which needs D = 32 K and
// 255 + P1 + P2 < 2^15 (the wrapper's bidir_fits_s16x2 at c_max = 255);
// C, Sd and Su must be 16-byte aligned.
TPS_EXPORT int sgm_bidir_launch(const uint8_t* C, int16_t* Sd, int16_t* Su,
                                int B, int H, int W, int D, int dx, int p1,
                                int p2, int accumulate, int packed,
                                void* stream) {
  if (dx < -1 || dx > 1 || D < 1 || D > 512 || p1 < 0 || p2 < p1)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)C | (uintptr_t)Sd | (uintptr_t)Su) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int K = D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : D <= 256 ? 8 : 16;
  packed = packed && BIDIR_S16X2;
  if (packed && (D != 32 * K || 255 + p1 + p2 >= 1 << 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPS_LAUNCH(KK) \
  return launch<KK>(C, Sd, Su, B, H, W, D, dx, p1, p2, accumulate, packed, s)
  if (K == 1) TPS_LAUNCH(1);
  if (K == 2) TPS_LAUNCH(2);
  if (K == 4) TPS_LAUNCH(4);
  if (K == 8) TPS_LAUNCH(8);
  TPS_LAUNCH(16);
#undef TPS_LAUNCH
}
