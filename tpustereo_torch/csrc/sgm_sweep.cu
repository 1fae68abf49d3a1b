// One directional SGM sweep: writes L_r, or adds it to the partial sum S.
//
// Replaces: tpustereo/kernels/sgm_pallas.py, sgm_sweep (kernel body
// `_sweep_kernel`), which the JAX pipeline calls for the down, up, diagonal
// and horizontal sweeps; its first sweep of a schedule takes S_in = None and
// writes S, the later ones accumulate; with `p2_maps` (adaptive P2) each
// pixel has its own P2.
//
// For direction r = (dy, dx) it computes
//   L_r(p) = C(p) + min(Lp, Lp(d-1) + P1, Lp(d+1) + P1, minLp + P2) - minLp
// over the predecessor p - r, and L_r(p) = C(p) where p - r lies outside
// the image (the JAX `has_prev` restart rule). P2 is the scalar, or, given
// the left image I (B, H, W) uint8, P2'(p) = max(P1 + 1, P2 // max(1,
// |I(p) - I(p - r)|)) (the JAX `ops.sgm.p2_map`). It writes S = L_r
// (accumulate == 0) or adds it, S += L_r (accumulate == 1). C is
// (B, H, W, D) uint8 and S (B, H, W, D) int16; int16 sums wrap, as the
// plain version's do. The pipeline keeps every sum of paths below 2^15
// (`check_slice`), so its sums never wrap.
//
// Bound on this card: bytes. The write form reads C and writes S, 3 bytes
// a cost; the add form also reads S, 5 bytes a cost; about 9 integer
// operations a cost. The horizontal (E, W) sweeps have only B * H lines of
// W steps (1,500 warps at KITTI F = 4, 11 an SM), each step a dependent
// chain of two shuffles and a warp min: there a warp must keep several
// pixels' bytes in flight, or the chain's latency shows.
//
// Design (after the GPU SGM of arXiv 1610.04121): a path is a line of
// pixels whose recurrence reads only the previous pixel on the same line,
// so one warp walks one line: the rows for E/W, the columns for N/S and the
// W + H - 1 diagonal lines (most shorter than H) for each diagonal. Each
// lane keeps K = D/32 (rounded up to a power of two) contiguous
// disparities of the int32 carry in registers; Lp(d+-1) across lanes comes
// by shuffle and minLp by one __reduce_min_sync. A zero carry makes the
// first step L = C, the restart rule. Each pixel lies on exactly one line
// of a direction, so no atomics.
//   * Loads run RING pixels ahead: each lane copies its own K costs (and,
//     in the add form, its K partial sums) of a pixel into its slot of a
//     per-warp shared-memory ring by cp.async, one group a pixel, and reads
//     back only what it copied, so the ring needs no barrier. A line
//     shorter than the ring fills only its own pixels. Where D is not a
//     multiple of 4 and of K, or a base pointer is not 16-byte aligned, the
//     lane fills its slot by plain loads.
//   * A slot is the lane's fields side by side (`Slot`): the costs, then
//     the partial sums of the add form.
//   * Adaptive P2 (I given) keeps the image off the ring and off the
//     step's dependent chain: lane j holds the image byte of pixel t0 + j
//     of the line's current group of 32 pixels and, loaded when that group
//     starts, the byte of the next group's pixel (a plain load 32 to 63
//     pixels ahead; cp.async copies no single byte). At a group's start
//     each lane takes its predecessor's byte by one shuffle and computes
//     its pixel's P2' (one integer division a lane per 32 pixels); each
//     step takes its pixel's P2' from the lane that holds it by one more
//     shuffle, which depends on nothing of the carry. The image adds 1
//     byte a pixel against 3 or 5 a cost, 0.26 % or 0.16 % of the bytes at
//     D = 128. The scalar build has none of it (ADAPT is a template flag).
//   * Each lane writes its K int16 with one vector store (2K bytes; 8 at
//     D = 128), the add form's partial sums added per 16-bit half. Where
//     the slice is not aligned, scalar stores.
//   * D = 32 K (the presets' 128) has a build with every lane full.
//   * The ring hand-off between strips (the JAX kernel's `init_carry` /
//     `return_final_carry`, y-scanning directions only): Q (B, W, D) int32
//     holds q = L - min_d L of the row before the strip's first in sweep
//     order. A line that starts on the first row at column x, with
//     0 <= x - dx < W, loads its carry from Q[b, x - dx] (minLp = 0, since
//     q is renormalised); every other line restarts, as the JAX `has_prev`
//     rule gives (the diagonal lines that start on a side column have no
//     predecessor). Under adaptive P2 that first pixel's predecessor byte
//     comes from Ip (B, W), the image row of the carry. A line that ends
//     on the last row at column x writes its q to Fo[b, x]: each column of
//     that row ends exactly one line, so no atomics. The carry moves
//     2 W D 4 bytes a launch, about 1 MB at W = 1241, D = 128, against the
//     tens of MB of C and S. The packed E/W build takes no carry.
#include "common.cuh"

#ifndef SWEEP_RING_DEPTH
#define SWEEP_RING_DEPTH 8  // pixels in flight per warp (a power of two)
#endif
#ifndef SWEEP_WARPS
#define SWEEP_WARPS 4  // warps a block
#endif
#ifndef SWEEP_SCALAR_STORES
#define SWEEP_SCALAR_STORES 0  // 1: one 2-byte store per int16 (measurement)
#endif
#ifndef SWEEP_S16X2
#define SWEEP_S16X2 0  // 1: the E/W sweeps' carry as s16x2 pairs (measurement)
#endif
constexpr int RING = SWEEP_RING_DEPTH;
constexpr int WARPS = SWEEP_WARPS;
static_assert((RING & (RING - 1)) == 0, "ring depth must be a power of two");

// One ring slot of a warp: the lanes' costs (CB bytes a lane), then, in the
// add form, their partial sums (SB bytes a lane).
template <int K, bool ACC>
struct Slot {
  static constexpr int CB = K < 4 ? 4 : K;
  static constexpr int SB = 2 * K < 4 ? 4 : 2 * K;
  static constexpr int s = 32 * CB;
  static constexpr int bytes = ACC ? 32 * (CB + SB) : 32 * CB;
};

// `sgm_step` with the carry as s16x2 words of adjacent disparities (word i
// holds d0 + 2i low and d0 + 2i + 1 high), renormalised, q = Lp - min Lp,
// every lane full (D = 32 K, K >= 2). L = C + min(q, q(d-1) + P1,
// q(d+1) + P1, P2) per half in Hopper's DPX instructions; d = -1 and d = D
// have no path, so the other neighbour stands in for them. Exact while
// c_max + P1 + P2 < 2^15, the condition of `sgm_step_s16x2`.
template <int NW>
__device__ __forceinline__ void sgm_step_pairs(const unsigned (&c)[NW],
                                               const unsigned (&q)[NW],
                                               int lane, unsigned p1x2,
                                               unsigned p2x2,
                                               unsigned (&L)[NW]) {
  const unsigned left = __shfl_up_sync(FULL_MASK, q[NW - 1], 1);
  const unsigned right = __shfl_down_sync(FULL_MASK, q[0], 1);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    unsigned dn = __byte_perm(i == 0 ? left : q[i - 1], q[i], 0x5432);
    unsigned up = __byte_perm(q[i], i == NW - 1 ? right : q[i + 1], 0x5432);
    if (i == 0 && lane == 0) dn = __byte_perm(dn, up, 0x3254);
    if (i == NW - 1 && lane == 31) up = __byte_perm(up, dn, 0x7610);
    L[i] = c[i] + __vimin3_s16x2(q[i], __viaddmin_s16x2(up, p1x2, dn + p1x2),
                                 p2x2);
  }
}

template <int K, bool ACC, bool ALIGNED, bool FULL, bool PACKED, bool ADAPT>
__global__ void __launch_bounds__(32 * WARPS)
    sgm_sweep_kernel(const uint8_t* __restrict__ C, int16_t* __restrict__ S,
                     const uint8_t* __restrict__ I,
                     const int* __restrict__ Q, int* __restrict__ Fo,
                     const uint8_t* __restrict__ Ip, int B, int H, int W,
                     int D, int dy, int dx, int p1, int p2) {
  using Sl = Slot<K, ACC>;
  constexpr int NW = NWORDS(K);
  constexpr bool VEC = ALIGNED && !SWEEP_SCALAR_STORES;
  if (FULL) D = 32 * K;  // every lane full: the d < D masks fold away
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int nlines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  const long line = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (line >= (long)B * nlines) return;  // the whole warp leaves together
  uint8_t* ring = smem + (threadIdx.x >> 5) * RING * Sl::bytes;
  const int b = (int)(line / nlines), li = (int)(line % nlines);
  int y, x, n;  // start pixel and length of the line
  if (dy == 0) {
    y = li;
    x = dx > 0 ? 0 : W - 1;
    n = W;
  } else if (dx == 0 || li < W) {
    y = dy > 0 ? 0 : H - 1;
    x = li;
    n = dx == 0 ? H : min(H, dx > 0 ? W - x : x + 1);
  } else {  // diagonal lines that start on the first (dx > 0) or last column
    const int j = li - W;
    y = dy > 0 ? 1 + j : H - 2 - j;
    x = dx > 0 ? 0 : W - 1;
    n = min(H - 1 - j, W);
  }
  const ptrdiff_t step = (ptrdiff_t)dy * W + dx;
  const size_t p0 = (size_t)b * H * W + (size_t)y * W + x;
  const int d0 = lane * K;
  const bool mine = d0 < D;
  // where the lane's chunks start in a pixel's costs (bytes) and sums
  // (elements), and where its own slice starts in them
  const int c_sub = ALIGNED ? (d0 & 3) : 0, s_sub = ALIGNED ? (d0 & 1) : 0;
  const int c_at = d0 - c_sub, s_at = d0 - s_sub;
  uint8_t* my_c = ring + lane * Sl::CB;
  uint8_t* my_s = ring + Sl::s + lane * Sl::SB;

  // pixel t of the line into ring slot t % RING
  auto fill = [&](int t) {
    if (!mine) return;
    const int o = (t & (RING - 1)) * Sl::bytes;
    const size_t a = (p0 + t * step) * D;
    if constexpr (ALIGNED) {
      cp_async<Sl::CB>(my_c + o, C + a + c_at);
      if constexpr (ACC) cp_async<Sl::SB>(my_s + o, S + a + s_at);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool real = d0 + k < D;
        my_c[o + k] = real ? C[a + d0 + k] : 0;
        if constexpr (ACC)
          reinterpret_cast<int16_t*>(my_s + o)[k] = real ? S[a + d0 + k] : 0;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < RING; ++i) {
    if (i < n) fill(i);
    cp_async_commit();
  }
  // a zero carry makes the first step L = C, the restart rule
  int Lp[K];
  unsigned q[NW];  // PACKED: the renormalised carry, s16x2 pairs
  int minLp = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) Lp[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) q[i] = 0;
  // the previous strip's q, for a line that starts on the first row with
  // its predecessor column inside the image (lanes d >= D hold BIG)
  const int xp = x - dx;
  const bool seeded = !PACKED && Q != nullptr && (dx == 0 || li < W) &&
                      xp >= 0 && xp < W;
  if (seeded) {
    const int* qs = Q + ((size_t)b * W + xp) * D;
#pragma unroll
    for (int k = 0; k < K; ++k) Lp[k] = d0 + k < D ? qs[d0 + k] : SGM_BIG;
  }
  const unsigned p1x2 = (unsigned)p1 * 0x10001u;
  unsigned p2x2 = (unsigned)p2 * 0x10001u;
  // adaptive P2: the image byte of pixel t0 + j of the group of 32 pixels
  // that starts next (lane j), the last byte of the group before, the
  // lane's P2'. The next group's byte is loaded as the last use of the
  // current one ends, clamped into the line rather than predicated, so
  // that it lands in the register it is read from a group later: a copy
  // or a select of it would wait for the load where it is issued.
  auto image = [&](int t) { return (int)I[p0 + min(t, n - 1) * step]; };
  int ibyte = 0, ilast = 0, p2v = p2, p2t = p2;
  if constexpr (ADAPT) {
    ibyte = image(lane);
    if (seeded) ilast = Ip[(size_t)b * W + xp];  // the carry row's byte
  }

  for (int t = 0; t < n; ++t) {
    if constexpr (ADAPT) {
      if ((t & 31) == 0) {  // a group starts: its P2', one pixel a lane
        int iprev = __shfl_up_sync(FULL_MASK, ibyte, 1);
        // pixel 0 of a line: the carry row's byte, or unread (a restart)
        if (lane == 0) iprev = ilast;
        ilast = __shfl_sync(FULL_MASK, ibyte, 31);
        p2v = max(p1 + 1, p2 / max(1, abs(ibyte - iprev)));
        ibyte = image(t + 32 + lane);
      }
      p2t = __shfl_sync(FULL_MASK, p2v, t & 31);
      if constexpr (PACKED) p2x2 = (unsigned)p2t * 0x10001u;
    }
    cp_async_wait<RING - 1>();  // pixel t's group has landed
    const int o = (t & (RING - 1)) * Sl::bytes;
    unsigned wc[(K + 3) / 4], sv[NW] = {};
    read_costs<K>(my_c + o, c_sub, wc);
    if constexpr (ACC) read_sums<K>(my_s + o, s_sub, sv);
    // the slot is read: refill it RING pixels ahead
    if (t + RING < n) fill(t + RING);
    cp_async_commit();

    unsigned out[NW];  // this pixel's L, int16 pairs (K = 1: the low half)
    if constexpr (PACKED) {
      unsigned c[NW], L[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i)
        c[i] = __byte_perm(wc[i / 2], 0, i % 2 ? 0x4342 : 0x4140);
      sgm_step_pairs<NW>(c, q, lane, p1x2, p2x2, L);
      const unsigned m = warp_min_s16x2<NW>(L);
      const unsigned M = min(m & 0xffffu, m >> 16) * 0x10001u;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        out[i] = L[i];
        q[i] = L[i] - M;  // no half borrows
      }
    } else {
      int cv[K], L[K];
#pragma unroll
      for (int k = 0; k < K; ++k) cv[k] = cost_byte(wc, k);
      sgm_step<K>(cv, Lp, minLp, lane, D, p1, p2t, L);
      if constexpr (K == 1) {
        out[0] = (unsigned)L[0];
      } else {
#pragma unroll
        for (int i = 0; i < NW; ++i)
          out[i] = __byte_perm(L[2 * i], L[2 * i + 1], 0x5410);
      }
      minLp = __reduce_min_sync(FULL_MASK, lane_min<K>(L));
#pragma unroll
      for (int k = 0; k < K; ++k) Lp[k] = L[k];
    }
    store_line<K, ACC, VEC>(S + (p0 + t * step) * D + d0, out, sv, d0, D);
  }
  // the strip's last row in sweep order: this line's q into the carry out
  if constexpr (!PACKED) {
    if (Fo != nullptr && y + (n - 1) * dy == (dy > 0 ? H - 1 : 0)) {
      int* fs = Fo + ((size_t)b * W + x + (n - 1) * dx) * D;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (d0 + k < D) fs[d0 + k] = Lp[k] - minLp;
    }
  }
}

template <int K, bool ACC, bool ALIGNED, bool FULL, bool PACKED, bool ADAPT>
static int launch_one(const uint8_t* C, int16_t* S, const uint8_t* I,
                      const int* Q, int* Fo, const uint8_t* Ip, int B, int H,
                      int W, int D, int dy, int dx, int p1, int p2,
                      cudaStream_t s) {
  auto kernel = sgm_sweep_kernel<K, ACC, ALIGNED, FULL, PACKED, ADAPT>;
  const int smem = WARPS * RING * Slot<K, ACC>::bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long lines = (long)B * (dy == 0 ? H : (dx == 0 ? W : W + H - 1));
  const unsigned blocks = (unsigned)((lines + WARPS - 1) / WARPS);
  kernel<<<blocks, 32 * WARPS, smem, s>>>(C, S, I, Q, Fo, Ip, B, H, W, D,
                                          dy, dx, p1, p2);
  return (int)cudaGetLastError();
}

template <int K, bool ACC, bool ADAPT>
static int launch(const uint8_t* C, int16_t* S, const uint8_t* I,
                  const int* Q, int* Fo, const uint8_t* Ip, int B, int H,
                  int W, int D, int dy, int dx, int p1, int p2,
                  cudaStream_t s) {
#define TPS_ONE(ALIGNED, FULL, PACKED)                                     \
  return launch_one<K, ACC, ALIGNED, FULL, PACKED, ADAPT>(                 \
      C, S, I, Q, Fo, Ip, B, H, W, D, dy, dx, p1, p2, s)
  const bool aligned = D % K == 0 && D % 4 == 0 &&
                       ((uintptr_t)C | (uintptr_t)S) % 16 == 0;
  if (aligned && D == 32 * K) {
#if SWEEP_S16X2
    // the s16x2 halves hold c_max + P1 + the largest P2 (P1 + 1 under
    // adaptive P2 with P1 = P2)
    if constexpr (K >= 2)
      if (dy == 0 &&
          255 + p1 + (ADAPT && p1 + 1 > p2 ? p1 + 1 : p2) < 1 << 15)
        TPS_ONE(true, true, true);
#endif
    TPS_ONE(true, true, false);
  }
  if (aligned) TPS_ONE(true, false, false);
  TPS_ONE(false, false, false);
#undef TPS_ONE
}

// accumulate == 0 writes S = L_r and reads no S; 1 adds L_r to S. I, the
// left image (B, H, W) uint8, null for the scalar P2. Q, the carry in
// (B, W, D) int32, null for a fresh start; Fo, the carry out, null when not
// wanted; Ip (B, W) uint8, the carry's image row, needed with I and Q.
TPS_EXPORT int sgm_sweep_launch(const uint8_t* C, int16_t* S,
                                const uint8_t* I, const int* Q, int* Fo,
                                const uint8_t* Ip, int B, int H, int W, int D,
                                int dy, int dx, int p1, int p2,
                                int accumulate, void* stream) {
  if (dy < -1 || dy > 1 || dx < -1 || dx > 1 || (dy == 0 && dx == 0) ||
      D < 1 || D > 512 || p1 < 0 || p2 < p1)
    return (int)cudaErrorInvalidValue;
  if ((dy == 0 && (Q || Fo || Ip)) || (Ip && (!I || !Q)) || (I && Q && !Ip))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPS_ACC(KK, ADAPT)                                                 \
  return accumulate                                                         \
             ? launch<KK, true, ADAPT>(C, S, I, Q, Fo, Ip, B, H, W, D, dy,  \
                                       dx, p1, p2, s)                       \
             : launch<KK, false, ADAPT>(C, S, I, Q, Fo, Ip, B, H, W, D, dy, \
                                        dx, p1, p2, s)
#define TPS_LAUNCH(KK)   \
  if (I) TPS_ACC(KK, true); \
  TPS_ACC(KK, false)
  if (D <= 32) { TPS_LAUNCH(1); }
  if (D <= 64) { TPS_LAUNCH(2); }
  if (D <= 128) { TPS_LAUNCH(4); }
  if (D <= 256) { TPS_LAUNCH(8); }
  TPS_LAUNCH(16);
#undef TPS_LAUNCH
#undef TPS_ACC
}
