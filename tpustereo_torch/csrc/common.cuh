// Shared by every kernel library of tpustereo_torch: the export macro, the
// error-string hook the Python wrappers use to report a failed launch, and
// the per-warp SGM helpers of the sweep kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TPS_EXPORT extern "C" __attribute__((visibility("default")))

constexpr unsigned FULL_MASK = 0xffffffffu;

TPS_EXPORT const char* tps_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// One SGM recurrence step for the K disparities d = lane*K + k that this
// lane owns (contiguous per lane), given the predecessor's path costs Lp and
// their minimum minLp over all D:
//   L = C + min(Lp, Lp(d-1) + P1, Lp(d+1) + P1, minLp + P2) - minLp.
// Lp(d+-1) across a lane boundary come by shuffle; d = -1 and d = D read
// BIG, and lanes d >= D hold BIG (they never win a min). int32 throughout,
// so the sums match the reference's int32 arithmetic exactly.
constexpr int SGM_BIG = 1 << 24;

template <int K>
__device__ __forceinline__ void sgm_step(const int (&c)[K], const int (&Lp)[K],
                                         int minLp, int lane, int D, int p1,
                                         int p2, int (&L)[K]) {
  int left = __shfl_up_sync(FULL_MASK, Lp[K - 1], 1);
  int right = __shfl_down_sync(FULL_MASK, Lp[0], 1);
  if (lane == 0) left = SGM_BIG;
  if (lane == 31) right = SGM_BIG;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int dn = k == 0 ? left : Lp[k - 1];
    const int up = k == K - 1 ? right : Lp[k + 1];
    int cand = min(Lp[k], min(up, dn) + p1);
    cand = min(cand, minLp + p2);
    L[k] = lane * K + k < D ? c[k] + cand - minLp : SGM_BIG;
  }
}

// `sgm_step` for two lines at once, in Hopper's DPX min-plus instructions:
// each 32-bit word packs the same disparity of two lines as signed 16-bit
// halves (s16x2), and one instruction does both halves. The carry is
// renormalised, q = Lp - min_d Lp (K words a lane, d = lane*K + k, every
// lane full: D = 32 K), and the step returns
//   L = C + min(q, q(d-1) + P1, q(d+1) + P1, P2)
// per half; the caller takes min_d L (`warp_min_s16x2`) and carries L minus
// it. d = -1 and d = D have no path: the other neighbour stands in for them,
// which gives what a sentinel above P2 would and needs none. Exact while
// every half stays in [0, 2^15): q is at most c_max + P2, so it holds when
// c_max + P1 + P2 < 2^15. The halves' sums never carry: c + cand and
// q(d+-1) + P1 stay below 2^16.
template <int K>
__device__ __forceinline__ void sgm_step_s16x2(const unsigned (&c)[K],
                                               const unsigned (&q)[K],
                                               int lane, unsigned p1x2,
                                               unsigned p2x2,
                                               unsigned (&L)[K]) {
  const unsigned left = __shfl_up_sync(FULL_MASK, q[K - 1], 1);
  const unsigned right = __shfl_down_sync(FULL_MASK, q[0], 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    unsigned dn = k == 0 ? left : q[k - 1];
    unsigned up = k == K - 1 ? right : q[k + 1];
    if (k == 0 && lane == 0) dn = up;
    if (k == K - 1 && lane == 31) up = dn;
    L[k] = c[k] + __vimin3_s16x2(q[k], __viaddmin_s16x2(up, p1x2, dn + p1x2),
                                 p2x2);
  }
}

// Per-half min of two s16x2 words.
__device__ __forceinline__ unsigned min_s16x2(unsigned a, unsigned b) {
  return __vimin3_s16x2(a, b, b);
}

// The per-half minimum over the warp's K words a lane, in every lane, by a
// __shfl_xor_sync tree of s16x2 mins (5 shuffles, 5 mins). On the H100 it
// is as fast as two __reduce_min_sync on the unpacked halves or faster.
template <int K>
__device__ __forceinline__ unsigned warp_min_s16x2(const unsigned (&v)[K]) {
  unsigned m = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = min_s16x2(m, v[k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = min_s16x2(m, __shfl_xor_sync(FULL_MASK, m, o));
  return m;
}

// The K costs and partial sums of one pixel that this lane owns; lanes past
// D read 0.
template <int K>
__device__ __forceinline__ void load_pixel(const uint8_t* c, const int16_t* s,
                                           int lane, int D, int (&cv)[K],
                                           int (&sv)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane * K + k;
    cv[k] = d < D ? c[d] : 0;
    sv[k] = d < D ? s[d] : 0;
  }
}

// N bytes as 32-bit words, aligned to N: one vector load or store of up to
// 16 bytes (two for 32).
template <int N>
struct alignas(N) Words {
  uint32_t w[N / 4];
};

// `load_pixel` for a lane whose K costs and K partial sums lie at c and s,
// c aligned to K bytes and s to 2K (K >= 4): one vector load of each.
// Every element is read, so a lane past D must point at readable bytes.
template <int K>
__device__ __forceinline__ void load_slice(const uint8_t* c, const int16_t* s,
                                           int (&cv)[K], int (&sv)[K]) {
  const Words<K> cw = *reinterpret_cast<const Words<K>*>(c);
  const Words<2 * K> sw = *reinterpret_cast<const Words<2 * K>*>(s);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cv[k] = (cw.w[k / 4] >> (8 * (k % 4))) & 0xff;
    sv[k] = (int16_t)(sw.w[k / 2] >> (16 * (k % 2)));
  }
}

// An asynchronous copy of N bytes (4, 8, 16 or 32) from device to shared
// memory, both aligned to min(N, 16), in the thread's current group.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 32) {
    cp_async<16>(dst, src);
    cp_async<16>(static_cast<char*>(dst) + 16,
                 static_cast<const char*>(src) + 16);
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (N == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                   "l"(src), "n"(N) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ring helpers of the sweep kernels (`sgm_sweep.cu`, `sgm_bidir.cu`): a
// lane copies its slice of a pixel into a shared-memory slot, K cost bytes
// (CB = max(K, 4) bytes: a lane under 4 bytes copies the aligned word that
// holds its slice, `sub` elements in) and K int16 partial sums (SB =
// max(2K, 4) bytes), and reads it back as 32-bit words.
__host__ __device__ constexpr int NWORDS(int K) { return K < 2 ? 1 : K / 2; }

// the lane's K cost bytes of one line, byte k of word k / 4
template <int K>
__device__ __forceinline__ void read_costs(const uint8_t* p, int sub,
                                           unsigned (&w)[(K + 3) / 4]) {
  if constexpr (K >= 4) {
    const Words<K> v = *reinterpret_cast<const Words<K>*>(p);
#pragma unroll
    for (int i = 0; i < K / 4; ++i) w[i] = v.w[i];
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(p) >> (8 * sub);
  }
}

// the lane's K partial sums of one line, int16 pairs (the element low);
// for K = 1 the low half of w[0]
template <int K>
__device__ __forceinline__ void read_sums(const uint8_t* p, int sub,
                                          unsigned (&w)[NWORDS(K)]) {
  if constexpr (K >= 2) {
    const Words<2 * K> v = *reinterpret_cast<const Words<2 * K>*>(p);
#pragma unroll
    for (int i = 0; i < K / 2; ++i) w[i] = v.w[i];
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(p) >> (16 * sub);
  }
}

__device__ __forceinline__ int cost_byte(const unsigned* w, int k) {
  return (w[k / 4] >> (8 * (k % 4))) & 0xff;
}

// per-half sums of two int16 pairs, each mod 2^16
__device__ __forceinline__ unsigned add16x2(unsigned a, unsigned b) {
  return __byte_perm(a + b, a + (b & 0xffff0000u), 0x7610);
}

// The lane's K int16 results of one line at dst: w holds them as int16
// pairs (K >= 2) or in its low half (K = 1), s the partial sums as read_sums
// gave them (added, wrapping as int16 does, when ACC). One vector store
// (VEC: dst aligned to 2K bytes), or scalar stores.
template <int K, bool ACC, bool VEC>
__device__ __forceinline__ void store_line(int16_t* dst,
                                           unsigned (&w)[NWORDS(K)],
                                           const unsigned (&s)[NWORDS(K)],
                                           int d0, int D) {
  if constexpr (K == 1) {
    if (d0 < D) dst[0] = (int16_t)(ACC ? s[0] + w[0] : w[0]);
  } else {
#pragma unroll
    for (int i = 0; i < K / 2; ++i)
      if (ACC) w[i] = add16x2(s[i], w[i]);
    if constexpr (VEC) {
      if (d0 < D) {
        Words<2 * K> v;
#pragma unroll
        for (int i = 0; i < K / 2; ++i) v.w[i] = w[i];
        *reinterpret_cast<Words<2 * K>*>(dst) = v;
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (d0 + k < D) dst[k] = (int16_t)(w[k / 2] >> (16 * (k % 2)));
    }
  }
}

template <int K>
__device__ __forceinline__ int lane_min(const int (&v)[K]) {
  int m = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = min(m, v[k]);
  return m;
}

// v[k] for a k known only at run time, without spilling v to local memory.
template <int K>
__device__ __forceinline__ int pick(const int (&v)[K], int k) {
  int r = v[0];
#pragma unroll
  for (int i = 1; i < K; ++i) r = i == k ? v[i] : r;
  return r;
}

// The float32 disparity of the WTA index j in the reference's op order
// (`ops/wta.py`): float(j + d_start), plus the parabola vertex offset from
// S[j-1] = sm, S[j] = s0, S[j+1] = sp (reads clamped into [0, D)) when
// subpixel is on and j is interior. The _rn intrinsics keep nvcc from
// contracting the sum into an FMA, which would round differently.
__device__ __forceinline__ float subpixel_disp(int j, int d_start, int D,
                                               bool subpixel, int sm, int s0,
                                               int sp) {
  float dv = (float)(j + d_start);
  if (!subpixel) return dv;
  const float smf = (float)sm, spf = (float)sp, s0f = (float)s0;
  const float denom = __fadd_rn(__fsub_rn(smf, __fmul_rn(2.0f, s0f)), spf);
  float offs = 0.0f;
  if (denom > 0.0f)
    offs = __fdiv_rn(__fsub_rn(smf, spf), fmaxf(__fmul_rn(2.0f, denom), 1e-9f));
  offs = fminf(fmaxf(offs, -0.5f), 0.5f);
  return j > 0 && j < D - 1 ? __fadd_rn(dv, offs) : dv;
}

// `ops.wta` for one pixel whose D costs a warp holds, K per lane (d = lane*K
// + k): s[k] the cost, packed[k] = s[k] * 2^ps + d (anything above every
// real value for d >= D). Returns the packed minimum (ties to the lowest d)
// and sets the pixel's disparity and uniqueness flag:
//   ok = !(second * 100 < best * (100 + uniq)), second the min over
//   |d - d*| > 1 (1 << 24 when there is none), when uniq > 0.
// Every lane must call it; all get the same results.
constexpr int WTA_BIG = 1 << 24;

template <int K>
__device__ __forceinline__ int warp_wta(const int (&s)[K],
                                        const int (&packed)[K], int lane,
                                        int D, int ps, int uniq,
                                        bool subpixel, int d_start, float& dv,
                                        bool& ok) {
  const int m = __reduce_min_sync(FULL_MASK, lane_min<K>(packed));
  const int best = m >> ps, j = m & ((1 << ps) - 1);
  ok = true;
  if (uniq > 0) {
    int sec = WTA_BIG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (d < D && abs(d - j) > 1) sec = min(sec, s[k]);
    }
    sec = __reduce_min_sync(FULL_MASK, sec);
    ok = !(sec * 100 < best * (100 + uniq));
  }
  int sm = 0, sp = 0;
  if (subpixel) {
    const int dm = max(j - 1, 0), dp = min(j + 1, D - 1);
    sm = __shfl_sync(FULL_MASK, pick<K>(s, dm % K), dm / K);
    sp = __shfl_sync(FULL_MASK, pick<K>(s, dp % K), dp / K);
  }
  dv = subpixel_disp(j, d_start, D, subpixel, sm, best, sp);
  return m;
}
