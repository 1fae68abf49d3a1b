// Shared by every kernel library of tpustereo_torch: the export macro, the
// error-string hook the Python wrappers use to report a failed launch, and
// the per-warp SGM helpers of the two sweep kernels.
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
