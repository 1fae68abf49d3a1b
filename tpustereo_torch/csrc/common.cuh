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
