// Connected-component labels of a 4-connected pixel graph.
//
// Replaces: tpustereo/kernels/cc_pallas.py, connected_component_labels_pallas
// (kernel body `_cc_kernel`, whole-image and banded modes).
//
// conn_h (F, H, W-1) and conn_v (F, H-1, W) are bool edge masks: conn_h
// joins (y, x) and (y, x+1), conn_v joins (y, x) and (y+1, x). The output
// lab (F, H, W) int32 holds, for every pixel, the minimum linear index
// (y * W + x, within its own frame) of its component: exactly what the JAX
// kernel and `ops.postproc.connected_component_labels` return.
//
// Bound on this card: bytes (2 bytes of edge masks read and 4 bytes of
// labels written per pixel). Union-find does a handful of integer
// operations and a few dependent loads per pixel; what costs time is the
// length of the pointer chains that finds walk and the atomics on roots.
//
// Design: union-find with atomics (Playne & Hawick 2018; Allegretti et al.
// 2019), three launches. The TPU kernel iterated segmented min-scans in
// VMEM to a fixpoint and went banded when an image outgrew VMEM; here the
// label image is the union-find forest itself, in device memory, at any
// size.
//   1. rows:    one warp per image row labels each horizontal run with its
//               first pixel (a ballot per 32 pixels, the open run carried
//               from one 32-pixel chunk to the next), so every horizontal
//               edge is settled without an atomic and every pixel points
//               straight at its run's root.
//   2. merge:   each pixel with a vertical edge unites itself with the pixel
//               below: find both roots, then link the larger root under the
//               smaller with atomicMin, retrying when another thread moved
//               the root first. A vertical edge whose left neighbour's
//               vertical edge joins the same two runs is skipped: that
//               union is already made. Finds halve the path as they walk.
//   3. flatten: lab[p] = find(p).
// Every pointer leads to a smaller pixel of the same component and roots
// only move to smaller indices, so each component's final root is its
// minimum index: the result is exact and does not depend on the order in
// which the atomics land. Settling the runs first is what keeps finds
// short: uniting every horizontal edge by atomics as well builds chains as
// long as a run, and on KITTI maps most runs span most of a row.
//
// Races, and why they are benign: finds read without atomics, so a read
// may return an older, larger ancestor, still a valid pointer. Path halving
// stores a grandparent into a pixel that is not a root (a pixel never
// becomes a root again), which only shortens a path; a concurrent atomicMin
// on that pixel came from a stale find and returns the pixel's parent, not
// the pixel, so its union goes on from that parent and relies on no link
// that the store may replace. Every retry of the merge loop lowers a root,
// so the loop ends. Flatten writes lab[p] while other threads walk through
// p; old and new values are both ancestors of p.
#include "common.cuh"

__device__ __forceinline__ int cc_find(const int32_t* L, int p) {
  int q = L[p];
  while (q != p) {
    p = q;
    q = L[p];
  }
  return p;
}

__device__ __forceinline__ int cc_find_halve(int32_t* L, int p) {
  while (true) {
    const int q = L[p];
    if (q == p) return p;
    const int r = L[q];
    if (r != q) L[p] = r;
    p = r;
  }
}

__device__ __forceinline__ void cc_union(int32_t* L, int a, int b) {
  while (true) {
    a = cc_find_halve(L, a);
    b = cc_find_halve(L, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&L[b], a);
    if (old == b) return;  // b was a root and now hangs under a
    b = old;               // b had moved; unite a with where it went
  }
}

// One warp per image row (F * H rows): lab[p] = the frame-local index of the
// first pixel of p's horizontal run.
__global__ void cc_rows_kernel(const uint8_t* __restrict__ conn_h,
                               int32_t* __restrict__ lab, int rows, int H,
                               int W) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const uint8_t* ch = conn_h + (long)row * (W - 1);
  int32_t* out = lab + (long)row * W;
  const int y0 = (row % H) * W;  // frame-local index of the row's start
  const unsigned upto = FULL_MASK >> (31 - lane);  // lanes 0..lane
  int open = 0;  // start column of the run open at the chunk's left edge
  for (int x0 = 0; x0 < W; x0 += 32) {
    const int x = x0 + lane;
    const bool left = x < W && x > 0 && ch[x - 1];
    const unsigned starts = ~__ballot_sync(FULL_MASK, left) & upto;
    const int start = starts ? x0 + 31 - __clz(starts) : open;
    if (x < W) out[x] = y0 + start;
    open = __shfl_sync(FULL_MASK, start, 31);
  }
}

__global__ void cc_merge_kernel(const uint8_t* __restrict__ conn_h,
                                const uint8_t* __restrict__ conn_v,
                                int32_t* lab, long n, int H, int W) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long hw = (long)H * W;
  const long f = i / hw;
  const int p = (int)(i - f * hw);
  const int y = p / W, x = p - y * W;
  if (y >= H - 1) return;
  const uint8_t* cv = conn_v + f * (hw - W);
  if (!cv[p]) return;
  if (x > 0 && cv[p - 1]) {
    // the left neighbour's edge joins the same two runs when both rows
    // continue to the left
    const uint8_t* ch = conn_h + (f * H + y) * (W - 1);
    if (ch[x - 1] && ch[W - 1 + x - 1]) return;
  }
  cc_union(lab + f * hw, p, p + W);
}

__global__ void cc_flatten_kernel(int32_t* lab, long n, int hw) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long base = i - i % hw;
  lab[i] = cc_find(lab + base, (int)(i - base));
}

TPS_EXPORT int cc_labels_launch(const uint8_t* conn_h, const uint8_t* conn_v,
                                int32_t* lab, int F, int H, int W,
                                void* stream) {
  const long n = (long)F * H * W;
  const int rows = F * H;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const unsigned row_blocks = (unsigned)((rows * 32L + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cc_rows_kernel<<<row_blocks, threads, 0, s>>>(conn_h, lab, rows, H, W);
  cc_merge_kernel<<<blocks, threads, 0, s>>>(conn_h, conn_v, lab, n, H, W);
  cc_flatten_kernel<<<blocks, threads, 0, s>>>(lab, n, H * W);
  return (int)cudaGetLastError();
}
