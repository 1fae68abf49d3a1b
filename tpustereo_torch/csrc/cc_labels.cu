// Connected-component labels of a 4-connected pixel graph, and speckle's
// mask from the components' sizes.
//
// Replaces: tpustereo/kernels/cc_pallas.py, connected_component_labels_pallas
// (kernel body `_cc_kernel`, whole-image and banded modes); with its size
// count (`cc_big_launch`), also the JAX `component_big`'s sort of every
// label (tpustereo/ops/postproc.py), which the port ran as a radix sort and
// two binary searches.
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
// Design: block-based union-find with atomics (Allegretti, Bolelli and
// Grana, "Optimized Block-Based Algorithms to Label Connected Components
// on GPUs", IEEE TPDS 2020; Playne & Hawick 2018). The TPU kernel iterated
// segmented min-scans in VMEM to a fixpoint and went banded when an image
// outgrew VMEM; here the label image is the union-find forest itself, in
// device memory, at any size. Three launches:
//   1. local:   one block a tile of TILE_ROWS x TILE_COLS pixels of one
//               frame (a tile never crosses a frame), its forest in shared
//               memory. The tile's edge bytes are copied to shared memory
//               first, every load issued at once, so that no union waits
//               on a device load. One
//               warp a tile row labels each horizontal run inside the tile
//               with its first pixel (a ballot per 32 pixels, the open run
//               carried from one chunk to the next), so every horizontal
//               edge inside the tile is settled without an atomic. Then
//               each vertical edge inside the tile unites its two pixels by
//               shared-memory atomicMin, finds halving the path as they
//               walk. Then every run start takes its tile-local root as its
//               parent (every parent is a run start, so each pixel's root
//               is then two reads away), and each pixel's parent in device
//               memory is the frame-local index of its tile-local root,
//               whose own parent is itself.
//   2. border:  one thread an edge that crosses a tile border (horizontal
//               edges between tile columns, vertical edges between tile
//               rows) unites the two roots in device memory: find both,
//               link the larger root under the smaller with atomicMin,
//               retry when another thread moved the root first.
//   3. flatten: lab[p] = find(p), a thread a pixel. A chain runs p -> its
//               tile-local root -> the roots that the border unions linked
//               it under. (Blocks a tile, walking their pixels' chains in
//               turn, in lockstep or once a tile-local root, were slower on
//               an H100: 16-20 us against 13.6 at 4 KITTI frames.)
// Borders need every tile's local roots, and the flatten every border
// union, both across the whole grid: hence three launches, not one.
// Edges that the other three edges of their 2x2 square already join are
// skipped, which keeps most unions and their atomics off a component's
// root: a vertical edge whose left neighbour's vertical edge and both
// rows' edges to the left are set (both phases), and a horizontal border
// edge whose upper neighbour's horizontal edge and both vertical edges
// between the two rows are set, except on a tile's first row. A skipped
// edge leans on edges that are never skipped or whose own chain of skips
// ends at one (leftwards, or upwards at a tile's first row); the one
// exception would be a square at a tile corner, where each skip would
// lean on the other.
//
// Exactness: within a tile, row-major local order (ly, lx) is the global
// order (y = y0 + ly first, then x = x0 + lx; lx < TILE_COLS and every
// column of the tile is inside the frame), so a tile-local root, the
// minimum local index of its tile-component, is that tile-component's
// minimum frame-local index. Every pointer, in shared or device memory,
// leads to a smaller pixel of the same component and roots only move to
// smaller indices, so each component's final root is its minimum index:
// the result is exact and does not depend on the order in which the
// atomics land.
//
// Races, and why they are benign: finds read without atomics, so a read
// may return an older, larger ancestor, still a valid pointer. Path halving
// stores a grandparent into a pixel that is not a root (a pixel never
// becomes a root again), which only shortens a path; a concurrent atomicMin
// on that pixel came from a stale find and returns the pixel's parent, not
// the pixel, so its union goes on from that parent and relies on no link
// that the store may replace. Every retry of the union loop lowers a root,
// so the loop ends. Flatten writes lab[p] while other threads walk through
// p; old and new values are both ancestors of p.
//
// Sizes (`cc_big_launch`: valid & (component size >= thresh), what speckle
// keeps, bit for bit the mask of `component_big` over the labels). A
// scene's few large components hold most pixels, so a per-pixel atomic on
// the root would serialise there; instead every count below is at most one
// atomic a tile-component:
//   1. local, counting: each warp adds its pixels to their tile-local roots
//      in shared memory (one atomic a root a warp, `__match_any_sync`),
//      and the block writes count[p] = its tile-component's pixels at each
//      tile-local root p and 0 at every other pixel (no fill of its own);
//   2. border, as above;
//   3. sizes: each tile-local root (count > 0) that the border unions
//      linked under another adds its count to its root's with one global
//      atomic and points straight at it; a component's root is its
//      minimum, which is its own tile-component's root too, so its counter
//      started at that tile-component's pixels and ends at the component's;
//   4. mask: big[p] = valid[p] && count[find(p)] >= thresh, a thread a
//      pixel; the chain is p -> its tile-local root -> the root. No label
//      image is written.
// Bound: bytes, 2 of edges and 1 of valid read and 1 of mask written a
// pixel against 4 of labels and 4 of counts written, then read, by the
// passes in between.
#include "common.cuh"

#ifndef CC_TILE_ROWS
#define CC_TILE_ROWS 16
#endif
#ifndef CC_TILE_COLS
#define CC_TILE_COLS 128
#endif

constexpr int TILE_ROWS = CC_TILE_ROWS;
constexpr int TILE_COLS = CC_TILE_COLS;
constexpr int LOCAL_THREADS = 256;  // a tile's block
constexpr int THREADS = 256;
static_assert(TILE_COLS % 32 == 0 && TILE_ROWS >= 1 &&
                  TILE_ROWS * TILE_COLS <= 8192,
              "tiles of whole warps, at most 32 KB of labels");

// Works on shared and device memory alike (a generic pointer).
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

// Phase 1: one block a tile; tile index = (f * ncy + ty) * ncx + tx. With
// COUNT, also count[p] = the pixels of p's tile-component at each
// tile-local root p, 0 at every other pixel.
template <bool COUNT>
__global__ void __launch_bounds__(LOCAL_THREADS)
    cc_local_kernel(const uint8_t* __restrict__ conn_h,
                    const uint8_t* __restrict__ conn_v,
                    int32_t* __restrict__ lab, int32_t* __restrict__ count,
                    int H, int W, int ncy, int ncx) {
  constexpr int N = TILE_ROWS * TILE_COLS;
  __shared__ int32_t L[N];
  // at tile pixel i = (ly, lx): sh the edge to its left (0 at lx = 0), sv
  // the edge below it (0 on the tile's last row); both 0 outside the frame
  __shared__ uint8_t sh[N], sv[N];
  __shared__ int32_t C[COUNT ? N : 1];  // pixels of each tile-local root
  const long b = blockIdx.x;
  const int tx = (int)(b % ncx), ty = (int)(b / ncx % ncy);
  const long f = b / ncx / ncy;
  const int x0 = tx * TILE_COLS, y0 = ty * TILE_ROWS;
  const int wt = min(TILE_COLS, W - x0), ht = min(TILE_ROWS, H - y0);
  const uint8_t* ch = conn_h + f * H * (long)(W - 1);
  const uint8_t* cv = conn_v + f * (H - 1) * (long)W;
  const int lane = threadIdx.x & 31;
  const unsigned upto = FULL_MASK >> (31 - lane);  // lanes 0..lane

#pragma unroll
  for (int it = 0; it < (N + LOCAL_THREADS - 1) / LOCAL_THREADS; ++it) {
    const int i = it * LOCAL_THREADS + threadIdx.x;
    const int ly = i / TILE_COLS, lx = i % TILE_COLS;
    uint8_t h = 0, v = 0;
    if (i < N && ly < ht && lx < wt) {
      const long y = y0 + ly;
      if (lx > 0) h = ch[y * (W - 1) + x0 + lx - 1];
      if (ly < ht - 1) v = cv[y * W + x0 + lx];
    }
    if (i < N) {
      sh[i] = h;
      sv[i] = v;
      if (COUNT) C[i] = 0;
    }
  }
  __syncthreads();

  // runs: one warp a tile row; each pixel points at its run's first pixel
  for (int ly = threadIdx.x >> 5; ly < ht; ly += LOCAL_THREADS / 32) {
    int open = 0;  // start column of the run open at the chunk's left edge
#pragma unroll
    for (int lx0 = 0; lx0 < TILE_COLS; lx0 += 32) {
      const int i = ly * TILE_COLS + lx0 + lane;
      const unsigned starts = ~__ballot_sync(FULL_MASK, sh[i]) & upto;
      const int start = starts ? lx0 + 31 - __clz(starts) : open;
      L[i] = ly * TILE_COLS + start;
      open = __shfl_sync(FULL_MASK, start, 31);
    }
  }
  __syncthreads();

  // vertical edges inside the tile; skipped where the left neighbour's
  // vertical edge and both rows' edges to the left join the same two runs
  for (int i = threadIdx.x; i < (ht - 1) * TILE_COLS; i += LOCAL_THREADS) {
    if (!sv[i]) continue;
    if (i % TILE_COLS > 0 && sv[i - 1] && sh[i] && sh[i + TILE_COLS])
      continue;
    cc_union(L, i, i + TILE_COLS);
  }
  __syncthreads();

  // run starts (no edge to their left) to their roots; racing walks read an
  // old parent or the root, both ancestors
  for (int i = threadIdx.x; i < ht * TILE_COLS; i += LOCAL_THREADS)
    if (!sh[i]) L[i] = cc_find(L, i);
  __syncthreads();

  // each pixel's parent: its tile-local root, as a frame-local index; a
  // warp's pixels lie in one tile row, so most warps meet one root
  int32_t* out = lab + f * H * (long)W;
  for (int i = threadIdx.x; i < ht * TILE_COLS; i += LOCAL_THREADS) {
    const int lx = i % TILE_COLS;
    const int r = L[L[i]];
    if (COUNT) {
      const int key = lx < wt ? r : -1;
      const unsigned peers = __match_any_sync(FULL_MASK, key);
      if (key >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&C[r], __popc(peers));
    }
    if (lx >= wt) continue;
    out[(long)(y0 + i / TILE_COLS) * W + x0 + lx] =
        (y0 + r / TILE_COLS) * W + x0 + r % TILE_COLS;
  }
  if (!COUNT) return;
  __syncthreads();
  int32_t* cnt = count + f * H * (long)W;
  for (int i = threadIdx.x; i < ht * TILE_COLS; i += LOCAL_THREADS) {
    const int lx = i % TILE_COLS;
    if (lx < wt) cnt[(long)(y0 + i / TILE_COLS) * W + x0 + lx] = C[i];
  }
}

// Phase 2: one thread an edge across a tile border. The first n_h threads
// take the horizontal edges (y, x-1)-(y, x) at x = c * TILE_COLS, in the
// order (f, y, c); the rest the vertical edges (y-1, x)-(y, x) at
// y = r * TILE_ROWS, in the order (f, r, x).
__global__ void cc_border_kernel(const uint8_t* __restrict__ conn_h,
                                 const uint8_t* __restrict__ conn_v,
                                 int32_t* lab, int H, int W, int ncy, int ncx,
                                 long n_h, long n) {
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long hw = (long)H * W;
  if (i < n_h) {
    const int c = (int)(i % (ncx - 1)) + 1;
    const long fy = i / (ncx - 1);  // f * H + y
    const int y = (int)(fy % H), x = c * TILE_COLS;
    const long f = fy / H;
    const uint8_t* ch = conn_h + fy * (W - 1) + x - 1;
    const uint8_t* cv = conn_v + (f * (H - 1) + y - 1) * W + x - 1;
    const bool edge = ch[0];
    bool skip = false;
    if (y % TILE_ROWS != 0) skip = ch[-(W - 1)] & cv[0] & cv[1];
    if (!edge || skip) return;
    cc_union(lab + f * hw, y * W + x - 1, y * W + x);
    return;
  }
  const long j = i - n_h;
  const int x = (int)(j % W);
  const long fr = j / W;  // f * (ncy - 1) + r - 1
  const long f = fr / (ncy - 1);
  const int y = (int)(fr % (ncy - 1) + 1) * TILE_ROWS;
  const uint8_t* cv = conn_v + (f * (H - 1) + y - 1) * W + x;
  const uint8_t* ch = conn_h + (f * H + y - 1) * (W - 1) + x - 1;
  // every load at once; the skip rule is phase 1's
  const bool edge = cv[0];
  bool skip = false;
  if (x > 0) skip = cv[-1] & ch[0] & ch[W - 1];
  if (!edge || skip) return;
  cc_union(lab + f * hw, (y - 1) * W + x, y * W + x);
}

// Phase 3, each pixel to its root, as OUT says: LABELS writes the root
// (lab[i] = find(i)); SIZES and MASK are the size count's passes 3 and 4
// (above): a tile-local root linked under another adds its count to its
// root's and points at it; big[i] = valid[i] && count[root] >= thresh.
constexpr int LABELS = 0, SIZES = 1, MASK = 2;

template <int OUT>
__global__ void cc_flatten_kernel(int32_t* lab, int32_t* count,
                                  const uint8_t* __restrict__ valid,
                                  uint8_t* __restrict__ big, long n, int hw,
                                  int thresh) {
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int p = (int)i % hw;  // n < 2^31: a 32-bit division
  const long base = i - p;
  if (OUT == LABELS) {
    lab[i] = cc_find(lab + base, p);
  } else if (OUT == SIZES) {
    // a root's own counter may grow while it reads it: it only tests it;
    // no thread adds to a counter that is not a root's
    const int c = count[i];
    if (c == 0) return;
    const int r = cc_find(lab + base, p);
    if (r == p) return;
    lab[i] = r;
    atomicAdd(&count[base + r], c);
  } else {
    big[i] = valid[i] && count[base + cc_find(lab + base, p)] >= thresh;
  }
}

static unsigned blocks(long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

// Phases 1 and 2: the tile forests (with COUNT, and their counts) and the
// unions across tile borders.
template <bool COUNT>
static void forest(const uint8_t* conn_h, const uint8_t* conn_v, int32_t* lab,
                   int32_t* count, int F, int H, int W, cudaStream_t s) {
  const int ncy = (H + TILE_ROWS - 1) / TILE_ROWS;
  const int ncx = (W + TILE_COLS - 1) / TILE_COLS;
  const long n_h = (long)F * H * (ncx - 1);
  const long n_border = n_h + (long)F * (ncy - 1) * W;
  const unsigned tiles = (unsigned)((long)F * ncy * ncx);
  cc_local_kernel<COUNT><<<tiles, LOCAL_THREADS, 0, s>>>(
      conn_h, conn_v, lab, count, H, W, ncy, ncx);
  if (n_border > 0)
    cc_border_kernel<<<blocks(n_border), THREADS, 0, s>>>(
        conn_h, conn_v, lab, H, W, ncy, ncx, n_h, n_border);
}

static bool bad_shape(int F, int H, int W) {
  return F < 1 || H < 1 || W < 1 || (long)F * H * W >= (1L << 31);
}

TPS_EXPORT int cc_labels_launch(const uint8_t* conn_h, const uint8_t* conn_v,
                                int32_t* lab, int F, int H, int W,
                                void* stream) {
  if (bad_shape(F, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  forest<false>(conn_h, conn_v, lab, nullptr, F, H, W, s);
  const long n = (long)F * H * W;
  cc_flatten_kernel<LABELS><<<blocks(n), THREADS, 0, s>>>(
      lab, nullptr, nullptr, nullptr, n, H * W, 0);
  return (int)cudaGetLastError();
}

// big = valid & (the pixel's component has >= thresh pixels), all (F, H,
// W); lab and count are scratch of F * H * W int32 each, left unspecified.
TPS_EXPORT int cc_big_launch(const uint8_t* conn_h, const uint8_t* conn_v,
                             const uint8_t* valid, int32_t* lab,
                             int32_t* count, uint8_t* big, int F, int H,
                             int W, int thresh, void* stream) {
  if (bad_shape(F, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  forest<true>(conn_h, conn_v, lab, count, F, H, W, s);
  const long n = (long)F * H * W;
  cc_flatten_kernel<SIZES><<<blocks(n), THREADS, 0, s>>>(
      lab, count, nullptr, nullptr, n, H * W, 0);
  cc_flatten_kernel<MASK><<<blocks(n), THREADS, 0, s>>>(
      lab, count, valid, big, n, H * W, thresh);
  return (int)cudaGetLastError();
}
