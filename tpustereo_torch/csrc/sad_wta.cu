// SAD block matching fused with WTA, uniqueness, subpixel and the right-view
// disparity; the (H, W, D) cost volume is never written to device memory.
//
// Replaces: tpustereo/kernels/sad_pallas.py, sad_wta_pallas (kernel body
// `_kernel`) and its float decode.
//
// For plane j (disparity d = d_start + j) the absolute difference is
// A(y, x) = |L(y, x) - R(y, x - d)|, or 255 where x - d < 0, and the cost
// S(y, x, j) sums A over the block x block window of rows y - r ..
// y - r + block - 1 and columns x - r .. x - r + block - 1 (r = block / 2),
// each coordinate clamped into the image: the reference edge-pads the
// filled volume, so a padded tap takes A at the replicated pixel, 255 fill
// included. From S it takes `ops.wta` (packed min, ties to the lowest j;
// uniqueness against the min over |j - j*| > 1; the parabola offset from
// the clamped neighbours S[j*-1], S[j*+1], interior j* only, in the
// reference's float32 op order) and, when d_r is wanted, the right-view
// index map in the shifted-column convention of the JAX kernel:
// d_r[x'] = argmin_k S(x' + k, k) over x' + k < W. S < 255 * block^2 <
// 2^20 (the wrapper checks), so packed values fit int32.
// Inputs L, R (B, H, W) uint8; outputs disp f32, valid bool and d_r int32.
//
// Bound on this card: operations. The images are 2 bytes per pixel and the
// outputs 9, while every cost takes about 11 integer operations at least
// (difference, abs, fill select, four running-sum adds, the packed-min
// and second-min folds): over 100 times the bytes' time at D = 64.
//
// Design: one block of TY x TX threads per tile of TY rows x TX columns of
// one frame (16 x 64, or 8 x 32 where a large block and D overflow shared
// memory), so a 288 x 384 frame is 108 blocks; the tile's image rows
// (TY + block - 1 of them, clamped; R also D - 1 columns further left) are
// staged in shared memory once. The planes go in chunks of DC, three
// phases a chunk with one barrier between phases:
//   * vertical: one thread per (halo column, plane) slides a block-row sum
//     down the TY rows, two A evaluations a row, into V (int16: a column
//     sum is at most 255 * 64);
//   * horizontal: one thread per (row, plane) runs a sum of `block`
//     columns of V along the tile's TX columns, two adds a cost, into S;
//   * selection: one thread per pixel folds the chunk's S into its state
//     in plane order (below), and one thread per (row, diagonal) takes the
//     packed min of the chunk's S(x' + k, k) into the tile's right-view
//     slots. S's pixel stride is DC + 1 words, so both reads hit 32 banks.
// Uniqueness and the subpixel neighbours are folded in the same single pass
// over the planes, although d* is known only at the end: each pixel keeps
// S of the previous plane, the prefix minima of S two planes back, the min
// over the planes before d* - 1 (taken when d* moves) and the min over the
// planes after d* + 1 seen since; S[d*-1] is the previous plane's S when d*
// moves, S[d*+1] the next plane's.
// A right-view slot collects costs of the tiles up to D - 1 columns to its
// right, so after the last chunk each tile folds its slots into d_r by a
// packed atomicMin (ties to the lowest k, as the plain argmin); the launch
// fills d_r with 0x7f7f7f7f before and keeps the index bits after.
#include "common.cuh"

#include <climits>

#ifndef SAD_TX
#define SAD_TX 64  // tile columns (32 where SAD_TY x SAD_TX overflows)
#endif
#ifndef SAD_TY
#define SAD_TY 16  // tile rows (8 where SAD_TY x SAD_TX overflows)
#endif
#ifndef SAD_DC
#define SAD_DC 32  // planes a chunk
#endif
constexpr int DC = SAD_DC;
constexpr int SP = DC + 1;  // S's pixel stride in words (odd)
constexpr size_t SMEM_MAX = 232448;
static_assert(SAD_TX * SAD_TY <= 1024 && SAD_TX % 4 == 0,
              "tiles of 32k threads");

struct Smem {
  int cw, rw, nrows, nslots;  // halo columns, R columns, rows, map slots
  size_t s, drs, v, ls, rs, total;  // byte offsets and the total
};

template <int TX, int TY>
__host__ __device__ inline Smem smem_layout(int block, int D, int with_dr) {
  Smem m;
  m.cw = TX + block - 1;
  m.rw = m.cw + D - 1;
  m.nrows = TY + block - 1;
  m.nslots = TX + D - 1;
  m.s = 0;
  m.drs = m.s + (size_t)TY * TX * SP * 4;
  m.v = m.drs + (with_dr ? (size_t)TY * m.nslots * 4 : 0);
  m.ls = m.v + (size_t)TY * m.cw * DC * 2;
  m.rs = m.ls + (size_t)m.nrows * m.cw;
  m.total = m.rs + (size_t)m.nrows * m.rw;
  return m;
}

template <int TX, int TY>
__global__ void __launch_bounds__(TX * TY)
    sad_wta_kernel(const uint8_t* __restrict__ L,
                   const uint8_t* __restrict__ R, float* __restrict__ disp,
                   uint8_t* __restrict__ valid, int32_t* __restrict__ d_r,
                   int H, int W, int D, int block, int d_start, int uniq,
                   int subpixel, int with_dr, int xtiles, int bands,
                   int mul) {
  constexpr int THREADS = TX * TY;  // one pixel a thread
  extern __shared__ __align__(16) uint8_t smem[];
  const Smem lay = smem_layout<TX, TY>(block, D, with_dr);
  const int cw = lay.cw, rw = lay.rw, nrows = lay.nrows;
  const int nslots = lay.nslots;
  int* Sb = reinterpret_cast<int*>(smem + lay.s);        // TY x TX x SP
  int* drs = reinterpret_cast<int*>(smem + lay.drs);     // TY x nslots
  int16_t* V = reinterpret_cast<int16_t*>(smem + lay.v);  // TY x cw x DC
  uint8_t* Ls = smem + lay.ls;                            // nrows x cw
  uint8_t* Rs = smem + lay.rs;                            // nrows x rw

  const int tid = threadIdx.x, r = block / 2;
  int t = blockIdx.x;
  const int x0 = (t % xtiles) * TX;
  t /= xtiles;
  const int y0 = (t % bands) * TY, f = t / bands;
  const size_t fbase = (size_t)f * H * W;
  // halo column c is image column clamp(x0 - r + c); Rs column c is image
  // column rlo + c
  const int rlo = min(max(x0 - r, 0), W - 1) - d_start - (D - 1);
  for (int i = tid; i < nrows * cw; i += THREADS) {
    const int rr = i / cw, c = i - rr * cw;
    const int y = min(max(y0 - r + rr, 0), H - 1);
    Ls[i] = L[fbase + (size_t)y * W + min(max(x0 - r + c, 0), W - 1)];
  }
  for (int i = tid; i < nrows * rw; i += THREADS) {
    const int rr = i / rw, x = rlo + (i - rr * rw);
    const int y = min(max(y0 - r + rr, 0), H - 1);
    Rs[i] = x >= 0 && x < W ? R[fbase + (size_t)y * W + x] : 0;
  }
  if (with_dr)
    for (int i = tid; i < TY * nslots; i += THREADS) drs[i] = INT_MAX;

  int ps = 0;
  while ((1 << ps) < max(D, 2)) ++ps;
  const int mask = (1 << ps) - 1;
  // this thread's pixel: packed best, S[d*-1], S[d*+1], the min over
  // planes <= d*-2 and over planes >= d*+2, S of the previous plane, the
  // prefix minima up to the previous plane and the one before it
  const int py = tid / TX, px = tid - py * TX;
  int best = INT_MAX, sm = 0, sp = 0, lo = WTA_BIG, hi = WTA_BIG;
  int prv = 0, pm1 = WTA_BIG, pm2 = WTA_BIG;
  __syncthreads();

  for (int j0 = 0; j0 < D; j0 += DC) {
    const int nj = min(DC, D - j0);
    // vertical sums of the chunk's planes (V was last read before the
    // previous chunk's second barrier)
    for (int it = tid; it < cw * DC; it += THREADS) {
      const int c = it / DC, dd = it - c * DC;
      if (dd >= nj) continue;
      int16_t* v = V + c * DC + dd;
      const int xr = min(max(x0 - r + c, 0), W - 1) - d_start - j0 - dd;
      if (xr < 0) {
        for (int y = 0; y < TY; ++y) v[y * cw * DC] = (int16_t)(255 * block);
        continue;
      }
      const uint8_t* lc = Ls + c;
      const uint8_t* rc = Rs + (xr - rlo);
      int acc = 0;
      for (int i = 0; i < block; ++i)
        acc += abs((int)lc[i * cw] - (int)rc[i * rw]);
      v[0] = (int16_t)acc;
      for (int y = 1; y < TY; ++y) {
        const int in = y + block - 1, out = y - 1;
        acc += abs((int)lc[in * cw] - (int)rc[in * rw]) -
               abs((int)lc[out * cw] - (int)rc[out * rw]);
        v[y * cw * DC] = (int16_t)acc;
      }
    }
    __syncthreads();
    // horizontal running sums (S was last read before this barrier)
    for (int it = tid; it < TY * DC; it += THREADS) {
      const int y = it / DC, dd = it - y * DC;
      if (dd >= nj) continue;
      const int16_t* v = V + y * cw * DC + dd;
      int* s = Sb + y * TX * SP + dd;
      int acc = 0;
      for (int k = 0; k < block; ++k) acc += v[k * DC];
      s[0] = acc;
      for (int i = 1; i < TX; ++i) {
        acc += v[(i + block - 1) * DC] - v[(i - 1) * DC];
        s[i * SP] = acc;
      }
    }
    __syncthreads();
    // the pixel's fold over the chunk's planes
    const int* sp_row = Sb + tid * SP;
    for (int jj = 0; jj < nj; ++jj) {
      const int j = j0 + jj, s = sp_row[jj];
      const int pk = s * mul + j;  // mul = 2^ps: one IMAD
      const int js = best & mask;
      if (pk < best) {  // d* moves to j
        best = pk;
        sm = j > 0 ? prv : s;
        sp = s;  // stays S[d*] if j is the last plane
        lo = pm2;
        hi = WTA_BIG;
      } else if (j == js + 1) {
        sp = s;
      } else if (j >= js + 2) {
        hi = min(hi, s);
      }
      pm2 = pm1;
      pm1 = min(pm1, s);
      prv = s;
    }
    // the chunk's diagonals: local index t holds pixel t - (DC - 1) + jj at
    // plane jj, right-view slot x0 - j0 - (DC - 1) + t
    if (with_dr) {
      const int nd = TX + DC - 1;
      const int xend = min(TX, W - x0);
      for (int it = tid; it < TY * nd; it += THREADS) {
        const int y = it / nd, td = it - y * nd;
        const int jlo = max(0, DC - 1 - td);
        const int jhi = min(nj, xend + DC - 1 - td);
        int m = INT_MAX;
        for (int jj = jlo; jj < jhi; ++jj)
          m = min(m, Sb[(y * TX + td - (DC - 1) + jj) * SP + jj] * mul +
                         j0 + jj);
        if (jlo < jhi) {
          int* slot = drs + y * nslots + (D - DC - j0 + td);
          *slot = min(*slot, m);
        }
      }
    }
  }

  const int y = y0 + py, x = x0 + px;
  if (y < H && x < W) {
    const size_t o = fbase + (size_t)y * W + x;
    const int b = best >> ps, js = best & mask;
    const int sec = min(lo, hi);
    disp[o] = subpixel_disp(js, d_start, D, subpixel, sm, b, sp);
    valid[o] = !(uniq > 0 && sec * 100 < b * (100 + uniq));
  }
  if (with_dr) {
    __syncthreads();
    // slot i is right-view column x0 - (D - 1) + i
    for (int it = tid; it < TY * nslots; it += THREADS) {
      const int yy = it / nslots, i = it - yy * nslots;
      const int xs = x0 - (D - 1) + i;
      const int m = drs[it];
      if (m != INT_MAX && xs >= 0 && y0 + yy < H)
        atomicMin(&d_r[fbase + (size_t)(y0 + yy) * W + xs], m);
    }
  }
}

// The packed minima of d_r down to their plane index.
__global__ void dr_index_kernel(int32_t* __restrict__ d_r, size_t n,
                                int mask) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    d_r[i] &= mask;
}

// Whether the wrapper admits this width and block. The formula of the
// earlier design's limit (a band row of 512 threads x 8 pixels, its two
// int32 sum rows and the block's two uint8 image rows in shared memory)
// stays, so that routing does not change; this kernel takes any width.
TPS_EXPORT int sad_wta_fits(int W, int block) {
  return W <= 4096 && (size_t)(8 + 2 * block) * W <= SMEM_MAX;
}

// cudaFuncSetAttribute once per process and device: the kernel may take
// up to SMEM_MAX bytes of dynamic shared memory.
template <int TX, int TY>
static int configure() {
  static int done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && done[dev]) return 0;
  e = cudaFuncSetAttribute(sad_wta_kernel<TX, TY>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64) done[dev] = 1;
  return 0;
}

template <int TX, int TY>
static int launch(const uint8_t* L, const uint8_t* R, float* disp,
                  uint8_t* valid, int32_t* d_r, int B, int H, int W, int D,
                  int block, int d_start, int uniq, int subpixel, int with_dr,
                  cudaStream_t s) {
  const size_t smem = smem_layout<TX, TY>(block, D, with_dr).total;
  const int rc = configure<TX, TY>();
  if (rc != 0) return rc;
  const int xtiles = (W + TX - 1) / TX, bands = (H + TY - 1) / TY;
  const long blocks = (long)B * bands * xtiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  // 2^ps as a value the compiler cannot see, so that packing stays one
  // IMAD on the float pipe rather than a shift and an add on the integer
  // pipe, which bounds this kernel
  int ps = 0;
  while ((1 << ps) < (D > 2 ? D : 2)) ++ps;
  sad_wta_kernel<TX, TY><<<(unsigned)blocks, TX * TY, smem, s>>>(
      L, R, disp, valid, d_r, H, W, D, block, d_start, uniq, subpixel,
      with_dr, xtiles, bands, 1 << ps);
  return 0;
}

TPS_EXPORT int sad_wta_launch(const uint8_t* L, const uint8_t* R,
                              float* disp, uint8_t* valid, int32_t* d_r,
                              int B, int H, int W, int D, int block,
                              int d_start, int uniq, int subpixel,
                              int with_dr, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)B * H * W;
  const bool tall =
      smem_layout<SAD_TX, SAD_TY>(block, D, with_dr).total <= SMEM_MAX;
  if (!tall && smem_layout<32, 8>(block, D, with_dr).total > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (with_dr) {
    const cudaError_t e = cudaMemsetAsync(d_r, 0x7f, n * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
  }
  const int rc =
      tall ? launch<SAD_TX, SAD_TY>(L, R, disp, valid, d_r, B, H, W, D,
                                    block, d_start, uniq, subpixel, with_dr,
                                    s)
           : launch<32, 8>(L, R, disp, valid, d_r, B, H, W, D, block,
                           d_start, uniq, subpixel, with_dr, s);
  if (rc != 0) return rc;
  if (with_dr) {
    int ps = 0;
    while ((1 << ps) < (D > 2 ? D : 2)) ++ps;
    const unsigned grid = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256
                                                             : 4096);
    dr_index_kernel<<<grid, 256, 0, s>>>(d_r, n, (1 << ps) - 1);
  }
  return (int)cudaGetLastError();
}
