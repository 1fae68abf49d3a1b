// Census transform + Hamming cost volume, fused in one pass.
//
// Replaces: tpustereo/kernels/cost_pallas.py, census_cost_volume_pallas
// (kernel body `_kernel`).
//
// Computes C[b, y, x, d] = popcount(cenL[y, x] ^ cenR[y, x - d_start - d]),
// or max_cost where x - d_start - d < 0, as a plain (B, H, W, D) uint8
// volume. Census: edge-replicated window, bits row-major with the centre
// skipped, bit set iff neighbour < centre; up to 64 bits in one uint64.
//
// Bound on this card: the bytes of C written (B*H*W*D, one byte per cost);
// the inputs are 2*B*H*W bytes and the arithmetic (xor + popcount + select
// per cost) is far below the card's integer rate.
//
// Design: one block per image row (b, y). The block stages the ch rows of L
// and R it needs in shared memory (edge replication at load time), builds
// both rows' census words there, then streams the row's W*D costs out with
// d fastest, so consecutive threads write consecutive bytes; when D is a
// multiple of 4 each thread writes four costs as one 32-bit store. The
// census never touches device memory.
#include "common.cuh"

template <bool VEC4>
__global__ void census_cost_kernel(const uint8_t* __restrict__ left,
                                   const uint8_t* __restrict__ right,
                                   uint8_t* __restrict__ cost, int H, int W,
                                   int D, int ry, int rx, int d_start,
                                   int max_cost) {
  extern __shared__ uint64_t smem[];
  uint64_t* cen_l = smem;
  uint64_t* cen_r = smem + W;
  const int ch = 2 * ry + 1;
  uint8_t* rows_l = reinterpret_cast<uint8_t*>(smem + 2 * W);
  uint8_t* rows_r = rows_l + ch * W;

  const int row = blockIdx.x;  // b * H + y
  const int b = row / H, y = row % H;
  const uint8_t* lb = left + (size_t)b * H * W;
  const uint8_t* rb = right + (size_t)b * H * W;
  for (int i = threadIdx.x; i < ch * W; i += blockDim.x) {
    const int r = i / W, x = i % W;
    const int yy = min(max(y + r - ry, 0), H - 1);
    rows_l[i] = lb[(size_t)yy * W + x];
    rows_r[i] = rb[(size_t)yy * W + x];
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const uint8_t cl = rows_l[ry * W + x], cr = rows_r[ry * W + x];
    uint64_t wl = 0, wr = 0;
    int bit = 0;
    for (int dy = 0; dy < ch; ++dy) {
      for (int dx = -rx; dx <= rx; ++dx) {
        if (dy == ry && dx == 0) continue;
        const int xx = min(max(x + dx, 0), W - 1);
        wl |= (uint64_t)(rows_l[dy * W + xx] < cl) << bit;
        wr |= (uint64_t)(rows_r[dy * W + xx] < cr) << bit;
        ++bit;
      }
    }
    cen_l[x] = wl;
    cen_r[x] = wr;
  }
  __syncthreads();

  uint8_t* out = cost + (size_t)row * W * D;
  if (VEC4) {
    const int n4 = W * D / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const int x = (4 * i) / D, d0 = (4 * i) % D;
      const uint64_t wl = cen_l[x];
      uint32_t packed = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xr = x - d_start - d0 - k;
        const uint32_t v = xr >= 0 ? __popcll(wl ^ cen_r[xr]) : max_cost;
        packed |= v << (8 * k);
      }
      reinterpret_cast<uint32_t*>(out)[i] = packed;
    }
  } else {
    for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
      const int x = i / D, d = i % D;
      const int xr = x - d_start - d;
      out[i] = xr >= 0 ? __popcll(cen_l[x] ^ cen_r[xr]) : max_cost;
    }
  }
}

TPS_EXPORT size_t census_cost_smem_bytes(int W, int ch) {
  return (size_t)2 * W * sizeof(uint64_t) + (size_t)2 * ch * W;
}

TPS_EXPORT int census_cost_launch(const uint8_t* left, const uint8_t* right,
                                  uint8_t* cost, int B, int H, int W, int D,
                                  int ch, int cw, int d_start, int max_cost,
                                  void* stream) {
  const size_t smem = census_cost_smem_bytes(W, ch);
  const int threads = 256;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0) {
    cudaFuncSetAttribute(census_cost_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    census_cost_kernel<true><<<B * H, threads, smem, s>>>(
        left, right, cost, H, W, D, ch / 2, cw / 2, d_start, max_cost);
  } else {
    cudaFuncSetAttribute(census_cost_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    census_cost_kernel<false><<<B * H, threads, smem, s>>>(
        left, right, cost, H, W, D, ch / 2, cw / 2, d_start, max_cost);
  }
  return (int)cudaGetLastError();
}
