// Ascending bitonic sort of int32 keys with an optional int32 payload, many
// independent rows in one call.
//
// Replaces: tpustereo/kernels/bitonic_pallas.py, bitonic_sort_pallas (its
// kernel `_kernel` through `_part_call`, and the cross-part exchanges of
// `_cross_exchange`).
//
// Each row of rows x 2^n_log2 (padded by the caller with 2^31 - 1 keys and
// 0 payloads) runs the XOR-pairing bitonic network: stages k = 1..n_log2,
// substages j = k-1..0; the pair (i, i + 2^j), bit j of i clear, is put in
// ascending order iff bit k of i is 0, and swaps (keys and payloads
// together) only where the high key is strictly below the low one
// (ascending) or the low strictly below the high (descending). Equal keys
// never swap, so the payload order is the network's own, the same as the
// TPU kernel's blocked schedule of that network gives.
//
// Bound on this card: bytes for one pass (each key and payload read and
// written once) but the network does n/2 * n_log2 * (n_log2 + 1) / 2
// compare-exchanges, and its substages with j >= 12 each stream the whole
// array through device memory (L2 at the speckle sizes).
//
// Design, simple first: tiles of 2^12 keys (and payloads) sit in shared
// memory, 1024 threads to a tile. One tile launch runs every stage k <= 12
// (all their substages); then each later stage runs its substages
// j >= 12 as one global launch apiece (a thread per pair) and its
// substages j < 12 as one more tile launch. The TPU kernel's VMEM blocking
// (parts of 2^17) and its roll-based partner exchange have no counterpart
// here: a partner is an index.
#include "common.cuh"

constexpr int TILE_LOG2 = 12;
constexpr int TILE_THREADS = 1024;

// Index of the low element of pair q at distance 2^j: q with a 0 put in at
// bit j.
__device__ __forceinline__ long pair_lo(long q, int j) {
  return ((q >> j) << (j + 1)) | (q & ((1L << j) - 1));
}

template <bool P>
__device__ __forceinline__ void cmpx(int* k, int* p, long lo, long hi,
                                     bool asc) {
  const int a = k[lo], b = k[hi];
  if (asc ? b < a : a < b) {
    k[lo] = b;
    k[hi] = a;
    if constexpr (P) {
      const int t = p[lo];
      p[lo] = p[hi];
      p[hi] = t;
    }
  }
}

// One tile of 2^t elements of row blockIdx.y in shared memory: stages
// k0..k1, each through its substages min(k, t)-1 .. 0.
template <bool P>
__global__ void bitonic_tile(int* __restrict__ keys, int* __restrict__ pay,
                             long n2, int t, int k0, int k1) {
  __shared__ int sk[1 << TILE_LOG2];
  __shared__ int sp[P ? 1 << TILE_LOG2 : 1];
  const int T = 1 << t;
  const long base = (long)blockIdx.y * n2 + ((long)blockIdx.x << t);
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    sk[i] = keys[base + i];
    if constexpr (P) sp[i] = pay[base + i];
  }
  __syncthreads();
  const long g0 = (long)blockIdx.x << t;  // the tile's first index in its row
  for (int k = k0; k <= k1; ++k) {
    for (int j = min(k, t) - 1; j >= 0; --j) {
      for (int q = threadIdx.x; q < T / 2; q += blockDim.x) {
        const long lo = pair_lo(q, j);
        cmpx<P>(sk, sp, lo, lo + (1L << j), (((g0 + lo) >> k) & 1) == 0);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    keys[base + i] = sk[i];
    if constexpr (P) pay[base + i] = sp[i];
  }
}

// Substage j of stage k over whole rows: one thread per pair.
template <bool P>
__global__ void bitonic_global(int* __restrict__ keys, int* __restrict__ pay,
                               long n2, long pairs, int k, int j) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  const long row = idx / (n2 >> 1);
  const long lo = pair_lo(idx - row * (n2 >> 1), j);
  const long off = row * n2;
  cmpx<P>(keys + off, P ? pay + off : pay, lo, lo + (1L << j),
          ((lo >> k) & 1) == 0);
}

template <bool P>
static void run(int* keys, int* pay, int rows, int n_log2, cudaStream_t s) {
  const int t = min(n_log2, TILE_LOG2);
  const long n2 = 1L << n_log2;
  const dim3 tiles((unsigned)(n2 >> t), (unsigned)rows);
  const int threads = min(TILE_THREADS, 1 << (t - 1));
  const long pairs = (long)rows * (n2 >> 1);
  const unsigned blocks = (unsigned)((pairs + 255) / 256);
  bitonic_tile<P><<<tiles, threads, 0, s>>>(keys, pay, n2, t, 1, t);
  for (int k = t + 1; k <= n_log2; ++k) {
    for (int j = k - 1; j >= t; --j)
      bitonic_global<P><<<blocks, 256, 0, s>>>(keys, pay, n2, pairs, k, j);
    bitonic_tile<P><<<tiles, threads, 0, s>>>(keys, pay, n2, t, k, k);
  }
}

// keys (and pay, which may be null) are rows x 2^n_log2 int32, sorted in
// place along each row; n_log2 >= 8.
TPS_EXPORT int bitonic_launch(int* keys, int* pay, int rows, int n_log2,
                              void* stream) {
  if (n_log2 < 8 || n_log2 > 30 || rows < 1 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pay != nullptr)
    run<true>(keys, pay, rows, n_log2, s);
  else
    run<false>(keys, pay, rows, n_log2, s);
  return (int)cudaGetLastError();
}
