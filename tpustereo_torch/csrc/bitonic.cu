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
// TPU kernel's blocked schedule of that network gives. The schedule below
// runs every compare-exchange of that network, each on the same two
// elements as the network's, in an order that keeps every substage after
// the one before it on the elements they share: so it gives the network's
// output, payload order included.
//
// Bound on this card: bytes for one pass (each key and payload read and
// written once), but the network does n/2 * n_log2 * (n_log2 + 1) / 2
// compare-exchanges, and every launch streams the whole array (through L2
// at the speckle sizes: 16 MB for the pair sort of 4 KITTI frames).
//
// Design: a group of 2^m elements whose indices differ only in bits
// jlo .. jlo + m - 1 is closed under substages jlo + m - 1 .. jlo of any
// stage k > jlo + m - 1, and all of it goes one way (bit k of its first
// index). So a thread loads one group into registers, runs those m
// substages there with no barrier, and stores it back. With a payload a
// descending group's keys are bit-inverted in registers (~key reverses
// int32 order), so its selects run the ascending network.
//   - Tiles of 2^TILE_LOG2 elements of a row sit in dynamic shared memory
//     (keys and payloads: 128 KB at 2^14, opted in past 48 KB), read and
//     written by 16-byte coalesced accesses, one thread to each
//     2^REG_LOG2 of them. Stages 1..REG_LOG2 run on each thread's
//     contiguous elements; every later substage below the tile runs in
//     groups of REG_LOG2 substages (the last group of a stage contiguous
//     again), one barrier a group.
//   - Substages at or above the tile run in global launches of GLOBAL_M
//     consecutive substages each (the fewer left at the bottom of a
//     stage), a thread a group of 2^GLOBAL_M elements at stride 2^jlo:
//     neighbouring threads read neighbouring addresses.
//   - A stage k past the tile is those global launches, then one tile
//     launch for its substages below the tile.
// At 2^19 with tiles of 2^14 and GLOBAL_M = 5 one sort makes 11 launches.
//
// Shared memory is swizzled within each 32-word row (`swz`) so that the
// groups' loads at strides 1, 16 and 256 words hit 32 distinct banks
// (REG_LOG2 = 4; larger strides are whole rows and conflict-free anyway).
// The swizzle is XOR-linear and a group's first index shares no bit with
// its offsets e << jlo, so an element's place is swz(first) ^ swz(e << jlo):
// with jlo a template parameter the second is a constant, and the address
// costs one XOR at most (none past jlo = 8); from a run-time jlo it took
// several instructions an element (the pair sort of 4 rows of 2^19 about
// 8 % slower on an H100).
#include "common.cuh"

#ifndef BITONIC_TILE_LOG2
#define BITONIC_TILE_LOG2 14
#endif
#ifndef BITONIC_REG_LOG2
#define BITONIC_REG_LOG2 4
#endif
#ifndef BITONIC_GLOBAL_M
#define BITONIC_GLOBAL_M 5
#endif

constexpr int TILE_LOG2 = BITONIC_TILE_LOG2;
constexpr int R = BITONIC_REG_LOG2;  // a tile thread holds 2^R elements
constexpr int GM = BITONIC_GLOBAL_M;  // substages a global launch runs
constexpr int TILE_THREADS = 1 << (TILE_LOG2 - R);
constexpr int GLOBAL_THREADS = 256;
constexpr int MIN_LOG2 = 8;
static_assert(R >= 1 && R <= 5, "REG_LOG2 in 1..5");
static_assert(GM >= 1 && GM <= 5, "GLOBAL_M in 1..5");
static_assert(TILE_LOG2 >= MIN_LOG2 && TILE_LOG2 - R <= 10,
              "TILE_LOG2 in 8..R+10");

template <int M, bool P>
struct Group {
  int k[1 << M];
  int p[P ? 1 << M : 1];
};

// The first index of group q of substages jlo + M - 1 .. jlo: q with M zero
// bits put in at bit jlo.
template <int M>
__device__ __forceinline__ int group_base(int q, int jlo) {
  return ((q >> jlo) << (jlo + M)) | (q & ((1 << jlo) - 1));
}

// A tile index's place in shared memory: the low 5 bits XORed with bits
// 5..8 and bit 8 again (one permutation of each 32-word row).
__device__ __forceinline__ int swz(int i) {
  return i ^ (((i >> 5) & 15) | ((i >> 4) & 16));
}

// Compare-exchange of elements a < b of a group, ascending iff asc. Keys
// alone are a min and a max (equal keys cannot be told apart).
template <int M, bool P>
__device__ __forceinline__ void cx(Group<M, P>& g, int a, int b, bool asc) {
  const int ka = g.k[a], kb = g.k[b];
  if constexpr (P) {
    const bool sw = asc ? kb < ka : ka < kb;
    g.k[a] = sw ? kb : ka;
    g.k[b] = sw ? ka : kb;
    const int pa = g.p[a], pb = g.p[b];
    g.p[a] = sw ? pb : pa;
    g.p[b] = sw ? pa : pb;
  } else {
    g.k[a] = asc ? min(ka, kb) : max(ka, kb);
    g.k[b] = asc ? max(ka, kb) : min(ka, kb);
  }
}

// Substages M-1 .. 0 of one group, all one way: element e meets e + 2^s at
// substage s. With a payload the keys come in bit-inverted where the group
// descends (x = -1), so the selects always run the ascending network; keys
// alone take the direction into their min and max.
template <int M, bool P>
__device__ __forceinline__ void group_net(Group<M, P>& g, int x) {
#pragma unroll
  for (int s = M - 1; s >= 0; --s)
#pragma unroll
    for (int e = 0; e < (1 << M); ++e)
      if (!(e & (1 << s))) cx<M, P>(g, e, e | (1 << s), P || x == 0);
}

// Stages 1..R of a thread's 2^R contiguous elements, whose first index in
// the row is base: in stage k < R the direction changes inside the group.
template <bool P>
__device__ __forceinline__ void first_stages(Group<R, P>& g, int base) {
#pragma unroll
  for (int k = 1; k <= R; ++k)
#pragma unroll
    for (int s = k - 1; s >= 0; --s)
#pragma unroll
      for (int e = 0; e < (1 << R); ++e)
        if (!(e & (1 << s)))
          cx<R, P>(g, e, e | (1 << s),
                   k < R ? !((e >> k) & 1) : !((base >> R) & 1));
}

// Element e of the group at stride 2^JLO whose first index has the
// shared-memory place sb: sb ^ swz(e << JLO), the XOR only on the low 5
// bits (the others of sb are 0 there).
template <int JLO>
__device__ __forceinline__ int place(int sb, int e) {
  const int c = swz(e << JLO);
  return (sb ^ (c & 31)) + (c & ~31);
}

// The group whose first index has the place sb, in shared memory; with a
// payload, keys XORed with x (0, or -1 where the group descends) on the way
// in and out.
template <int M, int JLO, bool P>
__device__ __forceinline__ void smem_load(Group<M, P>& g, const int* sk,
                                          const int* sp, int sb, int x) {
#pragma unroll
  for (int e = 0; e < (1 << M); ++e) {
    const int i = place<JLO>(sb, e);
    g.k[e] = P ? sk[i] ^ x : sk[i];
    if constexpr (P) g.p[e] = sp[i];
  }
}

template <int M, int JLO, bool P>
__device__ __forceinline__ void smem_store(const Group<M, P>& g, int* sk,
                                           int* sp, int sb, int x) {
#pragma unroll
  for (int e = 0; e < (1 << M); ++e) {
    const int i = place<JLO>(sb, e);
    sk[i] = P ? g.k[e] ^ x : g.k[e];
    if constexpr (P) sp[i] = g.p[e];
  }
}

// Substages JLO + M - 1 .. JLO of stage k on a tile of 2^t elements in
// shared memory whose first index in its row is g0.
template <int M, int JLO, bool P>
__device__ void smem_chunk(int* sk, int* sp, int t, int k, int g0) {
  for (int q = threadIdx.x; q < (1 << (t - M)); q += blockDim.x) {
    const int base = group_base<M>(q, JLO);
    const int x = -(((g0 + base) >> k) & 1);
    const int sb = swz(base);
    Group<M, P> g;
    smem_load<M, JLO, P>(g, sk, sp, sb, x);
    group_net<M, P>(g, x);
    smem_store<M, JLO, P>(g, sk, sp, sb, x);
  }
}

// smem_chunk<m, jlo> for the run-time m (1..R) and jlo (a multiple of R).
template <int JLO, bool P>
__device__ void smem_chunk_at(int m, int jlo, int* sk, int* sp, int t,
                              int k, int g0) {
  if constexpr (JLO < TILE_LOG2) {
    if (jlo != JLO) {
      smem_chunk_at<JLO + R, P>(m, jlo, sk, sp, t, k, g0);
      return;
    }
    switch (m) {
#define TPS_CHUNK_CASE(M)                                                  \
  case M:                                                                  \
    if constexpr (M <= R && JLO + M <= TILE_LOG2)                          \
      smem_chunk<M, JLO, P>(sk, sp, t, k, g0);                             \
    break;
      TPS_CHUNK_CASE(1)
      TPS_CHUNK_CASE(2)
      TPS_CHUNK_CASE(3)
      TPS_CHUNK_CASE(4)
      TPS_CHUNK_CASE(5)
#undef TPS_CHUNK_CASE
    }
  }
}

// One tile of 2^t elements of row blockIdx.y, 2^(t - R) threads: stages
// k0..k1 (k0 = 1: all of stages 1..t; else k0 = k1 > t), each through its
// substages min(k, t)-1 .. 0.
template <bool P>
__global__ void __launch_bounds__(TILE_THREADS)
    bitonic_tile(int* __restrict__ keys, int* __restrict__ pay, int n_log2,
                 int t, int k0, int k1) {
  extern __shared__ int smem[];
  int* sk = smem;
  int* sp = smem + (1 << t);
  const int g0 = blockIdx.x << t;  // the tile's first index in its row
  const long off = ((long)blockIdx.y << n_log2) + g0;
  const int c0 = threadIdx.x << R;  // this thread's contiguous elements
  // the tile in by 16-byte loads, neighbouring threads on neighbouring
  // addresses (swz(4q + c) = swz(4q) ^ c); a thread's 64 contiguous bytes
  // straight from and to device memory, half a sector an access, took 1.2x
  // as long on an H100
  for (int q = threadIdx.x; q < (1 << t) / 4; q += blockDim.x) {
    const int sb = swz(4 * q);
    const int4 w = reinterpret_cast<const int4*>(keys + off)[q];
    sk[sb] = w.x, sk[sb ^ 1] = w.y, sk[sb ^ 2] = w.z, sk[sb ^ 3] = w.w;
    if constexpr (P) {
      const int4 v = reinterpret_cast<const int4*>(pay + off)[q];
      sp[sb] = v.x, sp[sb ^ 1] = v.y, sp[sb ^ 2] = v.z, sp[sb ^ 3] = v.w;
    }
  }
  __syncthreads();
  if (k0 == 1) {
    Group<R, P> g;
    smem_load<R, 0, P>(g, sk, sp, swz(c0), 0);
    first_stages<P>(g, g0 + c0);
    smem_store<R, 0, P>(g, sk, sp, swz(c0), 0);
    __syncthreads();
  }
  for (int k = k0 == 1 ? R + 1 : k0; k <= k1; ++k) {
    // substages min(k, t)-1 .. 0 in groups of R, aligned at multiples of R
    for (int jhi = min(k, t) - 1; jhi >= 0;) {
      const int jlo = jhi / R * R;
      if (jlo == 0 && k == k1) {
        // the last group: contiguous, back to shared memory, then out to
        // the row by 16-byte stores
        const int x = -(((g0 + c0) >> k) & 1);
        Group<R, P> g;
        smem_load<R, 0, P>(g, sk, sp, swz(c0), x);
        group_net<R, P>(g, x);
        smem_store<R, 0, P>(g, sk, sp, swz(c0), x);
        __syncthreads();
        for (int q = threadIdx.x; q < (1 << t) / 4; q += blockDim.x) {
          const int sb = swz(4 * q);
          reinterpret_cast<int4*>(keys + off)[q] =
              make_int4(sk[sb], sk[sb ^ 1], sk[sb ^ 2], sk[sb ^ 3]);
          if constexpr (P)
            reinterpret_cast<int4*>(pay + off)[q] =
                make_int4(sp[sb], sp[sb ^ 1], sp[sb ^ 2], sp[sb ^ 3]);
        }
        return;
      }
      smem_chunk_at<0, P>(jhi - jlo + 1, jlo, sk, sp, t, k, g0);
      __syncthreads();
      jhi = jlo - 1;
    }
  }
}

// Substages jlo + M - 1 .. jlo (all at or above the tile) of stage k over
// whole rows of 2^n_log2: one thread a group of 2^M elements.
template <int M, bool P>
__global__ void __launch_bounds__(GLOBAL_THREADS)
    bitonic_global(int* __restrict__ keys, int* __restrict__ pay, int n_log2,
                   long groups, int k, int jlo) {
  const long gid = (long)blockIdx.x * GLOBAL_THREADS + threadIdx.x;
  if (gid >= groups) return;
  const int per_row = n_log2 - M;  // log2 of the groups a row
  const int base = group_base<M>((int)(gid & ((1L << per_row) - 1)), jlo);
  const long off = ((gid >> per_row) << n_log2) + base;
  const int x = -((base >> k) & 1);
  Group<M, P> g;
#pragma unroll
  for (int e = 0; e < (1 << M); ++e) {
    g.k[e] = keys[off + ((long)e << jlo)] ^ (P ? x : 0);
    if constexpr (P) g.p[e] = pay[off + ((long)e << jlo)];
  }
  group_net<M, P>(g, x);
#pragma unroll
  for (int e = 0; e < (1 << M); ++e) {
    keys[off + ((long)e << jlo)] = g.k[e] ^ (P ? x : 0);
    if constexpr (P) pay[off + ((long)e << jlo)] = g.p[e];
  }
}

template <bool P>
static void global_m(int m, unsigned blocks, cudaStream_t s, int* keys,
                     int* pay, int n_log2, long groups, int k, int jlo) {
  switch (m) {
#define TPS_GLOBAL_CASE(M)                                              \
  case M:                                                               \
    if constexpr (GM >= M)                                              \
      bitonic_global<M, P><<<blocks, GLOBAL_THREADS, 0, s>>>(           \
          keys, pay, n_log2, groups, k, jlo);                           \
    break;
    TPS_GLOBAL_CASE(1)
    TPS_GLOBAL_CASE(2)
    TPS_GLOBAL_CASE(3)
    TPS_GLOBAL_CASE(4)
    TPS_GLOBAL_CASE(5)
#undef TPS_GLOBAL_CASE
  }
}

// The schedule of one sort: launches its kernels on s, or with keys null
// only counts them. Returns the count, or minus a CUDA error.
template <bool P>
static int run(int* keys, int* pay, int rows, int n_log2, cudaStream_t s) {
  const int t = min(n_log2, TILE_LOG2);
  const bool go = keys != nullptr;
  if (go) {
    // opt in to the largest tile's shared memory once
    static const cudaError_t opt = cudaFuncSetAttribute(
        bitonic_tile<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((P ? 2 : 1) * sizeof(int)) << TILE_LOG2);
    if (opt != cudaSuccess) return -(int)opt;
  }
  const dim3 tiles(1u << (n_log2 - t), (unsigned)rows);
  const unsigned threads = 1u << (t - R);
  const size_t smem = (P ? 2 : 1) * sizeof(int) << t;
  int n = 0;
  auto tile = [&](int k0, int k1) -> cudaError_t {
    ++n;
    if (!go) return cudaSuccess;
    bitonic_tile<P><<<tiles, threads, smem, s>>>(keys, pay, n_log2, t, k0,
                                                 k1);
    return cudaGetLastError();
  };
  cudaError_t e = tile(1, t);
  for (int k = t + 1; k <= n_log2 && e == cudaSuccess; ++k) {
    for (int jhi = k - 1; jhi >= t && e == cudaSuccess;) {
      const int m = min(GM, jhi - t + 1);
      ++n;
      if (go) {
        const long groups = (long)rows << (n_log2 - m);
        global_m<P>(m, (unsigned)((groups + GLOBAL_THREADS - 1) /
                                  GLOBAL_THREADS),
                    s, keys, pay, n_log2, groups, k, jhi - m + 1);
        e = cudaGetLastError();
      }
      jhi -= m;
    }
    if (e == cudaSuccess) e = tile(k, k);
  }
  return e == cudaSuccess ? n : -(int)e;
}

// keys (and pay, which may be null) are rows x 2^n_log2 int32, sorted in
// place along each row; n_log2 >= 8.
TPS_EXPORT int bitonic_launch(int* keys, int* pay, int rows, int n_log2,
                              void* stream) {
  if (keys == nullptr || n_log2 < MIN_LOG2 || n_log2 > 30 || rows < 1 ||
      rows > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = pay != nullptr ? run<true>(keys, pay, rows, n_log2, s)
                               : run<false>(keys, pay, rows, n_log2, s);
  return n < 0 ? -n : 0;
}

// The number of kernel launches one bitonic_launch of rows of 2^n_log2
// makes (the same for keys alone and with a payload), or -1.
TPS_EXPORT int bitonic_launches(int n_log2) {
  if (n_log2 < MIN_LOG2 || n_log2 > 30) return -1;
  return run<false>(nullptr, nullptr, 1, n_log2, nullptr);
}
