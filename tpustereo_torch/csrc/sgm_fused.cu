// The SGM sweeps of one scan order, fused: writes the sum over the column
// shifts dxs of L_(dy,dx), or adds it to the partial sum S.
//
// Replaces: tpustereo/kernels/sgm_pallas.py, sgm_sweep with K = len(dxs) > 1
// (kernel body `_sweep_kernel`), which the JAX `sgm_select_pallas` and
// `aggregate_pallas` call for the down set {S, SE, SW} (dxs (0, 1, -1)) and
// the up set {N, NE, NW} (the same dxs, `reverse`); its first sweep of a
// schedule takes S_in = None and writes S, the later ones accumulate; with
// `p2_maps` (adaptive P2) each direction has its own P2 at each pixel.
//
// For each dx of dxs and r = (dy, dx) it computes
//   L_r(p) = C(p) + min(Lp, Lp(d-1) + P1, Lp(d+1) + P1, minLp + P2) - minLp
// over the predecessor p - r, and L_r(p) = C(p) where p - r lies outside the
// image (the JAX `has_prev` restart rule), then writes S = sum_r L_r
// (accumulate == 0) or adds it, S += sum_r L_r (accumulate == 1). dy = +1 is
// the down order (rows 0 .. H-1), -1 the up order. The ring hand-off of the
// exact strip tiling (the JAX `init_carry` / `return_final_carry`, a (K, N,
// D) q-form carry): a carry in seeds each direction's row before row 0, and
// a carry out returns each direction's q of the last row. P2 is the scalar, or,
// given the left image I (B, H, W) uint8, P2'(p) = max(P1 + 1, P2 // max(1,
// |I(p) - I(p - r)|)) for each direction. C is (B, H, W, D) uint8 and S
// int16 of the same shape; int16 sums wrap, as the plain version's do.
//
// Bound on this card: bytes, as the one-direction sweep: C read once and S
// written once (3 bytes a cost), or also read (5), for all the directions
// together; about 9 integer operations a cost and direction.
//
// Design. A direction's step at row y, column x reads the previous row in
// sweep order at x - dx, so the directions of one scan order share a row
// wavefront: a pixel's predecessors lie in the neighbouring columns. One
// warp a line, as in `sgm_sweep.cu`, cannot serve three directions from one
// read. Here a block owns a tile of TW adjacent columns of one frame and
// walks the rows; the state is each direction's renormalised carry
// q = L - min_d L (at most c_max + P2, so int16; the wrapper checks
// 255 + P2 < 2^15), kept per column in a shared-memory row buffer,
// double-buffered by row parity, with one block barrier a row.
//   * Slots: the block's columns are TW own columns and FR halo columns on
//     each side, NWARP warps holding NS / NWARP slots each (slot s to warp
//     s % NWARP, so every warp holds the same mix of halo and own slots).
//     An own slot computes every direction and writes S; a left halo slot
//     computes only dx = +1 and a right halo slot only dx = -1, the only
//     directions whose predecessors cross into the tile from that side.
//   * Lanes run over D as in the one-direction kernel: K = D/32 (rounded up
//     to a power of two) contiguous disparities a lane, the predecessor's
//     K values one vector load from the row buffer, d +- 1 across lanes
//     (read from the buffer, or by shuffle), min_d L by one
//     __reduce_min_sync. Disparities past D hold a
//     large sentinel in the buffer, and a column outside the image (or the
//     zero row, for a predecessor outside the block) holds q = 0, whose
//     step is L = C: the restart rule needs no test.
//   * The row buffer holds three rows a slot (one a direction; a halo slot
//     uses one) and a zero slot on each side, so a predecessor's row lies
//     dx * 3 rows before its own in every slot, and the steps' shared-memory
//     offsets are constants from one base a warp (an earlier layout kept
//     own and halo rows apart behind a per-slot offset table and selects,
//     and spilled).
//   * Three directions a pass triple the integer work per byte moved, so
//     the step is cut to the bone where all three run, every lane is full
//     at D = 64, 128 or 256, the volumes are 16-byte aligned and
//     c_max + P1 + P2 < 2^15 (the presets' case):
//     the carry stays in the s16x2 pairs the buffer stores (two
//     disparities a word), a step is Hopper's DPX min-plus on pairs, the
//     directions' sum and the add form's partial sum are per-half adds,
//     and a lane moves words, not elements; a direction's minimum over d
//     is one permute and one DPX minimum a lane, in both halves, then one
//     __reduce_min_sync. A row of that build is straight-line code over the
//     warp's slots and directions, without a branch between them, so that
//     their independent chains interleave; its columns outside the image
//     compute on zeroed ring slots. It keeps every slot's and direction's
//     words live, so it is compiled for 2 blocks an SM (128 registers: at
//     3, a cap of 80, it spilled). Every other request runs the
//     int32 build, one direction after another, with plain loads and
//     stores (one build keeps the compile short).
//   * Tile edges. A halo column's value is exact only as far as the
//     predecessors it saw were: an unknown value beyond the block spreads
//     inwards one column a row, so after FR rows it reaches the last halo
//     column and never an own one. So tiles exchange their edge columns
//     once every FR rows (a band): at a band's end a tile writes its first
//     FR columns' q of dx = -1 and its last FR columns' q of dx = +1 to a
//     global buffer (double-buffered by band parity) and publishes the
//     band in a per-tile flag (release); at the next band's start it waits
//     for its neighbours' flags (acquire) and loads their edge q into its
//     halo slots. The edges move in vector `.cg` accesses, and one thread
//     fences after the band's barrier before the flag. A tile waits for
//     both neighbours whatever its directions, so none runs two bands ahead
//     of a tile that has still to read its edges. The blocks of a frame
//     wait on each other, so they must be resident together: the launch is
//     cooperative, its grid the tiles
//     of as many frames as fit on the card at once, each block walking the
//     frames of its group in turn. A frame with more tiles than the card
//     holds blocks (past some 3,200 columns at D = 256 or 1,050 at D = 512)
//     goes one at a time, each block owning TPB adjacent tiles and walking
//     them band by band, left to right: it keeps a tile's own carries in
//     global memory between its bands and reloads them, with its halo from
//     the exchange, when the tile's next band starts. Its inner neighbours'
//     flags are then already up, and the outer ones' blocks are resident,
//     so the waits still end. A sweep of at most FR rows, or without a
//     diagonal, exchanges nothing and takes a plain launch of every frame's
//     tiles.
//   * Loads run ahead of the rows. In the s16x2 build the block copies
//     each row's C of the tile's columns (and in the add form the own
//     columns' S), a few contiguous spans, in 16-byte cp.async pieces
//     spread over its threads into a ring of 2 rows, one row ahead: at a
//     row's end every thread waits for its copies of the next row, the
//     row barrier makes them everyone's, and then the row after is issued
//     into the slot just swept (a warp's own pixel copies, 4 or 8 bytes a
//     lane, took several times the instructions and stalled on the copy
//     queue). The int32 build keeps a per-warp ring RING rows ahead, each
//     lane loading its own K costs (and sums) of each of its warp's slots
//     with plain loads, and reading back only what it copied.
//   * Adaptive P2 (I given): lane 3j + k of a warp holds slot j's P2' of
//     direction k, computed from the two image bytes it loads a row ahead;
//     a step takes it by one shuffle, off the carry's dependent chain.
//   * S is written once a pixel, the directions summed in registers: each
//     lane's K int16 with one vector store, the add form's partial sums
//     added per 16-bit half.
//   * The ring hand-off: a carry in (int32, one slab a direction) is copied
//     into the row buffer of the row before row 0 for every slot that
//     computes the direction, halo slots too (a halo column next to the
//     block still reads the zero slot, an unknown value that stays in the
//     halo for a band, as anywhere else); the carry out is copied from the
//     own slots' rows after the last row, outside the row loop.
#include "common.cuh"

// Compile-time sizes. The shipped build takes these defaults; the
// candidate builds of `bench/kernel_micro.py sgm_fused` set them with -D
// (each candidate's times are in PERF.md).
#ifndef FUSED_TW
#define FUSED_TW 24  // own columns a tile at D <= 256 (a multiple of 8)
#endif
#ifndef FUSED_RING
#define FUSED_RING 2  // the int32 build's rows in flight at D <= 256 (a
                      // power of two; the s16x2 build's ring holds 2)
#endif
#ifndef FUSED_MINB
#define FUSED_MINB 2  // blocks an SM the s16x2 build is compiled for (at 3
                      // it was slower in the add forms and at D = 256)
#endif
#ifndef FUSED_PACKED_MAXK
#define FUSED_PACKED_MAXK 8  // the largest K (disparities a lane) with an
                             // s16x2 build: D = 256. At D = 512 the pipeline
                             // takes the one-direction launches
                             // (`kernels.sgm.FUSED_MAX_D`), which beat the
                             // s16x2 build there; direct calls take int32.
#endif
constexpr int NWARP = 8;      // warps a block
constexpr int FR = 8;         // halo columns a side, and rows a band
constexpr int QBIG = 0x7fff;  // the row buffer's value for d >= D
static_assert(FUSED_TW % 8 == 0 && (FUSED_RING & (FUSED_RING - 1)) == 0 &&
                  (FUSED_PACKED_MAXK == 8 || FUSED_PACKED_MAXK == 16),
              "tile width, ring depth or the s16x2 build's largest K");
// K with an s16x2 build
template <int K>
constexpr bool kPackable = K >= 2 && K <= FUSED_PACKED_MAXK;
#ifdef FUSED_PHASES
// The micro-benchmark's split of a row's cycles (`bench/kernel_micro.py
// sgm_fused`, never on the path): every thread stamps clock() at each
// phase's end, and lane 0 of each warp adds its sums, and the rows it
// walked, to g_phase at the end. The phases: 0 the band's edge loads and
// waits, 1 the ring wait, 2 the row's loads, 3 the steps, 4 the warp
// minimums, 5 the stores, 6 the ring refill, 7 the row barrier, 8 the
// band's edge stores and flag, 9 the rest (tile and frame set-up).
constexpr int NPHASE = 10;
__device__ unsigned long long g_phase[NPHASE + 1];
#define PHASE(i)                          \
  do {                                    \
    const unsigned now_ = (unsigned)clock(); \
    ph_[i] += now_ - last_;               \
    last_ = now_;                         \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

// slot s of a tile goes to warp s % NWARP, as its slot j = s / NWARP; with
// NWARP = FR, a warp's slot 0 is a left halo column, its last slot a right
// halo column and the others own columns
static_assert(NWARP == FR, "one halo column a side a warp");

// the tile geometry at K disparities a lane
template <int K>
struct Geo {
  static constexpr int TW = K >= 16 ? 8 : FUSED_TW;     // own columns
  static constexpr int NS = TW + 2 * FR;                // halo, own, halo
  static constexpr int SPW = NS / NWARP;                // slots a warp
  static constexpr int RING = K >= 16 ? 2 : FUSED_RING;  // rows in flight
  static constexpr int DP = 32 * K;             // disparities a buffer row
};

// A warp's ring row: each lane's costs of its two halo columns (CB bytes a
// lane each) and, for each own column, its costs and, in the add form, its
// partial sums (SB bytes a lane).
template <int K, bool ACC>
struct Ring {
  static constexpr int CB = K < 4 ? 4 : K;
  static constexpr int SB = 2 * K < 4 ? 4 : 2 * K;
  static constexpr int halo = 32 * CB;
  static constexpr int own = 32 * (CB + (ACC ? SB : 0));
  static constexpr int row = 2 * halo + (Geo<K>::SPW - 2) * own;
  // where slot j's costs start in a row; an own slot's sums follow them
  __host__ __device__ static constexpr int at(int j) {
    return j == 0 ? 0 : halo + (j - 1) * own;
  }
};

// The row buffer of one row parity: three rows of DP int16 for each slot,
// one a direction (a halo slot uses one of them), row (s + 1) * 3 + k for
// slot s and direction k, with a zero slot on each side (s = -1 and s =
// NS), the predecessors of the block's first and last columns. So a
// direction's predecessor row lies dx * 3 rows before its own row, in
// every slot: the steps' shared-memory offsets are constants from a base
// a warp.
template <int K>
__host__ __device__ constexpr int q_rows() {
  return (Geo<K>::NS + 2) * 3;
}
// shared memory: a guard row and both parities' rows, then the rings (the
// s16x2 step reads one word before and after a lane's slice of a row, so
// every row has readable neighbours)
template <int K>
__host__ __device__ constexpr int q_bytes() {
  return ((2 * q_rows<K>() + 1) * Geo<K>::DP * 2 + 15) / 16 * 16;
}
// The s16x2 build's ring, filled by the whole block: a row holds the
// tile's NS columns of C as they lie in device memory (DP = D bytes a
// column), then in the add form its TW own columns of S, so a row is a few
// contiguous spans copied in 16-byte pieces. Two rows: a row is copied
// while the one before it is swept.
template <int K, bool ACC>
struct BlockRing {
  static constexpr int c_row = Geo<K>::NS * Geo<K>::DP;
  static constexpr int row = c_row + (ACC ? Geo<K>::TW * Geo<K>::DP * 2 : 0);
};
template <int K, bool ACC, bool PACKED>
__host__ __device__ constexpr int smem_bytes() {
  return q_bytes<K>() + (PACKED ? 2 * BlockRing<K, ACC>::row
                             : NWARP * Geo<K>::RING * Ring<K, ACC>::row);
}

struct FusedArgs {
  const uint8_t* C;
  int16_t* S;
  const uint8_t* I;  // null: the scalar P2
  int* flags;        // [B][T] bands a tile has published, zeroed
  int16_t* xch;      // [B][T][2 band parity][2 sides][FR][DP] edge q
  int16_t* state;    // [T][TW * 3][DP] own carries between bands (TPB > 1)
  const int* cin;    // [nd][B][W][D] q of the row before row 0, or null
  int* cout;         // [nd][B][W][D] q of the last row, or null
  const uint8_t* Iprev;  // [B][W] the image row of cin (adaptive P2)
  int B, H, W, D, dy, nd, dx0, dx1, dx2, p1, p2;
  int slab0, slab1, slab2;  // direction k's slab of cin and cout
  int T, P, TPB, groups, exchange;  // tiles, blocks and a block's tiles a
                                    // frame, frames in flight
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The lane's K int16 at p as int16 pairs (K >= 2; element 2i low in word
// i), in vector accesses of at most 16 bytes; p aligned to min(2K, 16).
template <int K>
__device__ __forceinline__ void load_words(const int16_t* p,
                                           unsigned (&w)[K / 2]) {
  constexpr int N = 2 * K < 16 ? 2 * K : 16;
#pragma unroll
  for (int c = 0; c < 2 * K / N; ++c) {
    const Words<N> v = *reinterpret_cast<const Words<N>*>(p + c * N / 2);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) w[c * N / 4 + i] = v.w[i];
  }
}

template <int K>
__device__ __forceinline__ void store_words(int16_t* p,
                                            const unsigned (&w)[K / 2]) {
  constexpr int N = 2 * K < 16 ? 2 * K : 16;
#pragma unroll
  for (int c = 0; c < 2 * K / N; ++c) {
    Words<N> v;
#pragma unroll
    for (int i = 0; i < N / 4; ++i) v.w[i] = w[c * N / 4 + i];
    *reinterpret_cast<Words<N>*>(p + c * N / 2) = v;
  }
}

// The lane's K int16 of an edge row from or to the exchange buffer in
// device memory, bypassing L1 (`.cg`: another block writes or reads it),
// in vector accesses of at most 16 bytes; both ends aligned to min(2K, 16).
template <int K>
__device__ __forceinline__ void edge_load(int16_t* s, const int16_t* g) {
  if constexpr (K == 1) {
    *s = __ldcg(g);
  } else if constexpr (K == 2) {
    *reinterpret_cast<unsigned*>(s) =
        __ldcg(reinterpret_cast<const unsigned*>(g));
  } else if constexpr (K == 4) {
    *reinterpret_cast<uint2*>(s) = __ldcg(reinterpret_cast<const uint2*>(g));
  } else {
#pragma unroll
    for (int c = 0; c < K / 8; ++c)
      reinterpret_cast<uint4*>(s)[c] =
          __ldcg(reinterpret_cast<const uint4*>(g) + c);
  }
}

template <int K>
__device__ __forceinline__ void edge_store(int16_t* g, const int16_t* s) {
  if constexpr (K == 1) {
    __stcg(g, *s);
  } else if constexpr (K == 2) {
    __stcg(reinterpret_cast<unsigned*>(g),
           *reinterpret_cast<const unsigned*>(s));
  } else if constexpr (K == 4) {
    __stcg(reinterpret_cast<uint2*>(g), *reinterpret_cast<const uint2*>(s));
  } else {
#pragma unroll
    for (int c = 0; c < K / 8; ++c)
      __stcg(reinterpret_cast<uint4*>(g) + c,
             reinterpret_cast<const uint4*>(s)[c]);
  }
}

// the lane's K int16 of a buffer row, from d0, as int32
template <int K>
__device__ __forceinline__ void load_q(const int16_t* row, int d0,
                                       int (&q)[K]) {
  if constexpr (K == 1) {
    q[0] = row[d0];
  } else {
    unsigned w[K / 2];
    load_words<K>(row + d0, w);
#pragma unroll
    for (int k = 0; k < K; ++k) q[k] = (int16_t)(w[k / 2] >> (16 * (k % 2)));
  }
}

template <int K>
__device__ __forceinline__ void store_q(int16_t* row, int d0,
                                        const int (&q)[K]) {
  if constexpr (K == 1) {
    row[d0] = (int16_t)q[0];
  } else {
    unsigned w[K / 2];
#pragma unroll
    for (int i = 0; i < K / 2; ++i)
      w[i] = __byte_perm(q[2 * i], q[2 * i + 1], 0x5410);
    store_words<K>(row + d0, w);
  }
}

// One step of a direction on s16x2 pairs of adjacent disparities, the
// predecessor's carry q renormalised (min_d q = 0), every lane full (D =
// 32 K): L = C + min(q, q(d-1) + P1, q(d+1) + P1, P2) per half in Hopper's
// DPX instructions. left and right are the words before and after the
// lane's slice of the buffer row (read from it, not shuffled: a shuffle
// would chain the warp's steps); d = -1 and d = D have no path, so the
// other neighbour stands in for them, and the words read past the row's
// ends are never used. Exact while c_max + P1 + P2 < 2^15 (the launch's
// condition for this build).
template <int NW>
__device__ __forceinline__ void step_pairs(const unsigned (&c)[NW],
                                           const unsigned (&q)[NW],
                                           unsigned left, unsigned right,
                                           int lane, unsigned p1x2,
                                           unsigned p2x2, unsigned (&L)[NW]) {
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

// The s16x2 build is compiled for FUSED_MINB blocks an SM (128 registers
// a thread at 2: its straight-line row keeps every slot's and direction's
// words live; at 3 blocks, 80 registers, it spilled), the int32 builds
// for 2 at K <= 4 and 1 past it.
template <int K, bool ACC, bool ADAPT, bool PACKED>
__global__ void __launch_bounds__(32 * NWARP,
                                  PACKED ? FUSED_MINB : K <= 4 ? 2 : 1)
    sgm_fused_kernel(const FusedArgs a) {
  using G = Geo<K>;
  using Rg = Ring<K, ACC>;
  constexpr int TW = G::TW, NS = G::NS, SPW = G::SPW;
  constexpr int RING = PACKED ? 2 : G::RING;
  constexpr int DP = G::DP, NW = NWORDS(K);
  extern __shared__ __align__(16) uint8_t smem[];
  const int B = a.B, H = a.H, W = a.W, dy = a.dy, nd = a.nd;
  const int D = PACKED ? 32 * K : a.D;  // every lane full: no d < D masks
  const int p1 = a.p1, p2 = a.p2, T = a.T;
  const int dxs[3] = {a.dx0, a.dx1, a.dx2};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NQ = q_rows<K>();
  int16_t* qbuf = reinterpret_cast<int16_t*>(smem) + DP;  // a guard row
  using BR = BlockRing<K, ACC>;
  // the warp's ring, or the block's
  uint8_t* ring =
      smem + q_bytes<K>() + (PACKED ? 0 : warp * RING * Rg::row);
  const int d0 = lane * K;
  const bool mine = d0 < D;
  const int c_sub = PACKED ? (d0 & 3) : 0, s_sub = PACKED ? (d0 & 1) : 0;
  const int c_at = d0 - c_sub, s_at = d0 - s_sub;
  const unsigned p1x2 = (unsigned)p1 * 0x10001u;
  const ptrdiff_t rowstep = (ptrdiff_t)dy * W;  // pixels a row in sweep order
  // the block's tiles of each frame: a.TPB adjacent ones, walked band by
  // band when there are several (their carries kept in a.state between)
  const int tlo = blockIdx.x % a.P * a.TPB, thi = min(T, tlo + a.TPB);
  const bool multi = a.TPB > 1;
  const int seg = multi ? FR : H;  // rows a tile is walked before the next
  // the buffer offset of the warp's slot j, direction k, and of its
  // predecessor, dx slots to the left (the s16x2 build's dxs are (0, 1,
  // -1): constants)
  auto qrow = [&](int j, int k) {
    return ((warp + j * NWARP + 1) * 3 + k) * DP;
  };
  auto prow = [&](int j, int k) {
    const int dx = PACKED ? (k == 0 ? 0 : k == 1 ? 1 : -1) : dxs[k];
    return qrow(j, k) - dx * 3 * DP;
  };
  // the warp's slots, set for each tile: the column and which directions
  // run
  int xs[SPW];
  bool used[SPW], act[SPW][3];
  // adaptive P2: lane 3j + k holds slot j's P2' of direction k
  const int aj = lane / 3, ak = lane % 3;
  const bool alane = ADAPT && aj < SPW && ak < nd;
  int ax = 0, apx = 0;
  const size_t xch_side = (size_t)FR * DP;
  // the own columns' carries of buffer parity par to or from the tile's
  // place in a.state (16-byte words; the TW * 3 rows of DP int16 of the
  // own slots, from slot FR's)
  auto keep = [&](int par, int tl, bool save) {
    uint4* sm = reinterpret_cast<uint4*>(qbuf + (par * NQ + (FR + 1) * 3) *
                                                    DP);
    uint4* gm = reinterpret_cast<uint4*>(a.state + (size_t)tl * TW * 3 * DP);
    for (int i = threadIdx.x; i < TW * 3 * DP / 8; i += blockDim.x) {
      if (save)
        __stcg(gm + i, sm[i]);
      else
        sm[i] = __ldcg(gm + i);
    }
  };

#ifdef FUSED_PHASES
  unsigned ph_[NPHASE] = {}, last_ = (unsigned)clock(), rows_ = 0;
#endif
  const int slabs[3] = {a.slab0, a.slab1, a.slab2};
  int b = 0;  // the frame a block is on
  // the ring carry of buffer parity par from cin (every slot of the warp
  // that computes a direction) or to cout (own slots only): direction k's
  // slab, int16 in the buffer, int32 outside
  auto carry_io = [&](int par, bool in) {
    if (!mine) return;
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const bool own = j > 0 && j < SPW - 1;
      if (!in && !own) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (!act[j][k]) continue;
        int16_t* row = qbuf + par * NQ * DP + qrow(j, k);
        const size_t at = (((size_t)slabs[k] * B + b) * W + xs[j]) * a.D;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (d0 + i >= D) continue;
          if (in)
            row[d0 + i] = (int16_t)a.cin[at + d0 + i];
          else
            a.cout[at + d0 + i] = row[d0 + i];
        }
      }
    }
  };

  for (b = blockIdx.x / a.P; b < B; b += a.groups) {
    // pixel index of row 0 (in sweep order) of column 0
    const size_t row0 = (size_t)b * H * W + (size_t)(dy > 0 ? 0 : H - 1) * W;
    for (int t0 = 0; t0 < H; t0 += seg) {
      const int t1 = min(H, t0 + seg);
      for (int tile = tlo; tile < thi; ++tile) {
        const int x0 = tile * TW;
#pragma unroll
        for (int j = 0; j < SPW; ++j) {
          xs[j] = x0 - FR + warp + j * NWARP;
          const bool inside = xs[j] >= 0 && xs[j] < W;
          used[j] = false;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const bool mine_k = j == 0 ? dxs[k] == 1
                                       : j == SPW - 1 ? dxs[k] == -1 : true;
            act[j][k] = inside && k < nd && mine_k;
            used[j] |= act[j][k];
          }
        }
        ax = x0 - FR + warp + aj * NWARP;
        apx = ax - (ak == 0 ? a.dx0 : ak == 1 ? a.dx1 : a.dx2);
        if (t0 == 0 || multi) {
          // a fresh frame, or another tile's band: every carry 0 (the
          // restart), d >= D the sentinel, and the ring 0 (the ring of a
          // column outside the image is never filled: it reads 0)
          cp_async_wait<0>();
          if constexpr (PACKED) {
            __syncthreads();  // no warp reads the ring any more
            for (int i = threadIdx.x; i < 2 * BR::row / 16; i += 32 * NWARP)
              reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
          } else {
            for (int i = lane * 4; i < RING * Rg::row; i += 128)
              *reinterpret_cast<unsigned*>(ring + i) = 0;
          }
          for (int i = threadIdx.x; i < (2 * NQ + 1) * DP; i += blockDim.x)
            qbuf[i - DP] = i % DP < D ? 0 : QBIG;
          __syncthreads();
          if (t0 > 0) {  // the tile's own carries of the band's last row
            keep((t0 - 1) & 1, tile, false);
            __syncthreads();
          } else if (a.cin) {
            // the ring hand-off: each slot's q of the row before row 0 (of
            // its own directions, halo slots too), parity 1; columns
            // outside the image keep 0
            carry_io(1, true);
            __syncthreads();
          }
        }
        // the pixel index of slot j at row t: a base a row and a constant
        const ptrdiff_t col0 = (ptrdiff_t)row0 + x0 - FR + warp;
        auto pixel = [&](int t, int j) {
          return (size_t)(col0 + t * rowstep) + (size_t)(j * NWARP);
        };
        // the block's ring row t % 2: the tile's columns inside the image,
        // C and in the add form S, in 16-byte copies spread over the block
        auto block_fill_row = [&](int t) {
          uint8_t* row = ring + (t & 1) * BR::row;
          const size_t rp =  // the pixel index of column 0 in row t
              (size_t)((ptrdiff_t)row0 + (ptrdiff_t)t * rowstep);
          const int ca = max(x0 - FR, 0), cb = min(x0 - FR + NS, W);
          const int sb = min(x0 + TW, W);
          const int nc = (cb - ca) * DP / 16;
          const int ns = ACC ? (sb - x0) * DP * 2 / 16 : 0;
          const uint8_t* csrc = a.C + (rp + ca) * DP;
          uint8_t* cdst = row + (ca - (x0 - FR)) * DP;
          const uint8_t* ssrc =
              reinterpret_cast<const uint8_t*>(a.S + (rp + x0) * DP);
          for (int g = threadIdx.x; g < nc + ns; g += 32 * NWARP) {
            if (g < nc)
              cp_async<16>(cdst + 16 * g, csrc + 16 * g);
            else
              cp_async<16>(row + BR::c_row + 16 * (g - nc),
                           ssrc + 16 * (g - nc));
          }
        };
        // row t's costs (and sums) into the ring: the block's (s16x2), or
        // each slot's pixel into the warp's ring row t % RING
        auto fill = [&](int t) {
          if constexpr (PACKED) {
            block_fill_row(t);
            return;
          }
          if (!mine) return;
          uint8_t* row = ring + (t & (RING - 1)) * Rg::row;
#pragma unroll
          for (int j = 0; j < SPW; ++j) {
            if (!used[j]) continue;
            const bool own = j > 0 && j < SPW - 1;
            uint8_t* my_c = row + Rg::at(j) + lane * Rg::CB;
            uint8_t* my_s = row + Rg::at(j) + 32 * Rg::CB + lane * Rg::SB;
            const size_t px = pixel(t, j) * D;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const bool real = d0 + k < D;
              my_c[k] = real ? a.C[px + d0 + k] : 0;
              if (ACC && own)
                reinterpret_cast<int16_t*>(my_s)[k] = real ? a.S[px + d0 + k]
                                                           : 0;
            }
          }
        };
#pragma unroll
        for (int i = 0; i < RING; ++i) {
          if (t0 + i < t1) fill(t0 + i);
          cp_async_commit();
        }
        if constexpr (PACKED) {  // the first row's copies, every thread's
          cp_async_wait<RING - 1>();
          __syncthreads();
        }
        // the image bytes of row t for this lane's slot and direction: the
        // pixel's and its predecessor's (the pixel's own where there is none,
        // a zero gradient: that P2' is never used)
        int ib_c = 0, ib_p = 0, p2v = p2;
        auto image = [&](int t) {
          if (!ADAPT || !alane || t >= H) return;
          const size_t rowp = row0 + t * rowstep;
          ib_c = a.I[rowp + min(max(ax, 0), W - 1)];
          const bool pin = apx >= 0 && apx < W;
          ib_p = t > 0 && pin         ? a.I[rowp - rowstep + apx]
                 : a.Iprev && pin     ? a.Iprev[(size_t)b * W + apx]
                                      : ib_c;
        };
        image(t0);

        for (int t = t0; t < t1; ++t) {
          PHASE(9);
#ifdef FUSED_PHASES
          ++rows_;
#endif
          const int cur = t & 1, prv = cur ^ 1;
          int16_t* qcur = qbuf + cur * NQ * DP;
          const int16_t* qprv = qbuf + prv * NQ * DP;
          if (a.exchange && t % FR == 0 && t > 0) {
            // a band starts: the neighbours' edge q of the row before it. Both
            // neighbours are waited for, so that no tile runs two bands ahead
            // of a tile that still has to read its edges.
            const int band = t / FR;
            if (threadIdx.x == 0) {
              if (tile > 0)
                while (ld_acquire(a.flags + b * T + tile - 1) < band) {
                }
              if (tile < T - 1)
                while (ld_acquire(a.flags + b * T + tile + 1) < band) {
                }
            }
            __syncthreads();
            const int par = (band - 1) & 1;
#pragma unroll
            for (int j = 0; j < SPW; j += SPW - 1) {
              // slot 0: the left neighbour's last FR columns (dx = +1), slot
              // SPW - 1: the right one's first FR columns (dx = -1)
              const bool left = j == 0;
              const int nb = left ? tile - 1 : tile + 1;
              if (nb < 0 || nb >= T || xs[j] >= W || !mine) continue;
              const int16_t* src =
                  a.xch +
                  (((size_t)(b * T + nb) * 2 + par) * 2 + (left ? 1 : 0)) *
                      xch_side +
                  (size_t)warp * DP;
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                if (!act[j][k]) continue;
                int16_t* dst = qbuf + prv * NQ * DP + qrow(j, k);
                if constexpr (PACKED) {
                  edge_load<K>(dst + d0, src + d0);
                } else {
#pragma unroll
                  for (int i = 0; i < K; ++i)
                    if (d0 + i < D) dst[d0 + i] = __ldcg(src + d0 + i);
                }
              }
            }
            __syncthreads();
          }
          PHASE(0);
          int p2all = p2;
          if constexpr (ADAPT) {
            p2v = max(p1 + 1, p2 / max(1, abs(ib_c - ib_p)));
            image(t + 1);
            p2all = p2v;
          }
          if constexpr (!PACKED) cp_async_wait<RING - 1>();  // row t's group
          PHASE(1);
          const uint8_t* rrow =
              ring + (t & (RING - 1)) * (PACKED ? BR::row : Rg::row);
          // where slot j's costs, and an own slot's sums, start in the ring
          auto c_in = [&](int j) {
            return PACKED ? rrow + (warp + j * NWARP) * DP + c_at
                      : rrow + Rg::at(j) + lane * Rg::CB;
          };
          auto s_in = [&](int j) {
            return PACKED ? rrow + BR::c_row +
                                (warp + j * NWARP - FR) * DP * 2 + s_at * 2
                      : rrow + Rg::at(j) + 32 * Rg::CB + lane * Rg::SB;
          };
          if constexpr (PACKED) {
            // every slot and direction in straight-line code, in phases: all
            // loads of the row, all steps, the warp's minimums back to back,
            // all stores, so that the independent chains of the warp's steps
            // overlap. An outside column computes too: its costs are the
            // zeros its ring slots were cleared to, so the carries that inside
            // columns read from it stay 0 (a restart) and its sums go nowhere.
            // dxs are (0, 1, -1): a left halo slot runs k = 1, a right one 2.
            unsigned c[SPW][NW], sv[SPW][NW], q[SPW][3][NW], qe[SPW][3][2];
            unsigned p2x2[SPW][3], m[SPW][3];
#pragma unroll
            for (int j = 0; j < SPW; ++j) {
              unsigned wc[(K + 3) / 4];
              read_costs<K>(c_in(j), c_sub, wc);
#pragma unroll
              for (int i = 0; i < NW; ++i) {
                c[j][i] = __byte_perm(wc[i / 2], 0, i % 2 ? 0x4342 : 0x4140);
                sv[j][i] = 0;
              }
              if (ACC && j > 0 && j < SPW - 1)
                read_sums<K>(s_in(j), s_sub, sv[j]);
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                if ((j == 0 && k != 1) || (j == SPW - 1 && k != 2)) continue;
                const int16_t* src = qprv + prow(j, k);
                load_words<K>(src + d0, q[j][k]);
                qe[j][k][0] = *reinterpret_cast<const unsigned*>(src + d0 - 2);
                qe[j][k][1] = *reinterpret_cast<const unsigned*>(src + d0 + K);
                p2x2[j][k] =
                    (ADAPT ? (unsigned)__shfl_sync(FULL_MASK, p2all, 3 * j + k)
                           : (unsigned)p2) * 0x10001u;
              }
            }
            PHASE(2);
            // the steps (q[j][k] becomes L), each lane's min of its pairs, then
            // the warp's mins back to back, then the renormalised carries
#pragma unroll
            for (int j = 0; j < SPW; ++j) {
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                if ((j == 0 && k != 1) || (j == SPW - 1 && k != 2)) continue;
                unsigned L[NW];
                step_pairs<NW>(c[j], q[j][k], qe[j][k][0], qe[j][k][1], lane,
                               p1x2, p2x2[j][k], L);
                unsigned mw = L[0];
#pragma unroll
                for (int i = 0; i < NW; ++i) {
                  q[j][k][i] = L[i];
                  if (i > 0) mw = min_s16x2(mw, L[i]);
                  sv[j][i] = __vadd2(sv[j][i], L[i]);  // the sum over r
                }
                // the lane's minimum in both halves (m * 0x10001, which
                // orders as m does: every L is in [0, 2^15))
                m[j][k] = min_s16x2(mw, __byte_perm(mw, 0, 0x1032));
              }
            }
            PHASE(3);
#pragma unroll
            for (int j = 0; j < SPW; ++j)
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                if ((j == 0 && k != 1) || (j == SPW - 1 && k != 2)) continue;
                m[j][k] = __reduce_min_sync(FULL_MASK, m[j][k]);
              }
            PHASE(4);
#pragma unroll
            for (int j = 0; j < SPW; ++j) {
              const bool inside = xs[j] >= 0 && xs[j] < W;
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                if ((j == 0 && k != 1) || (j == SPW - 1 && k != 2)) continue;
#pragma unroll
                for (int i = 0; i < NW; ++i)
                  q[j][k][i] -= m[j][k];  // no borrow
                store_words<K>(qcur + qrow(j, k) + d0, q[j][k]);
              }
              if (j > 0 && j < SPW - 1 && inside)
                store_words<K>(a.S + pixel(t, j) * D + d0, sv[j]);
            }
            PHASE(5);
          } else {
#pragma unroll
            for (int j = 0; j < SPW; ++j) {
              if (!used[j]) continue;
              const bool own = j > 0 && j < SPW - 1;
              unsigned wc[(K + 3) / 4], sv[NW] = {};
              read_costs<K>(rrow + Rg::at(j) + lane * Rg::CB, c_sub, wc);
              if (ACC && own)
                read_sums<K>(rrow + Rg::at(j) + 32 * Rg::CB + lane * Rg::SB,
                             s_sub, sv);
              unsigned out[NW];
              int cv[K], sum[K];
#pragma unroll
              for (int i = 0; i < K; ++i) {
                cv[i] = cost_byte(wc, i);
                sum[i] = 0;
              }
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                if (!act[j][k]) continue;
                int q[K], L[K];
                load_q<K>(qprv + prow(j, k), d0, q);
                int left = __shfl_up_sync(FULL_MASK, q[K - 1], 1);
                int right = __shfl_down_sync(FULL_MASK, q[0], 1);
                if (lane == 0) left = SGM_BIG;
                if (lane == 31) right = SGM_BIG;
                const int p2t =
                    ADAPT ? __shfl_sync(FULL_MASK, p2all, 3 * j + k) : p2;
#pragma unroll
                for (int i = 0; i < K; ++i) {
                  const int dn = i == 0 ? left : q[i - 1];
                  const int up = i == K - 1 ? right : q[i + 1];
                  const int cand = min(min(q[i], min(up, dn) + p1), p2t);
                  L[i] = d0 + i < D ? cv[i] + cand : SGM_BIG;
                }
                const int m = __reduce_min_sync(FULL_MASK, lane_min<K>(L));
#pragma unroll
                for (int i = 0; i < K; ++i) {
                  sum[i] += L[i];
                  q[i] = d0 + i < D ? L[i] - m : QBIG;
                }
                store_q<K>(qcur + qrow(j, k), d0, q);
              }
              if (own) {
                if constexpr (K == 1) {
                  out[0] = (unsigned)sum[0];
                } else {
#pragma unroll
                  for (int i = 0; i < NW; ++i)
                    out[i] = __byte_perm(sum[2 * i], sum[2 * i + 1], 0x5410);
                }
                store_line<K, ACC, false>(a.S + pixel(t, j) * D + d0, out, sv,
                                            d0, D);
              }
            }
          }
          // every slot of row t is read: refill RING rows ahead
          if constexpr (!PACKED) PHASE(3);
          if constexpr (PACKED) {
            // row t + 1's copies are this thread's only ones in flight;
            // after the barrier every thread's have landed and no warp
            // reads ring row t % 2 any more, which takes row t + 2
            cp_async_wait<0>();
            PHASE(1);
            __syncthreads();  // row t's q and row t + 1's costs are in;
                              // row t - 1's q and ring row t are free
            PHASE(7);
            if (t + RING < t1) fill(t + RING);
            cp_async_commit();
            PHASE(6);
          } else {
            if (t + RING < t1) fill(t + RING);
            cp_async_commit();
            PHASE(6);
            __syncthreads();  // row t's q is in the buffer, row t - 1's is
                              // free
            PHASE(7);
          }
          if (a.exchange && (t + 1) % FR == 0 && t + 1 < H) {
            // a band ends: this tile's edge q for its neighbours, side 0 the
            // first FR own columns' dx = -1, side 1 the last FR's dx = +1
            const int band = t / FR;
#pragma unroll
            for (int j = 1; j < SPW - 1; ++j) {
              const int s = warp + j * NWARP;
              if (xs[j] >= W || !mine) continue;
#pragma unroll
              for (int side = 0; side < 2; ++side) {
                const int at = side == 0 ? s - FR : s - TW;
                if (at < 0 || at >= FR) continue;
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                  if (!act[j][k] || dxs[k] != (side == 0 ? -1 : 1)) continue;
                  int16_t* dst =
                      a.xch +
                      (((size_t)(b * T + tile) * 2 + (band & 1)) * 2 + side) *
                          xch_side +
                      (size_t)at * DP;
                  const int16_t* src = qcur + qrow(j, k);
                  if constexpr (PACKED) {
                    edge_store<K>(dst + d0, src + d0);
                  } else {
#pragma unroll
                    for (int i = 0; i < K; ++i)
                      if (d0 + i < D) __stcg(dst + d0 + i, src[d0 + i]);
                  }
                }
              }
            }
            // every edge of the band is stored; one thread's fence after
            // the barrier, then the flag (the pattern of a cooperative
            // grid's sync: the barrier orders the block's stores before
            // the fence, which is cumulative)
            __syncthreads();
            if (threadIdx.x == 0) {
              __threadfence();
              st_release(a.flags + b * T + tile, band + 1);
            }
          }
          PHASE(8);
        }
        if (multi && t1 < H) {  // the tile's own carries until its next band
          keep((t1 - 1) & 1, tile, true);
        }
        // the ring hand-off: the last row's q of the own columns (each warp
        // reads back what it stored)
        if (a.cout && t1 == H) carry_io((H - 1) & 1, false);
        __syncthreads();  // the buffers are free for the next tile or frame
      }
    }
  }
#ifdef FUSED_PHASES
  PHASE(9);
  if (lane == 0) {
    for (int i = 0; i < NPHASE; ++i) atomicAdd(g_phase + i, ph_[i]);
    atomicAdd(g_phase + NPHASE, rows_);
  }
#endif
}

// The grid of a launch: a.T tiles a frame. Without exchanges, a block a
// tile of every frame. With them the blocks of a frame must be resident
// together: a.groups frames in flight, as many as fit on the card at once,
// a block a tile; or, when a frame has more tiles than the card holds
// blocks, one frame at a time, each block walking a.TPB adjacent tiles.
template <int K, bool ACC, bool ADAPT, bool PACKED>
static int plan(FusedArgs& a) {
  auto kernel = sgm_fused_kernel<K, ACC, ADAPT, PACKED>;
  const int smem = smem_bytes<K, ACC, PACKED>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  a.T = a.P = (a.W + Geo<K>::TW - 1) / Geo<K>::TW;
  a.TPB = 1;
  a.groups = a.B;
  if (!a.exchange) return 0;
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, 32 * NWARP, smem)) != cudaSuccess)
    return (int)e;
  const int resident = per_sm * sms;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (a.T <= resident) {
    a.groups = resident / a.T < a.B ? resident / a.T : a.B;
    return 0;
  }
  a.TPB = (a.T + resident - 1) / resident;
  a.P = (a.T + a.TPB - 1) / a.TPB;
  a.groups = 1;
  return 0;
}

template <int K, bool ACC, bool ADAPT, bool PACKED>
static int launch_one(FusedArgs a, cudaStream_t s) {
  const int rc = plan<K, ACC, ADAPT, PACKED>(a);
  if (rc != 0) return rc;
  auto kernel = sgm_fused_kernel<K, ACC, ADAPT, PACKED>;
  const int smem = smem_bytes<K, ACC, PACKED>();
  if (!a.exchange) {
    kernel<<<(unsigned)a.B * a.T, 32 * NWARP, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.groups * a.P));
  cfg.blockDim = dim3(32 * NWARP);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int K, bool ACC>
static int launch(FusedArgs a, cudaStream_t s) {
  // the s16x2 build: all three directions, every lane full at 2, 4 or 8
  // disparities a lane (the presets' D = 128), 16-byte aligned volumes,
  // and the halves holding c_max + P1 + the largest P2 (P1 + 1 under
  // adaptive P2 with P1 = P2); the sum over the directions does not depend
  // on their order, so it takes them as (0, 1, -1). Every other request
  // takes the int32 build with plain loads: one build, not one a layout,
  // keeps the library's compile time down.
  const int p2_top = a.I && a.p1 + 1 > a.p2 ? a.p1 + 1 : a.p2;
  const bool packed = kPackable<K> && a.D == 32 * K && a.nd == 3 &&
                      ((uintptr_t)a.C | (uintptr_t)a.S) % 16 == 0 &&
                      255 + a.p1 + p2_top < 1 << 15;
  if (packed) {  // direction k of (0, 1, -1) keeps its caller's slab
    const int dx[3] = {a.dx0, a.dx1, a.dx2};
    for (int i = 0; i < 3; ++i) (dx[i] == 0 ? a.slab0 : dx[i] == 1 ? a.slab1
                                                                 : a.slab2) = i;
    a.dx0 = 0;
    a.dx1 = 1;
    a.dx2 = -1;
  }
#define TPS_ONE(ADAPT)                                        \
  if constexpr (kPackable<K>)                                   \
    if (packed) return launch_one<K, ACC, ADAPT, true>(a, s); \
  return launch_one<K, ACC, ADAPT, false>(a, s)
  if (a.I) {
    TPS_ONE(true);
  }
  TPS_ONE(false);
#undef TPS_ONE
}

static int lane_k(int D) {
  return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : D <= 256 ? 8 : 16;
}

// The wrapper's scratch for B frames of W columns at D disparities, needed
// only by a sweep of more than FR rows with a diagonal: n[0] flag ints,
// n[1] int16 elements of the edge buffer, n[2] of the carries between bands.
TPS_EXPORT int sgm_fused_scratch(int B, int W, int D, long long* n) {
  if (B < 1 || W < 1 || D < 1 || D > 512) return (int)cudaErrorInvalidValue;
  const int K = lane_k(D), tw = K >= 16 ? 8 : FUSED_TW;
  const long long T = (W + tw - 1) / tw;
  n[0] = (long long)B * T;
  n[1] = n[0] * 2 * 2 * FR * 32 * K;
  n[2] = T * tw * 3 * 32 * K;
  return 0;
}

// accumulate == 0 writes S and reads none; 1 adds to S. I, the left image
// (B, H, W) uint8, null for the scalar P2. nd directions dx0.. (distinct,
// each -1, 0 or 1). flags (zeroed), xch and state as `sgm_fused_scratch`
// sizes them; all three may be null for a sweep of at most FR rows or
// without a diagonal. The ring hand-off: cin (nd, B, W, D) int32, the q of
// the row before row 0 in sweep order, one slab a direction in dx order
// (null: a fresh start); cout the same for the last row (null: not
// returned); Iprev (B, W) uint8 the image row of cin, read under adaptive
// P2 (null without a carry).
TPS_EXPORT int sgm_fused_launch(const uint8_t* C, int16_t* S,
                                const uint8_t* I, int* flags, int16_t* xch,
                                int16_t* state, const int* cin, int* cout,
                                const uint8_t* Iprev, int B, int H, int W,
                                int D,
                                int dy, int nd, int dx0, int dx1, int dx2,
                                int p1, int p2, int accumulate,
                                void* stream) {
  const int dx[3] = {dx0, dx1, dx2};
  if ((dy != 1 && dy != -1) || nd < 1 || nd > 3 || D < 1 || D > 512 ||
      B < 1 || H < 1 || W < 1 || p1 < 0 || p2 < p1 ||
      255 + (I && p1 + 1 > p2 ? p1 + 1 : p2) >= 1 << 15)
    return (int)cudaErrorInvalidValue;
  bool diag = false;
  for (int k = 0; k < nd; ++k) {
    if (dx[k] < -1 || dx[k] > 1) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < k; ++j)
      if (dx[j] == dx[k]) return (int)cudaErrorInvalidValue;
    diag |= dx[k] != 0;
  }
  const int exchange = diag && H > FR;
  if (exchange && (!flags || !xch || !state))
    return (int)cudaErrorInvalidValue;
  if (I && cin && !Iprev) return (int)cudaErrorInvalidValue;
  FusedArgs a = {C,  S,  I,  flags, xch, state, cin, cout, Iprev, B,
                 H,  W,  D,  dy,    nd,  dx0,   dx1, dx2,  p1,    p2,
                 0,  1,  2,  0,     0,   0,     0,   exchange};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPS_ACC(KK) \
  return accumulate ? launch<KK, true>(a, s) : launch<KK, false>(a, s)
  switch (lane_k(D)) {
    case 1: TPS_ACC(1);
    case 2: TPS_ACC(2);
    case 4: TPS_ACC(4);
    case 8: TPS_ACC(8);
    default: TPS_ACC(16);
  }
#undef TPS_ACC
}

// The resident blocks an SM, dynamic shared memory and registers of a
// build, for the micro-benchmark's records: out[0..2].
template <int K, bool ACC, bool ADAPT, bool PACKED>
static int occupancy(int* out) {
  auto kernel = sgm_fused_kernel<K, ACC, ADAPT, PACKED>;
  const int smem = smem_bytes<K, ACC, PACKED>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                      32 * NWARP, smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  out[1] = smem;
  out[2] = e == cudaSuccess ? fa.numRegs : 0;
  return (int)e;
}

template <int K, bool PACKED>
static int occupancy_of(int accumulate, int adaptive, int* out) {
  if (accumulate)
    return adaptive ? occupancy<K, true, true, PACKED>(out)
                    : occupancy<K, true, false, PACKED>(out);
  return adaptive ? occupancy<K, false, true, PACKED>(out)
                  : occupancy<K, false, false, PACKED>(out);
}

template <int K>
static int occupancy_at(int accumulate, int adaptive, int packed, int* out) {
  if constexpr (kPackable<K>)
    if (packed) return occupancy_of<K, true>(accumulate, adaptive, out);
  return occupancy_of<K, false>(accumulate, adaptive, out);
}

// the build a launch at D disparities takes, the s16x2 one where packed
// and that build exists (D = 64, 128 or 256), else int32
TPS_EXPORT int sgm_fused_occupancy(int D, int accumulate, int adaptive,
                                   int packed, int* out) {
  switch (lane_k(D)) {
    case 1: return occupancy_at<1>(accumulate, adaptive, packed, out);
    case 2: return occupancy_at<2>(accumulate, adaptive, packed, out);
    case 4: return occupancy_at<4>(accumulate, adaptive, packed, out);
    case 8: return occupancy_at<8>(accumulate, adaptive, packed, out);
    default: return occupancy_at<16>(accumulate, adaptive, packed, out);
  }
}

#ifdef FUSED_PHASES
// g_phase to out[0..NPHASE], then zeroed
TPS_EXPORT int sgm_fused_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[NPHASE + 1] = {};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase));
}
#endif
