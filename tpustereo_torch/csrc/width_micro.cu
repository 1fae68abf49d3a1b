// Data-width micro-benchmarks of the SGM sweep step.
//
// Replaces: tpustereo/kernels/width_micro.py, every pallas_call of it:
// sweep_micro (`_kernel` and `_kernel_i8`), elem_chain_micro,
// roll_chain_micro, reg_chain_micro and bf16_roll_chain_micro. They are on
// no user's path: they time the step that bounds the port's sweeps at three
// data widths.
//
// sweep_micro_kernel: the axial recurrence of one line per warp (two lines
// packed per word for the 16-bit modes) over T steps from a zero carry,
// writing every step's L; each lane owns K = 4 of the D = 128 disparities,
// and the next step's costs are loaded before the current step, as in
// sgm_sweep.cu. Modes: v32 and v32_i8 run common.cuh's sgm_step<4>, the step
// the port ships (its L = c + cand - minLp is the micro's L = c + cand with
// the carry renormalised); swar and swar_i8 run sgm_step_s16x2<4> on lines
// packed as signed 16-bit halves (swar: the caller's packing, even row high;
// swar_i8: rows n and n + N/2 packed here, the first half high), with DPX
// min-plus instructions and the min over D by warp_min_s16x2; bf16_i8 runs
// the JAX bf16 step on __nv_bfloat162 (rows n and n + N/2, round to nearest
// after every operation, the 16384 sentinel). Bound on this card: the serial
// chain of T dependent steps (shuffles and a warp min each), not the bytes
// (3 a cost for the i8 modes, 8 for v32 and swar) or the operations.
//
// chain_kernel: dependent add/min chains held in registers, W = 1, 2 or 4
// 32-bit words a thread run side by side (one int32 or float32 value a
// word, two int16 or bf16), in blocks of 128 threads, one warp on each of
// an SM's four schedulers:
// ELEM is v = min(v + 1, x + i), REG is v = min(v + 1, w); w = w + 1 then
// v + w. int16 runs as s16x2, its add-mins on DPX (__viaddmin_s16x2) and
// its plain adds by __vadd2, bf16 as bf16x2 (__hadd2, __hmin2). Bound by the
// rate at which the schedulers issue them, one warp-instruction a clock
// each: the wrapper's `_chain_plan` chooses W so that the busiest of the
// card's 528 schedulers holds at most one warp more than the mean, and
// the loop makes each step's constant once for the thread's W words (the
// 16-bit ELEM chains read theirs from a table in shared memory that each
// block makes once).
//
// roll_kernel: dependent rolls by 1 + (i & 1) of lines of up to 24,576
// values held in registers, in blocked slots: thread t of a line holds E
// consecutive values (E - 1 in a line that does not fill its threads
// exactly). A roll by s moves the top s values of each thread into the
// bottom s slots of the next, one __shfl_sync each (a thread that ends a
// warp hands them over through shared memory, one barrier a step), and
// the other E - s values keep their registers: the loop is unrolled over
// a period of the slot rotation, so each step only renames them. A line
// takes one warp up to 64 x 32 values (one warp a block until every SM
// has one), past that a block of up to 12 warps. Rows load and store 16
// bytes a thread at a time where they can; columns (axis 0) value by
// value, each value a sector of its own (staging them by clusters of
// blocks, ROLL_STAGE_COLS, measured slower). PAIR16 packs two bf16 rows
// into one 32-bit word, so each shuffle moves two values. Bound on this
// card by the rate of the shuffles: 1.5 a warp a step, against 4 (every
// slot) in the strided layout it replaces; at one line a warp, by their
// issue (E >= 16) or their latency (a value crosses lanes every E / 1.5
// steps).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <string.h>

#include <utility>

#include "common.cuh"

namespace {

// the Python wrapper's `MODES` order
enum { V32 = 0, SWAR = 1, V32_I8 = 2, SWAR_I8 = 3, BF16_I8 = 4 };
enum { DT_I32 = 0, DT_I16 = 1, DT_BF16 = 2, DT_F32 = 3 };
enum { ELEM = 0, REG = 1 };

constexpr int KD = 4;      // disparities a lane
constexpr int DM = 128;    // D of the micro
constexpr float BF_BIG = 16384.0f;

__device__ __forceinline__ __nv_bfloat162 as_bf2(unsigned u) {
  __nv_bfloat162 r;
  memcpy(&r, &u, 4);
  return r;
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 b) {
  unsigned r;
  memcpy(&r, &b, 4);
  return r;
}

__device__ __forceinline__ __nv_bfloat162 bf2(float f) {
  return __bfloat162bfloat162(__float2bfloat16_rn(f));
}

__device__ __forceinline__ unsigned pack16(int lo, int hi) {
  return (unsigned)(lo & 0xffff) | (unsigned)hi << 16;
}

// One step's raw cost words of this lane: four int32 (v32, swar), the four
// int8 costs of row A (v32_i8), or of rows A and B (the paired modes).
template <int MODE>
__device__ __forceinline__ void load_raw(const void* C, size_t a, size_t b,
                                         unsigned (&raw)[4]) {
  if constexpr (MODE == V32 || MODE == SWAR) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        static_cast<const int32_t*>(C) + a);
    raw[0] = v.x, raw[1] = v.y, raw[2] = v.z, raw[3] = v.w;
  } else {
    const int8_t* c8 = static_cast<const int8_t*>(C);
    raw[0] = *reinterpret_cast<const unsigned*>(c8 + a);
    if constexpr (MODE != V32_I8)
      raw[1] = *reinterpret_cast<const unsigned*>(c8 + b);
  }
}

__device__ __forceinline__ int byte_of(unsigned w, int k) {
  return (int)(int8_t)(w >> (8 * k));
}

template <int MODE>
__global__ void __launch_bounds__(128)
    sweep_micro_kernel(const void* __restrict__ C, void* __restrict__ out,
                       int T, int N, int p1, int p2) {
  constexpr bool PAIRED = MODE == SWAR_I8 || MODE == BF16_I8;
  const int line = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int H = N / 2;
  if (line >= (PAIRED ? H : N)) return;  // the whole warp leaves together
  const size_t rowB = PAIRED ? line + H : line;
  const size_t sa = (size_t)line * DM + lane * KD, sb = rowB * DM + lane * KD;
  const size_t tstep = (size_t)N * DM;

  int Lp[KD] = {}, minLp = 0;  // v32, v32_i8: the port's sgm_step carry
  unsigned q[KD] = {};         // the packed modes' renormalised carry
  const unsigned p1x2 = (unsigned)p1 * 0x10001u, p2x2 = (unsigned)p2 * 0x10001u;
  const __nv_bfloat162 p1b = bf2((float)p1), p2b = bf2((float)p2);
  const __nv_bfloat162 big = bf2(BF_BIG);

  unsigned raw[4], nxt[4];
  load_raw<MODE>(C, sa, sb, raw);
  for (int t = 0; t < T; ++t) {
    const size_t o = (size_t)t * tstep;
    if (t + 1 < T) load_raw<MODE>(C, o + tstep + sa, o + tstep + sb, nxt);
    if constexpr (MODE == V32 || MODE == V32_I8) {
      int c[KD], L[KD];
#pragma unroll
      for (int k = 0; k < KD; ++k)
        c[k] = MODE == V32 ? (int)raw[k] : byte_of(raw[0], k);
      sgm_step<KD>(c, Lp, minLp, lane, DM, p1, p2, L);
      minLp = __reduce_min_sync(FULL_MASK, lane_min<KD>(L));
#pragma unroll
      for (int k = 0; k < KD; ++k) Lp[k] = L[k];
      if constexpr (MODE == V32)
        *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + o + sa) =
            make_int4(L[0], L[1], L[2], L[3]);
      else
        *reinterpret_cast<uint2*>(static_cast<int16_t*>(out) + o + sa) =
            make_uint2(pack16(L[0], L[1]), pack16(L[2], L[3]));
    } else if constexpr (MODE == SWAR || MODE == SWAR_I8) {
      unsigned c[KD], L[KD];
#pragma unroll
      for (int k = 0; k < KD; ++k)
        c[k] = MODE == SWAR ? raw[k]
                            : (unsigned)byte_of(raw[0], k) << 16 |
                                  (unsigned)byte_of(raw[1], k);
      sgm_step_s16x2<KD>(c, q, lane, p1x2, p2x2, L);
      const unsigned M = warp_min_s16x2<KD>(L);
#pragma unroll
      for (int k = 0; k < KD; ++k) q[k] = L[k] - M;  // no half borrows
      if constexpr (MODE == SWAR) {
        *reinterpret_cast<uint4*>(static_cast<int32_t*>(out) + o + sa) =
            make_uint4(L[0], L[1], L[2], L[3]);
      } else {
        int16_t* o16 = static_cast<int16_t*>(out) + o;
        *reinterpret_cast<uint2*>(o16 + sa) = make_uint2(
            __byte_perm(L[0], L[1], 0x7632), __byte_perm(L[2], L[3], 0x7632));
        *reinterpret_cast<uint2*>(o16 + sb) = make_uint2(
            __byte_perm(L[0], L[1], 0x5410), __byte_perm(L[2], L[3], 0x5410));
      }
    } else {  // BF16_I8: .x row A, .y row B
      const unsigned left = __shfl_up_sync(FULL_MASK, q[KD - 1], 1);
      const unsigned right = __shfl_down_sync(FULL_MASK, q[0], 1);
      __nv_bfloat162 L[KD];
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        __nv_bfloat162 dn = as_bf2(k == 0 ? left : q[k - 1]);
        __nv_bfloat162 up = as_bf2(k == KD - 1 ? right : q[k + 1]);
        if (k == 0 && lane == 0) dn = big;
        if (k == KD - 1 && lane == 31) up = big;
        const __nv_bfloat162 cand = __hmin2(
            __hmin2(as_bf2(q[k]), __hadd2(__hmin2(up, dn), p1b)), p2b);
        const __nv_bfloat162 cb = __floats2bfloat162_rn(
            (float)byte_of(raw[0], k), (float)byte_of(raw[1], k));
        L[k] = __hadd2(cb, cand);
      }
      __nv_bfloat162 m = L[0];
#pragma unroll
      for (int k = 1; k < KD; ++k) m = __hmin2(m, L[k]);
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        m = __hmin2(m, as_bf2(__shfl_xor_sync(FULL_MASK, as_u32(m), s)));
      int a[KD], b[KD];
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        q[k] = as_u32(__hsub2(L[k], m));
        a[k] = __bfloat162int_rz(__low2bfloat16(L[k]));
        b[k] = __bfloat162int_rz(__high2bfloat16(L[k]));
      }
      int16_t* o16 = static_cast<int16_t*>(out) + o;
      *reinterpret_cast<uint2*>(o16 + sa) =
          make_uint2(pack16(a[0], a[1]), pack16(a[2], a[3]));
      *reinterpret_cast<uint2*>(o16 + sb) =
          make_uint2(pack16(b[0], b[1]), pack16(b[2], b[3]));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) raw[k] = nxt[k];
  }
}

// ---------------------------------------------------------------------------
// chains

#ifndef CHAIN_UNROLL
#define CHAIN_UNROLL 8  // steps of one pass of an ELEM chain's loop; REG's,
                        // which make no step constant, run twice as many
                        // (an int32 ELEM pass of 16 made each constant by
                        // a UIADD3 of its own)
#endif
#ifndef CHAIN_SMID
#define CHAIN_SMID 0  // 1: each block counts itself on its SM
                      // (`chain_sm_blocks`), a diagnostic build
#endif

constexpr int CHAIN_MAX_THREADS = 1024;
constexpr unsigned ONE16 = 0x00010001u;   // the int16 pair (1, 1)
constexpr unsigned ONE_BF2 = 0x3f803f80u; // the bf16 pair (1, 1)

template <int DT>
__host__ __device__ constexpr int per_word() {
  return DT == DT_I16 || DT == DT_BF16 ? 2 : 1;
}

// The chain's carried values pass through an empty asm statement every
// step: without it nvcc folds integer chains across steps
// (min(v + 1, a) + 1 = min(v + 2, a + 1)), and the int32 chains then time
// fewer operations than they name. Floats and the packed intrinsics are not
// folded; they pass through it too, so every type runs the same loop.
__device__ __forceinline__ void pin(unsigned& v) { asm volatile("" : "+r"(v)); }

// a + b on bf16 pairs, rounded to nearest
__device__ __forceinline__ unsigned addbf(unsigned a, unsigned b) {
  return as_u32(__hadd2(as_bf2(a), as_bf2(b)));
}

// blocks a launch put on each SM (CHAIN_SMID builds only)
__device__ unsigned chain_sm_blocks[1024];

__device__ __forceinline__ unsigned bf2_word(__nv_bfloat16 b) {
  return as_u32(__bfloat162bfloat162(b));
}

// ELEM's 16-bit chains read each step's constant from a table in shared
// memory, made once a block for a chunk of CHAIN_TABLE steps
template <int DT, int KIND>
__host__ __device__ constexpr bool chain_table() {
  return KIND == ELEM && (DT == DT_I16 || DT == DT_BF16);
}
constexpr int CHAIN_TABLE = 1024;

// Step i's constant of a table: the pair (i, i) of int16 (i & 0xffff, as
// the int16 i wraps) or of bf16 (i rounded to nearest) values
template <int DT>
__device__ __forceinline__ unsigned step_const(int i) {
  if constexpr (DT == DT_I16) return __byte_perm(i, 0, 0x1010);
  return bf2_word(__int2bfloat16_rn(i));
}

// One step i of the chain on one word: ELEM v = min(v + 1, x + c), REG
// v = min(v + 1, w); w = w + 1, in the word's type (c: i for int32, else
// `step_const`). The int16 plain adds are __vadd2, which wraps each field
// and leaves the DPX add-min's pipe, which issues at half rate, to the
// add-mins.
template <int DT, int KIND>
__device__ __forceinline__ void step(unsigned& v, unsigned& w, unsigned x,
                                     unsigned c) {
  if constexpr (KIND == ELEM) {
    // nvcc makes min(v + 1, t) one DPX add-min (VIADDMNMX) on its own
    if constexpr (DT == DT_I32)
      v = (unsigned)min((int)(v + 1u), (int)(x + c));
    if constexpr (DT == DT_I16) v = __viaddmin_s16x2(v, ONE16, __vadd2(x, c));
    if constexpr (DT == DT_BF16)
      v = as_u32(__hmin2(as_bf2(addbf(v, ONE_BF2)),
                         as_bf2(addbf(x, c))));
    pin(v);
  } else {
    if constexpr (DT == DT_I32) {
      v = (unsigned)min((int)(v + 1u), (int)w);
      w = w + 1u;
    }
    if constexpr (DT == DT_F32) {
      v = __float_as_uint(
          fminf(__uint_as_float(v) + 1.0f, __uint_as_float(w)));
      w = __float_as_uint(__uint_as_float(w) + 1.0f);
    }
    if constexpr (DT == DT_I16) {
      v = __viaddmin_s16x2(v, ONE16, w);
      w = __vadd2(w, ONE16);
    }
    if constexpr (DT == DT_BF16) {
      v = as_u32(__hmin2(as_bf2(addbf(v, ONE_BF2)), as_bf2(w)));
      w = addbf(w, ONE_BF2);
    }
    pin(v), pin(w);
  }
}

// v = x and, for REG, w = v + 1 on each of the thread's W words
template <int DT, int W>
__device__ __forceinline__ void chain_start(const unsigned (&x)[W],
                                            unsigned (&v)[W],
                                            unsigned (&w)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    v[j] = x[j];
    if constexpr (DT == DT_I32) w[j] = v[j] + 1u;
    if constexpr (DT == DT_F32)
      w[j] = __float_as_uint(__uint_as_float(v[j]) + 1.0f);
    if constexpr (DT == DT_I16) w[j] = __vadd2(v[j], ONE16);
    if constexpr (DT == DT_BF16) w[j] = addbf(v[j], ONE_BF2);
  }
}

template <int KIND>
__host__ __device__ constexpr int chain_unroll_of() {
  return KIND == REG ? 2 * CHAIN_UNROLL : CHAIN_UNROLL;
}

// Steps i0 .. i0 + len - 1 of the chain on the thread's W words at once (W
// independent chains), `chain_unroll_of` steps a pass, each step's constant
// made once for the W words: int32 ELEM adds i inside each word's add (a
// uniform register and an immediate), the 16-bit ELEM chains read theirs
// from `table` (its entry k is step i0 + k's; a pass's by 16-byte loads,
// every lane at one address), REG has none.
template <int DT, int KIND, int W>
__device__ __forceinline__ void chain_steps(unsigned (&v)[W],
                                            unsigned (&w)[W],
                                            const unsigned (&x)[W], int i0,
                                            int len,
                                            const unsigned* table) {
  constexpr int U = chain_unroll_of<KIND>();
  static_assert(U >= 4 && U % 4 == 0, "a pass reads its table by fours");
  int k = 0;
#pragma unroll 1
  for (; k + U <= len; k += U) {
    unsigned c[U];
#pragma unroll
    for (int q = 0; q < U; q += 4) {
      if constexpr (chain_table<DT, KIND>()) {
        const uint4 t4 = *reinterpret_cast<const uint4*>(table + k + q);
        c[q] = t4.x, c[q + 1] = t4.y, c[q + 2] = t4.z, c[q + 3] = t4.w;
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) c[q + r] = (unsigned)(i0 + k + q + r);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q)
#pragma unroll
      for (int j = 0; j < W; ++j) step<DT, KIND>(v[j], w[j], x[j], c[q]);
  }
#pragma unroll 1
  for (; k < len; ++k) {
    const unsigned c =
        chain_table<DT, KIND>() ? table[k] : (unsigned)(i0 + k);
#pragma unroll
    for (int j = 0; j < W; ++j) step<DT, KIND>(v[j], w[j], x[j], c);
  }
}

// the chain's result in x: v for ELEM, v + w for REG
template <int DT, int KIND, int W>
__device__ __forceinline__ void chain_finish(const unsigned (&v)[W],
                                             const unsigned (&w)[W],
                                             unsigned (&x)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if constexpr (KIND == ELEM) {
      x[j] = v[j];
    } else {
      if constexpr (DT == DT_I32) x[j] = v[j] + w[j];
      if constexpr (DT == DT_F32)
        x[j] = __float_as_uint(__uint_as_float(v[j]) + __uint_as_float(w[j]));
      if constexpr (DT == DT_I16) x[j] = __vadd2(v[j], w[j]);
      if constexpr (DT == DT_BF16) x[j] = addbf(v[j], w[j]);
    }
  }
}

// W words of 32 bits as one load or store of 4 W bytes
template <int W> struct Words;
template <> struct Words<1> {
  using V = unsigned;
  __device__ static void get(V v, unsigned (&w)[1]) { w[0] = v; }
  __device__ static V make(const unsigned (&w)[1]) { return w[0]; }
};
template <> struct Words<2> {
  using V = uint2;
  __device__ static void get(V v, unsigned (&w)[2]) { w[0] = v.x, w[1] = v.y; }
  __device__ static V make(const unsigned (&w)[2]) {
    return make_uint2(w[0], w[1]);
  }
};
template <> struct Words<4> {
  using V = uint4;
  __device__ static void get(V v, unsigned (&w)[4]) {
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
  __device__ static V make(const unsigned (&w)[4]) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// n values; this thread's words are W t .. W t + W - 1, one load and one
// store of 4 W bytes, except in the last thread, which loads and stores
// value by value (the wrapper's `_chain_plan` sizes the grid). A block of
// a table chain keeps its threads past n for the table's barriers.
template <int DT, int KIND, int W>
__global__ void __launch_bounds__(CHAIN_MAX_THREADS)
    chain_kernel(const void* __restrict__ x, void* __restrict__ out, long n,
                 int chain) {
  constexpr int PER = per_word<DT>();
  constexpr bool TABLE = chain_table<DT, KIND>();
  using Vec = typename Words<W>::V;
  __shared__ __align__(16) unsigned table[TABLE ? CHAIN_TABLE : 4];
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
#if CHAIN_SMID
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    atomicAdd(&chain_sm_blocks[sm & 1023], 1u);
  }
#endif
  const long e0 = t * W * PER;
  const bool active = e0 < n;
  if (!TABLE && !active) return;
  const bool full = e0 + W * PER <= n;
  unsigned xw[W];
  if (full) {
    Words<W>::get(reinterpret_cast<const Vec*>(x)[t], xw);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      xw[j] = 0;
#pragma unroll
      for (int h = 0; h < PER; ++h) {
        const long e = e0 + j * PER + h;
        if (e >= n) continue;
        xw[j] |= PER == 1 ? static_cast<const unsigned*>(x)[e]
                          : (unsigned)static_cast<const uint16_t*>(x)[e]
                                << (16 * h);
      }
    }
  }
  unsigned v[W], w[W];
  chain_start<DT, W>(xw, v, w);
  if constexpr (TABLE) {
    for (int base = 0; base < chain;) {
      const int len = min(chain - base, CHAIN_TABLE);
      __syncthreads();  // the last chunk's reads are done
      for (int k = threadIdx.x; k < len; k += blockDim.x)
        table[k] = step_const<DT>(base + k);
      __syncthreads();
      if (active) chain_steps<DT, KIND, W>(v, w, xw, base, len, table);
      base += len;
    }
    if (!active) return;
  } else {
    chain_steps<DT, KIND, W>(v, w, xw, 0, chain, table);
  }
  chain_finish<DT, KIND, W>(v, w, xw);
  if (full) {
    reinterpret_cast<Vec*>(out)[t] = Words<W>::make(xw);
    return;
  }
#pragma unroll
  for (int j = 0; j < W; ++j)
#pragma unroll
    for (int h = 0; h < PER; ++h) {
      const long e = e0 + j * PER + h;
      if (e >= n) continue;
      if (PER == 1)
        static_cast<unsigned*>(out)[e] = xw[j];
      else
        static_cast<uint16_t*>(out)[e] = (uint16_t)(xw[j] >> (16 * h));
    }
}

// ---------------------------------------------------------------------------
// rolls

#ifndef ROLL_LPB
#define ROLL_LPB 4  // lines of one warp a block, once every SM has a block
#endif
#ifndef ROLL_MOVES
#define ROLL_MOVES 0  // 1: registers moved back every pair of steps, no renames
#endif
#ifndef ROLL_STAGE_COLS
#define ROLL_STAGE_COLS 0  // 1: columns staged by clusters (ROLL_COLUMNS), a
                           // candidate of bench/kernel_micro.py
#endif
#ifndef ROLL_CLUSTER
#define ROLL_CLUSTER 8  // columns a cluster stages: a row's 32-byte sector
#endif

// warps of a block that holds one line: 12 leave E = 64 its registers
constexpr int ROLL_MAXW = 12;

// how a line comes in and goes out: value by value (j * estride), 16 bytes
// at a time (exact lines of E % 4 == 0 on aligned rows), two bf16 rows a
// word, or staged in shared memory by a cluster of consecutive columns
enum { ROLL_PLAIN = 0, ROLL_VEC = 1, ROLL_PAIRS = 2, ROLL_COLUMNS = 3 };

// Steps of one period of the slot rotation: a pair of steps shifts the
// slots by 3, so E / gcd(E, 3) pairs bring them back.
template <int E>
__host__ __device__ constexpr int roll_period() {
  return ROLL_MOVES ? 2 : 2 * E / (E % 3 ? 1 : 3);
}

// The rotation before step j of a period: logical slot k of a thread sits
// in register (k + offset) % E.
template <int E>
__host__ __device__ constexpr int roll_offset(int j) {
  return ROLL_MOVES ? 0 : (E - ((j / 2) * 3 + (j & 1)) % E) % E;
}

struct RollLane {
  int lane;
  int src;        // the lane this lane's shuffles read
  bool shrt;      // holds E - 1 values
  int w, next_w;  // block lines: this warp, the warp its top values go to
  int send_lane;  // block lines: the lane of this warp that ends its values
};

using RollEdge = int (*)[ROLL_MAXW][2];

// Step J of the period: the roll by S = 1 + (J & 1). The values sent are
// the top S logical slots of the thread; the values received become its
// bottom S logical slots, in the registers of the values sent, and the
// rotation drops by S.
template <int E, bool EX, bool MW, int J>
__device__ __forceinline__ void roll_step(int (&v)[E], const RollLane& c,
                                          RollEdge edge) {
  constexpr int S = 1 + (J & 1);
  constexpr int R = roll_offset<E>(J);
  int send[S], got[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    send[k] = v[(E - S + k + R) % E];
    if constexpr (!EX) {
      if (c.shrt) send[k] = v[(E - 1 - S + k + R) % E];
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) got[k] = __shfl_sync(FULL_MASK, send[k], c.src);
  if constexpr (MW) {
    if (c.lane == c.send_lane) {
#pragma unroll
      for (int k = 0; k < S; ++k) edge[J & 1][c.next_w][k] = send[k];
    }
    __syncthreads();  // one a step: the edge slots alternate with J
    if (c.lane == 0) {
#pragma unroll
      for (int k = 0; k < S; ++k) got[k] = edge[J & 1][c.w][k];
    }
  }
  if constexpr (ROLL_MOVES) {
#pragma unroll
    for (int k = E - 1; k >= S; --k) v[k] = v[k - S];
#pragma unroll
    for (int k = 0; k < S; ++k) v[k] = got[k];
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k) v[(E - S + k + R) % E] = got[k];
  }
}

template <int E, bool EX, bool MW, int... J>
__device__ __forceinline__ void roll_period(int (&v)[E], const RollLane& c,
                                            RollEdge edge,
                                            std::integer_sequence<int, J...>) {
  (roll_step<E, EX, MW, J>(v, c, edge), ...);
}

template <int E, bool EX, bool MW, int... J>
__device__ __forceinline__ void roll_period_to(
    int (&v)[E], const RollLane& c, RollEdge edge, int rem,
    std::integer_sequence<int, J...>) {
  ((J < rem ? roll_step<E, EX, MW, J>(v, c, edge) : void()), ...);
}

#if ROLL_STAGE_COLS
template <bool B>
struct RollIn {
  static constexpr bool value = B;
};

// A cluster's ROLL_CLUSTER consecutive columns (the first at col0) between
// device memory and its blocks' shared memory, four rows at a time: each
// thread reads (writes) four whole rows of the columns, 16 bytes at a
// time, and moves each column's four values to (from) that column's block
// as one 16-byte piece. IN: device memory to shared memory.
template <bool IN>
__device__ __forceinline__ void roll_columns(int* const* peer, int* g,
                                             long len, long estride, long r0,
                                             long rn) {
  constexpr int Q = ROLL_CLUSTER / 4;  // 16-byte pieces of a row
  for (long r = 4 * r0; r < len; r += 4 * rn) {
    int4 row[4][Q];
    if constexpr (IN) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int h = 0; h < Q; ++h)
          row[u][h] = r + u < len
                          ? reinterpret_cast<const int4*>(g + (r + u) * estride)[h]
                          : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int h = 0; h < Q; ++h) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int4* piece = reinterpret_cast<int4*>(peer[4 * h + q] + r);
        if constexpr (IN) {
          auto at = [&](int u) {
            const int4 w = row[u][h];
            return q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
          };
          *piece = make_int4(at(0), at(1), at(2), at(3));
        } else {
          const int4 w = *piece;
          const int col[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            int* e = q == 0 ? &row[u][h].x : q == 1 ? &row[u][h].y
                     : q == 2 ? &row[u][h].z : &row[u][h].w;
            *e = col[u];
          }
        }
      }
    }
    if constexpr (!IN) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r + u < len)
#pragma unroll
          for (int h = 0; h < Q; ++h)
            reinterpret_cast<int4*>(g + (r + u) * estride)[h] = row[u][h];
    }
  }
}
#endif

// T threads a line, the first `nlong` of them E values, the others E - 1
// (EX: all E). Not MW: one warp a line, blockDim / 32 lines a block; MW:
// one line a block of ceil(T / 32) warps. Value j of line l at l * lstride
// + j * estride (in values); ROLL_PAIRS: the bf16 rows 2l and 2l + 1 in
// one word, low and high half, at l * lstride + j and l * lstride +
// lstride / 2 + j; ROLL_COLUMNS: one line a block, launched in clusters
// of ROLL_CLUSTER consecutive columns (lstride 1), staged in shared
// memory (`stage`, the column's values rounded up to 4). A line of one
// value rolls as a ring of two copies of it.
template <int E, bool EX, bool MW>
__global__ void __launch_bounds__(MW ? 32 * ROLL_MAXW : 32 * ROLL_LPB)
    roll_kernel(const void* __restrict__ x, void* __restrict__ out, int lines,
                int len, long lstride, long estride, int mode, int T,
                int nlong, int chain) {
  extern __shared__ int4 stage4[];
  __shared__ int edge[2][ROLL_MAXW][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int line = MW ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + warp;
  if (!MW && line >= lines) return;  // the whole warp leaves together
  const int t = MW ? threadIdx.x : lane;
  RollLane c;
  c.lane = lane;
  c.shrt = !EX && t >= nlong;
  if constexpr (MW) {
    const int W = blockDim.x >> 5;
    c.src = (lane + 31) & 31;  // lane 0 takes shared memory's instead
    c.w = warp;
    c.next_w = warp + 1 == W ? 0 : warp + 1;
    c.send_lane = warp + 1 == W ? (T - 1) & 31 : 31;
  } else {
    c.src = lane == 0 ? T - 1 : lane - 1;
  }
  const int n = c.shrt ? E - 1 : E;
  const long first = (long)t * (E - 1) + min(t, nlong);
  const bool active = t < T;
  const size_t base = (size_t)line * lstride, half = lstride / 2;
  const int* x32 = static_cast<const int*>(x);
  const uint16_t* x16 = static_cast<const uint16_t*>(x);
  int* stage = reinterpret_cast<int*>(stage4);

#if ROLL_STAGE_COLS
  // columns: the cluster's threads take rows of its columns into the
  // blocks' shared memory (the same again on the way out)
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  auto columns = [&](auto in) {
    constexpr bool IN = decltype(in)::value;
    const int rank = (int)cl.block_rank();
    int* peer[ROLL_CLUSTER];
#pragma unroll
    for (int q = 0; q < ROLL_CLUSTER; ++q) peer[q] = cl.map_shared_rank(stage, q);
    int* g = static_cast<int*>(IN ? const_cast<void*>(x) : out) +
             (blockIdx.x - rank);
    roll_columns<IN>(peer, g, len, estride,
                     (long)rank * blockDim.x + threadIdx.x,
                     (long)ROLL_CLUSTER * blockDim.x);
  };
  if (mode == ROLL_COLUMNS) {
    columns(RollIn<true>{});
    cl.sync();
  }
#endif

  // the registers hold logical slot k at k (rotation 0): chain = nfull
  // periods and the first rem steps of one more, after which logical slot
  // k sits at (k + of) % E
  int v[E];
  if (mode == ROLL_VEC) {
#pragma unroll
    for (int p = 0; p < E; p += 4) {
      const int4 w = active ? *reinterpret_cast<const int4*>(
                                  x32 + base + first + p)
                            : make_int4(0, 0, 0, 0);
      v[p] = w.x, v[p + 1] = w.y, v[p + 2] = w.z, v[p + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < E; ++p) {
      const long j = first + p < len ? first + p : len - 1;
      v[p] = 0;
      if (!active || p >= n) continue;
      if (ROLL_STAGE_COLS && mode == ROLL_COLUMNS)
        v[p] = stage[j];
      else if (mode == ROLL_PAIRS)
        v[p] = (int)pack16(x16[base + j], x16[base + half + j]);
      else
        v[p] = x32[base + (size_t)j * estride];
    }
  }
  constexpr int P = roll_period<E>();
  const int nfull = chain / P, rem = chain % P;
  const int of = roll_offset<E>(rem);
  using Period = std::make_integer_sequence<int, P>;
#pragma unroll 1
  for (int q = 0; q < nfull; ++q) roll_period<E, EX, MW>(v, c, edge, Period{});
  roll_period_to<E, EX, MW>(v, c, edge, rem, Period{});

  if (mode == ROLL_VEC && of % 4 == 0) {
    // logical slots k .. k + 3 sit in registers p .. p + 3 (E % 4 == 0)
#pragma unroll
    for (int p = 0; p < E; p += 4) {
      const int k = p >= of ? p - of : p - of + E;
      if (active)
        *reinterpret_cast<int4*>(static_cast<int*>(out) + base + first + k) =
            make_int4(v[p], v[p + 1], v[p + 2], v[p + 3]);
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < E; ++p) {
    const int k = p >= of ? p - of : p - of + E;
    const long j = first + k;
    if (!active || k >= n || j >= len) continue;
    if (ROLL_STAGE_COLS && mode == ROLL_COLUMNS) {
      stage[j] = v[p];
    } else if (mode == ROLL_PAIRS) {
      uint16_t* o16 = static_cast<uint16_t*>(out);
      o16[base + j] = (uint16_t)v[p];
      o16[base + half + j] = (uint16_t)((unsigned)v[p] >> 16);
    } else {
      static_cast<int*>(out)[base + (size_t)j * estride] = v[p];
    }
  }
#if ROLL_STAGE_COLS
  if (mode == ROLL_COLUMNS) {
    cl.sync();
    columns(RollIn<false>{});
    cl.sync();  // each block's shared memory stays until all have read it
  }
#endif
}

// One warp a block until every SM has a block, then up to ROLL_LPB lines
// a block.
int roll_lines_per_block(int lines) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int lpb = ROLL_LPB;
  while (lpb > 1 && (long)lines < (long)lpb * sms) lpb >>= 1;
  return lpb;
}

template <int E, bool EX, bool MW>
cudaError_t roll_launch(int blocks, int threads, size_t smem, bool cluster,
                        cudaStream_t st, const void* x, void* out, int lines,
                        int len, long lstride, long estride, int mode, int T,
                        int nlong, int chain) {
  static size_t allowed = 48 * 1024;  // each instantiation's opt-in so far
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        roll_kernel<E, EX, MW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ROLL_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, roll_kernel<E, EX, MW>, x, out, lines, len,
                         lstride, estride, mode, T, nlong, chain);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int E>
cudaError_t launch_roll(const void* x, void* out, int lines, int len,
                        long lstride, long estride, int pair16, int T,
                        int chain, cudaStream_t st) {
  const bool ex = T * E == (len < 2 ? 2 : len);
  const int nlong = ex ? T : len - T * (E - 1);
  if (T < 1 || T > 32 * ROLL_MAXW ||
      (!ex && (E < 3 || nlong <= 0 || nlong > T)))
    return cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  // columns whose rows hold the cluster's columns as whole 16-byte pieces
  const bool columns = ROLL_STAGE_COLS && !pair16 && lstride == 1 &&
                       estride > 1 && lines % ROLL_CLUSTER == 0 &&
                       estride % 4 == 0 && aligned;
  const bool vec = !pair16 && estride == 1 && ex && E % 4 == 0 &&
                   (lines == 1 || lstride % 4 == 0) && aligned;
  const int mode = pair16    ? ROLL_PAIRS
                   : columns ? ROLL_COLUMNS
                   : vec     ? ROLL_VEC
                             : ROLL_PLAIN;
  const bool mw = T > 32;
  const int lpb = mw || columns ? 1 : roll_lines_per_block(lines);
  const int blocks = (lines + lpb - 1) / lpb;
  const int threads = mw ? 32 * ((T + 31) / 32) : 32 * lpb;
  const size_t smem = columns ? (size_t)(len + 3) / 4 * 16 : 0;
#define ROLL_GO(EXB, MWB)                                                    \
  return roll_launch<E, EXB, MWB>(blocks, threads, smem, columns, st, x, out, \
                                  lines, len, lstride, estride, mode, T,      \
                                  nlong, chain)
  if (mw) {
    if (ex) ROLL_GO(true, true);
    ROLL_GO(false, true);
  }
  if (ex) ROLL_GO(true, false);
  ROLL_GO(false, false);
#undef ROLL_GO
}

template <int MODE>
cudaError_t launch_sweep(const void* C, void* out, int T, int N, int p1,
                         int p2, cudaStream_t st) {
  const int lines = MODE == SWAR_I8 || MODE == BF16_I8 ? N / 2 : N;
  sweep_micro_kernel<MODE>
      <<<(lines + 3) / 4, 128, 0, st>>>(C, out, T, N, p1, p2);
  return cudaGetLastError();
}

template <int DT, int KIND>
cudaError_t launch_chain(const void* x, void* out, long n, int words,
                         int threads, int blocks, int chain,
                         cudaStream_t st) {
  const long held = (long)blocks * threads * words * per_word<DT>();
  if (n < 1 || chain < 0 || threads < 128 || threads % 128 ||
      threads > CHAIN_MAX_THREADS || blocks < 1 || held < n)
    return cudaErrorInvalidValue;
#define CHAIN_GO(W)                                                    \
  case W:                                                              \
    chain_kernel<DT, KIND, W><<<blocks, threads, 0, st>>>(x, out, n,   \
                                                          chain);      \
    break;
  switch (words) {
    CHAIN_GO(1) CHAIN_GO(2) CHAIN_GO(4)
    default: return cudaErrorInvalidValue;
  }
#undef CHAIN_GO
  return cudaGetLastError();
}

}  // namespace

// C (T, N, 128) -> out (T, N, 128), the mode's dtypes (see the wrapper)
TPS_EXPORT int sweep_micro_launch(const void* C, void* out, int T, int N,
                                  int mode, int p1, int p2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case V32: return launch_sweep<V32>(C, out, T, N, p1, p2, st);
    case SWAR: return launch_sweep<SWAR>(C, out, T, N, p1, p2, st);
    case V32_I8: return launch_sweep<V32_I8>(C, out, T, N, p1, p2, st);
    case SWAR_I8: return launch_sweep<SWAR_I8>(C, out, T, N, p1, p2, st);
    case BF16_I8: return launch_sweep<BF16_I8>(C, out, T, N, p1, p2, st);
  }
  return cudaErrorInvalidValue;
}

// n values of dtype `dt` (int32, int16, bf16, float32), kind ELEM or REG,
// on `blocks` blocks of `threads` threads of `words` 32-bit words each (the
// wrapper's `_chain_plan`)
TPS_EXPORT int chain_micro_launch(const void* x, void* out, long n, int dt,
                                  int kind, int words, int threads,
                                  int blocks, int chain, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dt * 2 + kind) {
#define CHAIN_CASE(DT, KIND)                                        \
  case DT * 2 + KIND:                                               \
    return launch_chain<DT, KIND>(x, out, n, words, threads, blocks, \
                                  chain, st);
    CHAIN_CASE(DT_I32, ELEM) CHAIN_CASE(DT_I32, REG)
    CHAIN_CASE(DT_I16, ELEM) CHAIN_CASE(DT_I16, REG)
    CHAIN_CASE(DT_BF16, ELEM) CHAIN_CASE(DT_BF16, REG)
    CHAIN_CASE(DT_F32, REG)
#undef CHAIN_CASE
  }
  return cudaErrorInvalidValue;
}

// the steps of one pass of a chain loop of `kind` (its SASS is counted a
// pass)
TPS_EXPORT int chain_unroll(int kind) {
  return kind == REG ? chain_unroll_of<REG>() : chain_unroll_of<ELEM>();
}

// the blocks each of the first `n` SMs took since the last call (CHAIN_SMID
// builds; zeros elsewhere), then zeroed
TPS_EXPORT int chain_sm_blocks_take(unsigned* host, int n) {
  if (n < 0 || n > 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyFromSymbol(host, chain_sm_blocks,
                                       sizeof(unsigned) * n);
  if (e != cudaSuccess) return e;
  static const unsigned zeros[1024] = {};
  return cudaMemcpyToSymbol(chain_sm_blocks, zeros, sizeof(zeros));
}

// `lines` lines of `len` values, `threads` threads a line holding `slots`
// values each, or slots - 1 (the wrapper's `_roll_plan`; slots in its
// ROLL_SLOTS)
TPS_EXPORT int roll_micro_launch(const void* x, void* out, int lines, int len,
                                 long lstride, long estride, int pair16,
                                 int slots, int threads, int chain,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ROLL_CASE(E)                                                       \
  case E:                                                                  \
    return launch_roll<E>(x, out, lines, len, lstride, estride, pair16,    \
                          threads, chain, st);
  switch (slots) {
    ROLL_CASE(2) ROLL_CASE(3) ROLL_CASE(4) ROLL_CASE(6) ROLL_CASE(8)
    ROLL_CASE(12) ROLL_CASE(16) ROLL_CASE(24) ROLL_CASE(32) ROLL_CASE(48)
    ROLL_CASE(64)
  }
#undef ROLL_CASE
  return cudaErrorInvalidValue;
}
