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
// chain_kernel: dependent add/min chains held in registers, four 32-bit
// words a thread run side by side (one int32 or float32 value a word, two
// int16 or bf16):
// ELEM is v = min(v + 1, x + i), REG is v = min(v + 1, w); w = w + 1 then
// v + w. int16 runs as s16x2 (__viaddmin_s16x2, __vadd2), bf16 as bf16x2
// (__hadd2, __hmin2). Bound by the rate at which the SMs dispatch them.
//
// roll_kernel: dependent rolls by 1 + (i & 1) of a line of up to 2048
// values that one warp holds in registers, E a lane (value j of the line in
// slot j / 32 of lane j % 32): a roll by s is a register rotation in the
// lanes that wrap plus one __shfl_sync a slot. A line that does not fill
// its 32 E positions keeps two pad positions past its end, and the values
// that wrap are fetched from there (see roll_line). PAIR16 packs two bf16
// rows into one 32-bit word, so each shuffle moves two values. Bound by the
// shuffle rate.
#include <cuda_bf16.h>
#include <string.h>

#include "common.cuh"

namespace {

// the Python wrapper's `MODES` order
enum { V32 = 0, SWAR = 1, V32_I8 = 2, SWAR_I8 = 3, BF16_I8 = 4 };
enum { DT_I32 = 0, DT_I16 = 1, DT_BF16 = 2, DT_F32 = 3 };
enum { ELEM = 0, REG = 1 };

constexpr int KD = 4;      // disparities a lane
constexpr int DM = 128;    // D of the micro
constexpr int CW = 4;      // 32-bit words a thread in the chains
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

template <int DT>
__host__ __device__ constexpr int per_word() {
  return DT == DT_I16 || DT == DT_BF16 ? 2 : 1;
}

// The chain's carried values pass through an empty asm statement every
// iteration: without it nvcc folds integer chains across iterations
// (min(v + 1, a) + 1 = min(v + 2, a + 1)), and the int32 chains then time
// fewer operations than they name. Floats and the packed intrinsics are not
// folded; they pass through it too, so every type runs the same loop.
__device__ __forceinline__ void pin(unsigned& v) { asm volatile("" : "+r"(v)); }

// The chain on this thread's CW words at once (CW independent chains, so
// a thread has CW operations in flight); each iteration's constant is made
// once for all of them.
template <int DT, int KIND>
__device__ __forceinline__ void chain_words(unsigned (&x)[CW], int chain) {
  unsigned v[CW], w[CW];
  constexpr unsigned ONE16 = 0x00010001u;
  const __nv_bfloat162 one = bf2(1.0f);
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    v[j] = x[j];
    if constexpr (DT == DT_I32) w[j] = v[j] + 1u;
    if constexpr (DT == DT_F32)
      w[j] = __float_as_uint(__uint_as_float(v[j]) + 1.0f);
    if constexpr (DT == DT_I16) w[j] = __vadd2(v[j], ONE16);
    if constexpr (DT == DT_BF16) w[j] = as_u32(__hadd2(as_bf2(v[j]), one));
  }
#pragma unroll 4
  for (int i = 0; i < chain; ++i) {
    const unsigned i16 = (unsigned)(i & 0xffff) * ONE16;
    const __nv_bfloat162 ib = bf2((float)i);
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      if constexpr (KIND == ELEM) {  // v = min(v + 1, x + i)
        if constexpr (DT == DT_I32)
          v[j] = (unsigned)min((int)(v[j] + 1u), (int)(x[j] + (unsigned)i));
        if constexpr (DT == DT_I16)
          v[j] = __viaddmin_s16x2(v[j], ONE16, __vadd2(x[j], i16));
        if constexpr (DT == DT_BF16)
          v[j] = as_u32(__hmin2(__hadd2(as_bf2(v[j]), one),
                                __hadd2(as_bf2(x[j]), ib)));
        pin(v[j]);
      } else {  // v = min(v + 1, w); w = w + 1
        if constexpr (DT == DT_I32) {
          v[j] = (unsigned)min((int)(v[j] + 1u), (int)w[j]);
          w[j] = w[j] + 1u;
        }
        if constexpr (DT == DT_F32) {
          v[j] = __float_as_uint(
              fminf(__uint_as_float(v[j]) + 1.0f, __uint_as_float(w[j])));
          w[j] = __float_as_uint(__uint_as_float(w[j]) + 1.0f);
        }
        if constexpr (DT == DT_I16) {
          v[j] = __viaddmin_s16x2(v[j], ONE16, w[j]);
          w[j] = __vadd2(w[j], ONE16);
        }
        if constexpr (DT == DT_BF16) {
          v[j] = as_u32(__hmin2(__hadd2(as_bf2(v[j]), one), as_bf2(w[j])));
          w[j] = as_u32(__hadd2(as_bf2(w[j]), one));
        }
        pin(v[j]), pin(w[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    if constexpr (KIND == ELEM) {
      x[j] = v[j];
    } else {  // v + w
      if constexpr (DT == DT_I32) x[j] = v[j] + w[j];
      if constexpr (DT == DT_F32)
        x[j] = __float_as_uint(__uint_as_float(v[j]) + __uint_as_float(w[j]));
      if constexpr (DT == DT_I16) x[j] = __vadd2(v[j], w[j]);
      if constexpr (DT == DT_BF16)
        x[j] = as_u32(__hadd2(as_bf2(v[j]), as_bf2(w[j])));
    }
  }
}

// n values; this thread's words are CW * t .. CW * t + CW - 1, whole 16-byte
// vectors except in the last thread, which loads and stores value by value
template <int DT, int KIND>
__global__ void __launch_bounds__(256)
    chain_kernel(const void* __restrict__ x, void* __restrict__ out, long n,
                 int chain) {
  constexpr int PER = per_word<DT>();
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long e0 = t * CW * PER;
  if (e0 >= n) return;
  const bool full = e0 + CW * PER <= n;
  unsigned w[CW];
  if (full) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[t];
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      w[j] = 0;
#pragma unroll
      for (int h = 0; h < PER; ++h) {
        const long e = e0 + j * PER + h;
        if (e >= n) continue;
        w[j] |= PER == 1 ? static_cast<const unsigned*>(x)[e]
                         : (unsigned)static_cast<const uint16_t*>(x)[e]
                               << (16 * h);
      }
    }
  }
  chain_words<DT, KIND>(w, chain);
  if (full) {
    reinterpret_cast<uint4*>(out)[t] = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < CW; ++j)
#pragma unroll
    for (int h = 0; h < PER; ++h) {
      const long e = e0 + j * PER + h;
      if (e >= n) continue;
      if (PER == 1)
        static_cast<unsigned*>(out)[e] = w[j];
      else
        static_cast<uint16_t*>(out)[e] = (uint16_t)(w[j] >> (16 * h));
    }
}

// ---------------------------------------------------------------------------
// rolls

// v rolled by s (0 < s < len) along the warp's line of `len` values: value
// j moves to j + s, wrapping at len. The lanes that wrap (lane >= 32 - s)
// first rotate their slots by one, so that one shuffle from lane - s brings
// every lane the right value, from the same slot or from the slot before.
// That wraps at 32 E; when the line is shorter (pad), the positions len and
// len + 1 then hold the values that belong at 0 and 1, and lanes 0..s-1
// fetch them from there.
template <int E>
__device__ __forceinline__ void roll_line(int (&v)[E], int s, int lane,
                                          int len, bool pad) {
  const bool rot = lane >= 32 - s;
  const int src = (lane - s) & 31;
  int n[E];
#pragma unroll
  for (int k = 0; k < E; ++k)
    n[k] = __shfl_sync(FULL_MASK, rot ? v[k == 0 ? E - 1 : k - 1] : v[k],
                       src);
  if (pad) {
    const int r = len & 31, b = len >> 5;
    const int t = __shfl_sync(FULL_MASK, pick<E>(n, lane >= r ? b : b + 1),
                              (len + lane) & 31);
    if (lane < s) n[0] = t;
  }
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = n[k];
}

// One warp a line: value j of line l at l * lstride + j * estride (in
// values); PAIR16: the bf16 rows 2l and 2l + 1 in one word, low and high
// half, at l * lstride + j and l * lstride + lstride / 2 + j.
template <int E, bool PAIR16>
__global__ void __launch_bounds__(128)
    roll_kernel(const void* __restrict__ x, void* __restrict__ out, int lines,
                int len, long lstride, long estride, int pad, int chain) {
  const int line = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (line >= lines) return;
  const size_t base = (size_t)line * lstride, half = lstride / 2;
  int v[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = 32 * k + lane;
    v[k] = 0;
    if (j >= len) continue;
    if constexpr (PAIR16) {
      const uint16_t* x16 = static_cast<const uint16_t*>(x);
      v[k] = (int)pack16(x16[base + j], x16[base + half + j]);
    } else {
      v[k] = static_cast<const int*>(x)[base + (size_t)j * estride];
    }
  }
  for (int i = 0; i < chain; ++i) {
    const int s = (1 + (i & 1)) % len;  // a roll by len is none
    if (s) roll_line<E>(v, s, lane, len, pad);
  }
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = 32 * k + lane;
    if (j >= len) continue;
    if constexpr (PAIR16) {
      uint16_t* o16 = static_cast<uint16_t*>(out);
      o16[base + j] = (uint16_t)v[k];
      o16[base + half + j] = (uint16_t)((unsigned)v[k] >> 16);
    } else {
      static_cast<int*>(out)[base + (size_t)j * estride] = v[k];
    }
  }
}

template <int E>
cudaError_t launch_roll(const void* x, void* out, int lines, int len,
                        long lstride, long estride, int pair16, int pad,
                        int chain, cudaStream_t st) {
  const int blocks = (lines + 3) / 4;
  if (pair16)
    roll_kernel<E, true><<<blocks, 128, 0, st>>>(x, out, lines, len, lstride,
                                                 estride, pad, chain);
  else
    roll_kernel<E, false><<<blocks, 128, 0, st>>>(x, out, lines, len, lstride,
                                                  estride, pad, chain);
  return cudaGetLastError();
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
cudaError_t launch_chain(const void* x, void* out, long n, int chain,
                         cudaStream_t st) {
  const long threads = (n + CW * per_word<DT>() - 1) / (CW * per_word<DT>());
  chain_kernel<DT, KIND>
      <<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(x, out, n, chain);
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

// n values of dtype `dt` (int32, int16, bf16, float32), kind ELEM or REG
TPS_EXPORT int chain_micro_launch(const void* x, void* out, long n, int dt,
                                  int kind, int chain, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dt * 2 + kind) {
#define CHAIN_CASE(DT, KIND) \
  case DT * 2 + KIND:        \
    return launch_chain<DT, KIND>(x, out, n, chain, st);
    CHAIN_CASE(DT_I32, ELEM) CHAIN_CASE(DT_I32, REG)
    CHAIN_CASE(DT_I16, ELEM) CHAIN_CASE(DT_I16, REG)
    CHAIN_CASE(DT_BF16, ELEM) CHAIN_CASE(DT_BF16, REG)
    CHAIN_CASE(DT_F32, REG)
#undef CHAIN_CASE
  }
  return cudaErrorInvalidValue;
}

// `lines` lines of `len` values, `slots` a lane (the wrapper's ROLL_SLOTS),
// pad when 32 * slots > len
TPS_EXPORT int roll_micro_launch(const void* x, void* out, int lines, int len,
                                 long lstride, long estride, int pair16,
                                 int slots, int pad, int chain, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ROLL_CASE(E)                                                        \
  case E:                                                                   \
    return launch_roll<E>(x, out, lines, len, lstride, estride, pair16, pad, \
                          chain, st);
  switch (slots) {
    ROLL_CASE(1) ROLL_CASE(2) ROLL_CASE(3) ROLL_CASE(4) ROLL_CASE(5)
    ROLL_CASE(6) ROLL_CASE(8) ROLL_CASE(12) ROLL_CASE(16) ROLL_CASE(24)
    ROLL_CASE(32) ROLL_CASE(40) ROLL_CASE(48) ROLL_CASE(56) ROLL_CASE(64)
    ROLL_CASE(65)
  }
#undef ROLL_CASE
  return cudaErrorInvalidValue;
}
