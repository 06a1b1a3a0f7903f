// The returns walk over config sets of any number of states, shared by
// the two first-generation kernels: K4 (wide_walk.cu, one history) and
// K5 (wide_keyed.cu, many keys' streams concatenated).
//
// What one walk computes is what walk.cuh computes, at any S: for each
// return r of its stream, with c_r = #{j : slot_ops[r, j] >= 0},
//   passes = min(c_r, W) Jacobi fire passes; each pass, from the
//            pass-start set `old`,
//            new[m][t] = old[m][t] | OR_{j: bit j of m, op_j >= 0}
//                        OR_s old[m ^ (1 << j)][s] & P[op_j][s][t]
//   then the projection on slot j = ret_slot[r] (-1: identity):
//            R[m][t] = (m & 1 << j) ? 0 : R[m | 1 << j][t].
// The TPU kernels (reach_pallas._fire_and_project) run two passes, then
// more while the set's popcount grows, W passes at most. Both end at
// the same set, the fixpoint of the pass: a pass never removes a config
// and depends only on the set, so a pass that adds nothing (the popcount
// test) has reached the fixpoint, and later passes are the identity;
// and every config of the fixpoint is reached from the set by a chain
// of firings of distinct pending slots (a fired slot's bit stays set),
// at most c_r <= W long, while pass p reaches every chain of length p.
// All values are 0/1, so the result is bit-identical to the plain
// versions.
//
// An empty set stays empty: firing adds only images of members, and the
// projection only moves or drops them. So the walk tests for emptiness
// after each return that projects (a return with no projection cannot
// empty a nonempty set) and stops at the first empty one.
//
// What bounds a walk on an H100: its serial chain, as in walk.cuh.
// Every pass depends on the whole previous set, so each return costs
// up to c_r passes, and a pass costs the images of the partner sets it
// fires. With more than 32 states a mask's set is NW = ceil(S / 32)
// words. The design keeps the chain of a pass short:
//   - nibble image tables instead of a loop over set states. A grid-
//     wide kernel, pack_tables, builds once a launch
//       T[o][k][v] (NT words): the image under op o of the states
//                  4k + b for the set bits b of the nibble value v,
//     k < K, v < 16. K is ceil(S / 4) and NT is NW, both rounded up to
//     a power of two where the warp form may take S (the padding
//     entries and words are zero). Word w of the image of a partner set
//     x under op o is then the OR over k of T[o][k][nibble k of x][w]:
//     K loads that do not depend on each other, with no data-dependent
//     branch, where a loop over x's set states takes up to S serial
//     steps;
//   - the layout makes a warp's lookup conflict-free. For fixed
//     (o, k) the 16 entries are contiguous, 16·NT words. A pass fires
//     slot j with the same op o_j in every mask, so at NT <= 2 a
//     warp-wide lookup of nibble k stays in one slice of at most 32
//     words, one word a bank: lanes that read different nibble values
//     hit different banks, lanes that read the same value share one
//     broadcast word, whatever the lanes' nibbles are. At NT = 4
//     (128-bit lookups) entries v and v + 8 share banks, at most 2-way
//     within a quarter warp; at NT = 8 entries v, v + 4, v + 8, v + 12
//     do, at most 4-way; in the block form at NT >= 32 a warp reads one
//     mask's entry, conflict-free again;
//   - the tables go into shared memory when they fit beside the set
//     and a chunk of the stream (multi-register, 21 ops at S = 64:
//     43,008 bytes); else they stay in device memory and are read
//     through L1 and the 50 MB L2 (the cas alphabet of 735 ops at
//     S = 64: 1,505,280 bytes);
//   - a pass that adds no config ends the return's passes: it has
//     reached the fixpoint, and the passes left are the identity (see
//     above), so a return runs as many passes as its longest chain of
//     firings needs, plus one, up to c_r;
//   - the warp form, for W <= 5 and NW <= 8 (M <= 32 masks, S <= 256):
//     one warp a walk, lane m holding mask m's set as NT words in
//     registers (walk.cuh's walk_warp at NT words, an instance for each
//     (NT, K) and for tables in shared or device memory). Firing slot
//     j with 8 lookups or more, the two lanes of a pair (m, m ^ 1 << j)
//     each look up half of the bit-clear mask's image; a pair's exchange,
//     the projection and the partner sets are __shfl_xor_sync, the
//     tests for growth and emptiness __any_sync. There is no
//     __syncthreads at all, and the stream is staged a chunk at a time
//     between __syncwarp;
//   - the block form, for W > 5 or NW > 8: one thread block a walk, R
//     double-buffered [2][M][NW] words in shared memory, each thread
//     owning (mask, word) pairs and firing every pending slot into its
//     word from the pass-start set; one __syncthreads_or a pass, which
//     also tells whether the pass grew the set, and one for the
//     projection, which tests emptiness.
// The form follows from the geometry alone (wide_warp_form), before
// the launch. Walks that are independent run as separate blocks: the
// keys of K5.

#pragma once

#include "walk.cuh"

namespace {

constexpr int kWideMaxW = 20;
constexpr int kWarpMaxW = 5;             // the warp form: M <= 32 masks
constexpr int kWarpMaxNW = 8;            // and NW <= 8 words (S <= 256)
constexpr size_t kSmemMax = 227 * 1024;  // one block's shared memory

// One launch's operands: walk.cuh's (P, the stream, R0 and final_out
// for K4, the key runs and dead for K5; H = 1) and the image tables.
struct Wide {
  Walk a;
  const uint32_t* T;  // [O1][K][16][NT], filled by pack_tables
  int NW;             // words a mask's set takes
  int K;              // nibbles a table holds
  int NT;             // words a table entry takes
  int rlim;           // K4: a death at r >= rlim is not reported
  int t_shared;       // copy T into shared memory
};

inline int n_words(int S) { return (S + 31) / 32; }
inline int pow2_at_least(int n) {
  int t = 1;
  while (t < n) t *= 2;
  return t;
}
// Nibbles a table holds: ceil(S / 4), rounded up to a power of two
// where the warp form may take S (the padding nibbles' entries are
// zero), so that each warp instance looks up a fixed count.
inline int n_nibbles(int S) {
  const int K = (S + 3) / 4;
  return n_words(S) > kWarpMaxNW ? K : pow2_at_least(K);
}
// Words a table entry takes: NW, rounded up to a power of two up to 8.
inline int table_words(int S) {
  const int NW = n_words(S);
  return NW > kWarpMaxNW ? NW : pow2_at_least(NW);
}
inline bool wide_warp_form(int W, int S) {
  return W <= kWarpMaxW && n_words(S) <= kWarpMaxNW;
}
inline size_t table_bytes(int S, int O1) {
  return 4 * (size_t)O1 * n_nibbles(S) * 16 * table_words(S);
}

// Shared memory one block needs, in bytes: the tables when they fit,
// R [2][M][NW] in the block form, and a chunk of the stream.
// reach_pallas.smem_bytes mirrors it for routing on hosts with no card;
// chip_smoke.py checks that the two agree.
inline size_t wide_smem_base(int W, int S) {
  const size_t set =
      wide_warp_form(W, S) ? 0 : 2 * ((size_t)1 << W) * n_words(S);
  return 4 * (set + (size_t)kChunk * (W + 1));
}
inline bool wide_t_shared(int W, int S, int O1) {
  return wide_smem_base(W, S) + table_bytes(S, O1) <= kSmemMax;
}
inline size_t wide_smem(int W, int S, int O1) {
  return wide_smem_base(W, S) +
         (wide_t_shared(W, S, O1) ? table_bytes(S, O1) : 0);
}

// T[o][k][v][w] for warp (o, k): per word w, four ballots build the
// target words of the states 4k .. 4k+3 (each lane reading one float of
// a row of P, coalesced), and lane v < 16 ORs the rows of its bits.
__global__ void pack_tables(const float* __restrict__ P,
                            uint32_t* __restrict__ T, int O1, int S, int K,
                            int NT) {
  const size_t warp = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= (size_t)O1 * K) return;  // whole warps leave together
  const size_t o = warp / K;
  const int k = (int)(warp % K);
  uint32_t* out = T + warp * 16 * NT;
  for (int w = 0; w < NT; ++w) {
    const int t = 32 * w + lane;
    uint32_t rows[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int s = 4 * k + b;
      const bool bit = s < S && t < S && P[(o * S + s) * S + t] > 0.5f;
      rows[b] = __ballot_sync(kFull, bit);
    }
    if (lane < 16) {
      uint32_t acc = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((lane >> b) & 1) acc |= rows[b];
      out[lane * NT + w] = acc;
    }
  }
}

// Copy the tables into shared memory, 16 bytes a thread (16·NT words
// an (o, k) slice, so the count is a multiple of 4).
__device__ __forceinline__ const uint32_t* stage_tables(const Wide& g,
                                                        uint32_t* Ts) {
  if (!g.t_shared) return g.T;
  const size_t n = (size_t)g.a.O1 * g.K * 16 * g.NT / 4;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x)
    ((uint4*)Ts)[i] = ((const uint4*)g.T)[i];
  return Ts;
}

// acc |= the NT words of the table entry at e, as one vector load (two
// at NT = 8).
template <int NT>
__device__ __forceinline__ void or_entry(const uint32_t* e,
                                         uint32_t (&acc)[NT]) {
  if constexpr (NT == 1) {
    acc[0] |= e[0];
  } else if constexpr (NT == 2) {
    const uint2 v = *(const uint2*)e;
    acc[0] |= v.x;
    acc[1] |= v.y;
  } else {
#pragma unroll
    for (int i = 0; i < NT; i += 4) {
      const uint4 v = *(const uint4*)(e + i);
      acc[i] |= v.x;
      acc[i + 1] |= v.y;
      acc[i + 2] |= v.z;
      acc[i + 3] |= v.w;
    }
  }
}

// Whether the two lanes of a slot's pair split the KT lookups of an
// image: on an H100 the halved lookups outweigh the shuffle that joins
// the halves at 16 lookups, and do not at 1 or 2.
template <int KT>
constexpr bool kSplit = KT >= 8;

// part |= lane hb's share of the image, under the op whose tables start
// at To, of the set x of the bit-clear mask of a slot's pair: with
// kSplit, hb = 0 looks up the nibbles below KT / 2 and hb = 1 the rest;
// else every nibble. The lookups do not depend on each other and take
// no branch.
template <int NT, int KT>
__device__ __forceinline__ void or_part(const uint32_t* To, int hb,
                                        const uint32_t (&x)[NT],
                                        uint32_t (&part)[NT]) {
  if constexpr (!kSplit<KT>) {
#pragma unroll
    for (int k = 0; k < KT; ++k)
      or_entry<NT>(To + (16 * k + ((x[k / 8] >> (4 * (k % 8))) & 15u)) * NT,
                   part);
  } else if constexpr (NT == 1) {  // KT = 8: a half is 4 nibbles of x[0]
    const uint32_t h = x[0] >> (16 * hb);
    const uint32_t* Tb = To + hb * 4 * 16;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      or_entry<NT>(Tb + 16 * q + ((h >> (4 * q)) & 15u), part);
  } else {
    constexpr int HW = NT / 2;  // a half's words: KT / 2 = 8·HW nibbles
    const uint32_t* Tb = To + hb * (KT / 2) * 16 * NT;
#pragma unroll
    for (int v = 0; v < HW; ++v) {
      const uint32_t h = hb ? x[HW + v] : x[v];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        or_entry<NT>(Tb + (16 * (8 * v + q) + ((h >> (4 * q)) & 15u)) * NT,
                     part);
    }
  }
}

// The warp form (W <= 5, NW <= 8): one warp, lane m holding mask m's
// set as NT words in registers; KT = n_nibbles(S), and the tables in
// shared memory when kShared. Lanes m >= M start empty and stay empty:
// their partners are lanes >= M too. K4 (kKeyed false) walks returns
// [0, R_pad) from R0, writes the final set to final_out and to dead[0]
// the first r < rlim after which the set is empty, or -1. K5 (kKeyed
// true): block k walks key k's run [lo[k], hi[k]) from the one-hot seed
// (mask 0, state 0) and writes the flat index of its first empty
// return, or -1, to dead[k].
//
// Firing slot j, the pair (m, m ^ 1 << j) both hold the bit-clear
// mask's set after one shuffle; with kSplit each looks up half of its
// image and a second shuffle gives the bit-set lane the whole, else the
// bit-set lane looks it all up. A pass that adds nothing ends the
// return's passes: the set is at the fixpoint (see above), and the
// passes left are the identity.
template <int NT, int KT, bool kShared, bool kKeyed>
__global__ void wide_warp(Wide g) {
  extern __shared__ uint32_t smem[];
  const Walk& a = g.a;
  const int W = a.W, S = a.S, NW = g.NW, M = 1 << W;
  const int m = threadIdx.x;
  const uint32_t* T = g.T;
  if constexpr (kShared) {
    stage_tables(g, smem);
    T = smem;
  }
  int* js_s = (int*)(smem + (kShared ? (size_t)a.O1 * KT * 16 * NT : 0));
  int* ops_s = js_s + kChunk;  // [kChunk][W]
  int h, r0, r1;
  bounds<kKeyed>(a, h, r0, r1);
  uint32_t x[NT];
  int any = 0;
#pragma unroll
  for (int w = 0; w < NT; ++w) {
    if (kKeyed)
      x[w] = m == 0 && w == 0 ? 1u : 0u;
    else
      x[w] = m < M && w < NW
                 ? word_of(a.R0 + (size_t)m * S + 32 * w, min(32, S - 32 * w))
                 : 0u;
    any |= x[w] != 0u;
  }
  // the seed itself may be empty (K4): then the first return is dead
  int dead = __any_sync(kFull, any) ? -1 : (r0 < r1 ? r0 : -1);

  for (int r = r0; r < r1 && dead < 0; ++r) {
    const int k = (r - r0) % kChunk;
    if (k == 0) {
      __syncwarp();
      stage(a, h, r, r1, js_s, ops_s);
      __syncwarp();
    }
    int ops[kWarpMaxW];
    int c = 0;
#pragma unroll
    for (int j = 0; j < kWarpMaxW; ++j) {
      ops[j] = j < W ? ops_s[k * W + j] : -1;
      c += ops[j] >= 0;
    }
    const int js = js_s[k];
    for (int p = 0; p < c; ++p) {
      uint32_t acc[NT];
#pragma unroll
      for (int w = 0; w < NT; ++w) acc[w] = x[w];
#pragma unroll
      for (int j = 0; j < kWarpMaxW; ++j) {
        if (j >= W) break;
        if (ops[j] < 0) continue;  // the same in every lane
        const int hb = (m >> j) & 1;
        uint32_t y[NT], part[NT];
#pragma unroll
        for (int w = 0; w < NT; ++w) {
          const uint32_t other = __shfl_xor_sync(kFull, x[w], 1 << j);
          y[w] = hb ? other : x[w];
          part[w] = 0u;
        }
        or_part<NT, KT>(T + (size_t)ops[j] * KT * 16 * NT, hb, y, part);
        const uint32_t keep = 0u - (uint32_t)hb;
#pragma unroll
        for (int w = 0; w < NT; ++w) {
          if constexpr (kSplit<KT>)
            part[w] |= __shfl_xor_sync(kFull, part[w], 1 << j);
          acc[w] |= part[w] & keep;
        }
      }
      int grew = 0;
#pragma unroll
      for (int w = 0; w < NT; ++w) {
        grew |= acc[w] != x[w];
        x[w] = acc[w];
      }
      if (!__any_sync(kFull, grew)) break;
    }
    if (js >= 0) {
      const int bit = 1 << js;
      int some = 0;
#pragma unroll
      for (int w = 0; w < NT; ++w) {
        const uint32_t hi = __shfl_xor_sync(kFull, x[w], bit);
        x[w] = (m & bit) ? 0u : hi;
        some |= x[w] != 0u;
      }
      if (!__any_sync(kFull, some)) dead = r;
    }
  }

  if (kKeyed) {
    if (m == 0) a.dead[blockIdx.x] = dead;
    return;
  }
  if (m == 0) a.dead[0] = dead < g.rlim ? dead : -1;
  // the final set through the stream's chunk (32·NT <= 256 words of at
  // least 2·kChunk), then written coalesced
  uint32_t* fin = (uint32_t*)js_s;
  __syncwarp();
#pragma unroll
  for (int w = 0; w < NT; ++w) fin[m * NT + w] = x[w];
  __syncwarp();
  for (int i = m; i < M * S; i += 32) {
    const int mm = i / S, t = i % S;
    a.final_out[i] = (float)((fin[mm * NT + t / 32] >> (t % 32)) & 1u);
  }
}

// Word w of the image of the partner set y (NW words in shared memory)
// under op o, by the tables: a word's 8 lookups do not depend on each
// other, and an empty word is skipped.
__device__ __forceinline__ uint32_t image_word(const uint32_t* T, int o,
                                               int K, int NT, int NW,
                                               const uint32_t* y, int w) {
  const uint32_t* col = T + (size_t)o * K * 16 * NT + w;
  uint32_t acc = 0;
  for (int v = 0; v < NW; ++v) {
    const uint32_t yv = y[v];
    if (!yv) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = min(8 * v + q, K - 1);  // past K the nibble is empty
      acc |= col[(size_t)(16 * k + ((yv >> (4 * q)) & 15u)) * NT];
    }
  }
  return acc;
}

// Word w of mask m's set after one fire pass from `src` [M][NW].
__device__ __forceinline__ uint32_t fire_word(const uint32_t* src,
                                              const Wide& g,
                                              const uint32_t* T,
                                              const int (&ops)[kWideMaxW],
                                              int W, int m, int w) {
  const int NW = g.NW;
  uint32_t acc = src[m * NW + w];
#pragma unroll
  for (int j = 0; j < kWideMaxW; ++j) {
    if (j >= W) break;
    const int o = ops[j];
    if (o >= 0 && ((m >> j) & 1))
      acc |= image_word(T, o, g.K, g.NT, NW, src + (m ^ (1 << j)) * NW, w);
  }
  return acc;
}

// The block form (W > 5 or NW > 8), with wide_warp's contract: one
// barrier a pass, whose __syncthreads_or also tells whether the pass
// added a config, and one for the projection, which tests emptiness.
template <bool kKeyed>
__global__ void wide_block(Wide g) {
  extern __shared__ uint32_t smem[];
  const Walk& a = g.a;
  const int W = a.W, S = a.S, NW = g.NW, M = 1 << W, MW = M * NW;
  const int tid = threadIdx.x, nt = blockDim.x;
  const uint32_t* T = stage_tables(g, smem);
  uint32_t* Rw = smem + (g.t_shared ? (size_t)a.O1 * g.K * 16 * g.NT : 0);
  int* js_s = (int*)(Rw + 2 * MW);  // [kChunk]
  int* ops_s = js_s + kChunk;       // [kChunk][W]
  int h, r0, r1;
  bounds<kKeyed>(a, h, r0, r1);
  int any = 0;
  for (int i = tid; i < MW; i += nt) {
    uint32_t v;
    if (kKeyed) {
      v = i == 0 ? 1u : 0u;
    } else {
      const int w = i % NW;
      const int n = min(32, S - 32 * w);
      v = word_of(a.R0 + (size_t)(i / NW) * S + 32 * w, n);
    }
    Rw[i] = v;
    any |= v != 0u;
  }
  // the seed itself may be empty (K4): then the first return is dead
  int dead = __syncthreads_or(any) ? -1 : (r0 < r1 ? r0 : -1);

  int cur = 0;
  for (int r = r0; r < r1 && dead < 0; ++r) {
    const int k = (r - r0) % kChunk;
    if (k == 0) {
      __syncthreads();
      stage(a, h, r, r1, js_s, ops_s);
      __syncthreads();
    }
    int ops[kWideMaxW];
    int c = 0;
#pragma unroll
    for (int j = 0; j < kWideMaxW; ++j) {
      ops[j] = j < W ? ops_s[k * W + j] : -1;
      c += ops[j] >= 0;
    }
    const int js = js_s[k];
    for (int p = 0; p < c; ++p) {
      const uint32_t* src = Rw + cur * MW;
      uint32_t* dst = Rw + (cur ^ 1) * MW;
      int grew = 0;
      for (int i = tid; i < MW; i += nt) {
        dst[i] = fire_word(src, g, T, ops, W, i / NW, i % NW);
        grew |= dst[i] != src[i];
      }
      cur ^= 1;
      if (!__syncthreads_or(grew)) break;  // the fixpoint
    }
    if (js >= 0) {
      const int bit = 1 << js;
      const uint32_t* src = Rw + cur * MW;
      uint32_t* dst = Rw + (cur ^ 1) * MW;
      int some = 0;
      for (int i = tid; i < MW; i += nt) {
        const int m = i / NW;
        dst[i] = (m & bit) ? 0u : src[(m | bit) * NW + i % NW];
        some |= dst[i] != 0u;
      }
      cur ^= 1;
      if (!__syncthreads_or(some)) dead = r;
    }
  }

  if (kKeyed) {
    if (tid == 0) a.dead[blockIdx.x] = dead;
    return;
  }
  if (tid == 0) a.dead[0] = dead < g.rlim ? dead : -1;
  const uint32_t* fin = Rw + cur * MW;
  for (int i = tid; i < M * S; i += nt) {
    const int m = i / S, t = i % S;
    a.final_out[i] = (float)((fin[m * NW + t / 32] >> (t % 32)) & 1u);
  }
}

// Build the tables T [O1][K][16][NT] from P on `stream`. Returns the
// CUDA error of the launch (0 when it was accepted).
inline int launch_tables(const float* P, uint32_t* T, int O1, int S,
                         void* stream) {
  if (O1 < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const size_t warps = (size_t)O1 * n_nibbles(S);
  const unsigned blocks = (unsigned)((warps * 32 + 255) / 256);
  pack_tables<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      P, T, O1, S, n_nibbles(S), table_words(S));
  return (int)cudaGetLastError();
}

using WideKernel = void (*)(Wide);

// The kernel of this geometry's form: the warp form's instance of its
// table's shape and place, else the block form.
template <bool kKeyed, bool kShared>
WideKernel warp_kernel(int S) {
  switch (table_words(S)) {
    case 1:
      switch (n_nibbles(S)) {
        case 1: return wide_warp<1, 1, kShared, kKeyed>;
        case 2: return wide_warp<1, 2, kShared, kKeyed>;
        case 4: return wide_warp<1, 4, kShared, kKeyed>;
        default: return wide_warp<1, 8, kShared, kKeyed>;
      }
    case 2: return wide_warp<2, 16, kShared, kKeyed>;
    case 4: return wide_warp<4, 32, kShared, kKeyed>;
    default: return wide_warp<8, 64, kShared, kKeyed>;
  }
}
template <bool kKeyed>
WideKernel wide_kernel(int W, int S, int O1) {
  if (!wide_warp_form(W, S)) return wide_block<kKeyed>;
  return wide_t_shared(W, S, O1) ? warp_kernel<kKeyed, true>(S)
                                 : warp_kernel<kKeyed, false>(S);
}

// Build the tables into T, then launch `blocks` walks on `stream`.
// Returns the CUDA error of the launches (0 when both were accepted).
template <bool kKeyed>
int launch_wide(Wide g, uint32_t* T, int blocks, void* stream) {
  const Walk& a = g.a;
  if (a.W < 1 || a.W > kWideMaxW || a.S < 1 || a.O1 < 1 || a.H != 1 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  g.NW = n_words(a.S);
  g.K = n_nibbles(a.S);
  g.NT = table_words(a.S);
  g.T = T;
  g.t_shared = wide_t_shared(a.W, a.S, a.O1);
  const size_t smem = wide_smem(a.W, a.S, a.O1);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int err = launch_tables(a.P, T, a.O1, a.S, stream);
  if (err != 0) return err;
  const WideKernel kernel = wide_kernel<kKeyed>(a.W, a.S, a.O1);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int threads = 32;
  if (!wide_warp_form(a.W, a.S)) {
    threads = ((1 << a.W) * g.NW + 31) / 32 * 32;
    if (threads > 1024) threads = 1024;
  }
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace
