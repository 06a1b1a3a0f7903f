// The returns walk over the dense config set R[mask, state]. One body,
// on P's nibble image tables, serves five kernels: K1 (lane_walk.cu, one
// history), K2 (batch_walk.cu, H lanes in lockstep, E seed groups per
// lane) and K3 (keyed_walk.cu, many keys' streams concatenated) at most
// 32 states, one 32-bit word a mask; K4 (wide_walk.cu, one history) and
// K5 (wide_keyed.cu, many keys' streams) at any number of states,
// launched through wide_walk.cuh.
//
// What one walk computes, for each return r of its stream:
//   c_r    = #{j : slot_ops[r, j] >= 0}                (pending ops)
//   passes = min(c_r, n_pass) Jacobi fire passes; each pass, from the
//            pass-start set `old`,
//            new[m][t] = old[m][t] | OR_{j: bit j of m, op_j >= 0}
//                        OR_s old[m ^ (1 << j)][s] & P[op_j][s][t]
//   then the projection on slot j = ret_slot[r] (-1: identity):
//            R[m][t] = (m & 1 << j) ? 0 : R[m | 1 << j][t].
// The TPU kernels run max(1, min(c_r, n_pass)) passes; with c_r = 0
// every op is -1 and a pass is the identity, so skipping it is exact.
// All values are 0/1, so the result is bit-identical to the plain
// versions.
//
// The fixpoint exit. A pass never removes a config and depends only on
// the set, so a pass that adds nothing has reached the pass's fixpoint
// and every later pass is the identity: a walk may stop a return's
// passes after the first pass that adds nothing, whatever its cap
// (n_pass, or W), and ends on the same set. Every config of the
// fixpoint is reached from the set by a chain of firings of distinct
// pending slots (a fired slot's bit stays set), at most c_r long, while
// pass p reaches every chain of length p: so min(c_r, W) passes reach
// the fixpoint, as the reference's popcount loop (two passes, then more
// while the popcount grows) does. K1-K5 stop at the first pass that
// adds nothing; K2 gates each lane by its own c_r where the reference
// gates by the batch's largest (batch_walk.cu).
//
// An empty set stays empty: firing adds only images of members, and the
// projection only moves or drops them. So a walk that reports its dead
// return tests for emptiness after each return that projects (a return
// with no projection cannot empty a nonempty set) and stops at the
// first empty one.
//
// What bounds a walk on an H100: neither bytes nor operations but its
// serial chain. Every pass depends on the whole previous set, so each
// return costs up to c_r passes of a few dependent on-chip loads, plus
// the exchange between passes. The design keeps that chain short:
//   - one thread block a walk, everything on chip; walks that are
//     independent run as separate blocks (the lanes and seed groups of
//     K2, the keys of K3 and K5);
//   - P's nibble image tables. One pack_tables launch before the walk
//     builds
//       T[o][k][v] (NT words): the image under op o of the states
//                  4k + b for the set bits b of the nibble value v,
//     k < K, v < 16. K is ceil(S / 4) and NT is ceil(S / 32), both
//     rounded up to a power of two up to 256 states (the padding
//     entries and words are zero): at S <= 32 one word an entry and
//     K in {1, 2, 4, 8}. The image of a partner set x under op o is then
//     the OR over k of T[o][k][nibble k of x]: K loads that do not
//     depend on each other, with no data-dependent branch, where a loop
//     over x's set states takes up to S serial steps. For fixed (o, k)
//     the 16 entries are contiguous, so a warp's lookup stays in one
//     slice of 16·NT words: conflict-free at NT <= 2 (wide_walk.cuh
//     states the pattern at NT = 4 and 8);
//   - no branch around a lookup: bit j of the mask gates slot j's image
//     by a bitwise AND, so a pass's loads overlap. In K1 and K2 a free
//     slot's op is P's last, all-zero row (the sentinel); K3, K4 and K5
//     skip a free slot by a branch the same in every thread;
//   - the tables go into shared memory when they fit beside the set and
//     a chunk of the stream (the cas alphabet of 37 ops at S = 8: 4,736
//     bytes), each block copying them in; else they stay in device
//     memory and are read through L1 and L2. The placement follows from
//     the geometry before the launch (t_shared);
//   - up to W = 5 (M <= 32) and 256 states the set lives in the
//     registers of one warp, lane m holding mask m as NT words: a
//     partner set is one __shfl_xor_sync a word, and the tests for
//     growth and emptiness are __any_sync (walk_warp). Firing slot j
//     with 8 lookups or more (S > 28), the two lanes of a pair
//     (m, m ^ 1 << j) each look up half of the bit-clear mask's image
//     and a shuffle joins the halves (kSplit). Else R is
//     double-buffered [2][M][NW] words in shared memory, each thread
//     owning (mask, word) pairs, with one __syncthreads_or a pass,
//     which also tells whether the pass grew the set, and one for the
//     projection (walk_block);
//   - the return stream is staged into shared memory a chunk of
//     returns at a time by the whole block, so the chain never waits on
//     a device-memory load.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 16;      // slots of a narrow walk
constexpr int kWideMaxW = 20;  // and of a wide one
constexpr int kChunk = 256;  // returns staged per shared-memory refill
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxW = 5;             // the warp form: M <= 32 masks
constexpr int kWarpMaxNW = 8;            // and (wide) NW <= 8 words
constexpr size_t kSmemMax = 227 * 1024;  // one block's shared memory

// One launch's operands. Return r of lane h is ret_slot[r * H + h] and
// slot_ops[(r * H + h) * W + j]. A lockstep launch (K1: H = E = 1; K2)
// runs block (h, e) over lane h's rows e*M .. e*M+M-1 of the
// [E*M, H*S] sets R0, ckpt[R_pad / B] and final_out, where row e*M + m,
// column h*S + t holds state t of mask m; K1 writes the first return
// after which its set is empty, or -1, to dead[0] (K2: dead is null).
// A keyed launch (K3, H = 1) runs block k over key k's run
// [lo[k], hi[k]) of the flat stream from the one-hot seed (mask 0,
// state 0) and writes the index of the first return after which its
// set is empty, or -1, to dead[k].
struct Walk {
  const float* P;
  const int* ret_slot;
  const int* slot_ops;
  const float* R0;
  float* ckpt;
  float* final_out;
  const int* lo;
  const int* hi;
  int* dead;
  int R_pad, H, W, S, O1, B, n_pass;
};

// One 0/1 float row of S states as a state word.
__device__ __forceinline__ uint32_t word_of(const float* __restrict__ row,
                                            int S) {
  uint32_t w = 0;
  for (int t = 0; t < S; ++t) w |= (uint32_t)(row[t] > 0.5f) << t;
  return w;
}

// Stage returns [r, min(r + kChunk, r1)) of lane h into shared memory.
__device__ __forceinline__ void stage(const Walk& a, int h, int r, int r1,
                                      int* __restrict__ js_s,
                                      int* __restrict__ ops_s) {
  const int n = min(kChunk, r1 - r);
  const int W = a.W;
  for (int i = threadIdx.x; i < n * W; i += blockDim.x)
    ops_s[i] = a.slot_ops[((size_t)(r + i / W) * a.H + h) * W + i % W];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    js_s[i] = a.ret_slot[(size_t)(r + i) * a.H + h];
}

// This block's lane and its run of returns.
template <bool kKeyed>
__device__ __forceinline__ void bounds(const Walk& a, int& h, int& r0,
                                       int& r1) {
  if (kKeyed) {
    h = 0;
    r0 = a.lo[blockIdx.x];
    r1 = a.hi[blockIdx.x];
  } else {
    h = blockIdx.x;
    r0 = 0;
    r1 = a.R_pad;
  }
}

// Whether a narrow walk runs in the warp form (else the block form);
// use_warp = 0 asks for the block form at every W (to time the two).
inline bool warp_form(int W, int use_warp) {
  return use_warp && W <= kWarpMaxW;
}

// -- P's nibble image tables (K1-K5) --------------------------------------

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
inline size_t table_bytes(int S, int O1) {
  return 4 * (size_t)O1 * n_nibbles(S) * 16 * table_words(S);
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

// Copy `words` words of tables (a multiple of 16: an (o, k) slice is
// 16·NT words) into shared memory, 16 bytes a thread.
__device__ __forceinline__ void copy_tables(const uint32_t* __restrict__ T,
                                            uint32_t* __restrict__ Ts,
                                            size_t words) {
  for (size_t i = threadIdx.x; i < words / 4; i += blockDim.x)
    ((uint4*)Ts)[i] = ((const uint4*)T)[i];
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

// -- K1-K5: the walk on the tables ------------------------------------------

// One launch's operands of a walk on the tables: the walk's (Walk) and
// P's tables. K1 and K2 are the lockstep walk (kLock below: a
// checkpoint every B returns, a free slot reading the sentinel); K4
// walks one history from R0 (H = 1); K3 and K5 walk key runs (kKeyed).
struct TableWalk {
  Walk a;
  const uint32_t* T;  // [O1][K][16][NT], filled by pack_tables
  int NW;             // words a mask's set takes
  int K;              // nibbles a table holds
  int NT;             // words a table entry takes
  int rlim;           // not keyed: a death at r >= rlim is not reported
};

// The tables a block reads: its copy in shared memory when kShared, else
// T in device memory. The copy is seen after the block's next barrier
// (before the first return's staging, or the seed's __syncthreads_or).
template <bool kShared>
__device__ __forceinline__ const uint32_t* tables(const TableWalk& g,
                                                  uint32_t* smem) {
  if constexpr (!kShared) {
    return g.T;
  } else {
    copy_tables(g.T, smem, (size_t)g.a.O1 * g.K * 16 * g.NT);
    return smem;
  }
}

// The ops of return k's staged row and its pending count. A free slot
// is -1, or with kLock the sentinel, P's last row (all zero), so that
// its lookups need no branch; else the walk skips it (a branch the same
// in every thread, which gains with tables in device memory).
template <int kSlots, bool kLock>
__device__ __forceinline__ int slot_row(const int* __restrict__ ops_s, int k,
                                        int W, int O1, int (&op)[kSlots]) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int o = j < W ? ops_s[k * W + j] : -1;
    c += o >= 0;
    op[j] = kLock && o < 0 ? O1 - 1 : o;
  }
  return c;
}

// The warp form (W <= 5, NW <= 8): one warp, lane m holding mask m's
// set as NT words in registers; KT = n_nibbles(S), and the tables in
// shared memory when kShared. Lanes m >= M start empty and stay empty:
// their partners are lanes >= M too. Not keyed, block (h, e) walks
// returns [0, R_pad) of lane h from its rows of R0 and writes its final
// set (K4: H = 1 and one block, so the rows are R0 and final_out
// whole), and when dead is given, the first r < rlim after which its set
// is empty, or -1, to dead[0]; kLock also writes the set at the start of
// every block of B returns to ckpt. Keyed (K3, K5), block k walks key k's
// run [lo[k], hi[k]) from the one-hot seed (mask 0, state 0) and writes
// the flat index of its first empty return, or -1, to dead[k]. A walk
// with dead stops at its first empty return.
//
// Firing slot j, the pair (m, m ^ 1 << j) both hold the bit-clear
// mask's set after one shuffle; with kSplit each looks up half of its
// image and a second shuffle gives the bit-set lane the whole, else the
// bit-set lane looks it all up (bit j of m gates it by AND). A pass
// that adds nothing ends the return's passes (the fixpoint exit).
template <int NT, int KT, bool kShared, bool kKeyed, bool kLock>
__global__ void walk_warp(TableWalk g) {
  static_assert(!(kKeyed && kLock) && (!kLock || NT == 1), "form");
  extern __shared__ uint32_t smem[];
  const Walk& a = g.a;
  const int W = a.W, S = a.S, NW = g.NW, M = 1 << W;
  const int m = threadIdx.x;
  const uint32_t* T = tables<kShared>(g, smem);
  int* js_s = (int*)(smem + (kShared ? (size_t)a.O1 * KT * 16 * NT : 0));
  int* ops_s = js_s + kChunk;  // [kChunk][W]
  int h, r0, r1;
  bounds<kKeyed>(a, h, r0, r1);
  // element (mask mm, state t) of this block's rows: at0 + mm * HS + t
  const size_t HS = (size_t)a.H * S;
  const size_t at0 = (size_t)blockIdx.y * M * HS + (size_t)h * S;
  uint32_t x[NT];
  int any = 0;
#pragma unroll
  for (int w = 0; w < NT; ++w) {
    if (kKeyed)
      x[w] = m == 0 && w == 0 ? 1u : 0u;
    else
      x[w] = m < M && w < NW ? word_of(a.R0 + at0 + m * HS + 32 * w,
                                       min(32, S - 32 * w))
                             : 0u;
    any |= x[w] != 0u;
  }
  // the seed itself may be empty: then the first return is dead
  const bool seeded = __any_sync(kFull, any);
  int dead = seeded || !a.dead || r0 >= r1 ? -1 : r0;
  // kLock: the next checkpoint, and the returns before it (a countdown:
  // a remainder by the runtime B a return costs about a tenth of K1)
  float* ck = kLock ? a.ckpt + at0 + m * HS : nullptr;
  int ck_left = 0;

  for (int r = r0; r < r1 && dead < 0; ++r) {
    const int k = (r - r0) % kChunk;
    if (k == 0) {
      __syncwarp();
      stage(a, h, r, r1, js_s, ops_s);
      __syncwarp();
    }
    if constexpr (kLock) {
      if (ck_left-- == 0) {
        if (m < M)
          for (int t = 0; t < S; ++t) ck[t] = (float)((x[0] >> t) & 1u);
        ck += (size_t)gridDim.y * M * HS;
        ck_left = a.B - 1;
      }
    }
    int op[kWarpMaxW];
    const int c = slot_row<kWarpMaxW, kLock>(ops_s, k, W, a.O1, op);
    const int js = js_s[k];
    const int passes = c < a.n_pass ? c : a.n_pass;
    for (int p = 0; p < passes; ++p) {
      uint32_t acc[NT];
#pragma unroll
      for (int w = 0; w < NT; ++w) acc[w] = x[w];
#pragma unroll
      for (int j = 0; j < kWarpMaxW; ++j) {
        if (j >= W) break;
        if constexpr (!kLock) {
          if (op[j] < 0) continue;  // the same in every lane
        }
        const int hb = (m >> j) & 1;
        uint32_t y[NT], part[NT];
#pragma unroll
        for (int w = 0; w < NT; ++w) {
          const uint32_t other = __shfl_xor_sync(kFull, x[w], 1 << j);
          y[w] = hb ? other : x[w];
          part[w] = 0u;
        }
        or_part<NT, KT>(T + (size_t)op[j] * KT * 16 * NT, hb, y, part);
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
      if (!__any_sync(kFull, grew)) break;  // the fixpoint
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
      if (a.dead && !__any_sync(kFull, some)) dead = r;
    }
  }

  if (kKeyed) {
    if (m == 0) a.dead[blockIdx.x] = dead;
    return;
  }
  if (a.dead && m == 0) a.dead[0] = dead < g.rlim ? dead : -1;
  // the final set through the stream's chunk (32·NT <= 256 words of at
  // least 2·kChunk), then written a row at a time
  uint32_t* fin = (uint32_t*)js_s;
  __syncwarp();
#pragma unroll
  for (int w = 0; w < NT; ++w) fin[m * NT + w] = x[w];
  __syncwarp();
  for (int i = m; i < M * S; i += 32) {
    const int mm = i / S, t = i % S;
    a.final_out[at0 + mm * HS + t] =
        (float)((fin[mm * NT + t / 32] >> (t % 32)) & 1u);
  }
}

// One word a mask (K1, K2, K3): mask m's set after one fire pass from
// `src`, every slot's image of its partner's set by KT table lookups,
// gated by bit j of m. A free slot reads the sentinel (kLock), else is
// skipped by a branch the same in every thread.
template <int KT, bool kLock>
__device__ __forceinline__ uint32_t fire_tab(const uint32_t* __restrict__ src,
                                             const uint32_t* __restrict__ T,
                                             const int (&op)[kMaxW], int W,
                                             int m) {
  uint32_t acc = src[m];
#pragma unroll
  for (int j = 0; j < kMaxW; ++j) {
    if (j >= W) break;
    if constexpr (!kLock) {
      if (op[j] < 0) continue;
    }
    const uint32_t* To = T + op[j] * KT * 16;
    const uint32_t y = src[m ^ (1 << j)];
    uint32_t img = 0;
#pragma unroll
    for (int k = 0; k < KT; ++k) img |= To[16 * k + ((y >> (4 * k)) & 15u)];
    acc |= img & (0u - (uint32_t)((m >> j) & 1));
  }
  return acc;
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

// Any number of words (K4, K5): word w of mask m's set after one fire
// pass from `src` [M][NW].
__device__ __forceinline__ uint32_t fire_word(const uint32_t* src,
                                              const TableWalk& g,
                                              const uint32_t* T,
                                              const int (&op)[kWideMaxW],
                                              int W, int m, int w) {
  const int NW = g.NW;
  uint32_t acc = src[m * NW + w];
#pragma unroll
  for (int j = 0; j < kWideMaxW; ++j) {
    if (j >= W) break;
    const int o = op[j];
    if (o >= 0 && ((m >> j) & 1))
      acc |= image_word(T, o, g.K, g.NT, NW, src + (m ^ (1 << j)) * NW, w);
  }
  return acc;
}

// The block form (W > 5, NW > 8, or the warp form not asked for), with
// walk_warp's contract: R double-buffered [2][M][NW] words in shared
// memory, each thread owning (mask, word) pairs and firing every
// pending slot into its word from the pass-start set; one
// __syncthreads_or a pass, which also tells whether the pass added a
// config, and one for the projection, which tests emptiness. With
// KT > 0 (K1, K2, K3) a mask is one word and its images KT lookups
// (fire_tab); else (K4, K5) NW words and fire_word's lookups.
template <int KT, bool kShared, bool kKeyed, bool kLock>
__global__ void walk_block(TableWalk g) {
  static_assert(!(kKeyed && kLock) && (!kLock || KT > 0), "form");
  extern __shared__ uint32_t smem[];
  const Walk& a = g.a;
  const int NW = KT > 0 ? 1 : g.NW;
  const int W = a.W, S = a.S, M = 1 << W, MW = M * NW;
  const int tid = threadIdx.x, nt = blockDim.x;
  const uint32_t* T = tables<kShared>(g, smem);
  uint32_t* Rw = smem + (kShared ? (size_t)a.O1 * g.K * 16 * g.NT : 0);
  int* js_s = (int*)(Rw + 2 * MW);  // [kChunk]
  int* ops_s = js_s + kChunk;       // [kChunk][W]
  int h, r0, r1;
  bounds<kKeyed>(a, h, r0, r1);
  const size_t HS = (size_t)a.H * S;  // as in walk_warp
  const size_t at0 = (size_t)blockIdx.y * M * HS + (size_t)h * S;
  int any = 0;
  for (int i = tid; i < MW; i += nt) {
    uint32_t v;
    if (kKeyed) {
      v = i == 0 ? 1u : 0u;
    } else {
      const int w = i % NW;
      v = word_of(a.R0 + at0 + (i / NW) * HS + 32 * w, min(32, S - 32 * w));
    }
    Rw[i] = v;
    any |= v != 0u;
  }
  // the seed itself may be empty: then the first return is dead
  int dead = __syncthreads_or(any) || !a.dead || r0 >= r1 ? -1 : r0;
  float* ck = kLock ? a.ckpt + at0 : nullptr;  // as in walk_warp
  int ck_left = 0;

  int cur = 0;
  for (int r = r0; r < r1 && dead < 0; ++r) {
    const int k = (r - r0) % kChunk;
    if (k == 0) {
      __syncthreads();
      stage(a, h, r, r1, js_s, ops_s);
      __syncthreads();
    }
    if constexpr (kLock) {
      if (ck_left-- == 0) {
        const uint32_t* now = Rw + cur * M;
        for (int i = tid; i < M * S; i += nt)
          ck[(i / S) * HS + i % S] = (float)((now[i / S] >> (i % S)) & 1u);
        ck += (size_t)gridDim.y * M * HS;
        ck_left = a.B - 1;
      }
    }
    constexpr int kSlots = KT > 0 ? kMaxW : kWideMaxW;
    int op[kSlots];
    const int c = slot_row<kSlots, kLock>(ops_s, k, W, a.O1, op);
    const int js = js_s[k];
    const int passes = c < a.n_pass ? c : a.n_pass;
    for (int p = 0; p < passes; ++p) {
      const uint32_t* src = Rw + cur * MW;
      uint32_t* dst = Rw + (cur ^ 1) * MW;
      int grew = 0;
      for (int i = tid; i < MW; i += nt) {
        uint32_t v;
        if constexpr (KT > 0)
          v = fire_tab<KT, kLock>(src, T, op, W, i);
        else
          v = fire_word(src, g, T, op, W, i / NW, i % NW);
        grew |= v != src[i];
        dst[i] = v;
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
        const uint32_t v = (m & bit) ? 0u : src[(m | bit) * NW + i % NW];
        dst[i] = v;
        some |= v != 0u;
      }
      cur ^= 1;
      if (!__syncthreads_or(some) && a.dead) dead = r;
    }
  }

  if (kKeyed) {
    if (tid == 0) a.dead[blockIdx.x] = dead;
    return;
  }
  if (a.dead && tid == 0) a.dead[0] = dead < g.rlim ? dead : -1;
  const uint32_t* fin = Rw + cur * MW;
  for (int i = tid; i < M * S; i += nt) {
    const int mm = i / S, t = i % S;
    a.final_out[at0 + mm * HS + t] =
        (float)((fin[mm * NW + t / 32] >> (t % 32)) & 1u);
  }
}

// Shared memory one block of a walk on the tables needs, in bytes: the
// tables when they fit, R [2][M][NW] in the block form, and a chunk of
// the stream. reach_lane.smem_bytes (K1, K2, K3) and
// reach_pallas.smem_bytes (K4, K5) mirror it for routing on hosts with
// no card; chip_smoke.py checks that they agree.
inline size_t walk_smem_base(int W, int S, bool warp) {
  const size_t set = warp ? 0 : 2 * ((size_t)1 << W) * n_words(S);
  return 4 * (set + (size_t)kChunk * (W + 1));
}
inline bool t_shared(int W, int S, int O1, bool warp) {
  return walk_smem_base(W, S, warp) + table_bytes(S, O1) <= kSmemMax;
}
inline size_t walk_smem(int W, int S, int O1, bool warp) {
  return walk_smem_base(W, S, warp) +
         (t_shared(W, S, O1, warp) ? table_bytes(S, O1) : 0);
}

using TableKernel = void (*)(TableWalk);

// The instance of a geometry at one word an entry, by its lookup count:
// the warp form, else (kNarrow) the block form at that count.
template <int KT, bool kShared, bool kKeyed, bool kLock, bool kNarrow>
TableKernel word_kernel(bool warp) {
  if constexpr (kNarrow) {
    if (!warp) return walk_block<KT, kShared, kKeyed, kLock>;
  }
  return walk_warp<1, KT, kShared, kKeyed, kLock>;
}

// The instance of this geometry's form, table shape and table place.
// The narrow walks (kNarrow: K1, K2, K3, at most 32 states) take both
// forms at their lookup count; K4 and K5 take the block form at any
// number of words.
template <bool kShared, bool kKeyed, bool kLock, bool kNarrow>
TableKernel table_kernel(int S, bool warp) {
  if constexpr (!kNarrow) {
    if (!warp) return walk_block<0, kShared, kKeyed, false>;
    switch (table_words(S)) {
      case 1: break;
      case 2: return walk_warp<2, 16, kShared, kKeyed, false>;
      case 4: return walk_warp<4, 32, kShared, kKeyed, false>;
      default: return walk_warp<8, 64, kShared, kKeyed, false>;
    }
  }
  switch (n_nibbles(S)) {
    case 1: return word_kernel<1, kShared, kKeyed, kLock, kNarrow>(warp);
    case 2: return word_kernel<2, kShared, kKeyed, kLock, kNarrow>(warp);
    case 4: return word_kernel<4, kShared, kKeyed, kLock, kNarrow>(warp);
    default: return word_kernel<8, kShared, kKeyed, kLock, kNarrow>(warp);
  }
}

// Build P's tables into T by one pack_tables launch, then launch `grid`
// walks on `stream` in the given form, each block copying the tables
// into its shared memory when they fit there. Returns the CUDA error of
// the launches (0 when both were accepted). kNarrow as in table_kernel.
template <bool kKeyed, bool kLock, bool kNarrow = kLock>
int launch_tabled(TableWalk g, uint32_t* T, dim3 grid, bool warp,
                  void* stream) {
  const Walk& a = g.a;
  if (T == nullptr) return (int)cudaErrorInvalidValue;
  g.T = T;
  g.NW = n_words(a.S);
  g.K = n_nibbles(a.S);
  g.NT = table_words(a.S);
  const size_t smem = walk_smem(a.W, a.S, a.O1, warp);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int err_t = launch_tables(a.P, T, a.O1, a.S, stream);
  if (err_t != 0) return err_t;
  const TableKernel kernel =
      t_shared(a.W, a.S, a.O1, warp)
          ? table_kernel<true, kKeyed, kLock, kNarrow>(a.S, warp)
          : table_kernel<false, kKeyed, kLock, kNarrow>(a.S, warp);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = 32;
  if (!warp) {
    threads = ((1 << a.W) * g.NW + 31) / 32 * 32;
    if (threads > 1024) threads = 1024;
  }
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// Shared memory of a narrow walk (K1, K2, K3) in the form that
// warp_form(W, use_warp) picks.
inline size_t lane_smem(int W, int S, int O1, int use_warp) {
  return walk_smem(W, S, O1, warp_form(W, use_warp));
}

// K1 and K2: the lockstep walk of `grid` = (H, E) blocks (K1: one), in
// the warp form when warp_form(W, use_warp). dead: K1's (its walk stops
// at its first empty return), or null (K2).
inline int launch_walk(const Walk& a, uint32_t* T, dim3 grid, int use_warp,
                       void* stream) {
  if (a.W < 1 || a.W > kMaxW || a.S < 1 || a.S > 32 || a.O1 < 1 ||
      a.H < 1 || a.n_pass < 0 || grid.x < 1 || grid.y < 1 ||
      grid.y > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_tabled<false, true>(TableWalk{a, nullptr, 0, 0, 0, a.R_pad},
                                    T, grid, warp_form(a.W, use_warp),
                                    stream);
}

}  // namespace
