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
// c_r passes of a few dependent loads plus a barrier. With more than 32
// states a mask's set is NW = ceil(S / 32) words, so the design is
// walk.cuh's block kernel on (mask, word) pairs:
//   - one thread block per walk; R double-buffered [2][M][NW] words in
//     shared memory; each thread owns (mask, word) pairs and fires every
//     pending slot into its word from the pass-start set, so a pass
//     needs one __syncthreads;
//   - P as target-set words [O1][S][NW] (word w of P[o][s]: the targets
//     32w .. 32w+31 of state s under op o), packed once per launch by a
//     grid-wide kernel (pack_words, one warp's ballot a word). The word
//     w of a partner set's image is the OR of P[o][s][w] over its set
//     states s. The words go to shared memory when they fit with the
//     set; else they stay in device memory and are read through L1 and
//     the 50 MB L2 (the cas alphabet of 734 ops is 376 KB of words), a
//     longer chain of loads a pass;
//   - the projection is fused into the last pass, whose barrier is the
//     __syncthreads_or that tests emptiness;
//   - the return stream is staged into shared memory a chunk at a time
//     (walk.cuh's stage).
// Walks that are independent run as separate blocks: the keys of K5.

#pragma once

#include "walk.cuh"

namespace {

constexpr int kWideMaxW = 20;
constexpr size_t kSmemMax = 227 * 1024;  // one block's shared memory

// One launch's operands: walk.cuh's (P, the stream, R0 and final_out
// for K4, the key runs and dead for K5; H = 1) and the words of P.
struct Wide {
  Walk a;
  const uint32_t* Pw;  // [O1][S][NW], filled by pack_words
  int NW;
  int rlim;            // K4: a death at r >= rlim is not reported
  int p_shared;        // copy Pw into shared memory
};

inline int n_words(int S) { return (S + 31) / 32; }

// Shared memory one block needs, in bytes: R [2][M][NW], a chunk of the
// stream, and P's words when all of it fits. reach_pallas.smem_bytes
// mirrors it for routing on hosts with no card; chip_smoke.py checks
// that the two agree.
inline size_t wide_smem_base(int W, int S) {
  return 4 * (2 * ((size_t)1 << W) * n_words(S) + (size_t)kChunk * (W + 1));
}
inline bool wide_p_shared(int W, int S, int O1) {
  return wide_smem_base(W, S) + 4 * (size_t)O1 * S * n_words(S) <= kSmemMax;
}
inline size_t wide_smem(int W, int S, int O1) {
  return wide_smem_base(W, S) +
         (wide_p_shared(W, S, O1) ? 4 * (size_t)O1 * S * n_words(S) : 0);
}

// Pw[row][w] = bits of the 0/1 floats P[row][32w .. 32w+31]: one warp a
// word, each lane reading one float (coalesced), one ballot.
__global__ void pack_words(const float* __restrict__ P,
                           uint32_t* __restrict__ Pw, int n_rows, int S,
                           int NW) {
  const size_t word = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (word >= (size_t)n_rows * NW) return;  // whole warps leave together
  const size_t row = word / NW;
  const int t = (int)(word % NW) * 32 + lane;
  const bool bit = t < S && P[row * S + t] > 0.5f;
  const uint32_t w = __ballot_sync(kFull, bit);
  if (lane == 0) Pw[word] = w;
}

// Word w of the image of the partner set x (NW words) under op o.
__device__ __forceinline__ uint32_t image_word(const uint32_t* Pw, int o,
                                               int S, int NW,
                                               const uint32_t* x, int w) {
  const uint32_t* col = Pw + (size_t)o * S * NW + w;
  uint32_t acc = 0;
  for (int v = 0; v < NW; ++v) {
    uint32_t b = x[v];
    while (b) {
      acc |= col[(size_t)(32 * v + __ffs(b) - 1) * NW];
      b &= b - 1;
    }
  }
  return acc;
}

// Word w of mask m's set after one fire pass from `src` [M][NW].
__device__ __forceinline__ uint32_t fire_word(const uint32_t* src,
                                              const uint32_t* Pw,
                                              const int (&ops)[kWideMaxW],
                                              int W, int S, int NW, int m,
                                              int w) {
  uint32_t acc = src[m * NW + w];
#pragma unroll
  for (int j = 0; j < kWideMaxW; ++j) {
    if (j >= W) break;
    const int o = ops[j];
    if (o >= 0 && ((m >> j) & 1))
      acc |= image_word(Pw, o, S, NW, src + (m ^ (1 << j)) * NW, w);
  }
  return acc;
}

// K4 (kKeyed false): block 0 walks returns [0, R_pad) from R0, writes
// the final set to final_out and to dead[0] the first r < rlim after
// which the set is empty, or -1. K5 (kKeyed true): block k walks key
// k's run [lo[k], hi[k]) from the one-hot seed (mask 0, state 0) and
// writes the flat index of its first empty return, or -1, to dead[k].
template <bool kKeyed>
__global__ void wide_walk(Wide g) {
  extern __shared__ uint32_t smem[];
  const Walk& a = g.a;
  const int W = a.W, S = a.S, NW = g.NW, M = 1 << W, MW = M * NW;
  const int tid = threadIdx.x, nt = blockDim.x;
  uint32_t* Rw = smem;                              // [2][M][NW]
  int* js_s = (int*)(Rw + 2 * MW);                  // [kChunk]
  int* ops_s = js_s + kChunk;                       // [kChunk][W]
  const uint32_t* Pw = g.Pw;
  if (g.p_shared) {
    uint32_t* Ps = (uint32_t*)(ops_s + kChunk * W);  // [O1][S][NW]
    for (int i = tid; i < a.O1 * S * NW; i += nt) Ps[i] = g.Pw[i];
    Pw = Ps;
  }
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
    const int bit = js >= 0 ? 1 << js : 0;
    const int passes = bit ? max(c, 1) : c;  // >= 1 pass to project in
    int alive = 1;
    for (int p = 0; p < passes; ++p) {
      const uint32_t* src = Rw + cur * MW;
      uint32_t* dst = Rw + (cur ^ 1) * MW;
      if (p == passes - 1 && bit) {
        int some = 0;
        for (int i = tid; i < MW; i += nt) {
          const int m = i / NW;
          uint32_t v = 0u;
          if (!(m & bit))
            v = p < c ? fire_word(src, Pw, ops, W, S, NW, m | bit, i % NW)
                      : src[(m | bit) * NW + i % NW];
          dst[i] = v;
          some |= v != 0u;
        }
        alive = __syncthreads_or(some);
      } else {
        for (int i = tid; i < MW; i += nt)
          dst[i] = fire_word(src, Pw, ops, W, S, NW, i / NW, i % NW);
        __syncthreads();
      }
      cur ^= 1;
    }
    if (!alive) dead = r;
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

// Pack P's words, then launch `blocks` walks on `stream`. Returns the
// CUDA error of the launches (0 when both were accepted).
template <bool kKeyed>
int launch_wide(Wide g, uint32_t* Pw, int blocks, void* stream) {
  const Walk& a = g.a;
  if (a.W < 1 || a.W > kWideMaxW || a.S < 1 || a.O1 < 1 || a.H != 1 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  g.NW = n_words(a.S);
  g.Pw = Pw;
  g.p_shared = wide_p_shared(a.W, a.S, a.O1);
  const size_t smem = wide_smem(a.W, a.S, a.O1);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const size_t warps = (size_t)a.O1 * a.S * g.NW;
  const unsigned pack_blocks = (unsigned)((warps * 32 + 255) / 256);
  pack_words<<<pack_blocks, 256, 0, (cudaStream_t)stream>>>(
      a.P, Pw, a.O1 * a.S, a.S, g.NW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wide_walk<kKeyed>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int pairs = (1 << a.W) * g.NW;
  int threads = (pairs + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  wide_walk<kKeyed><<<blocks, threads, smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace
