// The returns walk over the dense config set R[mask, state], shared by
// the three walk kernels: K1 (lane_walk.cu, one history), K2
// (batch_walk.cu, H lanes in lockstep, E seed groups per lane) and K3
// (keyed_walk.cu, many keys' streams concatenated).
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
// What bounds a walk on an H100: neither bytes nor operations but its
// serial chain. Every pass depends on the whole previous set, so each
// return costs c_r passes of a few dependent on-chip loads, plus the
// barrier between passes. The design keeps that chain short:
//   - one thread block per walk, everything on chip. A mask's states
//     are the bits of one 32-bit word (S <= 32), and P is kept as
//     [O1][S] words (bit t of P[o][s]: s steps to t under op o) in
//     shared memory. The image of a partner set x under op o is the OR
//     of P[o][s] over the set bits s of x;
//   - each thread owns whole masks m and fires every pending slot from
//     the pass-start set, so passes need no finer synchronisation;
//   - up to W = 5 (M <= 32) the set lives in the registers of one warp,
//     lane m holding mask m: a partner set is one __shfl_xor_sync and
//     no barrier is needed at all (walk_warp). Above that, R is
//     double-buffered [2][M] words in shared memory with one
//     __syncthreads per pass (walk_block);
//   - the projection is fused into the last pass, saving a barrier;
//   - the return stream is staged into shared memory a chunk of
//     returns at a time by the whole block, so the chain never waits on
//     a device-memory load.
// Walks that are independent run as separate blocks: the lanes and
// seed groups of K2 and the keys of K3.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 16;
constexpr int kChunk = 256;  // returns staged per shared-memory refill
constexpr unsigned kFull = 0xffffffffu;

// One launch's operands. Return r of lane h is ret_slot[r * H + h] and
// slot_ops[(r * H + h) * W + j]. A lockstep launch (K1: H = E = 1; K2)
// runs block (h, e) over lane h's rows e*M .. e*M+M-1 of the
// [E*M, H*S] sets R0, ckpt[R_pad / B] and final_out, where row e*M + m,
// column h*S + t holds state t of mask m. A keyed launch (K3, H = 1)
// runs block k over key k's run [lo[k], hi[k]) of the flat stream from
// the one-hot seed (mask 0, state 0) and writes the index of the first
// return after which its set is empty, or -1, to dead[k].
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

// OR of P[o][s] over the set bits s of x.
__device__ __forceinline__ uint32_t image(const uint32_t* __restrict__ Pw,
                                          int o, int S, uint32_t x) {
  const uint32_t* row = Pw + o * S;
  uint32_t acc = 0;
  while (x) {
    acc |= row[__ffs(x) - 1];
    x &= x - 1;
  }
  return acc;
}

// One 0/1 float row of S states as a state word.
__device__ __forceinline__ uint32_t word_of(const float* __restrict__ row,
                                            int S) {
  uint32_t w = 0;
  for (int t = 0; t < S; ++t) w |= (uint32_t)(row[t] > 0.5f) << t;
  return w;
}

// Convert P (f32 0/1 [O1][S][S]) to target-set words in shared memory.
__device__ __forceinline__ void load_P(const float* __restrict__ P,
                                       uint32_t* __restrict__ Pw, int O1,
                                       int S) {
  for (int i = threadIdx.x; i < O1 * S; i += blockDim.x)
    Pw[i] = word_of(P + (size_t)i * S, S);
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

// W <= 5: one warp, lane m holds mask m's state word in a register.
// Lanes m >= M start empty and stay empty: their partners are lanes
// >= M too.
template <bool kKeyed>
__global__ void walk_warp(Walk a) {
  extern __shared__ uint32_t smem[];
  const int W = a.W, S = a.S, M = 1 << W;
  int* js_s = (int*)smem;                          // [kChunk]
  int* ops_s = js_s + kChunk;                      // [kChunk][W]
  uint32_t* Pw = (uint32_t*)(ops_s + kChunk * W);  // [O1][S]
  int h, r0, r1;
  bounds<kKeyed>(a, h, r0, r1);
  const int m = threadIdx.x;
  const size_t HS = (size_t)a.H * S;
  const size_t at = ((size_t)blockIdx.y * M + m) * HS + (size_t)h * S;
  load_P(a.P, Pw, a.O1, S);
  uint32_t v;
  if (kKeyed)
    v = m == 0 ? 1u : 0u;
  else
    v = m < M ? word_of(a.R0 + at, S) : 0u;

  for (int r = r0; r < r1; ++r) {
    const int k = (r - r0) % kChunk;
    if (k == 0) {
      __syncwarp();
      stage(a, h, r, r1, js_s, ops_s);
      __syncwarp();
    }
    if (!kKeyed && r % a.B == 0 && m < M) {
      float* ck = a.ckpt + (size_t)(r / a.B) * gridDim.y * M * HS + at;
      for (int t = 0; t < S; ++t) ck[t] = (float)((v >> t) & 1u);
    }
    int ops[5];
    int c = 0;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      ops[j] = j < W ? ops_s[k * W + j] : -1;
      c += ops[j] >= 0;
    }
    const int js = js_s[k];
    const int passes = c < a.n_pass ? c : a.n_pass;
    for (int p = 0; p < passes; ++p) {
      uint32_t acc = v;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        if (j >= W) break;
        const uint32_t x = __shfl_xor_sync(kFull, v, 1 << j);
        if (ops[j] >= 0 && ((m >> j) & 1)) acc |= image(Pw, ops[j], S, x);
      }
      v = acc;
    }
    if (js >= 0) {
      const uint32_t hi = __shfl_xor_sync(kFull, v, 1 << js);
      v = ((m >> js) & 1) ? 0u : hi;
    }
    if (kKeyed && !__any_sync(kFull, v != 0u)) {
      if (m == 0) a.dead[blockIdx.x] = r;
      return;
    }
  }
  if (kKeyed) {
    if (m == 0) a.dead[blockIdx.x] = -1;
  } else if (m < M) {
    for (int t = 0; t < S; ++t)
      a.final_out[at + t] = (float)((v >> t) & 1u);
  }
}

// The set of mask m after one fire pass from `src`.
__device__ __forceinline__ uint32_t fire(const uint32_t* __restrict__ src,
                                         const uint32_t* __restrict__ Pw,
                                         const int (&ops)[kMaxW], int W,
                                         int S, int m) {
  uint32_t acc = src[m];
#pragma unroll
  for (int j = 0; j < kMaxW; ++j) {
    if (j >= W) break;
    const int o = ops[j];
    if (o >= 0 && ((m >> j) & 1)) acc |= image(Pw, o, S, src[m ^ (1 << j)]);
  }
  return acc;
}

// Any W: R double-buffered [2][M] words in shared memory, one
// __syncthreads per pass.
template <bool kKeyed>
__global__ void walk_block(Walk a) {
  extern __shared__ uint32_t smem[];
  const int W = a.W, S = a.S, M = 1 << W;
  uint32_t* Rw = smem;                             // [2][M]
  int* js_s = (int*)(Rw + 2 * M);                  // [kChunk]
  int* ops_s = js_s + kChunk;                      // [kChunk][W]
  uint32_t* Pw = (uint32_t*)(ops_s + kChunk * W);  // [O1][S]
  const int tid = threadIdx.x, nt = blockDim.x;
  int h, r0, r1;
  bounds<kKeyed>(a, h, r0, r1);
  const size_t HS = (size_t)a.H * S;
  // element (mask mm, state t) of this block's rows: at(mm) + t
  const size_t at0 = (size_t)blockIdx.y * M * HS + (size_t)h * S;
  load_P(a.P, Pw, a.O1, S);
  for (int m = tid; m < M; m += nt)
    Rw[m] = kKeyed ? (m == 0 ? 1u : 0u)
                   : word_of(a.R0 + at0 + (size_t)m * HS, S);

  int cur = 0;
  for (int r = r0; r < r1; ++r) {
    const int k = (r - r0) % kChunk;
    if (k == 0) {
      __syncthreads();
      stage(a, h, r, r1, js_s, ops_s);
      __syncthreads();
    }
    if (!kKeyed && r % a.B == 0) {
      const uint32_t* old = Rw + cur * M;
      float* ck = a.ckpt + (size_t)(r / a.B) * gridDim.y * M * HS + at0;
      for (int i = tid; i < M * S; i += nt)
        ck[(size_t)(i / S) * HS + i % S] =
            (float)((old[i / S] >> (i % S)) & 1u);
    }
    int ops[kMaxW];
    int c = 0;
#pragma unroll
    for (int j = 0; j < kMaxW; ++j) {
      ops[j] = j < W ? ops_s[k * W + j] : -1;
      c += ops[j] >= 0;
    }
    const int passes = c < a.n_pass ? c : a.n_pass;
    const int js = js_s[k];
    const int bit = js >= 0 ? 1 << js : 0;

    for (int p = 0; p < passes; ++p) {
      const uint32_t* src = Rw + cur * M;
      uint32_t* dst = Rw + (cur ^ 1) * M;
      if (p == passes - 1 && bit) {
        for (int m = tid; m < M; m += nt)
          dst[m] = (m & bit) ? 0u : fire(src, Pw, ops, W, S, m | bit);
      } else {
        for (int m = tid; m < M; m += nt)
          dst[m] = fire(src, Pw, ops, W, S, m);
      }
      __syncthreads();
      cur ^= 1;
    }
    if (passes == 0 && bit) {
      const uint32_t* src = Rw + cur * M;
      uint32_t* dst = Rw + (cur ^ 1) * M;
      for (int m = tid; m < M; m += nt)
        dst[m] = (m & bit) ? 0u : src[m | bit];
      __syncthreads();
      cur ^= 1;
    }
    if (kKeyed) {
      const uint32_t* now = Rw + cur * M;
      int any = 0;
      for (int m = tid; m < M; m += nt) any |= now[m] != 0u;
      if (!__syncthreads_or(any)) {
        if (tid == 0) a.dead[blockIdx.x] = r;
        return;
      }
    }
  }
  if (kKeyed) {
    if (tid == 0) a.dead[blockIdx.x] = -1;
    return;
  }
  const uint32_t* fin = Rw + cur * M;
  for (int i = tid; i < M * S; i += nt)
    a.final_out[at0 + (size_t)(i / S) * HS + i % S] =
        (float)((fin[i / S] >> (i % S)) & 1u);
}

// Whether a walk runs on walk_warp (else walk_block).
inline bool warp_kernel(int W, int use_warp) { return use_warp && W <= 5; }

// Shared memory one block needs, in bytes: the layout of the kernels
// above. reach_lane.smem_bytes mirrors it for routing on hosts with no
// card; chip_smoke.py checks that the two agree.
inline size_t walk_smem(int W, int S, int O1, int use_warp) {
  const size_t R = warp_kernel(W, use_warp) ? 0 : 2 * ((size_t)1 << W);
  return 4 * (R + (size_t)kChunk * (W + 1) + (size_t)O1 * S);
}

// Launch `grid` blocks of one walk kernel on `stream`. Returns the CUDA
// error of the launch (0 when it was accepted).
template <bool kKeyed>
int launch_walk(const Walk& a, dim3 grid, int use_warp, void* stream) {
  if (a.W < 1 || a.W > kMaxW || a.S < 1 || a.S > 32 || a.O1 < 1 ||
      a.H < 1 || a.n_pass < 0 || grid.x < 1 || grid.y < 1 ||
      grid.y > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem(a.W, a.S, a.O1, use_warp);
  auto kernel = warp_kernel(a.W, use_warp) ? walk_warp<kKeyed>
                                           : walk_block<kKeyed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((1 << a.W) + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
