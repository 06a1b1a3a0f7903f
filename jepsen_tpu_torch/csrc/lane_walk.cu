// Single-history returns walk over the dense config set R[mask, state].
//
// Replaces the Pallas lane kernel of the reference package
// (jepsen_tpu/checkers/reach_lane.py, _make_kernel / _lane_call, with
// its helpers _ladder_fire, _project, reach_pallas._gather_G and
// _one_fire_pass).
//
// What it computes, for each return r of the padded stream:
//   c_r    = #{j : slot_ops[r, j] >= 0}                (pending ops)
//   passes = min(c_r, n_pass) Jacobi fire passes; each pass, from the
//            pass-start set `old`,
//            new[m][t] = old[m][t] | OR_{j: bit j of m, op_j >= 0}
//                        OR_s old[m ^ (1 << j)][s] & P[op_j][s][t]
//   then the projection on slot j = ret_slot[r] (-1: identity):
//            R[m][t] = (m & 1 << j) ? 0 : R[m | 1 << j][t].
// The reference runs max(1, min(c_r, n_pass)) passes; with c_r = 0
// every op is -1 and a pass is the identity, so skipping it is exact.
// At the start of every block of B returns the set is written to
// ckpt[block]; after the last return it is written to final. All
// values are 0/1, so the result is bit-identical to the plain version.
//
// What bounds it on an H100: neither bytes (the inputs are a few MB)
// nor operations (in the word form below a pass is one 32-bit OR per
// set state of each partner set, at most M*W*S/2, a few hundred at
// S=8, W=5). The limit is the serial chain: every pass
// depends on the whole previous set, so each return costs c_r passes
// (about 3 on cas histories) of a few dependent on-chip loads, plus the
// barrier between passes. The design keeps that chain short:
//   - one thread block per walk, everything on chip. A mask's states
//     are the bits of one 32-bit word (S <= 32), and P is kept as
//     [O1][S] words (bit t of P[o][s]: s steps to t under op o) in
//     shared memory. The image of a partner set x under op o is the OR
//     of P[o][s] over the set bits s of x: a handful of loads, where a
//     byte-per-config layout needed W*S loads per config and diverged
//     within warps;
//   - each thread owns whole masks m and fires every pending slot from
//     the pass-start set, so passes need no finer synchronisation;
//   - up to W = 5 (M <= 32, the common case) the set lives in the
//     registers of one warp, lane m holding mask m: a partner set is
//     one __shfl_xor_sync and no barrier is needed at all. Above that,
//     R is double-buffered [2][M] words in shared memory with one
//     __syncthreads per pass (chip_smoke.py times both kernels at the
//     W = 5 headline shape, which is why the warp kernel exists);
//   - the projection is fused into the last pass, saving a barrier;
//   - the return stream is staged into shared memory a chunk of
//     returns at a time by the whole block, so the chain never waits on
//     a device-memory load.
// One block uses one of the card's 132 SMs; the walk cannot be split
// across blocks without changing the algorithm.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 16;
constexpr int kChunk = 256;  // returns staged per shared-memory refill
constexpr unsigned kFull = 0xffffffffu;

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

// Stage returns [r0, r0 + kChunk) of the stream into shared memory.
__device__ __forceinline__ void stage(const int* __restrict__ ret_slot,
                                      const int* __restrict__ slot_ops,
                                      int* __restrict__ js_s,
                                      int* __restrict__ ops_s, int r0,
                                      int R_pad, int W) {
  const int n = min(kChunk, R_pad - r0);
  for (int i = threadIdx.x; i < n * W; i += blockDim.x)
    ops_s[i] = slot_ops[(size_t)r0 * W + i];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    js_s[i] = ret_slot[r0 + i];
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

// W <= 5: one warp, lane m holds mask m's state word in a register.
__global__ void lane_walk_warp(const float* __restrict__ P,
                               const int* __restrict__ ret_slot,
                               const int* __restrict__ slot_ops,
                               const float* __restrict__ R0,
                               float* __restrict__ ckpt,
                               float* __restrict__ final_out, int R_pad,
                               int W, int S, int O1, int B, int n_pass) {
  extern __shared__ uint32_t smem[];
  int* js_s = (int*)smem;                          // [kChunk]
  int* ops_s = js_s + kChunk;                      // [kChunk][W]
  uint32_t* Pw = (uint32_t*)(ops_s + kChunk * W);  // [O1][S]
  const int M = 1 << W;
  const int m = threadIdx.x;               // lanes >= M carry junk
  load_P(P, Pw, O1, S);
  uint32_t v = m < M ? word_of(R0 + (size_t)m * S, S) : 0u;

  for (int r = 0; r < R_pad; ++r) {
    const int k = r % kChunk;
    if (k == 0) {
      __syncwarp();
      stage(ret_slot, slot_ops, js_s, ops_s, r, R_pad, W);
      __syncwarp();
    }
    if (r % B == 0 && m < M) {
      float* ck = ckpt + ((size_t)(r / B) * M + m) * S;
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
    const int passes = c < n_pass ? c : n_pass;
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
  }
  if (m < M)
    for (int t = 0; t < S; ++t)
      final_out[(size_t)m * S + t] = (float)((v >> t) & 1u);
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

// Any W (used above W = 5): R double-buffered [2][M] words in shared
// memory, one __syncthreads per pass.
__global__ void lane_walk_block(const float* __restrict__ P,
                                const int* __restrict__ ret_slot,
                                const int* __restrict__ slot_ops,
                                const float* __restrict__ R0,
                                float* __restrict__ ckpt,
                                float* __restrict__ final_out, int R_pad,
                                int W, int S, int O1, int B, int n_pass) {
  extern __shared__ uint32_t smem[];
  const int M = 1 << W;
  uint32_t* Rw = smem;                             // [2][M]
  int* js_s = (int*)(Rw + 2 * M);                  // [kChunk]
  int* ops_s = js_s + kChunk;                      // [kChunk][W]
  uint32_t* Pw = (uint32_t*)(ops_s + kChunk * W);  // [O1][S]
  const int tid = threadIdx.x, nt = blockDim.x;
  load_P(P, Pw, O1, S);
  for (int m = tid; m < M; m += nt) Rw[m] = word_of(R0 + (size_t)m * S, S);

  int cur = 0;
  for (int r = 0; r < R_pad; ++r) {
    const int k = r % kChunk;
    if (k == 0) {
      __syncthreads();
      stage(ret_slot, slot_ops, js_s, ops_s, r, R_pad, W);
      __syncthreads();
    }
    if (r % B == 0) {
      const uint32_t* old = Rw + cur * M;
      float* ck = ckpt + (size_t)(r / B) * M * S;
      for (int i = tid; i < M * S; i += nt)
        ck[i] = (float)((old[i / S] >> (i % S)) & 1u);
    }
    int ops[kMaxW];
    int c = 0;
#pragma unroll
    for (int j = 0; j < kMaxW; ++j) {
      ops[j] = j < W ? ops_s[k * W + j] : -1;
      c += ops[j] >= 0;
    }
    const int passes = c < n_pass ? c : n_pass;
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
  }
  const uint32_t* fin = Rw + cur * M;
  for (int i = tid; i < M * S; i += nt)
    final_out[i] = (float)((fin[i / S] >> (i % S)) & 1u);
}

}  // namespace

extern "C" {

// Whether the walk runs on lane_walk_warp (else lane_walk_block).
static bool warp_kernel(int W, int use_warp) { return use_warp && W <= 5; }

// Shared memory the walk needs for this geometry, in bytes: the layout
// of the two kernels above. reach_lane.smem_bytes mirrors it for routing
// on hosts with no card; chip_smoke.py checks that the two agree.
size_t jt_lane_walk_smem(int W, int S, int O1, int use_warp) {
  const size_t R = warp_kernel(W, use_warp) ? 0 : 2 * ((size_t)1 << W);
  return 4 * (R + (size_t)kChunk * (W + 1) + (size_t)O1 * S);
}

// Launch one walk on `stream`. Pointers are device pointers to
// contiguous float32 (P [O1,S,S], R0 [M,S], ckpt [R_pad/B,M,S],
// final [M,S]) and int32 (ret_slot [R_pad], slot_ops [R_pad,W]) data,
// with M = 2^W, 1 <= W <= 16, 1 <= S <= 32 and R_pad a multiple of B.
// use_warp = 0 runs lane_walk_block at every W (to time the two).
// Returns the CUDA error of the launch (0 when it was accepted).
int jt_lane_walk(const void* P, const void* ret_slot, const void* slot_ops,
                 const void* R0, void* ckpt, void* final_out, int R_pad,
                 int W, int S, int O1, int B, int n_pass, int use_warp,
                 void* stream) {
  if (W < 1 || W > kMaxW || S < 1 || S > 32 || B < 1 || R_pad < 1 ||
      R_pad % B != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = jt_lane_walk_smem(W, S, O1, use_warp);
  auto kernel = warp_kernel(W, use_warp) ? lane_walk_warp : lane_walk_block;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((1 << W) + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const float*)P, (const int*)ret_slot, (const int*)slot_ops,
      (const float*)R0, (float*)ckpt, (float*)final_out, R_pad, W, S, O1, B,
      n_pass);
  return (int)cudaGetLastError();
}

}  // extern "C"
