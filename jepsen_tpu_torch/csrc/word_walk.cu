// K11: the word-packed post-hoc returns walk, a block a lane.
//
// Replaces the reference package's word walk
// (jepsen_tpu/checkers/reach_word.py:162 _walk_words, jitted at :231 and
// vmapped over lockstep lanes at :241), an XLA program (a lax.scan)
// rather than a Pallas kernel. Its plain version is
// checkers/reach_word.py walk_words_plain.
//
// What it computes: for each lane h of H, which share one transition
// table T i32 [S, O1p] (its last column the -1 sentinel), the walk of the
// lane's n[h] steps from its set R0[h]: a set is S rows of NW 32-bit
// words (NW = max(1, 2^W / 32)), bit m & 31 of word m >> 5 of row s the
// configuration (state s, mask m). A step fires its pending slots in
// passes, then projects on its returning slot:
//   - firing slot j < 5 moves the bit-j-clear half of each word up by
//     2^j bits, (R[s][w] & ~cmask(j)) << 2^j, which stays in its word;
//     slot j >= 5 moves whole words: word w with bit j - 5 set receives
//     R[s][w ^ 1 << (j - 5)], the others nothing;
//   - each shifted word is OR-ed into row T[s, op_j] of the set; a target
//     of -1 (an inconsistent op, or slot op -1 reading the sentinel)
//     discards it;
//   - the projection on slot j keeps the bit-j-set half and clears the
//     bit: (R & cmask(j)) >> 2^j for j < 5; for j >= 5 word w with bit
//     j - 5 clear takes word w | 1 << (j - 5) and the others become 0;
//     slot -1 is the identity.
// It writes the lane's final set and the first step after which the set
// is empty (dead), or -1. A lane that names a slot past W or an op past
// the table walks nothing: dead -2, its set left as it was.
//
// The passes and their exit. The reference runs W Jacobi passes a step,
// each R | fired(R). This kernel ORs each shifted word into the set in
// place (atomicOr in shared memory), so a pass may already read words
// that the same pass added: the set stays between the Jacobi pass's and
// the closure, and grows monotonically. The closure is the fixpoint of
// walk.cuh's argument ("The fixpoint exit"): every configuration of it
// is reached by a chain of firings of distinct pending slots, at most c
// long (c the step's pending slots), and pass p reaches every chain of
// length p. So c passes reach it, and a pass that adds nothing has
// reached it: the kernel runs at most c passes and stops after the first
// that adds nothing (__syncthreads_or over the threads' "grew" bits).
// The final set and the dead step are the reference's exactly.
//
// An empty set stays empty (firing adds images of members, projection
// moves or drops them), so emptiness is tested after each step that
// projects, and once at the seed; the lane stops at its first empty set
// and writes it.
//
// What bounds it on an H100: the serial chain of one lane's steps, each a
// few dependent rounds of shared-memory loads and atomics with a block
// barrier between them; the bytes (the stream, once) and the operations
// (S * W * NW words a pass) are far below it. The design, for Hopper, is
// the simple one:
//   - one thread block a lane; the set, a projection buffer, the step's
//     targets [S][W] and a chunk of the stream (min(R, 256) returns and
//     their W ops) in shared memory (at most ~45 KB in the word walk's
//     envelope, reach_word.admits); threads stride over (s, j, w) in the
//     passes and over (s, w) in the projection;
//   - the table stays in device memory, read through the read-only path
//     (a step reads S * W entries of it);
//   - the lane's stream is checked once, before the walk, for slots and
//     ops past the table, so the walk itself reads without bounds tests;
//   - ragged lanes end at their own count n[h]: no padding of lanes or
//     steps, nothing compiled per shape.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;      // returns staged at a time
constexpr int kMaxThreads = 512;
constexpr int kBadLane = -2;

struct WordWalk {
  const int* T;         // [S, O1p]
  const uint32_t* R0;   // [H, S, NW]
  const int* ret;       // [H, R]
  const int* ops;       // [H, R, W]
  const int* n;         // [H]
  uint32_t* out;        // [H, S, NW]
  int* dead;            // [H]
  int* stats;           // [H, 2] or null: passes run, steps walked
  int R, S, O1p, W, NW, chunk;
};

// bit m of cmask(j) is set iff bit j of m is (m < 32)
__device__ __forceinline__ uint32_t cmask(int j) {
  switch (j) {
    case 0: return 0xAAAAAAAAu;
    case 1: return 0xCCCCCCCCu;
    case 2: return 0xF0F0F0F0u;
    case 3: return 0xFF00FF00u;
    default: return 0xFFFF0000u;
  }
}

__global__ void word_walk(WordWalk a) {
  extern __shared__ uint32_t smem[];
  const int h = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int S = a.S, W = a.W, NW = a.NW;
  const int SN = S * NW, SW = S * W, SWN = SW * NW;
  uint32_t* R = smem;
  uint32_t* X = smem + SN;                 // the projection's target
  int* tgt = (int*)(smem + 2 * SN);        // [S][W]
  int* js = tgt + SW;                      // [chunk]
  int* ops = js + a.chunk;                 // [chunk][W]
  const int n = a.n[h];
  const int* lane_ret = a.ret + (long long)h * a.R;
  const int* lane_ops = a.ops + (long long)h * a.R * W;

  // the lane's stream, checked once: a slot past W or an op past the
  // table leaves the lane unwalked
  int bad = 0;
  for (int i = tid; i < n; i += nt) bad |= lane_ret[i] >= W;
  for (long long i = tid; i < (long long)n * W; i += nt)
    bad |= lane_ops[i] >= a.O1p;
  bad = __syncthreads_or(bad);

  int nz = 0;
  for (int i = tid; i < SN; i += nt) {
    const uint32_t v = a.R0[(long long)h * SN + i];
    R[i] = v;
    nz |= v != 0;
  }
  nz = __syncthreads_or(nz);
  int dead = bad ? kBadLane : (!nz && n > 0 ? 0 : -1);
  int passes = 0, steps = 0;

  for (int base = 0; base < n && dead == -1; base += a.chunk) {
    const int c = min(a.chunk, n - base);
    __syncthreads();                       // the last chunk is read
    for (int i = tid; i < c; i += nt) js[i] = lane_ret[base + i];
    for (int i = tid; i < c * W; i += nt)
      ops[i] = lane_ops[(long long)base * W + i];
    __syncthreads();
    for (int k = 0; k < c; ++k) {
      const int* row = ops + k * W;
      int pend = 0;
      for (int j = 0; j < W; ++j) pend += row[j] >= 0;
      for (int i = tid; i < SW; i += nt) {
        const int s = i / W, o = row[i - s * W];
        tgt[i] = o < 0 ? -1 : __ldg(a.T + (long long)s * a.O1p + o);
      }
      __syncthreads();
      ++steps;
      for (int p = 0; p < pend; ++p) {
        ++passes;
        int grew = 0;
        for (int i = tid; i < SWN; i += nt) {
          const int q = i / NW, w = i - q * NW;
          const int t = tgt[q];
          if (t < 0) continue;
          const int s = q / W, j = q - s * W;
          uint32_t v;
          if (j < 5) {
            v = (R[s * NW + w] & ~cmask(j)) << (1 << j);
          } else {
            const int b = 1 << (j - 5);
            v = (w & b) ? R[s * NW + (w ^ b)] : 0u;
          }
          uint32_t* dst = R + t * NW + w;
          if (v & ~*dst) grew |= (v & ~atomicOr(dst, v)) != 0;
        }
        if (!__syncthreads_or(grew)) break;
      }
      const int j = js[k];
      if (j >= 0) {
        int live = 0;
        for (int i = tid; i < SN; i += nt) {
          uint32_t v;
          if (j < 5) {
            v = (R[i] & cmask(j)) >> (1 << j);
          } else {
            const int b = 1 << (j - 5);
            v = ((i % NW) & b) ? 0u : R[i + b];
          }
          X[i] = v;
          live |= v != 0;
        }
        live = __syncthreads_or(live);
        uint32_t* swap = R;
        R = X;
        X = swap;
        if (!live) {
          dead = base + k;
          break;
        }
      }
    }
  }
  for (int i = tid; i < SN; i += nt) a.out[(long long)h * SN + i] = R[i];
  if (tid == 0) {
    a.dead[h] = dead;
    if (a.stats != nullptr) {
      a.stats[2 * h] = passes;
      a.stats[2 * h + 1] = steps;
    }
  }
}

struct Design {
  int threads;
  size_t smem;
  int chunk;
};

Design design(int S, int W, int NW, int R) {
  Design d;
  d.chunk = R < kChunk ? (R > 0 ? R : 1) : kChunk;
  const int work = S * W * NW;
  d.threads = ((work + 31) / 32) * 32;
  if (d.threads > kMaxThreads) d.threads = kMaxThreads;
  if (d.threads < 32) d.threads = 32;
  d.smem = sizeof(uint32_t) *
           ((size_t)2 * S * NW + (size_t)S * W + d.chunk +
            (size_t)d.chunk * W);
  return d;
}

bool args_ok(int H, int R, int S, int O1p, int W, int NW) {
  return H >= 1 && R >= 0 && S >= 1 && O1p >= 1 && W >= 1 && W <= 10 &&
         NW == ((1 << W) >> 5 > 1 ? (1 << W) >> 5 : 1);
}

// the largest dynamic shared memory the instance may take, set once
int reserve_smem(size_t smem) {
  static size_t reserved = 48 * 1024;
  if (smem <= reserved) return 0;
  const int err = (int)cudaFuncSetAttribute(
      word_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == 0) reserved = smem;
  return err;
}

}  // namespace

extern "C" {

// Launch K11 on `stream` (a cudaStream_t): one block a lane. T i32 [S,
// O1p]; R0 u32 [H, S, NW]; ret i32 [H, R]; ops i32 [H, R, W]; n i32 [H]
// (each lane's steps, at most R); out u32 [H, S, NW]; dead i32 [H];
// stats i32 [H, 2] or null: each lane's fire passes and steps walked.
// With ev0 and ev1 (cudaEvent_t, or null) the events are recorded on the
// stream right before and after the launch. Returns a CUDA error, 0 on
// success.
int jt_word_walk(const void* T, const void* R0, const void* ret,
                 const void* ops, const void* n, void* out, void* dead,
                 void* stats, int H, int R, int S, int O1p, int W, int NW,
                 void* stream, void* ev0, void* ev1) {
  if (!args_ok(H, R, S, O1p, W, NW)) return (int)cudaErrorInvalidValue;
  const Design d = design(S, W, NW, R);
  int err = reserve_smem(d.smem);
  if (err != 0) return err;
  const WordWalk a{(const int*)T,   (const uint32_t*)R0, (const int*)ret,
                   (const int*)ops, (const int*)n,      (uint32_t*)out,
                   (int*)dead,      (int*)stats,        R,
                   S,               O1p,                W,
                   NW,              d.chunk};
  cudaStream_t st = (cudaStream_t)stream;
  if (ev0 != nullptr &&
      (err = (int)cudaEventRecord((cudaEvent_t)ev0, st)) != 0)
    return err;
  word_walk<<<dim3(H), d.threads, d.smem, st>>>(a);
  err = (int)cudaGetLastError();
  if (err == 0 && ev1 != nullptr)
    err = (int)cudaEventRecord((cudaEvent_t)ev1, st);
  return err;
}

// The launch jt_word_walk makes for a lane of this geometry and stream
// length: out[0] threads a block, out[1] dynamic shared memory (bytes),
// out[2] the returns staged at a time. Returns a CUDA error, 0 on
// success.
int jt_word_design(int S, int W, int NW, int R, int* out) {
  if (!args_ok(1, R, S, 1, W, NW)) return (int)cudaErrorInvalidValue;
  const Design d = design(S, W, NW, R);
  out[0] = d.threads;
  out[1] = (int)d.smem;
  out[2] = d.chunk;
  return 0;
}

}  // extern "C"
