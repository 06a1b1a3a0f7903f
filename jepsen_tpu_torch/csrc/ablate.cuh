// The ablation walk: K1's returns walk with the body taken apart along
// the axes the ablation harness (tools/ablate_lane.py, and its port
// jepsen_tpu_torch/tools/ablate_lane.py) measures. Shared by K6
// (ablate_walk.cu, the fire operand gathered from P inside the kernel)
// and K7 (ablate_stream.cu, the fire operand pre-gathered for every
// return and streamed from device memory).
//
// What one walk computes, for each return k of its stream (ops o_j of
// its W slots, slot -1 mapped to the all-zero sentinel row O1 - 1):
//   passes  n_pass unconditional passes, then, for each deep gate g in
//           turn, gate[g] more while c_k > off (c_k the return's pending
//           count, off the passes so far: the "cgate" ladder). Pass p of
//           a return merges its slots forward or in reverse by p (the
//           tuple fires of the harness);
//   a pass  from the pass-start set `old`, for every mask m and state t
//             new[m][t] = old[m][t] (+) F_j[m ^ 1<<j][t]  over the slots
//           j whose bit is set in m, in the pass's slot order, where
//             F_j[m'][t] = sum_s old[m'][s] * P[o_j][s][t]
//           and (+) is the variant's merge: bool (F > 0.5, OR), add
//           (the count variants) or max (maxnc);
//   then    the projection on slot j = ret_slot[k] (-1: identity), by
//           the bit move R[m] = (m & 1<<j) ? 0 : R[m | 1<<j] ("blend")
//           or by a product with the table PJ[j < 0 ? W : j] ("table"),
//           clamped to 1 when `counts`.
// The set is written to ckpt[k / B] at the start of every block of B
// returns, and to final_out after the last return.
//
// The kernel computes what each variant computes; it does not copy the
// Mosaic block structure. One body, templated on what changes the
// arithmetic or the data:
//   - the set's representation: kBool holds a mask's states as the bits
//     of one word (S <= 32) and an image is the OR of P's rows over the
//     partner's set states, as walk.cuh does; kAdd and kMax hold f32
//     values per (mask, state), because the arithmetic is what the count
//     variants ablate. Their values are integers (sums of 0/1 products)
//     far below 2^24, so every order of summation gives the same floats
//     as the plain version's matrix product;
//   - the slot order of the merge (kFwd, kRev, or by pass from a mask);
//   - the projection: the bit move, or a product through PJ held in
//     shared memory (the table variant reads the table; PJ is 0/1 with
//     at most one 1 a row, as the harness builds it);
//   - unroll 1 or 2 (returns per loop iteration).
// n_pass, the gates and the pass order mask are runtime arguments.
//
// What bounds it on an H100: as for K1, the serial chain. Every pass
// depends on the whole previous set; the set is double-buffered in
// shared memory, one __syncthreads per pass and one for the projection,
// one thread block on one SM. No pass is skipped: a variant's
// unconditional passes run even where the return has no pending op,
// since their cost is what the ablation measures.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 16;
constexpr int kChunk = 256;     // returns staged per shared-memory refill
constexpr int kMaxGates = 8;
constexpr int kMaxThreads = 1024;

enum { kBool = 0, kAdd = 1, kMax = 2 };     // representation and merge
enum { kFwd = 0, kRev = 1, kByPass = 2 };   // slot order of a pass

// One launch's operands. K6 reads slot_ops and P; K7 reads G, the fire
// operand of every return pre-gathered as [R_pad][S][W*S] (f32, or
// int8 when g_int8): element (s, j*S + t) is P[o_j][s][t].
struct Ablate {
  const int* ret_slot;     // [R_pad]
  const int* slot_ops;     // [R_pad][W]
  const float* P;          // [O1][S][S], row O1 - 1 the sentinel
  const float* PJ;         // [W + 1][M][M]
  const void* G;           // [R_pad][S][W * S]
  const float* R0;         // [M][S], 0/1
  float* ckpt;             // [R_pad / B][M][S]
  float* final_out;        // [M][S]
  int R_pad, W, S, O1, B, n_pass, counts;
  int rev_mask;            // kByPass: bit p set = pass p in reverse
  int n_gates;
  int gate[kMaxGates];
};

// Bytes of one return's G, and its stage in shared memory (16-aligned).
__host__ __device__ inline size_t g_bytes(int W, int S, int g_int8) {
  return (size_t)S * W * S * (g_int8 ? 1 : 4);
}
__host__ __device__ inline size_t g_stage(int W, int S, int g_int8) {
  return (g_bytes(W, S, g_int8) + 15) / 16 * 16;
}

// Byte offsets of the shared-memory regions. The Python wrappers
// mirror `total` (tools/ablate_lane.py smem_bytes) for their fits
// checks without a card; chip_smoke.py checks that the two agree.
struct Layout {
  size_t graw, set, pj, opnd, js, ops, total;
};

__host__ __device__ inline Layout layout(int W, int S, int O1, int rep,
                                         int table, int stream,
                                         int g_int8) {
  const size_t M = (size_t)1 << W;
  Layout L;
  size_t at = 0;
  L.graw = at;                  // K7: G of two returns, cp.async targets
  if (stream) at += 2 * g_stage(W, S, g_int8);
  L.set = at;                   // the set, double-buffered
  at += 4 * (rep == kBool ? 2 * M : 2 * M * S);
  L.pj = at;                    // the projection table
  if (table) at += 4 * (size_t)(W + 1) * M * M;
  L.opnd = at;                  // the fire operand in the body's form
  if (!stream)                  // K6: P, as words or f32
    at += 4 * (rep == kBool ? (size_t)O1 * S : (size_t)O1 * S * S);
  else if (rep == kBool)        // K7: this return's G as words [W][S]
    at += 4 * (size_t)W * S;
  else if (g_int8)              // K7: this return's G widened to f32
    at += 4 * (size_t)S * W * S;
  L.js = at;                    // a chunk of the return stream
  at += 4 * (size_t)kChunk;
  L.ops = at;
  if (!stream) at += 4 * (size_t)kChunk * W;
  L.total = at;
  return L;
}

// One 0/1 float row of S states as a state word.
__device__ __forceinline__ uint32_t word_of(const float* __restrict__ row,
                                            int S) {
  uint32_t w = 0;
  for (int t = 0; t < S; ++t) w |= (uint32_t)(row[t] > 0.5f) << t;
  return w;
}

// OR of rows[s] over the set bits s of x.
__device__ __forceinline__ uint32_t image(const uint32_t* __restrict__ rows,
                                          uint32_t x) {
  uint32_t acc = 0;
  while (x) {
    acc |= rows[__ffs(x) - 1];
    x &= x - 1;
  }
  return acc;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// K7: start copying return k's G into its stage (k & 1), one commit
// group a return (empty past the stream's end).
__device__ __forceinline__ void stage_G(const Ablate& a, int k,
                                        unsigned char* graw, size_t gb,
                                        size_t gs) {
  if (k < a.R_pad) {
    const unsigned char* src = (const unsigned char*)a.G + (size_t)k * gb;
    unsigned char* dst = graw + (size_t)(k & 1) * gs;
    if (gb % 16 == 0) {
      for (size_t i = threadIdx.x * 16; i < gb; i += blockDim.x * 16)
        cp_async16(dst + i, src + i);
    } else {
      for (size_t i = threadIdx.x * 4; i < gb; i += blockDim.x * 4)
        cp_async4(dst + i, src + i);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kRep, int kOrder, bool kTable, int kUnroll, bool kStream,
          bool kI8>
__global__ void __launch_bounds__(kMaxThreads) ablate_walk(Ablate a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.W, S = a.S, M = 1 << W;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = layout(W, S, a.O1, kRep, kTable, kStream, kI8);
  unsigned char* graw = smem + L.graw;
  uint32_t* Rw = (uint32_t*)(smem + L.set);   // kBool: [2][M]
  float* Rf = (float*)(smem + L.set);         // else: [2][M][S]
  float* PJs = (float*)(smem + L.pj);
  uint32_t* Ow = (uint32_t*)(smem + L.opnd);  // kBool operand words
  float* Of = (float*)(smem + L.opnd);        // f32 operand
  int* js_s = (int*)(smem + L.js);
  int* ops_s = (int*)(smem + L.ops);
  const int nE = kRep == kBool ? M : M * S;   // elements of the set
  const size_t gb = g_bytes(W, S, kI8), gs = g_stage(W, S, kI8);
  const size_t MS = (size_t)M * S;

  if (!kStream) {
    if (kRep == kBool)
      for (int i = tid; i < a.O1 * S; i += nt)
        Ow[i] = word_of(a.P + (size_t)i * S, S);
    else
      for (int i = tid; i < a.O1 * S * S; i += nt) Of[i] = a.P[i];
  }
  if (kTable)
    for (int i = tid; i < (W + 1) * M * M; i += nt)
      PJs[i] = a.PJ[i];
  for (int e = tid; e < nE; e += nt) {
    if (kRep == kBool)
      Rw[e] = word_of(a.R0 + (size_t)e * S, S);
    else
      Rf[e] = a.R0[e];
  }
  if (kStream) stage_G(a, 0, graw, gb, gs);

  int cur = 0;
  for (int k0 = 0; k0 < a.R_pad; k0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u;
      const int kk = k % kChunk;
      if (kk == 0) {
        __syncthreads();
        const int n = min(kChunk, a.R_pad - k);
        for (int i = tid; i < n; i += nt) js_s[i] = a.ret_slot[k + i];
        if (!kStream)
          for (int i = tid; i < n * W; i += nt)
            ops_s[i] = a.slot_ops[(size_t)k * W + i];
        __syncthreads();
      }
      if (k % a.B == 0) {
        float* ck = a.ckpt + (size_t)(k / a.B) * MS;
        for (size_t i = tid; i < MS; i += nt) {
          if (kRep == kBool)
            ck[i] = (float)((Rw[cur * M + i / S] >> (i % S)) & 1u);
          else
            ck[i] = Rf[cur * MS + i];
        }
      }

      // this return's fire operand: slot j's rows (kBool: words [S]) or
      // matrix (f32: element (s, t) at opnd[j] + s * ld + t)
      const float* Fo = Of;
      int ld = S;
      int c = 0;
      if (kStream) {
        stage_G(a, k + 1, graw, gb, gs);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncthreads();
        const unsigned char* g = graw + (size_t)(k & 1) * gs;
        ld = W * S;
        if (kRep == kBool) {
          for (int i = tid; i < W * S; i += nt) {  // i = j * S + s
            const int j = i / S, s = i % S;
            uint32_t w = 0;
            for (int t = 0; t < S; ++t) {
              const int at = s * W * S + j * S + t;
              const float v = kI8 ? (float)((const int8_t*)g)[at]
                                  : ((const float*)g)[at];
              w |= (uint32_t)(v > 0.5f) << t;
            }
            Ow[i] = w;
          }
          __syncthreads();
        } else if (kI8) {
          for (int i = tid; i < S * W * S; i += nt)
            Of[i] = (float)((const int8_t*)g)[i];
          __syncthreads();
        } else {
          Fo = (const float*)g;
        }
      } else {
        for (int j = 0; j < W; ++j) c += ops_s[kk * W + j] >= 0;
      }
      // the offset of slot j's operand in Ow (kBool) or Fo (f32)
      auto opnd = [&](int j) -> int {
        if (kStream) return j * S;
        int o = ops_s[kk * W + j];
        o = o < 0 ? a.O1 - 1 : o;
        return kRep == kBool ? o * S : o * S * S;
      };

      int passes = a.n_pass;
      if (!kStream) {
        int off = a.n_pass;
        for (int g = 0; g < a.n_gates; ++g) {
          if (c > off) passes += a.gate[g];
          off += a.gate[g];
        }
      }
      for (int p = 0; p < passes; ++p) {
        const int rev = kOrder == kFwd   ? 0
                        : kOrder == kRev ? 1
                                         : p < 32 && ((a.rev_mask >> p) & 1);
        if (kRep == kBool) {
          const uint32_t* src = Rw + cur * M;
          uint32_t* dst = Rw + (cur ^ 1) * M;
          for (int m = tid; m < M; m += nt) {
            uint32_t acc = src[m];
            for (int i = 0; i < W; ++i) {
              const int j = rev ? W - 1 - i : i;
              if ((m >> j) & 1)
                acc |= image(Ow + opnd(j), src[m ^ (1 << j)]);
            }
            dst[m] = acc;
          }
        } else {
          const float* src = Rf + cur * MS;
          float* dst = Rf + (cur ^ 1) * MS;
          for (int e = tid; e < nE; e += nt) {
            const int m = e / S, t = e % S;
            float acc = src[e];
            for (int i = 0; i < W; ++i) {
              const int j = rev ? W - 1 - i : i;
              if (!((m >> j) & 1)) continue;
              const float* x = src + (size_t)(m ^ (1 << j)) * S;
              const float* gcol = Fo + opnd(j) + t;
              float f = 0.f;
              for (int s = 0; s < S; ++s) f += x[s] * gcol[s * ld];
              acc = kRep == kAdd ? acc + f : fmaxf(acc, f);
            }
            dst[e] = acc;
          }
        }
        __syncthreads();
        cur ^= 1;
      }

      const int js = js_s[kk];
      const int jt = js < 0 ? W : js;
      if (kRep == kBool) {
        const uint32_t* src = Rw + cur * M;
        uint32_t* dst = Rw + (cur ^ 1) * M;
        for (int m = tid; m < M; m += nt) {
          uint32_t v;
          if (kTable) {
            const float* row = PJs + ((size_t)jt * M + m) * M;
            v = 0u;
            for (int m2 = 0; m2 < M; ++m2)
              if (row[m2] != 0.f) v |= src[m2];
          } else if (js < 0) {
            v = src[m];
          } else {
            v = ((m >> js) & 1) ? 0u : src[m | (1 << js)];
          }
          dst[m] = v;
        }
      } else {
        const float* src = Rf + cur * MS;
        float* dst = Rf + (cur ^ 1) * MS;
        for (int e = tid; e < nE; e += nt) {
          const int m = e / S, t = e % S;
          float v;
          if (kTable) {
            const float* row = PJs + ((size_t)jt * M + m) * M;
            v = 0.f;
            for (int m2 = 0; m2 < M; ++m2) v += row[m2] * src[m2 * S + t];
          } else if (js < 0) {
            v = src[e];
          } else {
            v = ((m >> js) & 1) ? 0.f : src[(m | (1 << js)) * S + t];
          }
          dst[e] = a.counts ? fminf(v, 1.f) : v;
        }
      }
      __syncthreads();
      cur ^= 1;
    }
  }

  for (size_t i = tid; i < MS; i += nt) {
    if (kRep == kBool)
      a.final_out[i] = (float)((Rw[cur * M + i / S] >> (i % S)) & 1u);
    else
      a.final_out[i] = Rf[cur * MS + i];
  }
}

// Threads of one walk: one per element of the set, whole warps, at most
// kMaxThreads (threads loop over the rest).
inline int walk_threads(int rep, int W, int S) {
  const long nE = rep == kBool ? (1L << W) : (1L << W) * S;
  long t = (nE + 31) / 32 * 32;
  return (int)(t > kMaxThreads ? kMaxThreads : t);
}

// Launch one instance on `stream`. Returns the CUDA error of the launch
// (0 when it was accepted).
template <int kRep, int kOrder, bool kTable, int kUnroll, bool kStream,
          bool kI8>
int launch(const Ablate& a, void* stream) {
  const int rep = kRep;
  const size_t smem =
      layout(a.W, a.S, a.O1, rep, kTable, kStream, kI8).total;
  auto kernel = ablate_walk<kRep, kOrder, kTable, kUnroll, kStream, kI8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, walk_threads(rep, a.W, a.S), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The checks every launch makes, whatever the instance.
inline bool valid(const Ablate& a, int rep) {
  if (rep < kBool || rep > kMax || a.W < 1 || a.W > kMaxW || a.S < 1 ||
      (rep == kBool && a.S > 32) ||
      a.O1 < 1 || a.B < 1 || a.R_pad < 1 || a.R_pad % a.B != 0 ||
      a.n_pass < 0 || a.n_gates < 0 || a.n_gates > kMaxGates)
    return false;
  for (int g = 0; g < a.n_gates; ++g)
    if (a.gate[g] < 0) return false;
  return true;
}

}  // namespace
