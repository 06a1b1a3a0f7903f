// K9: the dirty-block word join of the transactional checker's
// incremental closure, for K stacked lanes:
//
//   out[b, i, :] = C[b, i, :] | OR_{k : bit k of A[b, i]} B[b, k, :]
//
// Replaces step 4 of the word-packed XLA body of the reference package
// (jepsen_tpu/txn/cycles.py, _inc_word_call): the OR-reduce of
// where(thru > 0, right_w, 0) over the dirty columns into Cw, and of
// where(right > 0, thru^T packed, 0) into CwT. That body is no Pallas
// kernel: XLA fuses the [K, Np, d, NW] broadcast, which eager PyTorch
// would materialise (8.6 GB at K = 4, Np = 8,192, d = 256).
//
// Operands, all contiguous int32 words with the reference's uint32 bits
// (bit k & 31 of word k >> 5):
//   A   [K, Np, DW]  bits over B's d rows (bits at d and above are zero)
//   B   [K, d, NW]   word rows
//   C   [K, Np, NW]  the carried words
//   out [K, Np, NW]  a fresh buffer, so a call equals its plain version
//                    (txn/cycles.py, inc_join_plain) bit for bit.
// The wrapper calls it twice an append block: for Cw (A = thru packed
// over the dirty columns, B = (C v I)[dd, :] as words, C = Cw) and for
// CwT (A = right^T packed over the dirty rows, B = thru^T packed over
// the rows, C = CwT).
//
// What bounds it on an H100: bytes. At K = 4, Np = 8,192, d = 256 it
// reads A (1 MB), B (1 MB) and C (32 MB) and writes out (32 MB): 0.020
// ms at 3.35 TB/s, against 2 K Np d Np = 1.4e11 single-bit operations
// (0.009 ms at the measured 15.8 POP/s of the b1 tensor cores). This
// design does one 32-bit OR a word for every set bit of A instead:
// K Np NW popcount(A) of them, read from L2 (B is small and shared by
// every row of its lane).
//
// The design (simple first): one warp a row i and a chunk of 32 * WPL
// words of it, the words in the lanes' registers (lane l holds words
// l, l + 32, ...: WPL of them, 8 at NW = 256). The warp reads A's row 32
// words at a time, skips zero words by a ballot, broadcasts each nonzero
// word and walks its set bits; for each it ORs B's row k into the
// registers, each of the WPL reads 128 coalesced bytes. Then it writes
// the row once. Tensor cores (wgmma .b1, as K8) and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block of 256 threads

template <int WPL>
__global__ void __launch_bounds__(kWarps * 32)
    inc_join_kernel(const uint32_t* __restrict__ A,
                    const uint32_t* __restrict__ B,
                    const uint32_t* __restrict__ C,
                    uint32_t* __restrict__ out, int K, int Np, int DW, int d,
                    int NW) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);  // over K * Np
  if (row >= (long long)K * Np) return;                    // warp-uniform
  const long long b = row / Np;
  const int c0 = blockIdx.y * 32 * WPL;                    // first word
  const uint32_t* crow = C + row * NW;
  uint32_t acc[WPL];
#pragma unroll
  for (int t = 0; t < WPL; ++t) {
    const int w = c0 + t * 32 + lane;
    acc[t] = w < NW ? crow[w] : 0u;
  }
  const uint32_t* arow = A + row * DW;
  const uint32_t* bl = B + b * d * (long long)NW;
  for (int w0 = 0; w0 < DW; w0 += 32) {
    const uint32_t mine = w0 + lane < DW ? arow[w0 + lane] : 0u;
    unsigned nz = __ballot_sync(0xffffffffu, mine != 0u);
    while (nz) {                                           // warp-uniform
      const int j = __ffs(nz) - 1;
      nz &= nz - 1;
      uint32_t bits = __shfl_sync(0xffffffffu, mine, j);
      const int kb = (w0 + j) * 32;
      while (bits) {
        const int k = kb + __ffs(bits) - 1;
        bits &= bits - 1;
        if (k >= d) break;                // bits past d: none, by contract
        const uint32_t* brow = bl + (long long)k * NW;
#pragma unroll
        for (int t = 0; t < WPL; ++t) {
          const int w = c0 + t * 32 + lane;
          if (w < NW) acc[t] |= __ldg(brow + w);
        }
      }
    }
  }
  uint32_t* orow = out + row * NW;
#pragma unroll
  for (int t = 0; t < WPL; ++t) {
    const int w = c0 + t * 32 + lane;
    if (w < NW) orow[w] = acc[t];
  }
}

template <int WPL>
int launch(const void* A, const void* B, const void* C, void* out, int K,
           int Np, int DW, int d, int NW, cudaStream_t s) {
  const long long rows = (long long)K * Np;
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps),
                  (unsigned)((NW + 32 * WPL - 1) / (32 * WPL)));
  inc_join_kernel<WPL><<<grid, kWarps * 32, 0, s>>>(
      (const uint32_t*)A, (const uint32_t*)B, (const uint32_t*)C,
      (uint32_t*)out, K, Np, DW, d, NW);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one join on `stream`: A [K, Np, DW], B [K, d, NW], C and out
// [K, Np, NW], contiguous int32 on the device, d <= 32 * DW. Words a
// lane: 1, 2, 4 or 8 (NW up to 32, 64, 128, else 8 and a grid column a
// chunk of 256 words). Returns the CUDA error of the launch (0 when it
// was accepted).
int jt_txn_inc_join(const void* A, const void* B, const void* C, void* out,
                    int K, int Np, int DW, int d, int NW, void* stream) {
  if (K < 1 || Np < 1 || DW < 1 || d < 1 || NW < 1 || d > 32 * DW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (NW <= 32) return launch<1>(A, B, C, out, K, Np, DW, d, NW, s);
  if (NW <= 64) return launch<2>(A, B, C, out, K, Np, DW, d, NW, s);
  if (NW <= 128) return launch<4>(A, B, C, out, K, Np, DW, d, NW, s);
  return launch<8>(A, B, C, out, K, Np, DW, d, NW, s);
}

}  // extern "C"
