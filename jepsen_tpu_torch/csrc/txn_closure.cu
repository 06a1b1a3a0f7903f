// K8: one squaring step of the transactional checker's word-packed
// boolean closure, C <- C | C.C over K stacked lane masks.
//
// Replaces the word-packed XLA body of the reference package
// (jepsen_tpu/txn/cycles.py, _lattice_word_call, one iteration of its
// squaring ladder). That body is no Pallas kernel: it leaves
// any((Cw[:, :, None, :] & CwT[:, None, :, :]) != 0, -1) to XLA's
// fusion. Eager PyTorch has no such fusion, and the broadcast it would
// materialise is [K, Np, Np, NW] words (206 GB at K = 3, Np = 8,192).
//
// Operands. Cw is the row-packed closure and CwT the transpose-packed
// one, both int32[K, Np, NW] with NW = Np / 32: bit (k & 31) of word
// (k >> 5) of row i of Cw is C[b, i, k], and of row k of CwT it is
// C[b, i, k]'s transpose, C[b, k, i]. The step computes
//   prod[b, i, k] = OR_w (Cw[b, i, w] & CwT[b, k, w]) != 0
// and writes Cw | pack_rows(prod) to Cw_out and CwT | pack_rows(prod^T)
// to CwT_out: fresh buffers, never in place, so the step equals its
// plain version (txn/cycles.py, square_step_plain) bit for bit.
//
// What bounds the function on an H100: operations. A step does one
// `acc |= a & b` a word pair, which compiles to one three-input logic
// instruction (LOP3): K * Np^2 * NW 32-bit operations (5.2e10 at K = 3,
// Np = 8,192: 3.1 ms at the integer pipe's 64 a clock an SM), against
// 4 * K * Np * NW * 4 bytes read and written (50 MB there: 0.015 ms).
//
// The design, a simple one. One block of 32 x 32 threads a 32 x 32
// tile of prod: thread (x, y) owns prod[b, i0 + y, k0 + x]. The tile's
// 32 Cw rows and 32 CwT rows are staged through shared memory 32 words
// at a time (each thread loads one word of each, coalesced along the
// words); in the inner loop a warp reads its row's Cw word as a
// broadcast and 32 different CwT rows' words from a padded array (no
// bank conflicts), and ORs the ANDs into one register. Then each warp's
// __ballot_sync of (acc != 0) is the row-packed output word of row
// i0 + y, and, after the tile of flags is transposed through shared
// memory, a second ballot is the transpose-packed word of row k0 + y.
// Each shared-memory word feeds one LOP3: a warp makes two shared
// loads (32 words each) a LOP3, and the shared-memory pipe serves 32
// words a clock an SM, so it allows 16 LOP3 lanes a clock an SM against
// the integer pipe's 64. The shared-memory pipe, not the integer pipe,
// sets this design's pace: about 4x the bound. Register tiling (several
// outputs a thread, each loaded word feeding several LOP3s) is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;   // prod tile edge: one warp a row, 32 warps
constexpr int CHUNK = 32;  // words staged per round

__global__ void __launch_bounds__(TILE * TILE)
square_step(const uint32_t* __restrict__ Cw, const uint32_t* __restrict__ CwT,
            uint32_t* __restrict__ Cw_out, uint32_t* __restrict__ CwT_out,
            int Np, int NW) {
  __shared__ uint32_t a[TILE][CHUNK];          // Cw rows i0..i0+31
  __shared__ uint32_t bt[TILE][CHUNK + 1];     // CwT rows k0..k0+31, padded
  __shared__ uint32_t flag[TILE][TILE + 1];    // prod tile, for the transpose

  const int x = threadIdx.x, y = threadIdx.y;
  const int k0 = blockIdx.x * TILE, i0 = blockIdx.y * TILE;
  const size_t lane = (size_t)blockIdx.z * Np * NW;
  const uint32_t* rowA = Cw + lane + (size_t)(i0 + y) * NW;
  const uint32_t* rowB = CwT + lane + (size_t)(k0 + y) * NW;

  uint32_t acc = 0;
  for (int w0 = 0; w0 < NW; w0 += CHUNK) {
    const int w = w0 + x;
    a[y][x] = w < NW ? rowA[w] : 0u;
    bt[y][x] = w < NW ? rowB[w] : 0u;
    __syncthreads();
    const int n = NW - w0 < CHUNK ? NW - w0 : CHUNK;
#pragma unroll 8
    for (int j = 0; j < n; ++j) acc |= a[y][j] & bt[x][j];
    __syncthreads();
  }
  const bool hit = acc != 0u;

  // row-packed: bit x of word k0/32 of row i0 + y is prod[i0 + y, k0 + x]
  const uint32_t row_word = __ballot_sync(0xffffffffu, hit);
  flag[y][x] = hit;
  __syncthreads();
  // transpose-packed: bit x of word i0/32 of row k0 + y is
  // prod[i0 + x, k0 + y]
  const uint32_t col_word = __ballot_sync(0xffffffffu, flag[x][y] != 0u);
  if (x == 0) {
    const size_t r = lane + (size_t)(i0 + y) * NW + (k0 >> 5);
    Cw_out[r] = Cw[r] | row_word;
    const size_t c = lane + (size_t)(k0 + y) * NW + (i0 >> 5);
    CwT_out[c] = CwT[c] | col_word;
  }
}

}  // namespace

extern "C" {

// Launch one squaring step on `stream`. Cw, CwT, Cw_out and CwT_out are
// device pointers to contiguous int32[K, Np, NW] words with NW = Np /
// 32; Np is a multiple of 32 with Np / 32 <= 65,535 and 1 <= K <=
// 65,535. The outputs must not alias the inputs. Returns the CUDA error
// of the launch (0 when it was accepted).
int jt_txn_square_step(const void* Cw, const void* CwT, void* Cw_out,
                       void* CwT_out, int K, int Np, void* stream) {
  if (K < 1 || K > 65535 || Np < TILE || Np % TILE != 0 ||
      Np / TILE > 65535 || Cw_out == Cw || CwT_out == CwT ||
      Cw_out == CwT || CwT_out == Cw)
    return (int)cudaErrorInvalidValue;
  const int NW = Np / 32;
  dim3 grid(Np / TILE, Np / TILE, K), block(TILE, TILE);
  square_step<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)Cw, (const uint32_t*)CwT, (uint32_t*)Cw_out,
      (uint32_t*)CwT_out, Np, NW);
  return (int)cudaGetLastError();
}

}  // extern "C"
