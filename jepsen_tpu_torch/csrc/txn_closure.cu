// K8: one squaring step of the transactional checker's word-packed
// boolean closure, C <- C | C.C over K stacked lane masks, on Hopper's
// single-bit tensor cores.
//
// Replaces the word-packed XLA body of the reference package
// (jepsen_tpu/txn/cycles.py, _lattice_word_call, one iteration of its
// squaring ladder). That body is no Pallas kernel: it leaves
// any((Cw[:, :, None, :] & CwT[:, None, :, :]) != 0, -1) to XLA's
// fusion.
//
// Operands. Cw is the row-packed closure and CwT the transpose-packed
// one, both int32[K, Np, NW] with NW = Np / 32: bit (k & 31) of word
// (k >> 5) of row i of Cw is C[b, i, k]. The step computes
//   prod[b, i, k] = sum_w popcount(Cw[b, i, w] & CwT[b, k, w]) > 0,
// a boolean matrix product A.B^T with A = Cw and B = CwT as bits (CwT
// need not be Cw's transpose), and writes Cw | pack_rows(prod) to
// Cw_out and CwT | pack_rows(prod^T) to CwT_out: fresh buffers, so the
// step equals its plain version (txn/cycles.py, square_step_plain) bit
// for bit.
//
// The form. tools/mma_forms.py timed each tensor-core form that can
// take the packed words on an H100 (PERF.md): wgmma m64n256k256
// .b1 with AND and popcount, A and B read from shared memory, ran at
// 15.8 POP/s (2 * M * N * K a second), eight times s8 wgmma's 2.0 and
// the data sheet's int8 1,979 TOP/s. It takes the packed words as they
// are: a k-step of 256 is 8 words of a row, and the s32 counts (up to
// Np) are exact.
//
// What bounds it: operations, 2 * K * Np^3 of them at that rate (0.278
// ms at K = 4, Np = 8,192), against 4 * K * Np * NW * 4 bytes read and
// written (67 MB there: 0.020 ms at 3.35 TB/s). At the int8 peak the
// same operations take 2.22 ms, and the first design's bound (one
// three-input logic op a word pair, K * Np^2 * NW of them over the
// integer pipe) was 4.11 ms. Between the tensor cores and device
// memory sits the operands' traffic from L2 to the SMs, (BM + BN) rows
// of NW words a tile: 3.2 GB at that shape for a 128 x 256 tile, which
// TMA moves in boxes of whole tiles (per-thread 16-byte copies could
// not keep enough bytes in flight).
//
// The design. A persistent block (one an SM) walks tiles of prod, BM x
// BN of one lane each, in the order lane, row tile, column tile. BM =
// 64 rows a warpgroup (128 threads), each warpgroup holding its 64 x BN
// counts in registers (the wgmma accumulator layout). The big form is 2
// warpgroups x 256 columns (128 x 256, 128 accumulators a thread), the
// small one 1 x 64 (square_form in txn/cycles.py picks it from Np).
// The K axis goes in stages of 32 words a row (KS = 4 k-steps of 256),
// the stages of all the block's tiles in one sequence through a ring of
// RING slots. A slot holds the tile's BM Cw rows and BN CwT rows as
// wgmma reads them: K-major, 128-byte swizzle (a row's 128 bytes, its
// 16-byte chunks permuted by row % 8 within each 8-row, 1,024-byte
// atom), k-step kk 32 bytes into the row. One thread fills the slots by
// TMA (a tensor map a packing, boxes of BM or BN rows x 32 words,
// zero past Np and NW), each completing on the slot's mbarrier, RING - 1
// stages ahead, so the next tile's first stages land during this
// tile's epilogue. A stage: wait for the slot, issue its KS wgmma,
// wait for the stage before, sync the block, refill that stage's slot.
// Where a row's stride is not a multiple of 16 bytes (NW % 4 != 0, Np
// not a multiple of 128), or an operand not 16-byte aligned, TMA cannot
// take the operands: there every thread copies 4-byte words with
// cp.async into the same layout, one stage at a time.
//
// The epilogue takes count > 0. A quad of lanes holds a row's 32
// columns of a word (2 of each block of 8), so each lane sets its 8
// bits and two xor-shuffles OR the word together: the row-packed words,
// which also go to shared memory. The transpose-packed words are the
// same flags read transposed: a warp loads a 32 x 32 block of them, a
// word a lane, and five butterfly stages of shuffles transpose it in
// registers. Both are ORed into the old words, which the thread loads
// at the start of the tile so that they land during its stages. Each
// warpgroup stores the words of its own 64 rows, so its own barrier,
// not the block's, orders its epilogue.
//
// Resources (-Xptxas -v, sm_90a): the big form 255
// registers a thread, the small one 89, no spills in either; 32 bytes
// of static shared memory (the mbarriers) and 202,240 (big) or 67,328
// (small) dynamic bytes (Tile::SMEM); 16 named barriers reserved (the
// warpgroups' own barrier takes its id from a register).

#include "bitmma.cuh"

namespace {

constexpr int KS = 4;        // 256-bit k-steps a stage
constexpr int SW = 8 * KS;   // words of a row a stage: one 128-byte row
constexpr int RING = 4;      // ring slots; RING - 1 stages in flight

template <int WGS, int BN>
struct Tile {
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BM = 64 * WGS;
  static constexpr int ABYTES = BM * 128;        // a slot's Cw rows
  static constexpr int SLOT = (BM + BN) * 128;   // bytes of a ring slot
  static constexpr int NACC = BN / 2;            // s32 accumulators a thread
  static constexpr int CW = BN / 32;             // row words of the tile
  static constexpr int FLAGS = BM * (CW + 1) * 4;
  // ring, flags, and 1,024 bytes to align the ring for the swizzle
  static constexpr int SMEM = RING * SLOT + FLAGS + 1024;
};

// the stage's KS wgmma of this warpgroup from the slot at `slot`; stage
// 0 of a tile starts the counts
template <int WGS, int BN>
__device__ __forceinline__ void mma_stage(uint32_t (&d)[BN / 2],
                                          uint32_t slot, int wg, int st) {
  using T = Tile<WGS, BN>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    mma<BN>(d, desc(slot + wg * 64 * 128 + kk * 32),
            desc(slot + T::ABYTES + kk * 32), st > 0 || kk > 0);
}

struct Geometry {
  int Np, NW, S, tiles_i, tiles_k;  // stages a tile; row and column tiles
};

template <int WGS, int BN>
__global__ void __launch_bounds__(Tile<WGS, BN>::THREADS, 1)
square_step(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            const uint32_t* __restrict__ Cw, const uint32_t* __restrict__ CwT,
            uint32_t* __restrict__ Cw_out, uint32_t* __restrict__ CwT_out,
            Geometry geo, int tiles, int tma) {
  using T = Tile<WGS, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[RING];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint32_t* flags =
      reinterpret_cast<uint32_t*>(smem_raw + (ring - raw) + RING * T::SLOT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, wg = warp >> 2;
  const int Np = geo.Np, NW = geo.NW, S = geo.S;
  const int wt = tid & 127, wi = warp & 3;  // thread, warp in the warpgroup
  constexpr int ROW_ITEMS = 64 * T::CW / 128, COL_ITEMS = 2 * T::CW / 4;
  const int per_lane = geo.tiles_i * geo.tiles_k;

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's stages in one sequence: n = its t-th tile's stage st
  const int my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * S;
  auto issue = [&](int n) {  // thread 0, TMA path
    const int t = blockIdx.x + (n / S) * gridDim.x, st = n % S;
    const int b = t / per_lane, r = t % per_lane;
    const int i0 = (r / geo.tiles_k) * T::BM, k0 = (r % geo.tiles_k) * BN;
    const uint32_t slot = ring + (n % RING) * T::SLOT;
    const uint32_t bar = smem_addr(&full[n % RING]);
    mbar_expect(bar, T::SLOT);
    tma_load(slot, &map_a, st * SW, i0, b, bar);
    tma_load(slot + T::ABYTES, &map_b, st * SW, k0, b, bar);
  };
  if (tma && tid == 0)
    for (int n = 0; n < RING - 1 && n < total; ++n) issue(n);

  uint32_t d[T::NACC];
#pragma unroll
  for (int j = 0; j < T::NACC; ++j) d[j] = 0;
  int n = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / per_lane, r = t % per_lane;
    const int i0 = (r / geo.tiles_k) * T::BM, k0 = (r % geo.tiles_k) * BN;
    const size_t base = (size_t)b * Np * NW;
    const uint32_t* cw = Cw + base;
    const uint32_t* cwt = CwT + base;
    // the old words this thread ORs into, loaded now so that they land
    // during the tile's stages. A warpgroup writes its own 64 rows: row
    // words it = wt + 128 u of them (row it / CW, word it % CW), and
    // the transposed 32 x 32 blocks (rb, cb) = (2 wg + blk % 2, blk / 2)
    // of blk = wi + 4 u
    uint32_t old_row[ROW_ITEMS], old_col[COL_ITEMS];
#pragma unroll
    for (int u = 0; u < ROW_ITEMS; ++u) {
      const int it = wt + 128 * u, rr = 64 * wg + it / T::CW, c = it % T::CW;
      const int gi = i0 + rr, gw = (k0 >> 5) + c;
      old_row[u] = gi < Np && gw < NW ? cw[(size_t)gi * NW + gw] : 0u;
    }
#pragma unroll
    for (int u = 0; u < COL_ITEMS; ++u) {
      const int blk = wi + 4 * u, rb = 2 * wg + blk % 2, cb = blk / 2;
      const int gk = k0 + 32 * cb + lane, gw = (i0 >> 5) + rb;
      old_col[u] = gk < Np && gw < NW ? cwt[(size_t)gk * NW + gw] : 0u;
    }

    if (tma) {
      for (int st = 0; st < S; ++st, ++n) {
        const uint32_t slot = ring + (n % RING) * T::SLOT;
        mbar_wait(smem_addr(&full[n % RING]), (n / RING) & 1);
#pragma unroll
        for (int j = 0; j < T::NACC; ++j) keep(d[j]);
        wg_fence();
        mma_stage<WGS, BN>(d, slot, wg, st);
        wg_commit();
        wg_wait<1>();  // this warpgroup's stage n - 1 is done
#pragma unroll
        for (int j = 0; j < T::NACC; ++j) keep(d[j]);
        __syncthreads();  // ... every warpgroup's: its slot is free
        if (tid == 0 && n + RING - 1 < total) issue(n + RING - 1);
      }
    } else {
      // 4-byte copies into slot 0, one stage at a time
      for (int st = 0; st < S; ++st) {
        for (int c = tid; c < (T::BM + BN) * SW; c += T::THREADS) {
          const int row = c / SW, j = c % SW;
          const int gr = row < T::BM ? i0 + row : k0 + row - T::BM;
          const int w = st * SW + j;
          const bool ok = gr < Np && w < NW;
          const uint32_t* src =
              (row < T::BM ? cw : cwt) + (ok ? (size_t)gr * NW + w : 0);
          const int off = row < T::BM ? swz_off(row, j)
                                      : T::ABYTES + swz_off(row - T::BM, j);
          cp4(ring + off, src, ok ? 4 : 0);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        fence_async();
        __syncthreads();
#pragma unroll
        for (int j = 0; j < T::NACC; ++j) keep(d[j]);
        wg_fence();
        mma_stage<WGS, BN>(d, ring, wg, st);
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int j = 0; j < T::NACC; ++j) keep(d[j]);
        __syncthreads();
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < T::NACC; ++j) keep(d[j]);

    const int ra = 16 * warp + g;  // this thread's rows: ra and ra + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < T::CW; ++c) {
        uint32_t p = 0;  // distinct bits: + is |
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            p += min(d[4 * (4 * c + jj) + 2 * h + e], 1u)
                 << (8 * jj + 2 * q + e);
        p |= __shfl_xor_sync(0xffffffffu, p, 1);
        p |= __shfl_xor_sync(0xffffffffu, p, 2);
        if (q == 0) flags[(ra + 8 * h) * (T::CW + 1) + c] = p;
      }
    }
    wg_sync(wg);  // the warpgroup's flags are in shared memory
    uint32_t* out = Cw_out + base;
#pragma unroll
    for (int u = 0; u < ROW_ITEMS; ++u) {
      const int it = wt + 128 * u, rr = 64 * wg + it / T::CW, c = it % T::CW;
      const int gi = i0 + rr, gw = (k0 >> 5) + c;
      if (gi < Np && gw < NW)
        out[(size_t)gi * NW + gw] = old_row[u] | flags[rr * (T::CW + 1) + c];
    }
    // transpose-packed: lane l ends with bit x = flag[32 rb + x][32 cb +
    // l], word i0 / 32 + rb of CwT row k0 + 32 cb + l
    uint32_t* outT = CwT_out + base;
#pragma unroll
    for (int u = 0; u < COL_ITEMS; ++u) {
      const int blk = wi + 4 * u, rb = 2 * wg + blk % 2, cb = blk / 2;
      uint32_t x = flags[(32 * rb + lane) * (T::CW + 1) + cb];
#pragma unroll
      for (int s = 16; s >= 1; s >>= 1) {
        const uint32_t lo = s == 16  ? 0x0000FFFFu
                            : s == 8 ? 0x00FF00FFu
                            : s == 4 ? 0x0F0F0F0Fu
                            : s == 2 ? 0x33333333u
                                     : 0x55555555u;
        const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
        x = (lane & s) ? (x & ~lo) | ((y & ~lo) >> s)
                       : (x & lo) | ((y & lo) << s);
      }
      const int gk = k0 + 32 * cb + lane, gw = (i0 >> 5) + rb;
      if (gk < Np && gw < NW) outT[(size_t)gk * NW + gw] = old_col[u] | x;
    }
    wg_sync(wg);  // its flags are free for the next tile
  }
}

template <int WGS, int BN>
int launch(const void* Cw, const void* CwT, void* Cw_out, void* CwT_out,
           int K, int Np, cudaStream_t stream) {
  using T = Tile<WGS, BN>;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(square_step<WGS, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  const int NW = Np / 32;
  Geometry geo{Np, NW, (NW + SW - 1) / SW, (Np + T::BM - 1) / T::BM,
               (Np + BN - 1) / BN};
  const int tiles = K * geo.tiles_i * geo.tiles_k;
  // TMA needs 16-byte aligned operands and row strides
  const int tma = NW % 4 == 0 && ((uintptr_t)Cw & 15) == 0 &&
                  ((uintptr_t)CwT & 15) == 0;
  CUtensorMap map_a{}, map_b{};
  if (tma) {
    int e = encode(&map_a, Cw, K, Np, NW, T::BM);
    if (e == 0) e = encode(&map_b, CwT, K, Np, NW, BN);
    if (e != 0) return e;
  }
  const int grid = tiles < sms ? tiles : sms;
  square_step<WGS, BN><<<grid, T::THREADS, T::SMEM, stream>>>(
      map_a, map_b, (const uint32_t*)Cw, (const uint32_t*)CwT,
      (uint32_t*)Cw_out, (uint32_t*)CwT_out, geo, tiles, tma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one squaring step on `stream` in form `form` (1: the big tile,
// 128 x 256; 0: the small one, 64 x 64; txn/cycles.py square_form picks
// it from Np). Cw, CwT, Cw_out and CwT_out are device pointers to
// contiguous int32[K, Np, NW] words with NW = Np / 32; Np is a multiple of 32 with Np <= 2^20 and 1 <= K <= 65,535. The
// outputs must not alias the inputs. Returns the CUDA error of the
// launch (0 when it was accepted).
int jt_txn_square_step(const void* Cw, const void* CwT, void* Cw_out,
                       void* CwT_out, int K, int Np, int form, void* stream) {
  if (K < 1 || K > 65535 || Np < 32 || Np % 32 != 0 || Np > (1 << 20) ||
      (form != 0 && form != 1) || Cw_out == Cw || CwT_out == CwT ||
      Cw_out == CwT || CwT_out == Cw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return form ? launch<2, 256>(Cw, CwT, Cw_out, CwT_out, K, Np, s)
              : launch<1, 64>(Cw, CwT, Cw_out, CwT_out, K, Np, s);
}

}  // extern "C"
