// K9: the boolean product of the transactional checker's incremental
// closure, on Hopper's single-bit tensor cores, for K stacked lanes:
//
//   prod[b, i, j] = OR_k A[b, i, k] & B[b, j, k]
//   out  = C  | pack_rows(prod)       [K, M, OW], OW = ceil(N / 32)
//   outT = CT | pack_rows(prod^T)     [K, N, TW], TW = ceil(M / 32)
//
// Replaces the skinny products of the word-packed XLA update of the
// reference package (jepsen_tpu/txn/cycles.py, _inc_word_call): the
// join of the closure through the dirty block (step 4, the OR-reduce of
// where(thru > 0, right_w, 0) into Cw and of its transpose into CwT),
// the left join thru = left . H (step 3), and the bit gathers of the
// dirty columns (txn/cycles.py, inc_update_word, runs all of them here
// and the dirty block's ladder on K8). That body is no Pallas kernel:
// XLA fuses the [K, Np, d, NW] broadcast and leaves the rest to f32
// einsums.
//
// Operands: contiguous int32 words with the reference's uint32 bits (bit
// k & 31 of word k >> 5). A [K, M, KW] and B [K, N, KW] are both K-major
// over the same KW words (the k axis packed), as wgmma .b1 reads them;
// this is K8's product Cw . CwT^T (txn_closure.cu) with A, B and C
// distinct and a k axis of its own. C and CT may be null (zero); outT
// null is the rows-only mode. Both outputs are fresh buffers, so a call
// equals its plain version (txn/cycles.py, inc_join_plain) bit for bit,
// and one launch writes both packings of the join.
//
// What bounds it on an H100. Operations: 2 K M N (32 KW) single-bit
// ones at the 15.8 POP/s that tools/mma_forms.py measured for wgmma
// m64n256k256 .b1 (the join at K = 4, M = N = 8,192, d = 32 KW = 8,192:
// 0.279 ms, K8's bound). Bytes where the k axis is short: A, B, C and CT
// read once and both outputs written once, 134 MB at d = 256 (0.040 ms
// at 3.35 TB/s against 0.009 ms of operations). The first design, a
// warp a row ORing one B row into registers for every set bit of A, read
// B's rows from L2 once a bit: K M d / 2 row reads at density 0.5, over
// 100 GB at d = 8,192. Here a tile reads its BM A rows and BN B rows once
// a stage, and the tiles walk the column tiles of one row band in turn,
// so the band's A rows stay in L2 while B streams past.
//
// The design is K8's, with its pieces (bitmma.cuh): persistent blocks
// walk the tiles of prod, BM x BN of one lane each (lane, row tile,
// column tile); the big form is two warpgroups x 256 columns, the small
// one one x 64 (cycles.join_form picks it from max(M, N)); stages of 32
// words a row pass through a ring of RING slots filled by TMA with the
// 128-byte swizzle (a tensor map an operand, zero past M, N and KW),
// RING - 1 stages ahead; each warpgroup's wgmma m64nBNk256 .b1 AND and
// popcount count into s32 accumulators; the epilogue packs count > 0 by
// quad shuffles into row words and by the 32 x 32 register butterfly
// into transposed ones, each ORed into the old words the thread loaded
// at the tile's start. Where the k axis is short a tile is one stage
// and one k-step long, and the epilogue's loads, packing and stores are
// most of its time. Edges K8 never met:
// - a short or ragged k axis (KW % 32 != 0; KW < 32 is d < 1,024): a
//   stage issues only the k-steps that hold words (ceil(KW / 8) of them
//   when KW < 8; the rest of a k-step is TMA's zero fill), so a join
//   over 8 dirty columns costs one k-step a tile, not four. That branch
//   around the wgmma makes ptxas fence the accumulators (C7519), so it
//   is an instance of its own (RAGGED); where KW % 32 == 0 every stage
//   issues all four k-steps unconditionally, as K8 does;
// - row strides that are not a multiple of 16 bytes (KW % 4 != 0, so KW
//   = 1 or 2 in the session): TMA cannot take them, and every thread
//   copies 4-byte words with cp.async into the same layout, the stage's
//   k-steps only, zero past KW;
// - M != N, and N or M not a multiple of the tile or of 32: rows past M
//   and N load as zero, so their counts are zero, and the epilogue
//   stores only the words inside [M, OW] and [N, TW].
//
// Resources: see the -Xptxas -v line chip_smoke.py prints for this
// source.

#include "bitmma.cuh"

namespace {

constexpr int KS = 4;        // 256-bit k-steps a stage
constexpr int SW = 8 * KS;   // words of a row a stage: one 128-byte row
constexpr int RING = 4;      // ring slots; RING - 1 stages in flight

template <int WGS, int BN>
struct Tile {
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BM = 64 * WGS;
  static constexpr int ABYTES = BM * 128;        // a slot's A rows
  static constexpr int SLOT = (BM + BN) * 128;   // bytes of a ring slot
  static constexpr int NACC = BN / 2;            // s32 accumulators a thread
  static constexpr int CW = BN / 32;             // row words of the tile
  static constexpr int FLAGS = BM * (CW + 1) * 4;
  // ring, flags, and 1,024 bytes to align the ring for the swizzle
  static constexpr int SMEM = RING * SLOT + FLAGS + 1024;
};

struct Geometry {
  int M, N, KW;              // A's rows, B's rows, words of the k axis
  int OW, TW;                // words of an out row, of an outT row
  int S, tiles_i, tiles_k;   // stages a tile; row and column tiles
};

// k-steps of stage st that hold words of the k axis
__device__ __forceinline__ int ksteps(int KW, int st) {
  const int left = KW - st * SW;
  return left >= SW ? KS : (left + 7) / 8;
}

// the stage's k-steps of this warpgroup from the slot at `slot` (all KS
// unless the k axis is RAGGED); stage 0 of a tile starts the counts
template <int WGS, int BN, bool RAGGED>
__device__ __forceinline__ void mma_stage(uint32_t (&d)[BN / 2],
                                          uint32_t slot, int wg, int st,
                                          int ks) {
  using T = Tile<WGS, BN>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (!RAGGED || kk < ks)
      mma<BN>(d, desc(slot + wg * 64 * 128 + kk * 32),
              desc(slot + T::ABYTES + kk * 32), st > 0 || kk > 0);
}

template <int WGS, int BN, bool RAGGED>
__global__ void __launch_bounds__(Tile<WGS, BN>::THREADS, 1)
join(const __grid_constant__ CUtensorMap map_a,
     const __grid_constant__ CUtensorMap map_b,
     const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
     const uint32_t* __restrict__ C, const uint32_t* __restrict__ CT,
     uint32_t* __restrict__ out, uint32_t* __restrict__ outT, Geometry geo,
     int tiles, int tma) {
  using T = Tile<WGS, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[RING];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint32_t* flags =
      reinterpret_cast<uint32_t*>(smem_raw + (ring - raw) + RING * T::SLOT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, wg = warp >> 2;
  const int M = geo.M, N = geo.N, KW = geo.KW, OW = geo.OW, TW = geo.TW;
  const int S = geo.S;
  const int wt = tid & 127, wi = warp & 3;  // thread, warp in the warpgroup
  constexpr int ROW_ITEMS = 64 * T::CW / 128, COL_ITEMS = 2 * T::CW / 4;
  const int per_lane = geo.tiles_i * geo.tiles_k;
  const bool both = outT != nullptr;

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
    const uint32_t* a = A + (size_t)b * M * KW;
    const uint32_t* bw = B + (size_t)b * N * KW;
    const size_t obase = (size_t)b * M * OW, tbase = (size_t)b * N * TW;
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
      old_row[u] = C != nullptr && gi < M && gw < OW
                       ? C[obase + (size_t)gi * OW + gw]
                       : 0u;
    }
#pragma unroll
    for (int u = 0; u < COL_ITEMS; ++u) {
      const int blk = wi + 4 * u, rb = 2 * wg + blk % 2, cb = blk / 2;
      const int gk = k0 + 32 * cb + lane, gw = (i0 >> 5) + rb;
      old_col[u] = CT != nullptr && gk < N && gw < TW
                       ? CT[tbase + (size_t)gk * TW + gw]
                       : 0u;
    }

    if (tma) {
      for (int st = 0; st < S; ++st, ++n) {
        const uint32_t slot = ring + (n % RING) * T::SLOT;
        mbar_wait(smem_addr(&full[n % RING]), (n / RING) & 1);
#pragma unroll
        for (int j = 0; j < T::NACC; ++j) keep(d[j]);
        wg_fence();
        mma_stage<WGS, BN, RAGGED>(d, slot, wg, st, ksteps(KW, st));
        wg_commit();
        wg_wait<1>();  // this warpgroup's stage n - 1 is done
#pragma unroll
        for (int j = 0; j < T::NACC; ++j) keep(d[j]);
        __syncthreads();  // ... every warpgroup's: its slot is free
        if (tid == 0 && n + RING - 1 < total) issue(n + RING - 1);
      }
    } else {
      // 4-byte copies into slot 0, one stage at a time, the words of its
      // k-steps only
      for (int st = 0; st < S; ++st) {
        const int ks = ksteps(KW, st), jw = 8 * ks;
        for (int c = tid; c < (T::BM + BN) * jw; c += T::THREADS) {
          const int row = c / jw, j = c % jw;
          const bool in_a = row < T::BM;
          const int gr = in_a ? i0 + row : k0 + row - T::BM;
          const int w = st * SW + j;
          const bool ok = gr < (in_a ? M : N) && w < KW;
          const uint32_t* src =
              (in_a ? a : bw) + (ok ? (size_t)gr * KW + w : 0);
          const int off =
              in_a ? swz_off(row, j) : T::ABYTES + swz_off(row - T::BM, j);
          cp4(ring + off, src, ok ? 4 : 0);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        fence_async();
        __syncthreads();
#pragma unroll
        for (int j = 0; j < T::NACC; ++j) keep(d[j]);
        wg_fence();
        mma_stage<WGS, BN, RAGGED>(d, ring, wg, st, ks);
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
#pragma unroll
    for (int u = 0; u < ROW_ITEMS; ++u) {
      const int it = wt + 128 * u, rr = 64 * wg + it / T::CW, c = it % T::CW;
      const int gi = i0 + rr, gw = (k0 >> 5) + c;
      if (gi < M && gw < OW)
        out[obase + (size_t)gi * OW + gw] =
            old_row[u] | flags[rr * (T::CW + 1) + c];
    }
    // transpose-packed: lane l ends with bit x = flag[32 rb + x][32 cb +
    // l], word i0 / 32 + rb of outT row k0 + 32 cb + l
    if (both) {
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
        if (gk < N && gw < TW)
          outT[tbase + (size_t)gk * TW + gw] = old_col[u] | x;
      }
    }
    wg_sync(wg);  // its flags are free for the next tile
  }
}

template <int WGS, int BN, bool RAGGED>
int launch(const void* A, const void* B, const void* C, const void* CT,
           void* out, void* outT, int K, int M, int N, int KW,
           cudaStream_t stream) {
  using T = Tile<WGS, BN>;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(join<WGS, BN, RAGGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  Geometry geo{M,
               N,
               KW,
               (N + 31) / 32,
               (M + 31) / 32,
               (KW + SW - 1) / SW,
               (M + T::BM - 1) / T::BM,
               (N + BN - 1) / BN};
  const long long tiles = (long long)K * geo.tiles_i * geo.tiles_k;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // TMA needs 16-byte aligned operands and row strides
  const int tma = KW % 4 == 0 && ((uintptr_t)A & 15) == 0 &&
                  ((uintptr_t)B & 15) == 0;
  CUtensorMap map_a{}, map_b{};
  if (tma) {
    int e = encode(&map_a, A, K, M, KW, T::BM);
    if (e == 0) e = encode(&map_b, B, K, N, KW, BN);
    if (e != 0) return e;
  }
  const int grid = tiles < sms ? (int)tiles : sms;
  join<WGS, BN, RAGGED><<<grid, T::THREADS, T::SMEM, stream>>>(
      map_a, map_b, (const uint32_t*)A, (const uint32_t*)B,
      (const uint32_t*)C, (const uint32_t*)CT, (uint32_t*)out,
      (uint32_t*)outT, geo, (int)tiles, tma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one product on `stream` in form `form` (1: the big tile, 128 x
// 256; 0: the small one, 64 x 64; txn/cycles.py join_form picks it). A
// [K, M, KW] and B [K, N, KW] are device pointers to contiguous int32
// words; C (may be null) and out are [K, M, ceil(N / 32)], CT (may be
// null) and outT [K, N, ceil(M / 32)]; outT null writes the rows only
// (CT must then be null). 1 <= K <= 65,535, 1 <= M, N <= 2^20, 1 <= KW
// <= 2^15. The outputs must not alias the inputs. Returns the CUDA
// error of the launch (0 when it was accepted).
int jt_txn_inc_join(const void* A, const void* B, const void* C,
                    const void* CT, void* out, void* outT, int K, int M,
                    int N, int KW, int form, void* stream) {
  const void* ins[4] = {A, B, C, CT};
  if (K < 1 || K > 65535 || M < 1 || M > (1 << 20) || N < 1 ||
      N > (1 << 20) || KW < 1 || KW > (1 << 15) || (form != 0 && form != 1) ||
      A == nullptr || B == nullptr || out == nullptr ||
      (outT == nullptr && CT != nullptr) || out == outT)
    return (int)cudaErrorInvalidValue;
  for (const void* p : ins)
    if (p != nullptr && (p == out || p == outT))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (KW % SW != 0)
    return form ? launch<2, 256, true>(A, B, C, CT, out, outT, K, M, N, KW, s)
                : launch<1, 64, true>(A, B, C, CT, out, outT, K, M, N, KW, s);
  return form ? launch<2, 256, false>(A, B, C, CT, out, outT, K, M, N, KW, s)
              : launch<1, 64, false>(A, B, C, CT, out, outT, K, M, N, KW, s);
}

}  // extern "C"
