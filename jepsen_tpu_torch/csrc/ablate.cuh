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
//   a pass  from the pass-start set `old` (Jacobi), for every mask m and
//           state t
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
// Every variant runs exactly its passes: no fixpoint exit, and a return
// with no pending op still runs them. The results would be the same
// without those passes, but their cost is what the harness times.
//
// What bounds it on an H100: as for K1 (walk.cuh), neither bytes nor
// operations but the serial chain of passes, one block on one SM. The
// design keeps each pass a few dependent on-chip steps:
//   - the bool body walks P's nibble image tables (walk.cuh's
//     pack_tables, or_part): an image is K = n_nibbles(S) independent
//     lookups gated by bit j of the mask with an AND, with no branch
//     around them. K6 builds the tables by one pack_tables launch and
//     copies them into shared memory when they fit, else reads them
//     from device memory. K7's operand changes every return, so the
//     warp builds that return's tables (W * K * 16 words, each the OR of
//     at most four of the return's row words) from the landed stage
//     into a ring of two in shared memory; where they do not fit beside
//     the stages (the edge of stream_fits, the block form only), the
//     image is a masked OR over the S row words;
//   - the warp form (W <= 5): lane m holds mask m's set in registers, a
//     partner's set is a __shfl_xor_sync, and no block barrier is taken
//     (__syncwarp around the staging only). Bool: one word a lane. The
//     table projection stays a product through PJ: lane m ORs the sets
//     of the m2 whose PJ[jt][m][m2] is non-zero, M shuffles, PJ held
//     transposed in shared memory so that the lanes read consecutive
//     words. f32 (add, max): lane m holds its row of S floats, the
//     partner's row arrives by S shuffles, and slot j's S x S block of
//     the operand is read from shared memory at one address for every
//     lane (a broadcast), four floats a load; the two lanes of a pair
//     each sum half of the image's states, and S / 2 shuffles give the
//     bit-set lane the other half. The f32 warp form is
//     instanced at S = 8 and 16 (a row, its accumulator and the
//     partner's value in registers, the loops unrolled); other S take
//     the block form;
//   - the f32 sums stay plain f32 accumulations over s: the values are
//     integers (sums of 0/1 products), exact in any order below 2^24, so
//     the kernel meets the plain version's floats. Tensor cores are no
//     route: TF32 keeps 11 significant bits, and the counts outgrow them
//     (maxnc grows up to S-fold a pass: 8^5 = 32,768 at five passes);
//   - the block form (W > 5, or f32 at other S): the set double-
//     buffered in shared memory, one barrier a pass and one for the
//     projection; bool on the tables, f32 one thread per (mask, state);
//   - K7 stages G through a ring of kRing bulk copies (cp.async.bulk,
//     one mbarrier a stage): one thread issues return k + N's copy as
//     soon as return k's stage has been read, and the consumers wait on
//     the stage's phase, so the copy runs up to N returns ahead. A
//     geometry whose G is not a multiple of 16 bytes a return cannot be
//     bulk-copied; it takes a per-thread copy into one stage, chosen
//     from the geometry before the launch (stream_layout).
// The form, the table place and the ring follow from the geometry before
// the launch (walk_layout, stream_layout), mirrored by the Python
// wrappers (tools/ablate_lane.py) and logged by chip_smoke.py.
//
// Template axes are what changes the code a pass runs: the form, the
// representation (bool, add, max), the slot order (kFwd, kRev, or by
// pass from a mask), the projection (bit move or table), unroll 1 or 2
// (returns per loop iteration), the lookup count KT, and (K7) the
// operand's type. n_pass, the gates and the pass order mask are runtime
// arguments.

#pragma once

#include "walk.cuh"

namespace {

constexpr int kMaxGates = 8;
constexpr int kMaxThreads = 1024;
constexpr int kRing = 8;           // K7: stages of G's bulk-copy ring
constexpr int kStreamChunk = 128;  // K7: returns of ret_slot a refill

enum { kBool = 0, kAdd = 1, kMax = 2 };    // representation and merge
enum { kFwd = 0, kRev = 1, kByPass = 2 };  // slot order of a pass

// Where one walk keeps what, in bytes from the start of its dynamic
// shared memory, and its form; decided on the host from the geometry.
struct Layout {
  int warp;      // the warp form (else the block form)
  int t_shared;  // K6, bool: P's tables in shared memory (else device)
  int stages;    // K7: stages of the ring
  int tables;    // K7, bool: per-return tables (else the masked OR)
  int bulk;      // K7: bulk copies (else a per-thread copy, one stage)
  size_t gb, gs;  // K7: bytes of one return's G, and of its stage
  size_t opnd;   // K6: P's tables (bool) or P as f32 [O1][S][S]
  size_t ring, bar;       // K7: the stages, and their mbarriers
  size_t set;    // the block form's set, double-buffered
  size_t pj;     // the projection table, transposed: [W+1][m2][m]
  size_t rows, tabs;      // K7, bool: row words [W][S], tables [2][W][K][16]
  size_t js, ops, total;  // a chunk of the return stream; the sum
};

// One launch's operands. K6 reads slot_ops, P and its tables T; K7 reads
// G, the fire operand of every return pre-gathered as [R_pad][S][W*S]
// (f32, or int8): element (s, j*S + t) is P[o_j][s][t].
struct Ablate {
  const int* ret_slot;     // [R_pad]
  const int* slot_ops;     // [R_pad][W]
  const float* P;          // [O1][S][S], row O1 - 1 the sentinel
  const uint32_t* T;       // [O1][K][16], P's tables (K6, bool)
  const float* PJ;         // [W + 1][M][M]
  const void* G;           // [R_pad][S][W * S]
  const float* R0;         // [M][S], 0/1
  float* ckpt;             // [R_pad / B][M][S]
  float* final_out;        // [M][S]
  int R_pad, W, S, O1, B, n_pass, counts;
  int rev_mask;            // kByPass: bit p set = pass p in reverse
  int n_gates;
  int gate[kMaxGates];
  int K;                   // nibbles a table holds
  Layout L;
};

inline size_t g_bytes(int W, int S, int g_int8) {
  return (size_t)S * W * S * (g_int8 ? 1 : 4);
}

inline bool f32_warp(int W, int S) {
  return W <= kWarpMaxW && (S == 8 || S == 16);
}

// K6: the warp form at W <= 5 when the tables fit in shared memory
// beside the projection table and a chunk (bool), or at S = 8 and 16
// (f32); the block form keeps the tables in shared memory when they fit
// beside its set, else reads them from device memory.
inline Layout walk_layout(int W, int S, int O1, int rep, int table) {
  const size_t M = (size_t)1 << W;
  const size_t pj = table ? 4 * (size_t)(W + 1) * M * M : 0;
  const size_t chunk = 4 * (size_t)kChunk * (W + 1);
  Layout L{};
  size_t opnd, set;
  if (rep == kBool) {
    opnd = table_bytes(S, O1);
    L.warp = W <= kWarpMaxW && opnd + pj + chunk <= kSmemMax;
    set = L.warp ? 0 : 4 * 2 * M;
    L.t_shared = set + opnd + pj + chunk <= kSmemMax;
    if (!L.t_shared) opnd = 0;
  } else {
    opnd = 4 * (size_t)O1 * S * S;
    L.warp = f32_warp(W, S);
    set = L.warp ? 0 : 4 * 2 * M * S;
  }
  L.opnd = 0;
  L.set = opnd;
  L.pj = L.set + set;
  L.js = L.pj + pj;
  L.ops = L.js + 4 * (size_t)kChunk;
  L.total = L.ops + 4 * (size_t)kChunk * W;
  return L;
}

// K7: the warp form as K6's (bool at W <= 5, f32 at S = 8 and 16). The
// per-return tables when they fit beside two stages, then as many stages
// as fit, up to kRing; one stage when G cannot be bulk-copied.
inline Layout stream_layout(int W, int S, int rep, int g_int8) {
  const size_t M = (size_t)1 << W;
  Layout L{};
  L.gb = g_bytes(W, S, g_int8);
  L.gs = (L.gb + 15) / 16 * 16;
  L.warp = rep == kBool ? W <= kWarpMaxW : f32_warp(W, S);
  L.bulk = L.gb % 16 == 0;
  const size_t set = L.warp ? 0 : 4 * 2 * M * (rep == kBool ? 1 : S);
  const size_t rows = rep == kBool ? 4 * (size_t)W * S : 0;
  const size_t tabs =
      rep == kBool ? 4 * 2 * (size_t)W * n_nibbles(S) * 16 : 0;
  const size_t fixed = 8 * (size_t)kRing + set + rows +
                       4 * (size_t)kStreamChunk;
  L.tables = rep == kBool && fixed + tabs + 2 * L.gs <= kSmemMax;
  const size_t used = fixed + (L.tables ? tabs : 0);
  int n = L.bulk ? kRing : 1;
  while (n > 1 && used + n * L.gs > kSmemMax) --n;
  L.stages = n;
  L.ring = 0;
  L.bar = n * L.gs;
  L.set = L.bar + 8 * (size_t)kRing;
  L.rows = L.set + set;
  L.tabs = L.rows + rows;
  L.js = L.tabs + (L.tables ? tabs : 0);
  L.total = L.js + 4 * (size_t)kStreamChunk;
  return L;
}

// The form and places as one int: warp | t_shared << 1 | tables << 2 |
// bulk << 3 | stages << 4 (the Python wrappers' design() packs the same).
inline int design_code(const Layout& L) {
  return L.warp | L.t_shared << 1 | L.tables << 2 | L.bulk << 3 |
         L.stages << 4;
}

// -- shared pieces ----------------------------------------------------------

template <bool kWarp>
__device__ __forceinline__ void sync_all() {
  if constexpr (kWarp)
    __syncwarp();
  else
    __syncthreads();
}

// Stage ret_slot (and slot_ops, when ops_s) of returns [k, k + chunk)
// into shared memory.
__device__ __forceinline__ void stage_returns(const Ablate& a, int k,
                                              int chunk, int* js_s,
                                              int* ops_s) {
  const int n = min(chunk, a.R_pad - k);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    js_s[i] = a.ret_slot[k + i];
  if (ops_s)
    for (int i = threadIdx.x; i < n * a.W; i += blockDim.x)
      ops_s[i] = a.slot_ops[(size_t)k * a.W + i];
}

// The passes a return of pending count c runs: n_pass, then each gate's
// while c exceeds the passes before it.
__device__ __forceinline__ int pass_count(const Ablate& a, int c) {
  int passes = a.n_pass, off = a.n_pass;
  for (int g = 0; g < a.n_gates; ++g) {
    if (c > off) passes += a.gate[g];
    off += a.gate[g];
  }
  return passes;
}

// Whether pass p merges its slots in reverse.
template <int kOrder>
__device__ __forceinline__ bool reversed(const Ablate& a, int p) {
  if constexpr (kOrder == kFwd) return false;
  if constexpr (kOrder == kRev) return true;
  return p < 32 && ((a.rev_mask >> p) & 1);
}

// PJ [W+1][M][M] into shared memory transposed, PJt[jt][m2][m]: the
// threads of a projection, one a mask, read consecutive words.
__device__ __forceinline__ void load_pj(const Ablate& a, float* PJt) {
  const int M = 1 << a.W, MM = M * M;
  for (int i = threadIdx.x; i < (a.W + 1) * MM; i += blockDim.x) {
    const int jt = i / MM, r = i % MM;
    PJt[jt * MM + (r % M) * M + r / M] = a.PJ[i];
  }
}

// Element i of an operand block: f32, or int8 widened to f32.
template <bool kI8>
__device__ __forceinline__ float g_at(const unsigned char* g, int i) {
  if constexpr (kI8)
    return (float)((const int8_t*)g)[i];
  else
    return ((const float*)g)[i];
}

// Elements i .. i+3 (i a multiple of 4, the block 16-byte aligned in
// f32, 4-byte in int8).
template <bool kI8>
__device__ __forceinline__ float4 g_at4(const unsigned char* g, int i) {
  if constexpr (kI8) {
    const char4 c = *(const char4*)((const int8_t*)g + i);
    return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
  } else {
    return *(const float4*)((const float*)g + i);
  }
}

// -- K7: the ring of bulk copies --------------------------------------------

struct Ring {
  unsigned char* buf;  // stages of gs bytes
  uint64_t* bar;       // one mbarrier a stage
  int n;
  size_t gb, gs;
  int bulk;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ Ring make_ring(const Ablate& a,
                                          unsigned char* smem) {
  return Ring{smem + a.L.ring, (uint64_t*)(smem + a.L.bar), a.L.stages,
              a.L.gb, a.L.gs, a.L.bulk};
}

// One thread: start copying return k's G into stage k % n; the stage's
// mbarrier completes its phase when the bytes have landed.
__device__ __forceinline__ void ring_issue(const Ablate& a, const Ring& r,
                                           int k) {
  if (k >= a.R_pad) return;
  const int s = k % r.n;
  const uint32_t bar = smem_u32(r.bar + s);
  const unsigned char* src = (const unsigned char*)a.G + (size_t)k * r.gb;
  // the stage's last reads (generic proxy) before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"((uint32_t)r.gb)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(r.buf + (size_t)s * r.gs)),
      "l"(src), "r"((uint32_t)r.gb), "r"(bar)
      : "memory");
}

// Initialise the stages' mbarriers and start the first n copies.
template <bool kWarp>
__device__ __forceinline__ void ring_start(const Ablate& a, const Ring& r) {
  if (r.bulk && threadIdx.x == 0) {
    for (int i = 0; i < r.n; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(r.bar + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sync_all<kWarp>();
  if (r.bulk && threadIdx.x == 0)
    for (int k = 0; k < r.n; ++k) ring_issue(a, r, k);
}

// Return k's G in shared memory: wait on its stage's phase (bulk), or
// copy it into the one stage by every thread.
template <bool kWarp>
__device__ __forceinline__ const unsigned char* ring_acquire(
    const Ablate& a, const Ring& r, int k) {
  if (r.bulk) {
    const int s = k % r.n;
    const uint32_t bar = smem_u32(r.bar + s);
    const uint32_t parity = (uint32_t)((k / r.n) & 1);
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    return r.buf + (size_t)s * r.gs;
  }
  // the previous return's reads of the stage are behind a barrier in
  // the block form; the warp form syncs here
  if constexpr (kWarp) __syncwarp();
  const unsigned char* src = (const unsigned char*)a.G + (size_t)k * r.gb;
  if (r.gb % 4 == 0) {
    for (size_t i = threadIdx.x; i < r.gb / 4; i += blockDim.x)
      ((uint32_t*)r.buf)[i] = ((const uint32_t*)src)[i];
  } else {
    for (size_t i = threadIdx.x; i < r.gb; i += blockDim.x)
      r.buf[i] = src[i];
  }
  sync_all<kWarp>();
  return r.buf;
}

// After every thread's last read of return k's stage (behind a sync):
// one thread refills it with return k + n.
__device__ __forceinline__ void ring_release(const Ablate& a, const Ring& r,
                                             int k) {
  if (r.bulk && threadIdx.x == 0) ring_issue(a, r, k + r.n);
}

// K7, bool: return k's G as row words rows[j][s] (the target set of
// state s under slot j), then, with tables, as its nibble image tables
// [W][K][16] in the ring of two at tabs (with K = n_nibbles(S) entries
// of one word, as pack_tables builds P's). Returns the tables, or the
// row words for the masked OR.
template <bool kWarp, bool kI8>
__device__ __forceinline__ const uint32_t* stream_tables(
    const Ablate& a, const Ring& r, int k, uint32_t* rows, uint32_t* tabs,
    int K, int with_tables) {
  const unsigned char* g = ring_acquire<kWarp>(a, r, k);
  const int W = a.W, S = a.S, WS = W * S;
  // row word i = (j, s): the S elements of G's row s in slot j's
  // columns; K nibbles hold S <= 4K states (K is the instance's lookup
  // count in the warp form, so the loads unroll and overlap), four
  // elements a load where S = 4K
  for (int i = threadIdx.x; i < WS; i += blockDim.x) {
    const int j = i / S, s = i % S, at = s * WS + j * S;
    uint32_t w = 0;
    if (S == 4 * K) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float4 v = g_at4<kI8>(g, at + 4 * q);
        w |= (uint32_t)(v.x > 0.5f) << (4 * q) |
             (uint32_t)(v.y > 0.5f) << (4 * q + 1) |
             (uint32_t)(v.z > 0.5f) << (4 * q + 2) |
             (uint32_t)(v.w > 0.5f) << (4 * q + 3);
      }
    } else {
#pragma unroll
      for (int t = 0; t < 4 * K; ++t)
        if (t < S) w |= (uint32_t)(g_at<kI8>(g, at + t) > 0.5f) << t;
    }
    rows[i] = w;
  }
  sync_all<kWarp>();
  ring_release(a, r, k);
  if (!with_tables) return rows;
  uint32_t* tk = tabs + (size_t)(k & 1) * W * K * 16;
  const int n = W * K * 16;
  // the warp form's loop runs a fixed count of rounds, unrolled
  const int rounds = kWarp ? (kWarpMaxW * K * 16 + 31) / 32
                           : (n + blockDim.x - 1) / blockDim.x;
#pragma unroll
  for (int it = 0; it < rounds; ++it) {
    const int e = threadIdx.x + it * blockDim.x;
    if (e >= n) break;
    const int j = e / (K * 16), kn = (e / 16) % K, v = e % 16;
    const uint32_t* rj = rows + j * S + 4 * kn;
    uint32_t acc = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * kn + b < S) acc |= rj[b] & (0u - (uint32_t)((v >> b) & 1));
    tk[e] = acc;
  }
  sync_all<kWarp>();
  return tk;
}

// -- the warp form: bool ----------------------------------------------------

// Mask m's set after one pass from x (lane m's word), the slots in the
// order kRevDir says: slot i of the pass is j = i, or W - 1 - i, and its
// image under the tables at to[i] takes KT lookups (split between the
// pair's lanes at KT = 8, as walk_warp does), gated by bit j of m.
template <int KT, bool kRevDir>
__device__ __forceinline__ uint32_t fire_warp(
    uint32_t x, int m, int W, const uint32_t* const (&to)[kWarpMaxW]) {
  uint32_t acc = x;
#pragma unroll
  for (int i = 0; i < kWarpMaxW; ++i) {
    if (i >= W) break;
    const int b = 1 << (kRevDir ? W - 1 - i : i);
    const int hb = (m & b) != 0;
    const uint32_t other = __shfl_xor_sync(kFull, x, b);
    const uint32_t y[1] = {hb ? other : x};
    uint32_t part[1] = {0u};
    or_part<1, KT>(to[i], hb, y, part);
    if constexpr (kSplit<KT>) part[0] |= __shfl_xor_sync(kFull, part[0], b);
    acc |= part[0] & (0u - (uint32_t)hb);
  }
  return acc;
}

// The projection of return slot js: the table product (M shuffles, PJt
// transposed in shared memory), or the bit move (one shuffle).
template <bool kTable>
__device__ __forceinline__ uint32_t project_warp(uint32_t x, int m, int M,
                                                 int W, int js,
                                                 const float* PJt) {
  if constexpr (kTable) {
    const int jt = js < 0 ? W : js;
    const float* col = PJt + (size_t)jt * M * M + (m < M ? m : 0);
    uint32_t v = 0;
    for (int m2 = 0; m2 < M; ++m2) {
      const uint32_t xm = __shfl_sync(kFull, x, m2);
      const bool on = m < M && col[m2 * M] != 0.f;
      v |= xm & (0u - (uint32_t)on);
    }
    return v;
  } else {
    if (js < 0) return x;
    const int b = 1 << js;
    const uint32_t hi = __shfl_xor_sync(kFull, x, b);
    return (m & b) ? 0u : hi;
  }
}

// One warp, lane m holding mask m's set as one word (lanes m >= M stay
// empty: their partners are lanes >= M too). K6 reads P's tables from
// shared memory; K7 builds each return's tables from its stage.
template <int KT, int kOrder, bool kTable, int kUnroll, bool kStream,
          bool kI8>
__global__ void __launch_bounds__(32) warp_bool(Ablate a) {
  extern __shared__ uint32_t smem_w[];  // walk.cuh's declaration
  unsigned char* smem = (unsigned char*)smem_w;
  const Layout& L = a.L;
  const int W = a.W, S = a.S, M = 1 << W, m = threadIdx.x;
  const uint32_t* T = (const uint32_t*)(smem + L.opnd);
  float* PJt = (float*)(smem + L.pj);
  int* js_s = (int*)(smem + L.js);
  int* ops_s = kStream ? nullptr : (int*)(smem + L.ops);
  uint32_t* rows = (uint32_t*)(smem + L.rows);
  uint32_t* tabs = (uint32_t*)(smem + L.tabs);
  const Ring ring = make_ring(a, smem);
  if constexpr (!kStream)
    copy_tables(a.T, (uint32_t*)(smem + L.opnd), (size_t)a.O1 * KT * 16);
  if constexpr (kTable) load_pj(a, PJt);
  if constexpr (kStream) ring_start<true>(a, ring);
  constexpr int chunk = kStream ? kStreamChunk : kChunk;
  uint32_t x = m < M ? word_of(a.R0 + (size_t)m * S, S) : 0u;
  const size_t MS = (size_t)M * S;
  float* ck = a.ckpt + (size_t)m * S;
  int ck_left = 0;  // returns before the next checkpoint

  for (int k0 = 0; k0 < a.R_pad; k0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u, kk = k % chunk;
      if (kk == 0) {
        __syncwarp();
        stage_returns(a, k, chunk, js_s, ops_s);
        __syncwarp();
      }
      if (ck_left-- == 0) {
        if (m < M)
          for (int t = 0; t < S; ++t) ck[t] = (float)((x >> t) & 1u);
        ck += MS;
        ck_left = a.B - 1;
      }
      // slot i's tables, in the forward and in the reverse order
      const uint32_t* tf[kWarpMaxW];
      const uint32_t* tr[kWarpMaxW];
      int c = 0;
      if constexpr (kStream) {
        const uint32_t* tk =
            stream_tables<true, kI8>(a, ring, k, rows, tabs, KT, 1);
#pragma unroll
        for (int i = 0; i < kWarpMaxW; ++i) {
          tf[i] = tk + (size_t)i * KT * 16;
          tr[i] = tk + (size_t)(i < W ? W - 1 - i : 0) * KT * 16;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kWarpMaxW; ++i) {
          const int o = i < W ? ops_s[kk * W + i] : -1;
          const int q = i < W ? ops_s[kk * W + W - 1 - i] : -1;
          c += o >= 0;
          tf[i] = T + (size_t)(o < 0 ? a.O1 - 1 : o) * KT * 16;
          tr[i] = T + (size_t)(q < 0 ? a.O1 - 1 : q) * KT * 16;
        }
      }
      const int passes = kStream ? a.n_pass : pass_count(a, c);
      for (int p = 0; p < passes; ++p)
        x = reversed<kOrder>(a, p) ? fire_warp<KT, true>(x, m, W, tr)
                                   : fire_warp<KT, false>(x, m, W, tf);
      x = project_warp<kTable>(x, m, M, W, js_s[kk], PJt);
    }
  }
  if (m < M)
    for (int t = 0; t < S; ++t)
      a.final_out[(size_t)m * S + t] = (float)((x >> t) & 1u);
}

// -- the warp form: f32 -----------------------------------------------------

// Lane m's row after one pass from r (its row of NS = S floats): slot i
// (forward) adds, or maxes in, the partner's row through slot i's S x S
// operand block at g[i] (row stride ld elements), read at one address
// for every lane. The two lanes of a pair (m, m ^ 1 << i) both hold the
// bit-clear mask's row and each sums half of its image's states; one
// shuffle a state gives the bit-set lane the other half, and bit i of m
// gates the merge by a select.
template <int NS, int kRep, bool kI8>
__device__ __forceinline__ void fire_f32(
    float (&r)[NS], int m, int W, const unsigned char* const (&g)[kWarpMaxW],
    int ld) {
  constexpr int H = NS / 2;
  float acc[NS];
#pragma unroll
  for (int t = 0; t < NS; ++t) acc[t] = r[t];
#pragma unroll
  for (int i = 0; i < kWarpMaxW; ++i) {
    if (i >= W) break;
    const int b = 1 << i;
    const bool hb = (m & b) != 0;
    const int t0 = hb ? H : 0;  // this lane's half of the states
    float f[H];
#pragma unroll
    for (int t = 0; t < H; ++t) f[t] = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float other = __shfl_xor_sync(kFull, r[s], b);
      const float ys = hb ? other : r[s];
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 v = g_at4<kI8>(g[i], s * ld + t0 + 4 * q);
        f[4 * q] += ys * v.x;
        f[4 * q + 1] += ys * v.y;
        f[4 * q + 2] += ys * v.z;
        f[4 * q + 3] += ys * v.w;
      }
    }
#pragma unroll
    for (int t = 0; t < H; ++t) {
      const float lo = __shfl_xor_sync(kFull, f[t], b);
      const float wl = kRep == kAdd ? acc[t] + lo : fmaxf(acc[t], lo);
      const float wh =
          kRep == kAdd ? acc[H + t] + f[t] : fmaxf(acc[H + t], f[t]);
      acc[t] = hb ? wl : acc[t];
      acc[H + t] = hb ? wh : acc[H + t];
    }
  }
#pragma unroll
  for (int t = 0; t < NS; ++t) r[t] = acc[t];
}

// The f32 projection: the table product (M shuffles a state), or the
// bit move; clamped to 1 with counts.
template <int NS, bool kTable>
__device__ __forceinline__ void project_f32(float (&r)[NS], int m, int M,
                                            int W, int js, const float* PJt,
                                            int counts) {
  if constexpr (kTable) {
    const int jt = js < 0 ? W : js;
    const float* col = PJt + (size_t)jt * M * M + (m < M ? m : 0);
    float v[NS];
#pragma unroll
    for (int t = 0; t < NS; ++t) v[t] = 0.f;
    for (int m2 = 0; m2 < M; ++m2) {
      const float pj = m < M ? col[m2 * M] : 0.f;
#pragma unroll
      for (int t = 0; t < NS; ++t) v[t] += pj * __shfl_sync(kFull, r[t], m2);
    }
#pragma unroll
    for (int t = 0; t < NS; ++t) r[t] = v[t];
  } else if (js >= 0) {
    const int b = 1 << js;
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const float hi = __shfl_xor_sync(kFull, r[t], b);
      r[t] = (m & b) ? 0.f : hi;
    }
  }
  if (counts) {
#pragma unroll
    for (int t = 0; t < NS; ++t) r[t] = fminf(r[t], 1.f);
  }
}

// One warp, lane m holding mask m's row of NS = S floats. K6 reads P as
// f32 from shared memory; K7 reads each return's G from its stage.
template <int NS, int kRep, bool kTable, int kUnroll, bool kStream,
          bool kI8>
__global__ void __launch_bounds__(32) warp_f32(Ablate a) {
  extern __shared__ uint32_t smem_w[];  // walk.cuh's declaration
  unsigned char* smem = (unsigned char*)smem_w;
  const Layout& L = a.L;
  const int W = a.W, M = 1 << W, m = threadIdx.x;
  float* Ps = (float*)(smem + L.opnd);
  float* PJt = (float*)(smem + L.pj);
  int* js_s = (int*)(smem + L.js);
  int* ops_s = kStream ? nullptr : (int*)(smem + L.ops);
  const Ring ring = make_ring(a, smem);
  if constexpr (!kStream)
    for (int i = m; i < a.O1 * NS * NS; i += 32) Ps[i] = a.P[i];
  if constexpr (kTable) load_pj(a, PJt);
  if constexpr (kStream) ring_start<true>(a, ring);
  constexpr int chunk = kStream ? kStreamChunk : kChunk;
  float r[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s)
    r[s] = m < M ? a.R0[(size_t)m * NS + s] : 0.f;
  const size_t MS = (size_t)M * NS;
  float* ck = a.ckpt + (size_t)m * NS;
  int ck_left = 0;

  for (int k0 = 0; k0 < a.R_pad; k0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u, kk = k % chunk;
      if (kk == 0) {
        __syncwarp();
        stage_returns(a, k, chunk, js_s, ops_s);
        __syncwarp();
      }
      if (ck_left-- == 0) {
        if (m < M)
#pragma unroll
          for (int s = 0; s < NS; ++s) ck[s] = r[s];
        ck += MS;
        ck_left = a.B - 1;
      }
      // slot i's operand block and its row stride, in elements
      const unsigned char* g[kWarpMaxW];
      int ld = NS, c = 0;
      if constexpr (kStream) {
        const unsigned char* gk = ring_acquire<true>(a, ring, k);
        ld = W * NS;
#pragma unroll
        for (int i = 0; i < kWarpMaxW; ++i)
          g[i] = gk + (size_t)i * NS * (kI8 ? 1 : 4);
      } else {
#pragma unroll
        for (int i = 0; i < kWarpMaxW; ++i) {
          const int o = i < W ? ops_s[kk * W + i] : -1;
          c += o >= 0;
          g[i] = (const unsigned char*)(Ps + (size_t)(o < 0 ? a.O1 - 1 : o) *
                                                 NS * NS);
        }
      }
      const int passes = kStream ? a.n_pass : pass_count(a, c);
      for (int p = 0; p < passes; ++p) fire_f32<NS, kRep, kI8>(r, m, W, g, ld);
      if constexpr (kStream) {
        __syncwarp();  // every lane's last read of the stage
        ring_release(a, ring, k);
      }
      project_f32<NS, kTable>(r, m, M, W, js_s[kk], PJt, a.counts);
    }
  }
  if (m < M)
#pragma unroll
    for (int s = 0; s < NS; ++s) a.final_out[(size_t)m * NS + s] = r[s];
}

// -- the block form ---------------------------------------------------------

// Bool: R double-buffered [2][M] words in shared memory, a thread a mask
// (looping over the rest), one barrier a pass and one for the
// projection. An image is K table lookups (K6: P's tables in shared or
// device memory; K7: the return's tables), or with K7's masked OR the OR
// of the partner's set states' row words.
template <int kOrder, bool kTable, int kUnroll, bool kStream, bool kI8>
__global__ void __launch_bounds__(kMaxThreads) block_bool(Ablate a) {
  extern __shared__ uint32_t smem_w[];  // walk.cuh's declaration
  unsigned char* smem = (unsigned char*)smem_w;
  const Layout& L = a.L;
  const int W = a.W, S = a.S, M = 1 << W, K = a.K;
  const int tid = threadIdx.x, nt = blockDim.x;
  uint32_t* Rw = (uint32_t*)(smem + L.set);
  float* PJt = (float*)(smem + L.pj);
  int* js_s = (int*)(smem + L.js);
  int* ops_s = kStream ? nullptr : (int*)(smem + L.ops);
  uint32_t* rows = (uint32_t*)(smem + L.rows);
  uint32_t* tabs = (uint32_t*)(smem + L.tabs);
  const Ring ring = make_ring(a, smem);
  const uint32_t* T = a.T;
  if (!kStream && L.t_shared) {
    copy_tables(a.T, (uint32_t*)(smem + L.opnd), (size_t)a.O1 * K * 16);
    T = (const uint32_t*)(smem + L.opnd);
  }
  if constexpr (kTable) load_pj(a, PJt);
  for (int i = tid; i < M; i += nt) Rw[i] = word_of(a.R0 + (size_t)i * S, S);
  if constexpr (kStream) ring_start<false>(a, ring);
  constexpr int chunk = kStream ? kStreamChunk : kChunk;
  const size_t MS = (size_t)M * S;
  int cur = 0;

  for (int k0 = 0; k0 < a.R_pad; k0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u, kk = k % chunk;
      if (kk == 0) {
        __syncthreads();
        stage_returns(a, k, chunk, js_s, ops_s);
        __syncthreads();
      }
      if (k % a.B == 0) {
        float* ck = a.ckpt + (size_t)(k / a.B) * MS;
        for (size_t i = tid; i < MS; i += nt)
          ck[i] = (float)((Rw[cur * M + i / S] >> (i % S)) & 1u);
      }
      const uint32_t* tk = T;  // slot j's tables: tk + opnd(j)
      int c = 0;
      if constexpr (kStream) {
        tk = stream_tables<false, kI8>(a, ring, k, rows, tabs, K, L.tables);
      } else {
        for (int j = 0; j < W; ++j) c += ops_s[kk * W + j] >= 0;
      }
      auto opnd = [&](int j) -> size_t {
        if (kStream) return (size_t)j * K * 16;
        const int o = ops_s[kk * W + j];
        return (size_t)(o < 0 ? a.O1 - 1 : o) * K * 16;
      };
      const int passes = kStream ? a.n_pass : pass_count(a, c);
      for (int p = 0; p < passes; ++p) {
        const bool rev = reversed<kOrder>(a, p);
        const uint32_t* src = Rw + cur * M;
        uint32_t* dst = Rw + (cur ^ 1) * M;
        for (int mm = tid; mm < M; mm += nt) {
          uint32_t acc = src[mm];
          for (int i = 0; i < W; ++i) {
            const int j = rev ? W - 1 - i : i;
            const uint32_t y = src[mm ^ (1 << j)];
            uint32_t img = 0;
            if (!kStream || L.tables) {
              const uint32_t* To = tk + opnd(j);
              for (int kn = 0; kn < K; ++kn)
                img |= To[16 * kn + ((y >> (4 * kn)) & 15u)];
            } else {
              for (int s = 0; s < S; ++s)
                img |= rows[j * S + s] & (0u - ((y >> s) & 1u));
            }
            acc |= img & (0u - (uint32_t)((mm >> j) & 1));
          }
          dst[mm] = acc;
        }
        __syncthreads();
        cur ^= 1;
      }
      const int js = js_s[kk];
      const uint32_t* src = Rw + cur * M;
      uint32_t* dst = Rw + (cur ^ 1) * M;
      for (int mm = tid; mm < M; mm += nt) {
        uint32_t v;
        if constexpr (kTable) {
          const float* col = PJt + (size_t)(js < 0 ? W : js) * M * M + mm;
          v = 0u;
          for (int m2 = 0; m2 < M; ++m2)
            v |= src[m2] & (0u - (uint32_t)(col[m2 * M] != 0.f));
        } else if (js < 0) {
          v = src[mm];
        } else {
          v = ((mm >> js) & 1) ? 0u : src[mm | (1 << js)];
        }
        dst[mm] = v;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  for (size_t i = tid; i < MS; i += nt)
    a.final_out[i] = (float)((Rw[cur * M + i / S] >> (i % S)) & 1u);
}

// f32: R double-buffered [2][M][S] in shared memory, one thread per
// (mask, state), each element's sum over s from the pass-start set; one
// barrier a pass and one for the projection.
template <int kRep, bool kTable, int kUnroll, bool kStream, bool kI8>
__global__ void __launch_bounds__(kMaxThreads) block_f32(Ablate a) {
  extern __shared__ uint32_t smem_w[];  // walk.cuh's declaration
  unsigned char* smem = (unsigned char*)smem_w;
  const Layout& L = a.L;
  const int W = a.W, S = a.S, M = 1 << W;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nE = M * S;
  float* Ps = (float*)(smem + L.opnd);
  float* Rf = (float*)(smem + L.set);
  float* PJt = (float*)(smem + L.pj);
  int* js_s = (int*)(smem + L.js);
  int* ops_s = kStream ? nullptr : (int*)(smem + L.ops);
  const Ring ring = make_ring(a, smem);
  if constexpr (!kStream)
    for (int i = tid; i < a.O1 * S * S; i += nt) Ps[i] = a.P[i];
  if constexpr (kTable) load_pj(a, PJt);
  for (int e = tid; e < nE; e += nt) Rf[e] = a.R0[e];
  if constexpr (kStream) ring_start<false>(a, ring);
  constexpr int chunk = kStream ? kStreamChunk : kChunk;
  int cur = 0;

  for (int k0 = 0; k0 < a.R_pad; k0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u, kk = k % chunk;
      if (kk == 0) {
        __syncthreads();
        stage_returns(a, k, chunk, js_s, ops_s);
        __syncthreads();
      }
      if (k % a.B == 0) {
        float* ck = a.ckpt + (size_t)(k / a.B) * nE;
        for (int i = tid; i < nE; i += nt) ck[i] = Rf[cur * nE + i];
      }
      // slot j's operand block (element (s, t) at s * ld + t from it)
      const unsigned char* gk = (const unsigned char*)Ps;
      int ld = S, c = 0;
      if constexpr (kStream) {
        gk = ring_acquire<false>(a, ring, k);
        ld = W * S;
      } else {
        for (int j = 0; j < W; ++j) c += ops_s[kk * W + j] >= 0;
      }
      auto opnd = [&](int j) -> int {
        if (kStream) return j * S;
        const int o = ops_s[kk * W + j];
        return (o < 0 ? a.O1 - 1 : o) * S * S;
      };
      const int passes = kStream ? a.n_pass : pass_count(a, c);
      for (int p = 0; p < passes; ++p) {
        const float* src = Rf + cur * nE;
        float* dst = Rf + (cur ^ 1) * nE;
        for (int e = tid; e < nE; e += nt) {
          const int mm = e / S, t = e % S;
          float acc = src[e];
          for (int j = 0; j < W; ++j) {
            if (!((mm >> j) & 1)) continue;
            const float* x = src + (size_t)(mm ^ (1 << j)) * S;
            const int at = opnd(j) + t;
            float f = 0.f;
            for (int s = 0; s < S; ++s) f += x[s] * g_at<kI8>(gk, at + s * ld);
            acc = kRep == kAdd ? acc + f : fmaxf(acc, f);
          }
          dst[e] = acc;
        }
        __syncthreads();
        cur ^= 1;
      }
      const int js = js_s[kk];
      const float* src = Rf + cur * nE;
      float* dst = Rf + (cur ^ 1) * nE;
      for (int e = tid; e < nE; e += nt) {
        const int mm = e / S, t = e % S;
        float v;
        if constexpr (kTable) {
          const float* col = PJt + (size_t)(js < 0 ? W : js) * M * M + mm;
          v = 0.f;
          for (int m2 = 0; m2 < M; ++m2) v += col[m2 * M] * src[m2 * S + t];
        } else if (js < 0) {
          v = src[e];
        } else {
          v = ((mm >> js) & 1) ? 0.f : src[(mm | (1 << js)) * S + t];
        }
        dst[e] = a.counts ? fminf(v, 1.f) : v;
      }
      __syncthreads();
      cur ^= 1;
      // behind a barrier that every thread passed after its wait on the
      // stage (a pass may not have run)
      if constexpr (kStream) ring_release(a, ring, k);
    }
  }
  for (int e = tid; e < nE; e += nt) a.final_out[e] = Rf[cur * nE + e];
}

// -- launching --------------------------------------------------------------

using AblateKernel = void (*)(Ablate);

// Launch one walk of `rep` in the form its layout says on `stream`.
// Returns the CUDA error of the launch (0 when it was accepted).
inline int launch_ablate(AblateKernel kernel, const Ablate& a, int rep,
                         void* stream) {
  const size_t smem = a.L.total;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  long threads = 32;
  if (!a.L.warp) {
    const long n = rep == kBool ? (1L << a.W) : (1L << a.W) * a.S;
    threads = (n + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
  }
  kernel<<<1, (unsigned)threads, smem, (cudaStream_t)stream>>>(a);
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
