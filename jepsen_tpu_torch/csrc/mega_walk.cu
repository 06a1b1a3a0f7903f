// K10: the mega-group advance of many streaming sessions' carried sets
// in one launch, a block a session (a lane).
//
// Replaces the reference package's batched word walk of a mega-group
// (jepsen_tpu/checkers/reach_word.py:249 _jitted_walk_words_mega, a vmap
// of _walk_words over the session axis, launched by
// launch_frontiers_mega), an XLA program rather than a Pallas kernel.
// The port's carries are K1 and K4 carries (checkers/reach.py
// FrontierCarry), so the group advance is their walk, walk.cuh's, with
// a lane axis whose lanes share a geometry and nothing else.
//
// What it computes: for each lane i of L, with its own nibble image
// tables T_i (built once when its carry was seeded, never here), its own
// set R_i f32 [M, S] and its own block of n_i returns, the walk of
// walk.cuh from R_i with n_pass = W (exact: each return runs to its
// pass's fixpoint), its final set, written to the lane's out buffer
// (apart from R_i), and the first of its own returns after which the set
// is empty, or -1. A lane that dies stops there, so its final set is the
// empty set. The lanes' returns are ragged, back to back: lane i's are
// [off[i], off[i + 1]) of the stream; in the padded layout of the plain
// version, the returns past n_i up to the group's longest (R_pad) are
// identity steps (ret_slot = -1, every op -1), which change nothing, so
// the walk ends at n_i.
//
// What bounds it on an H100: the serial chain of one lane's returns, as
// in K1 and K4 (a return's passes, each a round of independent table
// lookups, then a projection), spread over up to 1,024 independent
// blocks on 132 SMs; the bytes it must move (the real returns, the
// named ops' table rows, the sets) are a few MB, microseconds at 3.35
// TB/s. The design, for Hopper:
//   - each lane's operands come from a descriptor row (tables, set, out)
//     that the host made once, when the carry was seeded, and a wave's
//     stream and descriptors reach the card in one pinned copy: the
//     host does no per-lane work beyond a pointer and a count;
//   - a block first marks, in a shared bitmap of O1 bits, the ops its
//     own returns name, gives each a slot (the count of named ops below
//     it), fetches only those ops' table slices (K · 16 · NT words each)
//     into shared memory by one cp.async.bulk copy each, completing on
//     one mbarrier, and renames its staged ops to the slots; the copies
//     land while it reads and converts its seed (walk.cuh mega_begin).
//     A lane's whole tables are 8 KB at cas (O1 = 64) and 64-128 KB
//     at 64 states; a block moves only what its walk reads, and the
//     shared memory a launch asks for follows the group's largest count
//     of named ops (the launch's cap), so that more blocks are resident
//     at once;
//   - the stream is staged a chunk of min(R_pad, kChunk) returns at a
//     time, sized to the group's longest block, not to kChunk;
//   - where the compact slices would still leave the lanes in many more
//     rounds than device-memory tables at full residency, the tables
//     stay in device memory (read through L1 and L2): the launch
//     compares the two placements' rounds (mega_design);
//   - the walk itself is walk.cuh's: the narrow forms (K1's route: at
//     most 32 states, one word a mask; a warp a lane for W <= 5, else a
//     block a lane with the set in shared memory) or the wide ones (K4's
//     route: the warp form for W <= 5 and at most 8 words a mask, else
//     the block form);
//   - each kernel instance's attributes are set once per process, not
//     once per launch.

#include <mutex>

#include "wide_walk.cuh"

namespace {

// One instance's attributes, set and read once per process: the largest
// dynamic shared memory any launch may ask for, and the threads its
// registers allow a block.
int instance_threads(TableKernel k, int* max_threads) {
  struct Seen {
    TableKernel k;
    int max_threads;
  };
  static std::mutex mu;
  static Seen seen[64];
  static int n_seen = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].k == k) {
      *max_threads = seen[i].max_threads;
      return 0;
    }
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  if (n_seen == 64) return (int)cudaErrorInvalidValue;
  seen[n_seen++] = Seen{k, attr.maxThreadsPerBlock};
  *max_threads = attr.maxThreadsPerBlock;
  return 0;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

// A wave's launch: its instance, form, table place, threads, shared
// memory and staging, and the blocks an SM holds at once.
struct MegaDesign {
  TableKernel k;
  bool warp, shared;
  int threads, chunk, stage_w, blocks_per_sm;
  size_t smem;
};

inline size_t mega_smem(int W, int S, int O1, bool warp, int stage_w,
                        int cap, bool shared) {
  const size_t set = warp ? 0 : 2 * ((size_t)1 << W) * n_words(S);
  const size_t slices =
      shared ? (size_t)cap * n_nibbles(S) * 16 * table_words(S) : 0;
  return 4 * (4 + slices + set + stage_w + 2 * (size_t)((O1 + 31) / 32));
}

template <bool kShared>
TableKernel mega_kernel(bool narrow, int S, bool warp) {
  return narrow ? table_kernel<kShared, false, false, true, true>(S, warp)
                : table_kernel<kShared, false, false, false, true>(S, warp);
}

// How many times the rounds of resident blocks the shared slices may take
// against device-memory tables and still be picked: a lookup in device
// memory (through L1 and L2) costs several shared ones, so on an H100 at
// 1,024 lanes the slices in 2 rounds (64-state lanes, 4 blocks a SM)
// beat device memory in 1, and in 8 rounds (O1 = 128, 1 block a SM) lose
// to it (chip_smoke.py phase_k10, PERF.md).
constexpr long long kRoundsShared = 2;

// The design of a wave of L lanes whose longest block has R_pad returns
// and at most `cap` named ops a lane. place: 0 picks (the shared slices
// where they fit, unless they would take more than kRoundsShared times
// the rounds of resident blocks that device-memory tables take), 1 asks
// for the shared slices, 2 for device memory.
int mega_design(int L, int R_pad, int W, int S, int O1, bool narrow,
                int cap, int place, MegaDesign* d) {
  d->warp = narrow ? warp_form(W, 1) : wide_warp_form(W, S);
  d->chunk = R_pad < 1 ? 1 : (R_pad < kChunk ? R_pad : kChunk);
  const int sw = d->chunk * (W + 1);
  const int fin = 32 * table_words(S);
  d->stage_w = d->warp && fin > sw ? fin : sw;
  MegaDesign alt[2];
  for (int sh = 0; sh < 2; ++sh) {
    MegaDesign& x = alt[sh];
    x = *d;
    x.shared = sh == 1;
    x.smem = mega_smem(W, S, O1, x.warp, x.stage_w, cap, x.shared);
    x.k = x.shared ? mega_kernel<true>(narrow, S, x.warp)
                   : mega_kernel<false>(narrow, S, x.warp);
    int max_threads = 0;
    const int err = instance_threads(x.k, &max_threads);
    if (err != 0) return err;
    x.threads = 32;
    if (!x.warp) {
      // a thread a (mask, word) pair, as many as the instance's registers
      // let one block launch (the block form's loops stride by blockDim.x)
      x.threads = ((1 << W) * n_words(S) + 31) / 32 * 32;
      const int capped = max_threads / 32 * 32;
      if (x.threads > capped) x.threads = capped;
    }
    x.blocks_per_sm = 0;
    if (x.smem <= kSmemMax &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &x.blocks_per_sm, x.k, x.threads, x.smem) != cudaSuccess)
      return (int)cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  auto rounds = [&](const MegaDesign& x) {
    const long long at_once = (long long)x.blocks_per_sm * sms;
    return at_once > 0 ? (L + at_once - 1) / at_once : (long long)1 << 40;
  };
  bool shared;
  if (place == 1)
    shared = true;
  else if (place == 2)
    shared = false;
  else
    shared = alt[1].smem <= kSmemMax && alt[1].blocks_per_sm > 0 &&
             rounds(alt[1]) <= kRoundsShared * rounds(alt[0]);
  *d = alt[shared ? 1 : 0];
  if (d->smem > kSmemMax || d->blocks_per_sm < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

bool mega_args_ok(int L, int R_pad, int W, int S, int O1, int narrow,
                  int cap) {
  return L >= 1 && R_pad >= 0 && W >= 1 && S >= 1 && O1 >= 1 && cap >= 0 &&
         W <= (narrow ? kMaxW : kWideMaxW) && !(narrow && S > 32);
}

}  // namespace

extern "C" {

// Launch one wave of L lanes on `stream`. Device pointers: desc int64
// [L, 5] (lane i's tables', set's and out's addresses; its op count and
// geometry, which the host reads), off int32 [L + 1] (lane i's returns
// are [off[i], off[i + 1]) of the stream), ret_slot int32 [N], slot_ops
// int32 [N, W], dead int32 [L]. Each lane's tables are uint32 [O1, K,
// 16, NT] as pack_tables builds them (K = n_nibbles(S), NT =
// table_words(S)), 16-byte aligned, and its set and out float32 [M, S]
// with M = 2^W. R_pad is the longest lane's count, cap the most ops a
// lane's returns may name, place as in mega_design. narrow = 1 takes
// K1's forms (S <= 32, W <= 16), 0 K4's (W <= 20). With ev0 and ev1
// (CUDA events, the caller's) they are recorded on `stream` right
// around the launch, so that their interval is the kernel's alone.
// Returns the CUDA error of the launch (0 when it was accepted).
int jt_mega_walk(const void* desc, const void* off, const void* ret_slot,
                 const void* slot_ops, void* dead, int L, int R_pad, int W,
                 int S, int O1, int narrow, int cap, int place, void* stream,
                 void* ev0, void* ev1) {
  if (!mega_args_ok(L, R_pad, W, S, O1, narrow, cap))
    return (int)cudaErrorInvalidValue;
  MegaDesign d;
  int err = mega_design(L, R_pad, W, S, O1, narrow, cap, place, &d);
  if (err != 0) return err;
  const Walk a{nullptr, (const int*)ret_slot, (const int*)slot_ops,
               nullptr, nullptr, nullptr, nullptr, nullptr,
               (int*)dead, R_pad, 1, W, S, O1, 1, W};
  TableWalk g{a, nullptr, n_words(S), n_nibbles(S), table_words(S), 0};
  g.mega = TableWalk::Mega{(const long long*)desc, (const int*)off, cap,
                           d.chunk, d.stage_w};
  cudaStream_t st = (cudaStream_t)stream;
  if (ev0 != nullptr &&
      (err = (int)cudaEventRecord((cudaEvent_t)ev0, st)) != 0)
    return err;
  d.k<<<dim3(L), d.threads, d.smem, st>>>(g);
  err = (int)cudaGetLastError();
  if (err == 0 && ev1 != nullptr)
    err = (int)cudaEventRecord((cudaEvent_t)ev1, st);
  return err;
}

// The design jt_mega_walk would launch: out[0] 1 for the shared slices,
// 0 for device memory; out[1] threads a block; out[2] dynamic shared
// memory, bytes; out[3] blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); out[4] the SMs;
// out[5] the warp form (1) or the block form (0); out[6] the chunk of
// returns staged at a time. Returns a CUDA error, 0 on success.
int jt_mega_design(int L, int R_pad, int W, int S, int O1, int narrow,
                   int cap, int place, int* out) {
  if (!mega_args_ok(L, R_pad, W, S, O1, narrow, cap))
    return (int)cudaErrorInvalidValue;
  MegaDesign d;
  const int err = mega_design(L, R_pad, W, S, O1, narrow, cap, place, &d);
  if (err != 0) return err;
  out[0] = d.shared;
  out[1] = d.threads;
  out[2] = (int)d.smem;
  out[3] = d.blocks_per_sm;
  out[4] = sm_count();
  out[5] = d.warp;
  out[6] = d.chunk;
  return 0;
}

}  // extern "C"

namespace {

// One warp chases a pointer through shared memory: lane 0's clock64()
// cycles over `steps` dependent loads, the round trip of one lookup.
__global__ void smem_chase(int steps, long long* cycles, int* sink) {
  __shared__ int ring[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    ring[i] = (i * 33 + 1) & 1023;
  __syncwarp();
  int p = threadIdx.x;
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) p = ring[p];
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    *cycles = t1 - t0;
    *sink = p;
  }
}

}  // namespace

extern "C" {

// The round trip of one shared-memory load on this card: *cycles per
// dependent load, from one warp's chase of `steps` loads (a device
// buffer of two words is the caller's: scratch), and *ns at the card's
// SM clock rate (cudaDevAttrClockRate). Synchronises. Returns a CUDA
// error, 0 on success.
int jt_smem_round_trip(int steps, void* scratch, float* cycles, float* ns) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  long long* c = (long long*)scratch;
  smem_chase<<<1, 32>>>(steps, c, (int*)(c + 1));
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  long long host = 0;
  if ((err = (int)cudaMemcpy(&host, c, sizeof host,
                             cudaMemcpyDeviceToHost)) != 0)
    return err;
  int dev = 0, khz = 0;
  if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
  if ((err = (int)cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev)) !=
      0)
    return err;
  *cycles = (float)host / steps;
  *ns = *cycles / (khz * 1e-6f);
  return 0;
}

}  // extern "C"
