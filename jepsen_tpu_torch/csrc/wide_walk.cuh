// The launch of the returns walk over config sets of any number of
// states, for the two first-generation kernels: K4 (wide_walk.cu, one
// history) and K5 (wide_keyed.cu, many keys' streams concatenated). The
// body is walk.cuh's, which K1 and K2 share.
//
// What one walk computes is what walk.cuh computes, at any S, with
// n_pass = W: min(c_r, W) passes a return, then the projection. The
// TPU kernels (reach_pallas._fire_and_project) run two passes, then
// more while the set's popcount grows, W passes at most; both end at
// the same set, the fixpoint of the pass (walk.cuh, "The fixpoint
// exit"). All values are 0/1, so the result is bit-identical to the
// plain versions. An empty set stays empty (walk.cuh), so the walk
// tests for emptiness after each return that projects and stops at the
// first empty one.
//
// What bounds a walk on an H100: its serial chain, as in walk.cuh.
// Every pass depends on the whole previous set, so each return costs
// up to c_r passes, and a pass costs the images of the partner sets it
// fires. With more than 32 states a mask's set is NW = ceil(S / 32)
// words. The design keeps the chain of a pass short:
//   - P's nibble image tables (walk.cuh: T[o][k][v], NT words an
//     entry, K and NT rounded up to a power of two where the warp form
//     may take S), built once a launch by walk.cuh's pack_tables. At
//     NT = 4 (128-bit lookups) entries v and v + 8 share banks, at most
//     2-way within a quarter warp; at NT = 8 entries v, v + 4, v + 8,
//     v + 12 do, at most 4-way; in the block form at NT >= 32 a warp
//     reads one mask's entry, conflict-free;
//   - the tables go into shared memory when they fit beside the set
//     and a chunk of the stream (multi-register, 21 ops at S = 64:
//     43,008 bytes); else they stay in device memory and are read
//     through L1 and the 50 MB L2 (the cas alphabet of 735 ops at
//     S = 64: 1,505,280 bytes);
//   - a pass that adds no config ends the return's passes (walk.cuh's
//     fixpoint exit), so a return runs as many passes as its longest
//     chain of firings needs, plus one, up to c_r;
//   - the warp form, for W <= 5 and NW <= 8 (M <= 32 masks, S <= 256):
//     one warp a walk, lane m holding mask m's set as NT words in
//     registers (walk.cuh's walk_warp, an instance for each (NT, K) and
//     for tables in shared or device memory; a free slot is skipped, a
//     branch the same in every lane, where K1 and K2 read the
//     sentinel). Firing slot j with 8 lookups or more, the two lanes of
//     a pair (m, m ^ 1 << j) each look up half of the bit-clear mask's
//     image; a pair's exchange, the projection and the partner sets are
//     __shfl_xor_sync, the tests for growth and emptiness __any_sync.
//     There is no __syncthreads at all, and the stream is staged a
//     chunk at a time between __syncwarp;
//   - the block form, for W > 5 or NW > 8 (walk.cuh's walk_block): one
//     thread block a walk, R double-buffered [2][M][NW] words in shared
//     memory, each thread owning (mask, word) pairs and firing every
//     pending slot into its word from the pass-start set, a word's
//     lookups skipping an empty partner word; one __syncthreads_or a
//     pass, which also tells whether the pass grew the set, and one for
//     the projection, which tests emptiness.
// The form follows from the geometry alone (wide_warp_form), before
// the launch. Walks that are independent run as separate blocks: the
// keys of K5.

#pragma once

#include "walk.cuh"

namespace {

inline bool wide_warp_form(int W, int S) {
  return W <= kWarpMaxW && n_words(S) <= kWarpMaxNW;
}
inline size_t wide_smem(int W, int S, int O1) {
  return walk_smem(W, S, O1, wide_warp_form(W, S));
}

// Build the tables into T, then launch `blocks` walks on `stream`: K4
// (kKeyed false, one block; a death at r >= rlim is not reported) or K5.
// Returns the CUDA error of the launches (0 when both were accepted).
template <bool kKeyed>
int launch_wide(const Walk& a, int rlim, uint32_t* T, int blocks,
                void* stream) {
  if (a.W < 1 || a.W > kWideMaxW || a.S < 1 || a.O1 < 1 || a.H != 1 ||
      a.n_pass != a.W || blocks < 1)
    return (int)cudaErrorInvalidValue;
  return launch_tabled<kKeyed, false>(TableWalk{a, nullptr, 0, 0, 0, rlim},
                                      T, dim3(blocks),
                                      wide_warp_form(a.W, a.S), stream);
}

}  // namespace
