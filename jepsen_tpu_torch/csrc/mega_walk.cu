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
// seed R_i f32 [M, S] and its own block of n_i returns, padded to the
// group's longest R_pad with identity steps (ret_slot = -1, every op
// -1: no pass, no projection), the walk of walk.cuh from R_i with
// n_pass = W (exact: each return runs to its pass's fixpoint), its final
// set, and the first of its own returns after which the set is empty,
// or -1. A lane that dies stops there, so its final set is the empty
// set; a death inside the padding cannot happen (an identity step never
// projects) and would not be reported (rlim = n_i).
//
// Each lane's operands are reached through a device array of per-lane
// addresses (tables, seed) and counts, so a wave copies no P and stacks
// no set: its host work is one [L, R_pad] stream and the [L, 3]
// descriptors.
//
// What bounds it on an H100: the serial chain of one lane's returns, as
// in K1 and K4, spread over up to 1,024 independent blocks on 132 SMs.
// The form follows from the group's geometry: the narrow forms (K1's
// route: at most 32 states, one word a mask; a warp a lane for W <= 5,
// else a block a lane with the set in shared memory) or the wide ones
// (K4's route: the warp form for W <= 5 and at most 8 words a mask,
// else the block form), the tables in shared memory when they fit.

#include "wide_walk.cuh"

extern "C" {

// Launch one mega-group walk of L lanes on `stream`. Device pointers:
// lanes int64 [L, 3] (lane i's tables' and seed's addresses, then its
// real returns n_i <= R_pad), ret_slot int32 [L, R_pad], slot_ops int32
// [L, R_pad, W], final float32 [L, M, S], dead int32 [L]. Each lane's
// tables are uint32 [O1, K, 16, NT] as pack_tables builds them (K =
// n_nibbles(S), NT = table_words(S)) and its seed float32 [M, S], with
// M = 2^W. narrow = 1 takes K1's forms (S <= 32, W <= 16), 0 K4's
// (W <= 20). Returns the CUDA error of the launch (0 when it was
// accepted).
int jt_mega_walk(const void* lanes, const void* ret_slot,
                 const void* slot_ops, void* final_out, void* dead, int L,
                 int R_pad, int W, int S, int O1, int narrow, void* stream) {
  if (L < 1 || R_pad < 1 || W < 1 || S < 1 || O1 < 1 ||
      W > (narrow ? kMaxW : kWideMaxW) || (narrow && S > 32))
    return (int)cudaErrorInvalidValue;
  const Walk a{nullptr, (const int*)ret_slot, (const int*)slot_ops,
               nullptr, nullptr, (float*)final_out, nullptr, nullptr,
               (int*)dead, R_pad, 1, W, S, O1, 1, W};
  TableWalk g{a, nullptr, 0, 0, 0, 0, (const long long*)lanes};
  if (narrow)
    return launch_tabled<false, false, true, true>(
        g, nullptr, dim3(L), warp_form(W, 1), stream);
  return launch_tabled<false, false, false, true>(
      g, nullptr, dim3(L), wide_warp_form(W, S), stream);
}

}  // extern "C"
