// K1: the single-history returns walk over the dense config set
// R[mask, state], as one thread block.
//
// Replaces the Pallas lane kernel of the reference package
// (jepsen_tpu/checkers/reach_lane.py, _make_kernel / _lane_call, with
// its helpers _ladder_fire, _project, reach_pallas._gather_G and
// _one_fire_pass).
//
// The walk itself (what it computes, and the design that keeps its
// serial chain short) is in walk.cuh, whose body K2, K4 and K5 share:
// K1 is the lockstep walk with one lane and one seed group, on P's
// nibble image tables (one pack_tables launch first). At the start of
// every block of B returns the set is written to ckpt[block]; dead[0]
// gets the first return after which the set is empty, or -1, and the
// walk stops there (the caller zeroes ckpt and final, so the
// checkpoints past the death and the final set are the empty sets the
// plain version writes); else the set after the last return goes to
// final.
//
// What bounds it on an H100: neither bytes (the inputs are a few MB)
// nor operations (a pass is K = ceil(S/4) table lookups a slot and
// mask, a few hundred 32-bit operations at S=8, W=5). The limit is the
// serial chain: each return costs up to c_r passes (about 3 on cas
// histories) of a few dependent on-chip loads and warp exchanges. One
// block uses one of the card's 132 SMs; the walk cannot be split across
// blocks without changing the algorithm (chunk-lockstep,
// reach_chunklock.py, changes it).

#include "walk.cuh"

extern "C" {

// Shared memory the walk needs for this geometry, in bytes.
size_t jt_lane_walk_smem(int W, int S, int O1, int use_warp) {
  return lane_smem(W, S, O1, use_warp);
}

// Launch one walk on `stream`. Pointers are device pointers to
// contiguous float32 (P [O1,S,S], R0 [M,S], ckpt [R_pad/B,M,S],
// final [M,S]), int32 (ret_slot [R_pad], slot_ops [R_pad,W], dead [1])
// and uint32 (T [O1,K,16], scratch for P's tables, K = n_nibbles(S))
// data, with M = 2^W, 1 <= W <= 16, 1 <= S <= 32 and R_pad a multiple
// of B. use_warp = 0 runs the block form at every W (to time the two).
// Returns the CUDA error of the launches (0 when they were accepted).
int jt_lane_walk(const void* P, void* T, const void* ret_slot,
                 const void* slot_ops, const void* R0, void* ckpt,
                 void* final_out, void* dead, int R_pad, int W, int S,
                 int O1, int B, int n_pass, int use_warp, void* stream) {
  if (B < 1 || R_pad < 1 || R_pad % B != 0 || dead == nullptr)
    return (int)cudaErrorInvalidValue;
  const Walk a{(const float*)P, (const int*)ret_slot, (const int*)slot_ops,
               (const float*)R0, (float*)ckpt, (float*)final_out, nullptr,
               nullptr, (int*)dead, R_pad, 1, W, S, O1, B, n_pass};
  return launch_walk(a, (uint32_t*)T, dim3(1, 1), use_warp, stream);
}

}  // extern "C"
