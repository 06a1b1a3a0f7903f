// K4: the single-history returns walk at any number of states, as one
// warp or one thread block — the route of histories whose model has
// more than 32 states (the lane kernel K1 holds a mask's states in one
// word).
//
// Replaces the first-generation Pallas kernel of the reference package
// (jepsen_tpu/checkers/reach_pallas.py, _walk_call / _make_kernel, with
// its helpers _fire_and_project, _one_fire_pass and _gather_G).
//
// What it computes: the walk of walk.cuh from the seed R0 over
// returns [0, R), then the final set, and the first return r < rlim
// after which the set is empty (-1 if none). The reference finds that
// return exactly; so does this kernel (no checkpoints, no refinement).
//
// What bounds it on an H100: neither bytes (P is 12 MB of floats at the
// widest cas alphabet, read once to build its image tables) nor
// operations (a pass is K = ceil(S/4) table lookups a pending slot and
// word), but the serial chain: c_r passes a return, on one SM of 132.
// wide_walk.cuh says what the design does about it: nibble image
// tables, conflict-free in shared memory when they fit, and for at most
// 5 slots and 256 states the set in one warp's registers, with no
// barrier in a pass.

#include "wide_walk.cuh"

extern "C" {

// Shared memory the walk needs for this geometry, in bytes.
size_t jt_wide_walk_smem(int W, int S, int O1) { return wide_smem(W, S, O1); }

// 1 when the walk of this geometry takes the warp form, 0 for the block
// form.
int jt_wide_walk_form(int W, int S) { return wide_warp_form(W, S); }

// Build the image tables of P alone on `stream` (what every launch
// below does first): P is contiguous float32 [O1,S,S] and T uint32
// [O1, K, 16, NT] on the device, K and NT as n_nibbles and table_words.
// Returns the CUDA error of the launch (0 when it was accepted).
int jt_wide_tables(const void* P, void* T, int O1, int S, void* stream) {
  return launch_tables((const float*)P, (uint32_t*)T, O1, S, stream);
}

// Launch one walk on `stream`. Pointers are device pointers to
// contiguous float32 (P [O1,S,S], R0 [M,S], final [M,S]), int32
// (ret_slot [R], slot_ops [R,W], dead [1]) and uint32 (T, scratch for
// the image tables as jt_wide_tables fills it) data, with M = 2^W,
// 1 <= W <= 20 and R >= 0. Returns the CUDA error of the launches (0
// when they were accepted).
int jt_wide_walk(const void* P, void* T, const void* ret_slot,
                 const void* slot_ops, const void* R0, void* final_out,
                 void* dead, int R, int rlim, int W, int S, int O1,
                 void* stream) {
  if (R < 0) return (int)cudaErrorInvalidValue;
  const Walk a{(const float*)P, (const int*)ret_slot, (const int*)slot_ops,
               (const float*)R0, nullptr, (float*)final_out, nullptr,
               nullptr, (int*)dead, R, 1, W, S, O1, 1, W};
  return launch_wide<false>(a, rlim, (uint32_t*)T, 1, stream);
}

}  // extern "C"
