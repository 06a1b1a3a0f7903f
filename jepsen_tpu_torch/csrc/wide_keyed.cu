// K5: many keys' returns walks at any number of states, concatenated
// into one flat stream — the `independent` checker's batch when the
// union of the keys' alphabets has more than 32 states (beyond K3).
//
// Replaces the first-generation keyed Pallas kernel of the reference
// package (jepsen_tpu/checkers/reach_pallas.py, _keyed_call /
// _make_keyed_kernel).
//
// What it computes: key k's returns are the run [lo[k], hi[k]) of the
// flat stream (ret_slot [N], slot_ops [N, W]). Its walk starts from the
// one-hot seed (mask 0, state 0), runs walk.cuh's passes and
// projection, and dead[k] gets the flat index of the first return
// after which the key's set is empty, or -1. The TPU kernel walks the
// keys one after another, resetting its set at each key's first
// return; the keys are independent, so here each key is a block: one
// warp with the set in registers for at most 5 slots and 256 states
// (the independent suite has 4 slots), else walk.cuh's block form.
//
// What bounds it on an H100: each key's serial chain (tens of returns
// at the independent suite's 50 ops a key, each a few passes of
// nibble-table lookups) and each block's set-up (the image tables into
// shared memory when they fit), spread over 132 SMs. Above shared
// memory the blocks share the tables through the L2.

#include "wide_walk.cuh"

extern "C" {

// Launch K key walks on `stream`. Pointers are device pointers to
// contiguous float32 (P [O1,S,S]), int32 (ret_slot [N], slot_ops [N,W],
// lo [K], hi [K], dead [K]) and uint32 (T, scratch for the image tables,
// as in jt_wide_walk) data, with 1 <= W <= 20. Returns the CUDA error
// of the launches (0 when they were accepted).
int jt_wide_keyed(const void* P, void* T, const void* ret_slot,
                  const void* slot_ops, const void* lo, const void* hi,
                  void* dead, int K, int W, int S, int O1, void* stream) {
  const Walk a{(const float*)P, (const int*)ret_slot, (const int*)slot_ops,
               nullptr, nullptr, nullptr, (const int*)lo, (const int*)hi,
               (int*)dead, 0, 1, W, S, O1, 1, W};
  return launch_wide<true>(a, 0, (uint32_t*)T, K, stream);
}

}  // extern "C"
