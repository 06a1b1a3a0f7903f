// K3: many keys' returns walks, concatenated into one flat stream — the
// kernel of the `independent` checker's batch (reach.check_many) when
// the union of the keys' alphabets has at most 32 states.
//
// Replaces the Pallas keyed kernel of the reference package
// (jepsen_tpu/checkers/reach_lane.py, _keyed_call / _make_keyed_kernel).
//
// What it computes: key k's returns are the run [lo[k], hi[k]) of the
// flat stream (ret_slot [N], slot_ops [N, W]). Its walk starts from the
// one-hot seed (mask 0, state 0) and runs walk.cuh's fire passes (up to
// min(c_r, n_pass) a return, stopping at the fixpoint) and projection;
// dead[k] gets the flat index of the first return after which the
// key's set is empty, or -1. An empty set stays empty, so the walk
// stops there. A key with no returns reports -1.
//
// The TPU kernel walks the keys one after another because a TPU core
// is sequential, resetting its set at each key's first return. The keys
// are independent, so here each key is one thread block, running
// walk.cuh's table body at one word a mask: one pack_tables launch
// builds P's nibble image tables, which each block copies into its
// shared memory when they fit beside the set and a stream chunk (else
// reads from device memory); the set lives in one warp's registers for
// W <= 5 (walk_warp; the independent suite has W = 4), else in the
// block's shared memory (walk_block at the table's lookup count). A
// free slot is skipped by a branch the same in every thread.
//
// What bounds it on an H100: neither bytes nor operations but the
// longest key's serial chain (47 returns at most at the independent
// suite's 50 ops a key, each up to c_r passes of table lookups and warp
// exchanges), plus the pack_tables launch before it. 2,000 keys are one
// wave of one-warp blocks on 132 SMs, so the launch lasts about as long
// as its longest key.

#include "walk.cuh"

extern "C" {

// Shared memory one key's walk needs for this geometry, in bytes: the
// table walk's layout (walk.cuh, walk_smem).
size_t jt_keyed_walk_smem(int W, int S, int O1, int use_warp) {
  return lane_smem(W, S, O1, use_warp);
}

// Launch K key walks on `stream`. Pointers are device pointers to
// contiguous float32 (P [O1,S,S]), int32 (ret_slot [N], slot_ops [N,W],
// lo [K], hi [K], dead [K]) and uint32 (T [O1,K',16], scratch for P's
// tables, K' = n_nibbles(S)) data, with 1 <= W <= 16 and 1 <= S <= 32.
// use_warp = 0 runs the block form at every W. Returns the CUDA error of
// the launches (0 when they were accepted).
int jt_keyed_walk(const void* P, void* T, const void* ret_slot,
                  const void* slot_ops, const void* lo, const void* hi,
                  void* dead, int K, int W, int S, int O1, int n_pass,
                  int use_warp, void* stream) {
  if (K < 1 || W < 1 || W > kMaxW || S < 1 || S > 32 || O1 < 1 ||
      n_pass < 0)
    return (int)cudaErrorInvalidValue;
  const Walk a{(const float*)P, (const int*)ret_slot, (const int*)slot_ops,
               nullptr, nullptr, nullptr, (const int*)lo, (const int*)hi,
               (int*)dead, 0, 1, W, S, O1, 1, n_pass};
  return launch_tabled<true, false, true>(
      TableWalk{a, nullptr, 0, 0, 0, 0}, (uint32_t*)T, dim3(K),
      warp_form(W, use_warp), stream);
}

}  // extern "C"
