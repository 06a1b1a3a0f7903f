// K3: many keys' returns walks, concatenated into one flat stream — the
// kernel of the `independent` checker's batch (reach.check_many).
//
// Replaces the Pallas keyed kernel of the reference package
// (jepsen_tpu/checkers/reach_lane.py, _keyed_call / _make_keyed_kernel).
//
// What it computes: key k's returns are the run [lo[k], hi[k]) of the
// flat stream (ret_slot [N], slot_ops [N, W]). Its walk starts from the
// one-hot seed (mask 0, state 0), runs walk.cuh's first design (P's
// words in shared memory, a loop over a partner's set states): its fire
// passes (the exact ladder: n_pass = W, gated by each return's pending
// count) and projection, and dead[k] gets the flat index of the first
// return after which the key's set is empty, or -1; an empty set stays
// empty, so the walk stops there. A key with no returns reports -1.
//
// The TPU kernel walks the keys one after another because a TPU core
// is sequential, resetting its set at each key's first return. The keys
// are independent, so here each key is one thread block.
//
// What bounds it on an H100: each key's serial chain (tens of returns
// at the independent suite's 50 ops a key) plus the per-block set-up
// (P into shared memory), spread over the card's 132 SMs.

#include "walk.cuh"

extern "C" {

// Shared memory one key's walk needs for this geometry, in bytes: the
// envelope of the three narrow walks.
size_t jt_keyed_walk_smem(int W, int S, int O1, int use_warp) {
  return keyed_smem(W, S, O1, use_warp);
}

// Launch K key walks on `stream`. Pointers are device pointers to
// contiguous float32 (P [O1,S,S]) and int32 (ret_slot [N], slot_ops
// [N,W], lo [K], hi [K], dead [K]) data, with 1 <= W <= 16 and
// 1 <= S <= 32. use_warp = 0 runs keyed_block at every W.
// Returns the CUDA error of the launch (0 when it was accepted).
int jt_keyed_walk(const void* P, const void* ret_slot, const void* slot_ops,
                  const void* lo, const void* hi, void* dead, int K, int W,
                  int S, int O1, int n_pass, int use_warp, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  Walk a{(const float*)P, (const int*)ret_slot, (const int*)slot_ops,
         nullptr, nullptr, nullptr, (const int*)lo, (const int*)hi,
         (int*)dead, 0, 1, W, S, O1, 1, n_pass};
  return launch_keyed(a, dim3(K, 1), use_warp, stream);
}

}  // extern "C"
