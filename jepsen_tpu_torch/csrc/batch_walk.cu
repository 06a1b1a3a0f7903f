// K2: H independent returns walks in lockstep, each lane's rows split
// into E seed groups — the kernel of chunk-lockstep's two phases
// (reach_chunklock.py) and of walk_returns_batch (reach_batch.py).
//
// Replaces the Pallas lockstep batch kernel of the reference package
// (jepsen_tpu/checkers/reach_batch.py, _batch_call / _make_batch_kernel,
// with its helpers _one_fire_pass_b, _ladder_fire_b and _gather_G_b).
//
// What it computes: the sets R0 [E*M, H*S] hold lane h in columns
// h*S .. h*S+S-1 and, within a lane, seed group e in rows
// e*M .. e*M+M-1 (M = 2^W). Every lane walks its own return stream
// (slot_ops[(k*H + h)*W + j], ret_slot_rh[k*H + h]) over each of its
// groups: per step, fire passes and then the projection on the lane's
// returning slot (-1: identity), as in walk.cuh. The set at the start
// of every block of B steps goes to ckpt[R_pad/B, E*M, H*S], the set
// after the last step to final[E*M, H*S].
//
// The TPU kernel fills its matrix unit by stacking the lanes into one
// block-diagonal product; here the lanes, and the seed groups inside a
// lane, are independent walks, so each (h, e) is one thread block
// running walk.cuh's walk over its strided rows and columns, on P's
// nibble image tables, built once by a pack_tables launch and copied
// into each block's shared memory when they fit there (else read from
// device memory). Fire and projection only flip bits below W of
// a row index, so they never cross from one seed group into the next.
//
// Per-lane gating. The TPU kernel runs max(1, min(pendmax_k, n_pass))
// passes at step k for every lane, pendmax_k the largest pending count
// over the lanes; each block here runs min(c_h, n_pass) for its own
// lane's count c_h, and stops a return's passes after the first pass
// that adds nothing. The sets are bit-identical, by walk.cuh's fixpoint
// argument: Jacobi passes close a lane with c pending ops in c passes
// (a config reached through a chain of distinct pending ops is in after
// as many passes as the chain is long) and further passes change
// nothing; when c_h >= n_pass both gates run n_pass passes, and with
// c_h = 0 a pass is the identity. The plain version
// (reach_batch.batch_walk_plain) follows the reference's batch-max gate
// literally, and chip_smoke.py holds this kernel against it bit for
// bit.
//
// What bounds it on an H100: as for K1, each walk's serial chain, not
// bytes or operations. With H*E blocks (256 in chunk-lockstep's phase B
// at cas-100k) the chain is as long as one lane's stream, not the
// history's.

#include "walk.cuh"

extern "C" {

// Launch the H x E walks on `stream`. Pointers are device pointers to
// contiguous float32 (P [O1,S,S], R0 [E*M,H*S], ckpt [R_pad/B,E*M,H*S],
// final [E*M,H*S]), int32 (ret_slot_rh [R_pad,H], slot_ops [R_pad,H,W])
// and uint32 (T [O1,K,16], scratch for P's tables, as jt_lane_walk
// takes it) data, with M = 2^W, 1 <= W <= 16, 1 <= S <= 32 and R_pad a
// multiple of B. use_warp = 0 runs the block form at every W. Returns
// the CUDA error of the launches (0 when they were accepted).
int jt_batch_walk(const void* P, void* T, const void* ret_slot_rh,
                  const void* slot_ops, const void* R0, void* ckpt,
                  void* final_out, int R_pad, int H, int E, int W, int S,
                  int O1, int B, int n_pass, int use_warp, void* stream) {
  if (B < 1 || R_pad < 1 || R_pad % B != 0 || E < 1)
    return (int)cudaErrorInvalidValue;
  const Walk a{(const float*)P, (const int*)ret_slot_rh,
               (const int*)slot_ops, (const float*)R0, (float*)ckpt,
               (float*)final_out, nullptr, nullptr, nullptr, R_pad, H, W,
               S, O1, B, n_pass};
  return launch_walk(a, (uint32_t*)T, dim3(H, E), use_warp, stream);
}

}  // extern "C"
