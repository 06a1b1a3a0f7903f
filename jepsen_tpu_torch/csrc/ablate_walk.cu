// K6: the ablation walk with the fire operand gathered inside the
// kernel, one thread block.
//
// Replaces the Pallas kernel of the ablation harness
// (tools/ablate_lane.py, make_call, with its pass bodies _fire_bool,
// _fire_bool_rev, _fire_counts_tree, _fire_counts_gs, _fire_maxnc, the
// projections _proj_blend and the _proj_table_np table, and
// reach_pallas._gather_G).
//
// The body (what each variant computes, and why its representation and
// order are template axes) is in ablate.cuh, shared with K7. Here P sits
// in shared memory for the whole walk (as 32-bit target-set words for
// the bool variants, as f32 for the count variants), so gathering a
// return's fire operand is indexing P by its ops; the return stream is
// staged a chunk at a time.
//
// What bounds it on an H100: neither bytes (a few MB of stream) nor
// operations, but the serial chain of passes of one block on one SM,
// as for K1 (lane_walk.cu). The variants differ in how many passes a
// return runs and in what a pass costs.

#include "ablate.cuh"

namespace {

template <int kRep, int kOrder, bool kTable>
int by_unroll(const Ablate& a, int unroll, void* stream) {
  if (unroll == 2) return launch<kRep, kOrder, kTable, 2, false, false>(a, stream);
  return launch<kRep, kOrder, kTable, 1, false, false>(a, stream);
}

template <int kRep, int kOrder>
int by_table(const Ablate& a, int table, int unroll, void* stream) {
  return table ? by_unroll<kRep, kOrder, true>(a, unroll, stream)
               : by_unroll<kRep, kOrder, false>(a, unroll, stream);
}

}  // namespace

extern "C" {

// Shared memory one walk needs, in bytes (rep: 0 bool, 1 add, 2 max).
size_t jt_ablate_walk_smem(int W, int S, int O1, int rep, int table) {
  return layout(W, S, O1, rep, table, 0, 0).total;
}

// Launch one walk on `stream`. Device pointers to contiguous int32
// ret_slot [R_pad] and slot_ops [R_pad, W], and float32 P [O1, S, S],
// PJ [W+1, M, M], R0 [M, S], ckpt [R_pad/B, M, S], final [M, S], with
// M = 2^W and R_pad a multiple of B. rep: 0 bool (S <= 32), 1 add, 2 max;
// order: 0 forward, 1 reversed, 2 by pass from rev_mask (bool only);
// gates: n_gates (<= 8) deep-pass counts, read from host memory;
// unroll 1 or 2 (B a multiple of it). Returns the CUDA error of the
// launch (0 when it was accepted).
int jt_ablate_walk(const void* ret_slot, const void* slot_ops, const void* P,
                   const void* PJ, const void* R0, void* ckpt,
                   void* final_out, int R_pad, int W, int S, int O1, int B,
                   int n_pass, const int* gates, int n_gates, int rep,
                   int order, int rev_mask, int table, int counts,
                   int unroll, void* stream) {
  Ablate a{(const int*)ret_slot, (const int*)slot_ops, (const float*)P,
           (const float*)PJ, nullptr, (const float*)R0, (float*)ckpt,
           (float*)final_out, R_pad, W, S, O1, B, n_pass, counts,
           rev_mask, n_gates, {}};
  if (n_gates < 0 || n_gates > kMaxGates) return (int)cudaErrorInvalidValue;
  for (int g = 0; g < n_gates; ++g) a.gate[g] = gates[g];
  if (!valid(a, rep) || (unroll != 1 && unroll != 2) || B % unroll != 0 ||
      order < kFwd || order > kByPass || (rep != kBool && order != kFwd))
    return (int)cudaErrorInvalidValue;
  if (rep == kAdd) return by_table<kAdd, kFwd>(a, table, unroll, stream);
  if (rep == kMax) return by_table<kMax, kFwd>(a, table, unroll, stream);
  if (order == kRev) return by_table<kBool, kRev>(a, table, unroll, stream);
  if (order == kByPass)
    return by_table<kBool, kByPass>(a, table, unroll, stream);
  return by_table<kBool, kFwd>(a, table, unroll, stream);
}

}  // extern "C"
