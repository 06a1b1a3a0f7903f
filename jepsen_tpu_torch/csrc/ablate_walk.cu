// K6: the ablation walk with the fire operand gathered inside the
// kernel, one thread block.
//
// Replaces the Pallas kernel of the ablation harness
// (tools/ablate_lane.py, make_call, with its pass bodies _fire_bool,
// _fire_bool_rev, _fire_counts_tree, _fire_counts_gs, _fire_maxnc, the
// projections _proj_blend and the _proj_table_np table, and
// reach_pallas._gather_G).
//
// The body (what each variant computes, its forms, and why its
// representation and order are template axes) is in ablate.cuh, shared
// with K7. Here a return's fire operand is indexed by its ops: the bool
// variants read P's nibble image tables, built by one pack_tables launch
// before the walk into T and copied into shared memory where they fit;
// the count variants read P as f32 from shared memory. The return stream
// is staged a chunk at a time.
//
// What bounds it on an H100: neither bytes (a few MB of stream) nor
// operations, but the serial chain of passes of one block on one SM,
// as for K1 (lane_walk.cu). The variants differ in how many passes a
// return runs and in what a pass costs.

#include "ablate.cuh"

namespace {

template <int kOrder, bool kTable, int kUnroll>
AblateKernel bool_kernel(const Ablate& a) {
  if (!a.L.warp) return block_bool<kOrder, kTable, kUnroll, false, false>;
  switch (a.K) {
    case 1: return warp_bool<1, kOrder, kTable, kUnroll, false, false>;
    case 2: return warp_bool<2, kOrder, kTable, kUnroll, false, false>;
    case 4: return warp_bool<4, kOrder, kTable, kUnroll, false, false>;
    default: return warp_bool<8, kOrder, kTable, kUnroll, false, false>;
  }
}

template <int kRep, bool kTable, int kUnroll>
AblateKernel f32_kernel(const Ablate& a) {
  if (!a.L.warp) return block_f32<kRep, kTable, kUnroll, false, false>;
  return a.S == 16 ? warp_f32<16, kRep, kTable, kUnroll, false, false>
                   : warp_f32<8, kRep, kTable, kUnroll, false, false>;
}

template <bool kTable, int kUnroll>
AblateKernel by_body(const Ablate& a, int rep, int order) {
  if (rep == kAdd) return f32_kernel<kAdd, kTable, kUnroll>(a);
  if (rep == kMax) return f32_kernel<kMax, kTable, kUnroll>(a);
  if (order == kRev) return bool_kernel<kRev, kTable, kUnroll>(a);
  if (order == kByPass) return bool_kernel<kByPass, kTable, kUnroll>(a);
  return bool_kernel<kFwd, kTable, kUnroll>(a);
}

template <bool kTable>
AblateKernel by_unroll(const Ablate& a, int rep, int order, int unroll) {
  return unroll == 2 ? by_body<kTable, 2>(a, rep, order)
                     : by_body<kTable, 1>(a, rep, order);
}

}  // namespace

extern "C" {

// Shared memory one walk needs, in bytes (rep: 0 bool, 1 add, 2 max).
size_t jt_ablate_walk_smem(int W, int S, int O1, int rep, int table) {
  return walk_layout(W, S, O1, rep, table).total;
}

// The walk's form and table place (design_code in ablate.cuh: bit 0 the
// warp form, bit 1 P's tables in shared memory).
int jt_ablate_walk_design(int W, int S, int O1, int rep, int table) {
  return design_code(walk_layout(W, S, O1, rep, table));
}

// Launch one walk on `stream`: first pack_tables (bool), then the walk.
// Device pointers to contiguous int32 ret_slot [R_pad] and slot_ops
// [R_pad, W], float32 P [O1, S, S], PJ [W+1, M, M], R0 [M, S],
// ckpt [R_pad/B, M, S], final [M, S], with M = 2^W and R_pad a multiple
// of B, and uint32 T [O1, K, 16] (scratch for P's tables, K =
// n_nibbles(S); bool only, else null). rep: 0 bool (S <= 32), 1 add,
// 2 max; order: 0 forward, 1 reversed, 2 by pass from rev_mask (bool
// only); gates: n_gates (<= 8) deep-pass counts, read from host memory;
// unroll 1 or 2 (B a multiple of it). Returns the CUDA error of the
// launches (0 when they were accepted).
int jt_ablate_walk(const void* ret_slot, const void* slot_ops, const void* P,
                   void* T, const void* PJ, const void* R0, void* ckpt,
                   void* final_out, int R_pad, int W, int S, int O1, int B,
                   int n_pass, const int* gates, int n_gates, int rep,
                   int order, int rev_mask, int table, int counts,
                   int unroll, void* stream) {
  Ablate a{};
  a.ret_slot = (const int*)ret_slot;
  a.slot_ops = (const int*)slot_ops;
  a.P = (const float*)P;
  a.T = (const uint32_t*)T;
  a.PJ = (const float*)PJ;
  a.R0 = (const float*)R0;
  a.ckpt = (float*)ckpt;
  a.final_out = (float*)final_out;
  a.R_pad = R_pad;
  a.W = W;
  a.S = S;
  a.O1 = O1;
  a.B = B;
  a.n_pass = n_pass;
  a.counts = counts;
  a.rev_mask = rev_mask;
  a.n_gates = n_gates;
  if (n_gates < 0 || n_gates > kMaxGates) return (int)cudaErrorInvalidValue;
  for (int g = 0; g < n_gates; ++g) a.gate[g] = gates[g];
  if (!valid(a, rep) || (unroll != 1 && unroll != 2) || B % unroll != 0 ||
      order < kFwd || order > kByPass || (rep != kBool && order != kFwd) ||
      (rep == kBool && T == nullptr))
    return (int)cudaErrorInvalidValue;
  a.K = n_nibbles(S);
  a.L = walk_layout(W, S, O1, rep, table);
  if (rep == kBool) {
    const int err = launch_tables(a.P, (uint32_t*)T, O1, S, stream);
    if (err != 0) return err;
  }
  const AblateKernel kernel = table ? by_unroll<true>(a, rep, order, unroll)
                                    : by_unroll<false>(a, rep, order, unroll);
  return launch_ablate(kernel, a, rep, stream);
}

}  // extern "C"
