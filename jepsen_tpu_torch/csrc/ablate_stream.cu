// K7: the ablation walk with the fire operand pre-gathered for every
// return and streamed from device memory, one thread block.
//
// Replaces the Pallas kernel of the ablation harness's streamed-G
// variant (tools/ablate_lane.py, make_call_stream), where one XLA
// gather builds G [R_pad, S, W*S] for all returns in device memory and
// the Pallas pipeline streams it through the kernel. Here G is built by
// one PyTorch indexing op outside the kernel, in f32 or int8 (widened
// in the kernel, as the reference's astype does), and the kernel stages
// it through a ring of up to kRing bulk copies (cp.async.bulk, one
// mbarrier a stage): the counterpart of the Pallas pipeline, running up
// to that many returns ahead of the walk. The walk body is ablate.cuh's,
// with the blend projection, forward passes and no deep gates, as
// make_call_stream has; the bool variants build each return's nibble
// image tables from its landed stage.
//
// What bounds it on an H100: the serial chain, as for K6; the stream is
// S*W*S values a return (1,280 bytes in f32 at S = 8, W = 5), 105 MB
// for the 81,920 padded returns of the harness's cas-100k history (26 MB
// in int8), read once at a rate far below the card's.

#include "ablate.cuh"

namespace {

template <int kRep, bool kI8>
AblateKernel f32_kernel(const Ablate& a) {
  if (!a.L.warp) return block_f32<kRep, false, 1, true, kI8>;
  return a.S == 16 ? warp_f32<16, kRep, false, 1, true, kI8>
                   : warp_f32<8, kRep, false, 1, true, kI8>;
}

template <bool kI8>
AblateKernel stream_kernel(const Ablate& a, int rep) {
  if (rep == kAdd) return f32_kernel<kAdd, kI8>(a);
  if (rep == kMax) return f32_kernel<kMax, kI8>(a);
  if (!a.L.warp) return block_bool<kFwd, false, 1, true, kI8>;
  switch (a.K) {
    case 1: return warp_bool<1, kFwd, false, 1, true, kI8>;
    case 2: return warp_bool<2, kFwd, false, 1, true, kI8>;
    case 4: return warp_bool<4, kFwd, false, 1, true, kI8>;
    default: return warp_bool<8, kFwd, false, 1, true, kI8>;
  }
}

}  // namespace

extern "C" {

// Shared memory one walk needs, in bytes (rep: 0 bool, 1 add, 2 max).
size_t jt_ablate_stream_smem(int W, int S, int rep, int g_int8) {
  return stream_layout(W, S, rep, g_int8).total;
}

// The walk's design (design_code in ablate.cuh: bit 0 the warp form,
// bit 2 the per-return tables, bit 3 bulk copies, from bit 4 the ring's
// stages).
int jt_ablate_stream_design(int W, int S, int rep, int g_int8) {
  return design_code(stream_layout(W, S, rep, g_int8));
}

// Launch one walk on `stream`. Device pointers to contiguous int32
// ret_slot [R_pad], G [R_pad, S, W*S] (float32, or int8 with g_int8;
// 16-byte aligned), float32 R0 [M, S], ckpt [R_pad/B, M, S] and
// final [M, S], with M = 2^W and R_pad a multiple of B. rep: 0 bool
// (S <= 32), 1 add, 2 max. Returns the CUDA error of the launch (0 when
// it was accepted).
int jt_ablate_stream(const void* ret_slot, const void* G, const void* R0,
                     void* ckpt, void* final_out, int R_pad, int W, int S,
                     int B, int n_pass, int rep, int counts, int g_int8,
                     void* stream) {
  Ablate a{};
  a.ret_slot = (const int*)ret_slot;
  a.G = G;
  a.R0 = (const float*)R0;
  a.ckpt = (float*)ckpt;
  a.final_out = (float*)final_out;
  a.R_pad = R_pad;
  a.W = W;
  a.S = S;
  a.O1 = 1;
  a.B = B;
  a.n_pass = n_pass;
  a.counts = counts;
  if (!valid(a, rep) || ((size_t)G & 15) != 0)
    return (int)cudaErrorInvalidValue;
  a.K = n_nibbles(S);
  a.L = stream_layout(W, S, rep, g_int8);
  // the warp form's bool body always has its tables (W <= 5: they and
  // two stages fit at every S <= 32)
  if (a.L.warp && rep == kBool && !a.L.tables)
    return (int)cudaErrorInvalidValue;
  const AblateKernel kernel =
      g_int8 ? stream_kernel<true>(a, rep) : stream_kernel<false>(a, rep);
  return launch_ablate(kernel, a, rep, stream);
}

}  // extern "C"
