// K7: the ablation walk with the fire operand pre-gathered for every
// return and streamed from device memory, one thread block.
//
// Replaces the Pallas kernel of the ablation harness's streamed-G
// variant (tools/ablate_lane.py, make_call_stream), where one XLA
// gather builds G [R_pad, S, W*S] for all returns in device memory and
// the Pallas pipeline streams it through the kernel. Here G is built by
// one PyTorch indexing op outside the kernel, in f32 or int8 (widened
// in the kernel, as the reference's astype does), and the kernel stages
// G[k + 1] into shared memory with double-buffered cp.async while
// return k's passes run: the counterpart of the Pallas pipeline. (TMA is
// later work.) The walk body is ablate.cuh's, with the blend projection,
// forward passes and no deep gates, as make_call_stream has.
//
// What bounds it on an H100: the serial chain, as for K6; the stream is
// S*W*S values a return (1,280 bytes in f32 at S = 8, W = 5), 105 MB
// for the 81,920 padded returns of the harness's cas-100k history (26 MB
// in int8), read once at a rate far below the card's.

#include "ablate.cuh"

namespace {

template <int kRep>
int by_dtype(const Ablate& a, int g_int8, void* stream) {
  return g_int8 ? launch<kRep, kFwd, false, 1, true, true>(a, stream)
                : launch<kRep, kFwd, false, 1, true, false>(a, stream);
}

}  // namespace

extern "C" {

// Shared memory one walk needs, in bytes (rep: 0 bool, 1 add, 2 max).
size_t jt_ablate_stream_smem(int W, int S, int rep, int g_int8) {
  return layout(W, S, 1, rep, 0, 1, g_int8).total;
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
  Ablate a{(const int*)ret_slot, nullptr, nullptr, nullptr, G,
           (const float*)R0, (float*)ckpt, (float*)final_out, R_pad, W, S,
           1, B, n_pass, counts, 0, 0, {}};
  if (!valid(a, rep) || ((size_t)G & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (rep == kAdd) return by_dtype<kAdd>(a, g_int8, stream);
  if (rep == kMax) return by_dtype<kMax>(a, g_int8, stream);
  return by_dtype<kBool>(a, g_int8, stream);
}

}  // extern "C"
