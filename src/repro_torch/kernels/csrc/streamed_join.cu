// K4: the slave join under merge-on-read, over a materialized driver window,
// and K4p, its packed mode (K5), which probes block-codec words.
//
// Replaces the TPU kernel repro/kernels/posting_intersect.py:
// intersect_batched_streamed (pallas_call at line 958, body _streamed_kernel
// at line 699; its packed=/d_packed= mode at lines 904-945, decode at
// 706-772).  Python side and semantics:
// repro_torch/kernels/posting_intersect.py (streamed_join_cuda and
// streamed_join_packed_cuda, and the plain versions they are held
// against).
//
// What it computes: for each slot of the driver window a_docs (K3's merged
// output) that is valid, live (a_live) and passes the attribute filter,
// and each active term, the slot is a member of the term's logical list
// when it is in the term's main probe range and its doc flags have neither
// DEAD nor SUPERSEDED, or in the term's delta probe range and its flags
// lack DEAD.  The mask is 1 where every active term holds.  The probe
// plans (main at window, delta at cap) come from the skip tables and the
// exact spans of the driver tiles, before the launch.  With has_delta 0
// (the static mode: no delta arrays, no flags; their pointers may be null)
// a slot is a member when it is in the term's main probe range.
//
// What bounds it on the H100: the latency of dependent loads, as K1.  A
// block reads its driver slots (docIDs, attrs, live, flags) and, per
// active term, the planned run of the term's main list (at most window +
// TILE postings) and of its delta slab (at most cap + TILE); the work per
// byte is one binary search of a few steps.  The first design (one block
// per 1024-slot tile, main then delta range staged 2048 postings at a
// time, each chunk a round trip behind two barriers) ran 16-18x its bound.
//
// Design: K1's (probe_async.cuh; the block body, slave_join.cuh, is K7's
// too, with the plan arrays as its DensePlan).  A block owns JOIN_SUB =
// 256 slots of a driver tile; each term is two streams, its main range and its delta
// range (one, the main, in the static mode), staged by bulk copies that
// the producer warp issues with the plan, two rounds in flight, while the
// consumers read the driver.  A slot is searched in a stream only where
// its flags let that stream count.  The TPU kernel's (8,128)
// broadcast-compare and its (Q, A, T, S) sequential grid are not carried
// over.
//
// K4p runs the same body with the codec for the main and delta probes:
// the block reduces its live docIDs' interval, each range is narrowed on
// blk_base, and only the words of the blocks that can match are staged
// and decoded, one warp a block.  The driver is K3p's output and stays
// raw.  Its entry point takes both twins' words and descriptors and no raw
// posting pointer.
#include "slave_join.cuh"

__global__ void __launch_bounds__(JOIN_SUB + 32) streamed_join_kernel(
    const int* __restrict__ a_docs, const int* __restrict__ a_attrs,
    const int* __restrict__ a_live, const int* __restrict__ a_flags,
    const int* __restrict__ active, const int* __restrict__ attr_filter,
    const int* __restrict__ postings,     // [P]
    const int* __restrict__ b_tile, const int* __restrict__ n_b,
    const int* __restrict__ bounds,
    const int* __restrict__ d_postings,   // [D]
    const int* __restrict__ d_tile, const int* __restrict__ n_d,
    const int* __restrict__ d_bounds, int* __restrict__ out_mask,
    int t_slots, int num_a, int window, int has_delta)
{
    const Packed none{nullptr, nullptr, nullptr, nullptr, 0};
    const DensePlan plan{active, b_tile, n_b, bounds, d_tile, n_d, d_bounds,
                         t_slots, num_a, has_delta};
    streamed_join_body<false>(plan, postings, d_postings, none, none, a_docs, a_attrs,
                              a_live, a_flags, attr_filter, out_mask, t_slots, window,
                              has_delta);
}

__global__ void __launch_bounds__(JOIN_SUB + 32) streamed_join_packed_kernel(
    const int* __restrict__ a_docs, const int* __restrict__ a_attrs,
    const int* __restrict__ a_live, const int* __restrict__ a_flags,
    const int* __restrict__ active, const int* __restrict__ attr_filter,
    const uint32_t* __restrict__ words,   // main twin [Wd]
    const int* __restrict__ blk_base, const int* __restrict__ blk_meta,
    const int* __restrict__ blk_woff,
    const int* __restrict__ b_tile, const int* __restrict__ n_b,
    const int* __restrict__ bounds,
    const uint32_t* __restrict__ d_words,  // delta twin
    const int* __restrict__ d_base, const int* __restrict__ d_meta,
    const int* __restrict__ d_woff,
    const int* __restrict__ d_tile, const int* __restrict__ n_d,
    const int* __restrict__ d_bounds, int* __restrict__ out_mask,
    int t_slots, int num_a, int window, int n_blocks, int d_n_blocks,
    int has_delta)
{
    const Packed m{words, blk_base, blk_meta, blk_woff, n_blocks};
    const Packed d{d_words, d_base, d_meta, d_woff, d_n_blocks};
    const DensePlan plan{active, b_tile, n_b, bounds, d_tile, n_d, d_bounds,
                         t_slots, num_a, has_delta};
    streamed_join_body<true>(plan, nullptr, nullptr, m, d, a_docs, a_attrs, a_live,
                             a_flags, attr_filter, out_mask, t_slots, window,
                             has_delta);
}

extern "C" int streamed_join_launch(
    const void* a_docs, const void* a_attrs, const void* a_live,
    const void* a_flags, const void* active, const void* attr_filter,
    const void* postings, const void* b_tile, const void* n_b,
    const void* bounds, const void* d_postings, const void* d_tile,
    const void* n_d, const void* d_bounds, void* out_mask,
    int q_n, int t_slots, int window, int has_delta, void* stream)
{
    static int allowed = 48 * 1024;
    const int num_a = (window + TILE - 1) / TILE;
    const int smem = probe_layout(t_slots * (has_delta ? 2 : 1), false).total;
    const cudaError_t err = allow_smem(streamed_join_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(num_a * NSUB, q_n);
    streamed_join_kernel<<<grid, JOIN_SUB + 32, smem, (cudaStream_t)stream>>>(
        (const int*)a_docs, (const int*)a_attrs, (const int*)a_live,
        (const int*)a_flags, (const int*)active, (const int*)attr_filter,
        (const int*)postings, (const int*)b_tile, (const int*)n_b,
        (const int*)bounds, (const int*)d_postings, (const int*)d_tile,
        (const int*)n_d, (const int*)d_bounds, (int*)out_mask, t_slots, num_a,
        window, has_delta);
    return (int)cudaGetLastError();
}

extern "C" int streamed_join_packed_launch(
    const void* a_docs, const void* a_attrs, const void* a_live,
    const void* a_flags, const void* active, const void* attr_filter,
    const void* words, const void* blk_base, const void* blk_meta,
    const void* blk_woff, const void* b_tile, const void* n_b,
    const void* bounds, const void* d_words, const void* d_base,
    const void* d_meta, const void* d_woff, const void* d_tile,
    const void* n_d, const void* d_bounds, void* out_mask,
    int q_n, int t_slots, int window, int n_blocks, int d_n_blocks,
    int has_delta, void* stream)
{
    static int allowed = 48 * 1024;
    const int num_a = (window + TILE - 1) / TILE;
    const int smem = probe_layout(t_slots * (has_delta ? 2 : 1), true).total;
    const cudaError_t err = allow_smem(streamed_join_packed_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(num_a * NSUB, q_n);
    streamed_join_packed_kernel<<<grid, JOIN_SUB + 32, smem, (cudaStream_t)stream>>>(
        (const int*)a_docs, (const int*)a_attrs, (const int*)a_live,
        (const int*)a_flags, (const int*)active, (const int*)attr_filter,
        (const uint32_t*)words, (const int*)blk_base, (const int*)blk_meta,
        (const int*)blk_woff, (const int*)b_tile, (const int*)n_b,
        (const int*)bounds, (const uint32_t*)d_words, (const int*)d_base,
        (const int*)d_meta, (const int*)d_woff, (const int*)d_tile,
        (const int*)n_d, (const int*)d_bounds, (int*)out_mask, t_slots, num_a,
        window, n_blocks, d_n_blocks, has_delta);
    return (int)cudaGetLastError();
}
