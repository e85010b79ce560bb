// K7: the slave join under merge-on-read over a work list (K4's compacted
// twin), and K7p, its packed mode, which probes block-codec words.
//
// Replaces the TPU kernel repro/kernels/posting_intersect.py:
// _streamed_compact_call (pallas_call at line 1500, body
// _streamed_compact_kernel at line 1298; orchestrator
// intersect_batched_streamed_compact at line 1529).  Python side and
// semantics: repro_torch/kernels/posting_intersect.py
// (streamed_compact_join_cuda and streamed_compact_join_packed_cuda, and
// the plain versions they are held against, which execute the same table).
//
// What it computes: K4's mask, group by group of the work list
// (repro_torch/kernels/worklist.py): rows [q, i, t, main_tile, flags,
// delta_tile, 0, 0] grouped by (query q, driver tile i), the main and
// delta probe tiles of a term advancing in lockstep.  A driver slot of the
// materialized window (K3 / K8's output) survives when it is valid, live,
// passes the attribute filter, and for every term run is in one of the
// run's main tiles (clipped to the term's window) with its doc neither
// DEAD nor SUPERSEDED, or in one of its delta tiles (clipped to the slab)
// with its doc not DEAD.  With has_delta 0 (the static mode: no delta
// arrays, no flags, every row's delta tile -1) only main tiles are probed.
// Inert queries have no group; the wrapper fills their rows with 0.
//
// What bounds it on the H100: the latency of dependent loads, as K4.  The
// first design (one block of 256 threads a group, walking its rows in
// turn, each row's main and delta tile staged behind two barriers, one
// round trip a tile with nothing in flight) ran about 27x its bound, 2.6x
// K4's time.
//
// Design: K4's body and probe (slave_join.cuh, probe_async.cuh), with the
// table as its plan (TablePlan): groups * NSUB blocks of JOIN_SUB slots
// and a producer warp, which reads the group's rows and sets each term's
// main and delta stream from its run: each kind's tiles are consecutive
// (main from the run's first row while s < n_b, delta while s < n_d,
// counted apart), so each union is K4's planned range, staged by bulk
// copies, two rounds in flight.  A slot is searched in a stream only where
// its flags let that stream count.  K7p narrows each packed range on
// blk_base and decodes only the blocks that can match, as K4p.
#include "slave_join.cuh"

__global__ void __launch_bounds__(JOIN_SUB + 32) streamed_compact_kernel(
    const int* __restrict__ desc, const int* __restrict__ heads,
    const int* __restrict__ a_docs, const int* __restrict__ a_attrs,
    const int* __restrict__ a_live, const int* __restrict__ a_flags,
    const int* __restrict__ attr_filter,
    const int* __restrict__ postings,     // [P]
    const int* __restrict__ bounds,
    const int* __restrict__ d_postings,   // [D]
    const int* __restrict__ d_bounds, int* __restrict__ out_mask,
    int t_slots, int window, int has_delta)
{
    const Packed none{nullptr, nullptr, nullptr, nullptr, 0};
    const TablePlan plan{desc, heads, bounds, d_bounds, t_slots, has_delta};
    streamed_join_body<false>(plan, postings, d_postings, none, none, a_docs, a_attrs,
                              a_live, a_flags, attr_filter, out_mask, t_slots, window,
                              has_delta);
}

__global__ void __launch_bounds__(JOIN_SUB + 32) streamed_compact_packed_kernel(
    const int* __restrict__ desc, const int* __restrict__ heads,
    const int* __restrict__ a_docs, const int* __restrict__ a_attrs,
    const int* __restrict__ a_live, const int* __restrict__ a_flags,
    const int* __restrict__ attr_filter,
    const uint32_t* __restrict__ words,   // main twin [Wd]
    const int* __restrict__ blk_base, const int* __restrict__ blk_meta,
    const int* __restrict__ blk_woff, const int* __restrict__ bounds,
    const uint32_t* __restrict__ d_words,  // delta twin
    const int* __restrict__ d_base, const int* __restrict__ d_meta,
    const int* __restrict__ d_woff, const int* __restrict__ d_bounds,
    int* __restrict__ out_mask,
    int t_slots, int window, int n_blocks, int d_n_blocks, int has_delta)
{
    const Packed m{words, blk_base, blk_meta, blk_woff, n_blocks};
    const Packed d{d_words, d_base, d_meta, d_woff, d_n_blocks};
    const TablePlan plan{desc, heads, bounds, d_bounds, t_slots, has_delta};
    streamed_join_body<true>(plan, nullptr, nullptr, m, d, a_docs, a_attrs, a_live,
                             a_flags, attr_filter, out_mask, t_slots, window,
                             has_delta);
}

extern "C" int streamed_compact_launch(
    const void* desc, const void* heads, const void* a_docs,
    const void* a_attrs, const void* a_live, const void* a_flags,
    const void* attr_filter, const void* postings, const void* bounds,
    const void* d_postings, const void* d_bounds, void* out_mask,
    int n_groups, int t_slots, int window, int has_delta, void* stream)
{
    static int allowed = 48 * 1024;
    const int smem = probe_layout(t_slots * (has_delta ? 2 : 1), false).total;
    const cudaError_t err = allow_smem(streamed_compact_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    streamed_compact_kernel<<<n_groups * NSUB, JOIN_SUB + 32, smem,
                              (cudaStream_t)stream>>>(
        (const int*)desc, (const int*)heads, (const int*)a_docs,
        (const int*)a_attrs, (const int*)a_live, (const int*)a_flags,
        (const int*)attr_filter, (const int*)postings, (const int*)bounds,
        (const int*)d_postings, (const int*)d_bounds, (int*)out_mask,
        t_slots, window, has_delta);
    return (int)cudaGetLastError();
}

extern "C" int streamed_compact_packed_launch(
    const void* desc, const void* heads, const void* a_docs,
    const void* a_attrs, const void* a_live, const void* a_flags,
    const void* attr_filter, const void* words, const void* blk_base,
    const void* blk_meta, const void* blk_woff, const void* bounds,
    const void* d_words, const void* d_base, const void* d_meta,
    const void* d_woff, const void* d_bounds, void* out_mask,
    int n_groups, int t_slots, int window, int n_blocks, int d_n_blocks,
    int has_delta, void* stream)
{
    static int allowed = 48 * 1024;
    const int smem = probe_layout(t_slots * (has_delta ? 2 : 1), true).total;
    const cudaError_t err = allow_smem(streamed_compact_packed_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    streamed_compact_packed_kernel<<<n_groups * NSUB, JOIN_SUB + 32, smem,
                                     (cudaStream_t)stream>>>(
        (const int*)desc, (const int*)heads, (const int*)a_docs,
        (const int*)a_attrs, (const int*)a_live, (const int*)a_flags,
        (const int*)attr_filter, (const uint32_t*)words, (const int*)blk_base,
        (const int*)blk_meta, (const int*)blk_woff, (const int*)bounds,
        (const uint32_t*)d_words, (const int*)d_base, (const int*)d_meta,
        (const int*)d_woff, (const int*)d_bounds, (int*)out_mask,
        t_slots, window, n_blocks, d_n_blocks, has_delta);
    return (int)cudaGetLastError();
}
