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
// What bounds it on the H100: bytes and latency, as K1.  Each block reads
// one 1024-slot driver tile (docIDs, attrs, live, flags: 16 KB) and, per
// active term, the planned run of the term's main list (at most window +
// TILE postings) and of its delta slab (at most cap + TILE); the work per
// byte is one binary search of a few steps.
//
// Design: K1's block structure.  One block of 256 threads per (driver
// tile, query), four driver slots a thread; per active term, the main
// range and then the delta range are staged through shared memory and
// binary-searched (probe_range in probe.cuh, shared with K1); a slot is
// searched in a stream only where its flags let that stream count.  The
// fold uses the driver tile's flags.  The TPU kernel's (8,128)
// broadcast-compare and its (Q, A, T, S) sequential grid are not carried
// over.
//
// K4p runs the same body with PackedList sources for the main and delta
// probes (probe.cuh, decode.cuh): each probe chunk's blocks are decoded
// one per warp into shared memory, then searched.  The driver is K3p's
// output and stays raw.  Its entry point takes both twins' words and
// descriptors and no raw posting pointer.
#include "probe.cuh"

#define DOC_DEAD 1
#define DOC_SUPERSEDED 2

template <class Src>
__device__ __forceinline__ void streamed_join_body(
    const Src& main_src, const Src& delta_src,
    const int* __restrict__ a_docs,       // [Q, window]
    const int* __restrict__ a_attrs,      // [Q, window]
    const int* __restrict__ a_live,       // [Q, window]
    const int* __restrict__ a_flags,      // [Q, window]
    const int* __restrict__ active,       // [Q, T]
    const int* __restrict__ attr_filter,  // [Q]
    const int* __restrict__ b_tile,       // [Q, T, A]
    const int* __restrict__ n_b,          // [Q, T, A]
    const int* __restrict__ bounds,       // [Q, T, 2]
    const int* __restrict__ d_tile,       // [Q, T, A]
    const int* __restrict__ n_d,          // [Q, T, A]
    const int* __restrict__ d_bounds,     // [Q, T, 2]
    int* __restrict__ out_mask,           // [Q, window]
    int t_slots, int num_a, int window, int has_delta)
{
    __shared__ int sb[STAGE];
    const int i = blockIdx.x;   // driver tile
    const int q = blockIdx.y;   // query
    const int filt = attr_filter[q];

    int a[ITEMS];
    bool keep[ITEMS], main_ok[ITEMS], delta_ok[ITEMS];
    bool alive = false;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int w = i * TILE + r * THREADS + threadIdx.x;
        const bool in_win = w < window;
        const int64_t o = (int64_t)q * window + w;
        const int doc = in_win ? a_docs[o] : INVALID_DOC;
        const int at = in_win ? a_attrs[o] : INVALID_ATTR;
        const int lv = in_win ? a_live[o] : 0;
        const int fl = in_win && has_delta ? a_flags[o] : 0;
        a[r] = doc;
        keep[r] = doc != INVALID_DOC && (filt < 0 || at == filt) && lv != 0;
        main_ok[r] = (fl & (DOC_DEAD | DOC_SUPERSEDED)) == 0;
        delta_ok[r] = (fl & DOC_DEAD) == 0;
        alive |= keep[r];
    }

    for (int t = 0; t < t_slots; ++t) {
        // Uniform across the block: stop once no slot survives.
        if (!__syncthreads_or(alive)) break;
        const int64_t qt = (int64_t)q * t_slots + t;
        if (active[qt] == 0) continue;
        const int64_t qti = qt * num_a + i;
        bool need[ITEMS], in_main[ITEMS], in_delta[ITEMS];
        int64_t rlo, rhi;
        planned_range(b_tile[qti], n_b[qti], bounds[2 * qt], bounds[2 * qt + 1],
                      rlo, rhi);
#pragma unroll
        for (int r = 0; r < ITEMS; ++r) need[r] = keep[r] && main_ok[r];
        main_src.probe(rlo, rhi, sb, a, need, in_main);
        // has_delta is uniform across the block, so is the probe's barrier
        if (has_delta) {
            planned_range(d_tile[qti], n_d[qti], d_bounds[2 * qt],
                          d_bounds[2 * qt + 1], rlo, rhi);
#pragma unroll
            for (int r = 0; r < ITEMS; ++r) need[r] = keep[r] && delta_ok[r];
            delta_src.probe(rlo, rhi, sb, a, need, in_delta);
        } else {
#pragma unroll
            for (int r = 0; r < ITEMS; ++r) in_delta[r] = false;
        }
        alive = false;
#pragma unroll
        for (int r = 0; r < ITEMS; ++r) {
            keep[r] = keep[r] && (in_main[r] || in_delta[r]);
            alive |= keep[r];
        }
    }

#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int w = i * TILE + r * THREADS + threadIdx.x;
        if (w < window) out_mask[(int64_t)q * window + w] = keep[r] ? 1 : 0;
    }
}

__global__ void __launch_bounds__(THREADS) streamed_join_kernel(
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
    streamed_join_body(RawList{postings}, RawList{d_postings}, a_docs, a_attrs,
                       a_live, a_flags, active, attr_filter, b_tile, n_b,
                       bounds, d_tile, n_d, d_bounds, out_mask, t_slots, num_a,
                       window, has_delta);
}

__global__ void __launch_bounds__(THREADS) streamed_join_packed_kernel(
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
    const PackedList m{Packed{words, blk_base, blk_meta, blk_woff, n_blocks}};
    const PackedList d{Packed{d_words, d_base, d_meta, d_woff, d_n_blocks}};
    streamed_join_body(m, d, a_docs, a_attrs, a_live, a_flags, active,
                       attr_filter, b_tile, n_b, bounds, d_tile, n_d, d_bounds,
                       out_mask, t_slots, num_a, window, has_delta);
}

extern "C" int streamed_join_launch(
    const void* a_docs, const void* a_attrs, const void* a_live,
    const void* a_flags, const void* active, const void* attr_filter,
    const void* postings, const void* b_tile, const void* n_b,
    const void* bounds, const void* d_postings, const void* d_tile,
    const void* n_d, const void* d_bounds, void* out_mask,
    int q_n, int t_slots, int window, int has_delta, void* stream)
{
    const int num_a = (window + TILE - 1) / TILE;
    dim3 grid(num_a, q_n);
    streamed_join_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)a_docs, (const int*)a_attrs, (const int*)a_live,
        (const int*)a_flags, (const int*)active, (const int*)attr_filter,
        (const int*)postings, (const int*)b_tile, (const int*)n_b,
        (const int*)bounds, (const int*)d_postings, (const int*)d_tile,
        (const int*)n_d, (const int*)d_bounds, (int*)out_mask,
        t_slots, num_a, window, has_delta);
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
    const int num_a = (window + TILE - 1) / TILE;
    dim3 grid(num_a, q_n);
    streamed_join_packed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)a_docs, (const int*)a_attrs, (const int*)a_live,
        (const int*)a_flags, (const int*)active, (const int*)attr_filter,
        (const uint32_t*)words, (const int*)blk_base, (const int*)blk_meta,
        (const int*)blk_woff, (const int*)b_tile, (const int*)n_b,
        (const int*)bounds, (const uint32_t*)d_words, (const int*)d_base,
        (const int*)d_meta, (const int*)d_woff, (const int*)d_tile,
        (const int*)n_d, (const int*)d_bounds, (int*)out_mask,
        t_slots, num_a, window, n_blocks, d_n_blocks, has_delta);
    return (int)cudaGetLastError();
}
