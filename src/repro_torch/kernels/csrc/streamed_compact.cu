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
// What bounds it on the H100: bytes and latency, as K4: one 1024-slot
// driver tile (docIDs, attrs, live, flags) per group, each named probe
// tile once, 32 bytes a descriptor row.
//
// Design: one thread block per (q, i) group, walking its rows in order
// (see driver_compact.cu); K4's per-slot predicates; each named tile goes
// through K1's shared-memory probe (probe.cuh), searched only for the
// slots whose flags let that stream count.  K7p runs the same body over
// PackedList sources for the main and delta probes; the driver stays raw.
#include "probe.cuh"

#define DOC_DEAD 1
#define DOC_SUPERSEDED 2
#define FLAG_TERM_START 2
#define FLAG_TERM_END 4

template <class Src>
__device__ __forceinline__ void streamed_compact_body(
    const Src& main_src, const Src& delta_src,
    const int* __restrict__ desc,         // [n_pad, 8]
    const int* __restrict__ heads,        // [n_groups + 1]
    const int* __restrict__ a_docs,       // [Q, window]
    const int* __restrict__ a_attrs,      // [Q, window]
    const int* __restrict__ a_live,       // [Q, window]
    const int* __restrict__ a_flags,      // [Q, window]
    const int* __restrict__ attr_filter,  // [Q]
    const int* __restrict__ bounds,       // [Q, T, 2]
    const int* __restrict__ d_bounds,     // [Q, T, 2]
    int* __restrict__ out_mask,           // [Q, window]
    int t_slots, int window, int has_delta)
{
    __shared__ int sb[STAGE];
    const int g = blockIdx.x;
    const int r0 = heads[g], r1 = heads[g + 1];
    const int q = desc[8 * r0], i = desc[8 * r0 + 1];
    const int filt = attr_filter[q];

    int a[ITEMS];
    bool keep[ITEMS], main_ok[ITEMS], delta_ok[ITEMS], in_m[ITEMS], in_d[ITEMS];
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
        in_m[r] = in_d[r] = false;
        alive |= keep[r];
    }

    for (int n = r0; n < r1; ++n) {
        const int* d = desc + 8 * (int64_t)n;
        const int t = d[2], mt = d[3], flags = d[4], dt = has_delta ? d[5] : -1;
        if (flags & FLAG_TERM_START) {
#pragma unroll
            for (int r = 0; r < ITEMS; ++r) in_m[r] = in_d[r] = false;
        }
        // mt and dt are uniform across the block, so is the barrier
        if ((mt >= 0 || dt >= 0) && __syncthreads_or(alive)) {
            const int64_t qt = (int64_t)q * t_slots + t;
            bool need[ITEMS], hit[ITEMS];
            int64_t rlo, rhi;
            if (mt >= 0) {
                planned_range(mt, 1, bounds[2 * qt], bounds[2 * qt + 1], rlo, rhi);
#pragma unroll
                for (int r = 0; r < ITEMS; ++r)
                    need[r] = keep[r] && main_ok[r] && !in_m[r];
                main_src.probe(rlo, rhi, sb, a, need, hit);
#pragma unroll
                for (int r = 0; r < ITEMS; ++r) in_m[r] = in_m[r] || hit[r];
            }
            if (dt >= 0) {
                planned_range(dt, 1, d_bounds[2 * qt], d_bounds[2 * qt + 1],
                              rlo, rhi);
#pragma unroll
                for (int r = 0; r < ITEMS; ++r)
                    need[r] = keep[r] && delta_ok[r] && !in_d[r];
                delta_src.probe(rlo, rhi, sb, a, need, hit);
#pragma unroll
                for (int r = 0; r < ITEMS; ++r) in_d[r] = in_d[r] || hit[r];
            }
        }
        if (flags & FLAG_TERM_END) {
            alive = false;
#pragma unroll
            for (int r = 0; r < ITEMS; ++r) {
                keep[r] = keep[r] && (in_m[r] || in_d[r]);
                alive |= keep[r];
            }
        }
    }

#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int w = i * TILE + r * THREADS + threadIdx.x;
        if (w < window) out_mask[(int64_t)q * window + w] = keep[r] ? 1 : 0;
    }
}

__global__ void __launch_bounds__(THREADS) streamed_compact_kernel(
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
    streamed_compact_body(RawList{postings}, RawList{d_postings}, desc, heads,
                          a_docs, a_attrs, a_live, a_flags, attr_filter,
                          bounds, d_bounds, out_mask, t_slots, window,
                          has_delta);
}

__global__ void __launch_bounds__(THREADS) streamed_compact_packed_kernel(
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
    const PackedList m{Packed{words, blk_base, blk_meta, blk_woff, n_blocks}};
    const PackedList d{Packed{d_words, d_base, d_meta, d_woff, d_n_blocks}};
    streamed_compact_body(m, d, desc, heads, a_docs, a_attrs, a_live, a_flags,
                          attr_filter, bounds, d_bounds, out_mask, t_slots,
                          window, has_delta);
}

extern "C" int streamed_compact_launch(
    const void* desc, const void* heads, const void* a_docs,
    const void* a_attrs, const void* a_live, const void* a_flags,
    const void* attr_filter, const void* postings, const void* bounds,
    const void* d_postings, const void* d_bounds, void* out_mask,
    int n_groups, int t_slots, int window, int has_delta, void* stream)
{
    streamed_compact_kernel<<<n_groups, THREADS, 0, (cudaStream_t)stream>>>(
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
    streamed_compact_packed_kernel<<<n_groups, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)desc, (const int*)heads, (const int*)a_docs,
        (const int*)a_attrs, (const int*)a_live, (const int*)a_flags,
        (const int*)attr_filter, (const uint32_t*)words, (const int*)blk_base,
        (const int*)blk_meta, (const int*)blk_woff, (const int*)bounds,
        (const uint32_t*)d_words, (const int*)d_base, (const int*)d_meta,
        (const int*)d_woff, (const int*)d_bounds, (int*)out_mask,
        t_slots, window, n_blocks, d_n_blocks, has_delta);
    return (int)cudaGetLastError();
}
