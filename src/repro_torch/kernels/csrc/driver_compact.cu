// K6: the static slave join over a work list (K1's compacted twin), and
// K6p, its packed mode, which reads the postings as block-codec words.
//
// Replaces the TPU kernel repro/kernels/posting_intersect.py:
// _driver_compact_call (pallas_call at line 1762, body
// _driver_compact_kernel at line 1620; orchestrator
// intersect_batched_driver_streamed_compact at line 1792).  Python side
// and semantics: repro_torch/kernels/posting_intersect.py
// (driver_compact_join_cuda and driver_compact_join_packed_cuda, and the
// plain versions they are held against, which execute the same table).
//
// What it computes: the work list (repro_torch/kernels/worklist.py) names,
// per live (query q, driver tile i), the probe tiles of each active term,
// as rows [q, i, t, tile, flags, -, 0, 0] grouped by (q, i).  A group's
// output is K1's tile of docs and mask: the driver tile read from the flat
// arrays, and a posting survives when it is valid, passes the attribute
// filter, and for every term run (TERM_START .. TERM_END) occurs in one of
// the run's probe tiles, each clipped to the term's window [lo, hi).  A
// dead-term group (one item, tile -1, TERM_START|TERM_END) masks all; a
// FIRST|LAST group with no term keeps validity and the filter.  Inert
// queries have no group; the wrapper fills their rows.
//
// What bounds it on the H100: bytes and latency, as K1: one 1024-posting
// driver tile (docIDs + attrs) per group, each named probe tile once, 32
// bytes a descriptor row; one binary search of a few steps per posting and
// probe.
//
// Design: the TPU's 1-D grid, which carries a group's state across
// contiguous steps in VMEM scratch, becomes one thread block per group:
// the host derives the groups from the FLAG_FIRST rows (heads[g] ..
// heads[g + 1] - 1), and the block walks its group's rows in order, so the
// per-term OR and the fold across terms stay in registers, with no
// atomics.  Padding rows past the live items are never walked.  The driver
// tile is staged once, on the group's first row, four postings a thread as
// in K1; each probe goes through K1's shared-memory probe (probe.cuh).  A
// block whose postings have all died skips its remaining probes (uniform:
// __syncthreads_or).  K6p runs the same body over PackedList sources: the
// driver tile's blocks are decoded into the staging buffer and read into
// registers before any probe chunk overwrites it (probe.cuh's barrier at
// the start of each chunk).
#include "probe.cuh"

#define FLAG_TERM_START 2
#define FLAG_TERM_END 4

template <class Src>
__device__ __forceinline__ void driver_compact_body(
    const Src& src,
    const int* __restrict__ desc,         // [n_pad, 8]
    const int* __restrict__ heads,        // [n_groups + 1]
    const int* __restrict__ d_off,        // [Q]
    const int* __restrict__ d_neff,       // [Q]
    const int* __restrict__ attr_filter,  // [Q]
    const int* __restrict__ attrs,        // [P]
    const int* __restrict__ bounds,       // [Q, T, 2]
    int* __restrict__ out_docs,           // [Q, window]
    int* __restrict__ out_mask,           // [Q, window]
    int t_slots, int window)
{
    __shared__ int sb[STAGE];
    const int g = blockIdx.x;
    const int r0 = heads[g], r1 = heads[g + 1];
    const int q = desc[8 * r0], i = desc[8 * r0 + 1];
    const int64_t off = d_off[q];
    const int neff = d_neff[q];
    const int filt = attr_filter[q];
    const int t0 = i * TILE;
    const int n_tile = neff - t0 < 0 ? 0 : (neff - t0 < TILE ? neff - t0 : TILE);
    const int* drv = src.stage(off + t0, n_tile, sb);

    int a[ITEMS];
    bool keep[ITEMS], found[ITEMS];
    bool alive = false;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int w = t0 + r * THREADS + threadIdx.x;
        const bool in_win = w < neff;
        const int doc = in_win ? drv[w - t0] : INVALID_DOC;
        const int at = in_win ? attrs[off + w] : INVALID_ATTR;
        a[r] = doc;
        keep[r] = doc != INVALID_DOC && (filt < 0 || at == filt);
        found[r] = false;
        alive |= keep[r];
    }

    for (int n = r0; n < r1; ++n) {
        const int* d = desc + 8 * (int64_t)n;
        const int t = d[2], tile = d[3], flags = d[4];
        if (flags & FLAG_TERM_START) {
#pragma unroll
            for (int r = 0; r < ITEMS; ++r) found[r] = false;
        }
        // tile is uniform across the block, so is the barrier
        if (tile >= 0 && __syncthreads_or(alive)) {
            const int64_t qt = (int64_t)q * t_slots + t;
            int64_t rlo, rhi;
            planned_range(tile, 1, bounds[2 * qt], bounds[2 * qt + 1], rlo, rhi);
            bool need[ITEMS], hit[ITEMS];
#pragma unroll
            for (int r = 0; r < ITEMS; ++r) need[r] = keep[r] && !found[r];
            src.probe(rlo, rhi, sb, a, need, hit);
#pragma unroll
            for (int r = 0; r < ITEMS; ++r) found[r] = found[r] || hit[r];
        }
        if (flags & FLAG_TERM_END) {
            alive = false;
#pragma unroll
            for (int r = 0; r < ITEMS; ++r) {
                keep[r] = keep[r] && found[r];
                alive |= keep[r];
            }
        }
    }

#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int w = t0 + r * THREADS + threadIdx.x;
        if (w < window) {
            out_docs[(int64_t)q * window + w] = a[r];
            out_mask[(int64_t)q * window + w] = keep[r] ? 1 : 0;
        }
    }
}

__global__ void __launch_bounds__(THREADS) driver_compact_kernel(
    const int* __restrict__ desc, const int* __restrict__ heads,
    const int* __restrict__ d_off, const int* __restrict__ d_neff,
    const int* __restrict__ attr_filter,
    const int* __restrict__ postings,     // [P]
    const int* __restrict__ attrs, const int* __restrict__ bounds,
    int* __restrict__ out_docs, int* __restrict__ out_mask,
    int t_slots, int window)
{
    driver_compact_body(RawList{postings}, desc, heads, d_off, d_neff,
                        attr_filter, attrs, bounds, out_docs, out_mask,
                        t_slots, window);
}

__global__ void __launch_bounds__(THREADS) driver_compact_packed_kernel(
    const int* __restrict__ desc, const int* __restrict__ heads,
    const int* __restrict__ d_off, const int* __restrict__ d_neff,
    const int* __restrict__ attr_filter,
    const uint32_t* __restrict__ words,   // [Wd]
    const int* __restrict__ blk_base,     // [n_blocks + DESC_PAD]
    const int* __restrict__ blk_meta,     // [n_blocks + DESC_PAD]
    const int* __restrict__ blk_woff,     // [n_blocks + DESC_PAD + 1]
    const int* __restrict__ attrs, const int* __restrict__ bounds,
    int* __restrict__ out_docs, int* __restrict__ out_mask,
    int t_slots, int window, int n_blocks)
{
    const PackedList src{Packed{words, blk_base, blk_meta, blk_woff, n_blocks}};
    driver_compact_body(src, desc, heads, d_off, d_neff, attr_filter, attrs,
                        bounds, out_docs, out_mask, t_slots, window);
}

extern "C" int driver_compact_launch(
    const void* desc, const void* heads, const void* d_off,
    const void* d_neff, const void* attr_filter, const void* postings,
    const void* attrs, const void* bounds, void* out_docs, void* out_mask,
    int n_groups, int t_slots, int window, void* stream)
{
    driver_compact_kernel<<<n_groups, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)desc, (const int*)heads, (const int*)d_off,
        (const int*)d_neff, (const int*)attr_filter, (const int*)postings,
        (const int*)attrs, (const int*)bounds, (int*)out_docs,
        (int*)out_mask, t_slots, window);
    return (int)cudaGetLastError();
}

extern "C" int driver_compact_packed_launch(
    const void* desc, const void* heads, const void* d_off,
    const void* d_neff, const void* attr_filter, const void* words,
    const void* blk_base, const void* blk_meta, const void* blk_woff,
    const void* attrs, const void* bounds, void* out_docs, void* out_mask,
    int n_groups, int t_slots, int window, int n_blocks, void* stream)
{
    driver_compact_packed_kernel<<<n_groups, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)desc, (const int*)heads, (const int*)d_off,
        (const int*)d_neff, (const int*)attr_filter, (const uint32_t*)words,
        (const int*)blk_base, (const int*)blk_meta, (const int*)blk_woff,
        (const int*)attrs, (const int*)bounds, (int*)out_docs,
        (int*)out_mask, t_slots, window, n_blocks);
    return (int)cudaGetLastError();
}
