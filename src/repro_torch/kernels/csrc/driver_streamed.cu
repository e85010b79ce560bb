// K1: the static slave join, driver window streamed from the flat arrays,
// and K1p, its packed mode (K5), which reads the postings as block-codec
// words.
//
// Replaces the TPU kernel repro/kernels/posting_intersect.py:
// intersect_batched_driver_streamed (pallas_call at line 1207, body
// _driver_streamed_kernel at line 996; its packed= mode at lines 1167-1191,
// decode at 1033-1080).  Python side and semantics:
// repro_torch/kernels/posting_intersect.py (driver_streamed_join_cuda and
// driver_streamed_join_packed_cuda, and the plain versions they are held
// against).
//
// What bounds it on the H100: bytes and latency, not arithmetic.  Each
// block reads one 1024-posting driver tile (docIDs + attrs, 8 KB) and, per
// active other term, the planned run of that term's list (at most
// window + TILE postings); the work per byte is one binary search of a few
// steps, far below the card's operations-per-byte balance.  The plan comes
// from the skip table before the launch, so postings outside the
// overlapping tiles are never read (the paper's posting skipping).
//
// Design: one block of 256 threads per (driver tile, query).  Each thread
// keeps 4 driver postings in registers (coalesced loads: thread x reads
// window positions x, x+256, x+512, x+768 of the tile).  For each active
// term the block probes the planned range of the term's list through
// shared memory (probe_range in probe.cuh, shared with K4).  Membership is
// ANDed over terms; validity and the attribute filter are applied first,
// and a block whose postings have all died stops probing
// (__syncthreads_or).  The TPU kernel's (8,128) broadcast-compare and its
// clamped unblocked BlockSpecs are not carried over: the driver tile is
// read by position and masked, so no read passes a list's live range.
//
// K1p runs the same body over PackedList sources (probe.cuh, decode.cuh):
// the driver tile's blocks are decoded one per warp into shared memory
// before the threads pick their postings, and each probe chunk's blocks
// are decoded before it is searched.  Attrs stay raw.  Its entry point
// takes the words and descriptors and no raw posting pointer.  What bounds
// it: the same latency as K1, with the packed words (about half the raw
// bytes at full size) plus 12 descriptor bytes per decoded block in place
// of the raw postings, and a few shifts and one warp scan per block.
#include "probe.cuh"

template <class Src>
__device__ __forceinline__ void driver_streamed_body(
    const Src& src,
    const int* __restrict__ d_off,        // [Q]
    const int* __restrict__ d_neff,       // [Q]
    const int* __restrict__ active,       // [Q, T]
    const int* __restrict__ attr_filter,  // [Q]
    const int* __restrict__ attrs,        // [P]
    const int* __restrict__ b_tile,       // [Q, T, A]
    const int* __restrict__ n_b,          // [Q, T, A]
    const int* __restrict__ bounds,       // [Q, T, 2]
    int* __restrict__ out_docs,           // [Q, window]
    int* __restrict__ out_mask,           // [Q, window]
    int t_slots, int num_a, int window)
{
    __shared__ int sb[STAGE];
    const int i = blockIdx.x;   // driver tile
    const int q = blockIdx.y;   // query
    const int64_t off = d_off[q];
    const int neff = d_neff[q];
    const int filt = attr_filter[q];
    const int t0 = i * TILE;
    const int n_tile = neff - t0 < 0 ? 0 : (neff - t0 < TILE ? neff - t0 : TILE);
    const int* drv = src.stage(off + t0, n_tile, sb);

    int a[ITEMS];
    bool keep[ITEMS];
    bool alive = false;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int w = t0 + r * THREADS + threadIdx.x;
        const bool in_win = w < neff;
        const int doc = in_win ? drv[w - t0] : INVALID_DOC;
        const int at = in_win ? attrs[off + w] : INVALID_ATTR;
        a[r] = doc;
        keep[r] = doc != INVALID_DOC && (filt < 0 || at == filt);
        alive |= keep[r];
    }

    for (int t = 0; t < t_slots; ++t) {
        // Uniform across the block: stop once no posting survives.
        if (!__syncthreads_or(alive)) break;
        const int64_t qt = (int64_t)q * t_slots + t;
        if (active[qt] == 0) continue;
        const int64_t qti = qt * num_a + i;
        int64_t rlo, rhi;
        planned_range(b_tile[qti], n_b[qti], bounds[2 * qt], bounds[2 * qt + 1],
                      rlo, rhi);
        bool found[ITEMS];
        src.probe(rlo, rhi, sb, a, keep, found);
        alive = false;
#pragma unroll
        for (int r = 0; r < ITEMS; ++r) {
            keep[r] = keep[r] && found[r];
            alive |= keep[r];
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

__global__ void __launch_bounds__(THREADS) driver_streamed_kernel(
    const int* __restrict__ d_off, const int* __restrict__ d_neff,
    const int* __restrict__ active, const int* __restrict__ attr_filter,
    const int* __restrict__ postings,     // [P]
    const int* __restrict__ attrs, const int* __restrict__ b_tile,
    const int* __restrict__ n_b, const int* __restrict__ bounds,
    int* __restrict__ out_docs, int* __restrict__ out_mask,
    int t_slots, int num_a, int window)
{
    driver_streamed_body(RawList{postings}, d_off, d_neff, active, attr_filter,
                         attrs, b_tile, n_b, bounds, out_docs, out_mask,
                         t_slots, num_a, window);
}

__global__ void __launch_bounds__(THREADS) driver_streamed_packed_kernel(
    const int* __restrict__ d_off, const int* __restrict__ d_neff,
    const int* __restrict__ active, const int* __restrict__ attr_filter,
    const uint32_t* __restrict__ words,   // [Wd]
    const int* __restrict__ blk_base,     // [n_blocks + DESC_PAD]
    const int* __restrict__ blk_meta,     // [n_blocks + DESC_PAD]
    const int* __restrict__ blk_woff,     // [n_blocks + DESC_PAD + 1]
    const int* __restrict__ attrs, const int* __restrict__ b_tile,
    const int* __restrict__ n_b, const int* __restrict__ bounds,
    int* __restrict__ out_docs, int* __restrict__ out_mask,
    int t_slots, int num_a, int window, int n_blocks)
{
    const PackedList src{Packed{words, blk_base, blk_meta, blk_woff, n_blocks}};
    driver_streamed_body(src, d_off, d_neff, active, attr_filter, attrs,
                         b_tile, n_b, bounds, out_docs, out_mask,
                         t_slots, num_a, window);
}

extern "C" int driver_streamed_launch(
    const void* d_off, const void* d_neff, const void* active,
    const void* attr_filter, const void* postings, const void* attrs,
    const void* b_tile, const void* n_b, const void* bounds,
    void* out_docs, void* out_mask,
    int q_n, int t_slots, int window, void* stream)
{
    const int num_a = (window + TILE - 1) / TILE;
    dim3 grid(num_a, q_n);
    driver_streamed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)d_off, (const int*)d_neff, (const int*)active,
        (const int*)attr_filter, (const int*)postings, (const int*)attrs,
        (const int*)b_tile, (const int*)n_b, (const int*)bounds,
        (int*)out_docs, (int*)out_mask, t_slots, num_a, window);
    return (int)cudaGetLastError();
}

extern "C" int driver_streamed_packed_launch(
    const void* d_off, const void* d_neff, const void* active,
    const void* attr_filter, const void* words, const void* blk_base,
    const void* blk_meta, const void* blk_woff, const void* attrs,
    const void* b_tile, const void* n_b, const void* bounds,
    void* out_docs, void* out_mask,
    int q_n, int t_slots, int window, int n_blocks, void* stream)
{
    const int num_a = (window + TILE - 1) / TILE;
    dim3 grid(num_a, q_n);
    driver_streamed_packed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)d_off, (const int*)d_neff, (const int*)active,
        (const int*)attr_filter, (const uint32_t*)words, (const int*)blk_base,
        (const int*)blk_meta, (const int*)blk_woff, (const int*)attrs,
        (const int*)b_tile, (const int*)n_b, (const int*)bounds,
        (int*)out_docs, (int*)out_mask, t_slots, num_a, window, n_blocks);
    return (int)cudaGetLastError();
}
