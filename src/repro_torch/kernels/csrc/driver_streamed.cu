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
// What bounds it on the H100: the latency of dependent loads.  A block
// reads its driver slots (docIDs and attrs) and, per active other term,
// the planned run of that term's list (at most window + TILE postings).
// The work per byte is one binary search of a few steps, and the bytes of
// a main-path launch (Q 32, T 4, window 4096) take about 0.6 us at the
// card's memory rate; what costs is each round trip that a search waits
// for.  The first design (one block of 256 threads per 1024-slot tile,
// 128 blocks on 132 SMs, each range staged 2048 postings at a time behind
// two barriers) ran 11x that bound.  The plan comes from the skip table
// before the launch, so postings outside the overlapping tiles are never
// read (the paper's posting skipping).
//
// Design (probe_async.cuh; the block body, slave_join.cuh, is K6's too,
// with the plan arrays as its DensePlan): a block owns JOIN_SUB = 256
// slots of a driver tile (the grid is (tiles * NSUB, Q)), one a consumer
// thread (coalesced), and one producer warp reads the plan of every term
// and, with it, issues bulk copies of the terms' planned ranges into
// shared memory (two rounds in flight) while the consumers read the
// driver.  Each consumer then searches its slot in each landed range,
// starting from an interpolated window.  Membership is ANDed over active
// terms; validity and the attribute filter are applied first, and a block
// whose postings have all died stops.  The TPU kernel's (8,128)
// broadcast-compare and its clamped unblocked BlockSpecs are not carried
// over: the driver is read by position and masked, so no read passes a
// list's live range.
//
// K1p runs the same body over the codec: the sub-tile's driver blocks are
// decoded one per warp into shared memory (decode.cuh); the block reduces
// its live docIDs' interval, each probe range is narrowed on blk_base to
// the blocks that can hold it, and only their words are staged and
// decoded (from shared memory).  Attrs stay raw.  Its entry point takes
// the words and descriptors and no raw posting pointer.
#include "slave_join.cuh"

__global__ void __launch_bounds__(JOIN_SUB + 32) driver_streamed_kernel(
    const int* __restrict__ d_off, const int* __restrict__ d_neff,
    const int* __restrict__ active, const int* __restrict__ attr_filter,
    const int* __restrict__ postings,     // [P]
    const int* __restrict__ attrs, const int* __restrict__ b_tile,
    const int* __restrict__ n_b, const int* __restrict__ bounds,
    int* __restrict__ out_docs, int* __restrict__ out_mask,
    int t_slots, int num_a, int window)
{
    const Packed none{nullptr, nullptr, nullptr, nullptr, 0};
    const DensePlan plan{active, b_tile, n_b, bounds, nullptr, nullptr, nullptr,
                         t_slots, num_a, 0};
    driver_join_body<false>(plan, postings, none, d_off, d_neff, attr_filter, attrs,
                            out_docs, out_mask, t_slots, window);
}

__global__ void __launch_bounds__(JOIN_SUB + 32) driver_streamed_packed_kernel(
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
    const Packed pk{words, blk_base, blk_meta, blk_woff, n_blocks};
    const DensePlan plan{active, b_tile, n_b, bounds, nullptr, nullptr, nullptr,
                         t_slots, num_a, 0};
    driver_join_body<true>(plan, nullptr, pk, d_off, d_neff, attr_filter, attrs,
                           out_docs, out_mask, t_slots, window);
}

extern "C" int driver_streamed_launch(
    const void* d_off, const void* d_neff, const void* active,
    const void* attr_filter, const void* postings, const void* attrs,
    const void* b_tile, const void* n_b, const void* bounds,
    void* out_docs, void* out_mask,
    int q_n, int t_slots, int window, void* stream)
{
    static int allowed = 48 * 1024;
    const int num_a = (window + TILE - 1) / TILE;
    const int smem = probe_layout(t_slots, false).total;
    const cudaError_t err = allow_smem(driver_streamed_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(num_a * NSUB, q_n);
    driver_streamed_kernel<<<grid, JOIN_SUB + 32, smem, (cudaStream_t)stream>>>(
        (const int*)d_off, (const int*)d_neff, (const int*)active,
        (const int*)attr_filter, (const int*)postings, (const int*)attrs,
        (const int*)b_tile, (const int*)n_b, (const int*)bounds, (int*)out_docs,
        (int*)out_mask, t_slots, num_a, window);
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
    static int allowed = 48 * 1024;
    const int num_a = (window + TILE - 1) / TILE;
    const int smem = probe_layout(t_slots, true).total;
    const cudaError_t err = allow_smem(driver_streamed_packed_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(num_a * NSUB, q_n);
    driver_streamed_packed_kernel<<<grid, JOIN_SUB + 32, smem, (cudaStream_t)stream>>>(
        (const int*)d_off, (const int*)d_neff, (const int*)active,
        (const int*)attr_filter, (const uint32_t*)words, (const int*)blk_base,
        (const int*)blk_meta, (const int*)blk_woff, (const int*)attrs,
        (const int*)b_tile, (const int*)n_b, (const int*)bounds, (int*)out_docs,
        (int*)out_mask, t_slots, num_a, window, n_blocks);
    return (int)cudaGetLastError();
}

// The dynamic shared memory of one block of K1 or K4 (nstr = the terms'
// streams: t_slots, or 2 * t_slots for K4 with its delta), raw or packed.
extern "C" int probe_smem_bytes(int nstr, int packed)
{
    return probe_layout(nstr, packed != 0).total;
}

// The staging constants of probe_async.cuh, for host-side accounting of
// the rounds: out[0..5] = JOIN_SUB, RAW_CAP, WORD_CAP, DEC_BLKS, MAX_SEG,
// MAX_OPEN.
extern "C" void probe_round_caps(int* out)
{
    const int caps[] = {JOIN_SUB, RAW_CAP, WORD_CAP, DEC_BLKS, MAX_SEG, MAX_OPEN};
    for (int k = 0; k < 6; ++k) out[k] = caps[k];
}
