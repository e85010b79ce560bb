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
// What bounds it on the H100: the latency of dependent loads, as K1 (the
// bytes of a main-path launch take about 0.6 us at the card's memory
// rate).  The first design (one block of 256 threads a group, 128 blocks
// on 132 SMs, walking the group's rows in turn and staging each row's
// 1024-posting tile behind two barriers, so one round trip a row with
// nothing in flight) ran about 20x that bound, 3x K1's time.
//
// Design: K1's body and probe (slave_join.cuh, probe_async.cuh), with the
// table as its plan (TablePlan).  The grid is groups * NSUB blocks, a
// block JOIN_SUB = 256 slots of its group's driver tile; the producer warp
// reads the group's rows and sets one stream a term slot: the run's tiles
// are consecutive (the dense plan's steps), so their union is K1's planned
// range, staged by bulk copies, two rounds in flight, and searched from an
// interpolated window.  Against K1 a block waits for two more dependent
// loads: the group's head (heads[g], then its row) before the driver, and
// its rows before the term bounds.  K6p decodes the sub-tile's driver
// blocks and narrows each packed range on blk_base, as K1p.
#include "slave_join.cuh"

__global__ void __launch_bounds__(JOIN_SUB + 32) driver_compact_kernel(
    const int* __restrict__ desc, const int* __restrict__ heads,
    const int* __restrict__ d_off, const int* __restrict__ d_neff,
    const int* __restrict__ attr_filter,
    const int* __restrict__ postings,     // [P]
    const int* __restrict__ attrs, const int* __restrict__ bounds,
    int* __restrict__ out_docs, int* __restrict__ out_mask,
    int t_slots, int window)
{
    const Packed none{nullptr, nullptr, nullptr, nullptr, 0};
    const TablePlan plan{desc, heads, bounds, nullptr, t_slots, 0};
    driver_join_body<false>(plan, postings, none, d_off, d_neff, attr_filter, attrs,
                            out_docs, out_mask, t_slots, window);
}

__global__ void __launch_bounds__(JOIN_SUB + 32) driver_compact_packed_kernel(
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
    const Packed pk{words, blk_base, blk_meta, blk_woff, n_blocks};
    const TablePlan plan{desc, heads, bounds, nullptr, t_slots, 0};
    driver_join_body<true>(plan, nullptr, pk, d_off, d_neff, attr_filter, attrs,
                           out_docs, out_mask, t_slots, window);
}

extern "C" int driver_compact_launch(
    const void* desc, const void* heads, const void* d_off,
    const void* d_neff, const void* attr_filter, const void* postings,
    const void* attrs, const void* bounds, void* out_docs, void* out_mask,
    int n_groups, int t_slots, int window, void* stream)
{
    static int allowed = 48 * 1024;
    const int smem = probe_layout(t_slots, false).total;
    const cudaError_t err = allow_smem(driver_compact_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    driver_compact_kernel<<<n_groups * NSUB, JOIN_SUB + 32, smem,
                            (cudaStream_t)stream>>>(
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
    static int allowed = 48 * 1024;
    const int smem = probe_layout(t_slots, true).total;
    const cudaError_t err = allow_smem(driver_compact_packed_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    driver_compact_packed_kernel<<<n_groups * NSUB, JOIN_SUB + 32, smem,
                                   (cudaStream_t)stream>>>(
        (const int*)desc, (const int*)heads, (const int*)d_off,
        (const int*)d_neff, (const int*)attr_filter, (const uint32_t*)words,
        (const int*)blk_base, (const int*)blk_meta, (const int*)blk_woff,
        (const int*)attrs, (const int*)bounds, (int*)out_docs,
        (int*)out_mask, t_slots, window, n_blocks);
    return (int)cudaGetLastError();
}
