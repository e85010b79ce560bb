// K5: the block-codec decode on the card, shared by the packed kernels K1p
// (driver_streamed.cu), K3p (delta_merge.cu), K4p (streamed_join.cu), K6p
// (driver_compact.cu), K7p (streamed_compact.cu) and K8p (merge_compact.cu).
//
// Replaces the in-VMEM decode of the TPU kernels' packed modes:
// repro/kernels/posting_intersect.py _decode_block (line 231) and
// _decode_span (line 274), which delta_merge.py's packed mode calls too.
//
// The layout (repro_torch/core/index.py, pack_flat_postings): per BLOCK b
// of 128 postings, meta[b] = width | (count << 6); lane l's gap is the
// width-bit field at word woff[b] + ((l * width) >> 5), shift
// (l * width) & 31 (widths divide 32, so no field straddles a word); the
// docIDs are base[b] plus the inclusive prefix sum of the gaps (lane 0's
// gap is 0); lanes at or past count are INVALID_DOC.
//
// Design: one warp decodes one block.  Lane l extracts the gaps of the four
// consecutive positions 4l .. 4l+3, sums them, and a __shfl_up_sync scan
// over the warp gives it the sum of every gap before its four; base plus
// those sums are the docIDs, written to out[4l .. 4l+3] (shared memory or
// a global scratch row).  Fields are read as uint32_t and shifted
// logically (a 32-bit field may have its sign bit set); the width-32 mask
// is all ones (1u << 32 is undefined); a width-0 block reads no word; a
// block outside [0, n_blocks) decodes to all-INVALID without reading its
// descriptor.  So no read depends on the descriptor or word padding.
// The sums wrap modulo 2^32 exactly as the reference's int32 cumsum.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef INVALID_DOC
#define INVALID_DOC 2147483647
#endif
#define PBLOCK 128

// One packed flat array: the words and the per-block descriptors.
struct Packed {
    const uint32_t* words;
    const int* base;
    const int* meta;
    const int* woff;
    int n_blocks;
};

// Decode block b into out[0, 128).  Every lane of the warp must call it
// with the same b and out.
__device__ __forceinline__ void decode_block_warp(const Packed& pk, int64_t b,
                                                  int* out)
{
    const int lane = threadIdx.x & 31;
    if (b < 0 || b >= pk.n_blocks) {
#pragma unroll
        for (int j = 0; j < 4; ++j) out[4 * lane + j] = INVALID_DOC;
        return;
    }
    const int meta = pk.meta[b];
    const uint32_t w = (uint32_t)meta & 63u;
    const int cnt = meta >> 6;
    uint32_t s[4];   // inclusive sums of this lane's four gaps
    uint32_t acc = 0;
    if (w != 0) {
        const uint32_t mask = w >= 32u ? 0xFFFFFFFFu : ((1u << w) - 1u);
        const uint32_t* wb = pk.words + pk.woff[b];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint32_t bit = (uint32_t)(4 * lane + j) * w;
            acc += (wb[bit >> 5] >> (bit & 31u)) & mask;
            s[j] = acc;
        }
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = 0;
    }
    uint32_t incl = acc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += t;
    }
    const uint32_t lvl = (uint32_t)pk.base[b] + (incl - acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int l = 4 * lane + j;
        out[l] = l < cnt ? (int)(lvl + s[j]) : INVALID_DOC;
    }
}

// Decode the n_blk blocks b0 .. b0 + n_blk - 1 into out[0, n_blk * 128),
// one warp per block, all warps of the CTA.  The caller synchronises
// before reading.
__device__ __forceinline__ void decode_blocks(const Packed& pk, int64_t b0,
                                              int n_blk, int* out)
{
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    for (int k = warp; k < n_blk; k += n_warps)
        decode_block_warp(pk, b0 + k, out + k * PBLOCK);
}

// The blocks that hold the flat positions [p0, p0 + n): decoded into
// out[0, ...), the position p0 lands at out[lead]; returns lead.  n <= 0
// decodes nothing.
__device__ __forceinline__ int decode_range(const Packed& pk, int64_t p0,
                                            int n, int* out)
{
    const int lead = (int)(p0 & (PBLOCK - 1));
    const int n_blk = n > 0 ? (lead + n + PBLOCK - 1) / PBLOCK : 0;
    decode_blocks(pk, p0 >> 7, n_blk, out);
    return lead;
}
