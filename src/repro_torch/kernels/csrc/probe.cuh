// The synchronous membership probe of the staged join K10 (block_skip.cu),
// its last kernel.  (The slave joins K1, K4, K6, K7 and the batched staged
// join K9 stage their probes asynchronously: probe_async.cuh.)
//
// A block of THREADS threads owns one 1024-posting driver tile; each thread
// keeps ITEMS driver postings in registers.  For one (query, term, driver
// tile) the probe plan names a run of physical tiles of a sorted row,
// clipped to [lo, hi): positions [max(b_tile*TILE, lo),
// min((b_tile+n_b)*TILE, hi)), empty when n_b <= 0.  That range is one
// contiguous piece of one ascending row, so it stays sorted: the block
// stages it through shared memory in chunks of CHUNK postings and each
// thread binary-searches its postings in a chunk whose [min, max] can hold
// them.  Every thread of the block must call a probe with the same range
// (it synchronises).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"   // INVALID_DOC

#define TILE 1024
#define THREADS 256
#define ITEMS (TILE / THREADS)
#define CHUNK 2048
#define STAGE CHUNK
#define INVALID_ATTR (-1)

// The planned range [rlo, rhi) of one (query, term, driver tile).
__device__ __forceinline__ void planned_range(
    int b_tile, int n_b, int64_t lo, int64_t hi, int64_t& rlo, int64_t& rhi)
{
    const int64_t tile0 = (int64_t)b_tile * TILE;
    rlo = tile0 > lo ? tile0 : lo;
    rhi = tile0 + (int64_t)n_b * TILE;
    if (rhi > hi) rhi = hi;
    if (n_b <= 0) rhi = rlo;
}

// found[r] |= need[r] and a[r] occurs in the sorted sb[0, len).
__device__ __forceinline__ void search_staged(
    const int* sb, int len, const int (&a)[ITEMS], const bool (&need)[ITEMS],
    bool (&found)[ITEMS])
{
    const int cmin = sb[0], cmax = sb[len - 1];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int x = a[r];
        if (!need[r] || found[r] || x < cmin || x > cmax) continue;
        int l = 0, h = len - 1;   // first index with sb[idx] >= x
        while (l < h) {
            const int m = (l + h) >> 1;
            if (sb[m] < x) l = m + 1; else h = m;
        }
        found[r] = sb[l] == x;
    }
}

// Raw postings of one flat array.
struct RawList {
    const int* p;

    // found[r] = need[r] and a[r] occurs in p[rlo, rhi).
    __device__ __forceinline__ void probe(
        int64_t rlo, int64_t rhi, int* sb, const int (&a)[ITEMS],
        const bool (&need)[ITEMS], bool (&found)[ITEMS]) const
    {
#pragma unroll
        for (int r = 0; r < ITEMS; ++r) found[r] = false;
        for (int64_t c0 = rlo; c0 < rhi; c0 += CHUNK) {
            const int len = (int)((rhi - c0) < CHUNK ? (rhi - c0) : CHUNK);
            __syncthreads();  // the previous chunk is no longer read
            for (int k = threadIdx.x; k < len; k += THREADS) sb[k] = p[c0 + k];
            __syncthreads();
            search_staged(sb, len, a, need, found);
        }
    }
};
