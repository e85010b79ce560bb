// K10: the join of one list against another, with block skipping, over
// the synchronous probe (probe.cuh); the last kernel on it.  (K9, its
// batched twin, runs K4's body on the asynchronous probe: staged_join.cu.)
//
// Replaces the TPU kernel repro/kernels/posting_intersect.py:
// intersect_block_skip (pallas_call at line 396, body _intersect_kernel at
// line 92).  Python side and semantics:
// repro_torch/kernels/posting_intersect.py (block_skip_join_cuda, and the
// plain version it is held against).
//
// What it computes: for each slot of a TILE-padded list a_docs that is
// valid and passes the attribute predicate (attr_filter >= 0), the slot is
// a member when its docID occurs in the ascending, INVALID-padded list
// b_docs at positions [b_start*TILE, (b_start+n_b)*TILE) of its tile's
// skip map (compute_skip_map, computed on the card before the launch).
//
// What bounds it on the H100: bytes and latency.  Each block reads one
// 1024-slot tile of a (docIDs, attrs: 8 KB) and the B tiles of its skip
// range (for sorted lists about one or two tiles of 4 KB); the work per
// byte is one binary search of about ten steps.
//
// Design: one block of 256 threads per tile of a, four slots a thread in
// registers; the skip range, a contiguous sorted piece of b, is staged
// through shared memory in chunks and each thread binary-searches its live
// slots in it (block_skip_tile, written for any number of queries and
// slots, with a live stream, as K9's first design used it).  The TPU
// kernel's eight (8,128,128) broadcast compares (_tile_member) are not
// carried over.
#include "probe.cuh"

// Driver tile i of query q.  a_live and active may be null: all live, all
// active.
__device__ __forceinline__ void block_skip_tile(
    const int* __restrict__ a_docs,       // [Q, num_a*TILE]
    const int* __restrict__ a_attrs,      // [Q, num_a*TILE]
    const int* __restrict__ a_live,       // [Q, num_a*TILE] or null
    const int* __restrict__ b_docs,       // [Q, T, w_b]
    const int* __restrict__ active,       // [Q, T] or null
    int filt,
    const int* __restrict__ b_start,      // [Q, T, num_a]
    const int* __restrict__ n_b,          // [Q, T, num_a]
    int* __restrict__ out_mask,           // [Q, num_a*TILE]
    int q, int i, int t_slots, int num_a, int w_b)
{
    __shared__ int sb[STAGE];
    const int64_t row = (int64_t)q * num_a * TILE;

    int a[ITEMS];
    bool keep[ITEMS];
    bool alive = false;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int64_t o = row + i * TILE + r * THREADS + threadIdx.x;
        const int doc = a_docs[o];
        a[r] = doc;
        keep[r] = doc != INVALID_DOC && (filt < 0 || a_attrs[o] == filt)
                  && (a_live == nullptr || a_live[o] != 0);
        alive |= keep[r];
    }

    for (int t = 0; t < t_slots; ++t) {
        // Uniform across the block: stop once no slot survives.
        if (!__syncthreads_or(alive)) break;
        const int64_t qt = (int64_t)q * t_slots + t;
        if (active != nullptr && active[qt] == 0) continue;
        const int64_t qti = qt * num_a + i;
        int64_t rlo, rhi;
        planned_range(b_start[qti], n_b[qti], 0, w_b, rlo, rhi);
        bool found[ITEMS];
        RawList{b_docs + qt * w_b}.probe(rlo, rhi, sb, a, keep, found);
        alive = false;
#pragma unroll
        for (int r = 0; r < ITEMS; ++r) {
            keep[r] = keep[r] && found[r];
            alive |= keep[r];
        }
    }

#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
        out_mask[row + i * TILE + r * THREADS + threadIdx.x] = keep[r] ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS) intersect_block_skip_kernel(
    const int* __restrict__ a_docs, const int* __restrict__ a_attrs,
    const int* __restrict__ b_docs, const int* __restrict__ attr_filter,
    const int* __restrict__ b_start, const int* __restrict__ n_b,
    int* __restrict__ out_mask, int num_a, int w_b)
{
    block_skip_tile(a_docs, a_attrs, nullptr, b_docs, nullptr, attr_filter[0],
                    b_start, n_b, out_mask, 0, blockIdx.x, 1, num_a, w_b);
}

extern "C" int block_skip_launch(
    const void* a_docs, const void* a_attrs, const void* b_docs,
    const void* attr_filter, const void* b_start, const void* n_b,
    void* out_mask, int num_a, int w_b, void* stream)
{
    intersect_block_skip_kernel<<<num_a, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)a_docs, (const int*)a_attrs, (const int*)b_docs,
        (const int*)attr_filter, (const int*)b_start, (const int*)n_b,
        (int*)out_mask, num_a, w_b);
    return (int)cudaGetLastError();
}
