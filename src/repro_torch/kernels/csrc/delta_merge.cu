// K3: the merge-on-read driver merge, main window + the driver's delta slab,
// and K3p, its packed mode (K5), which reads both posting streams as
// block-codec words.
//
// Replaces the TPU kernel repro/kernels/delta_merge.py:merge_delta_windows
// (pallas_call at line 394, body _merge_kernel at line 165; its packed= /
// d_packed= mode at lines 342-373, decode at 202-245).  Python side and
// semantics: repro_torch/kernels/delta_merge.py (merge_delta_windows_cuda
// and merge_delta_windows_packed_cuda, and the plain versions they are
// held against).
//
// What bounds it on the H100: bytes and latency.  Per query it reads the
// live main window (docIDs + attrs, at most window postings) and the live
// delta slab (at most cap), and writes three int32 rows of window slots;
// per output slot the work is one binary search of log2(window) steps.
//
// Design: one thread per output slot, a grid of (output chunk, query)
// blocks of 256 threads, no shared memory.  Thread k finds its slot's
// co-rank on the merge path: i main postings and k - i delta postings come
// before it, found by a binary search over the two sorted streams with the
// main-first tie rule (the first k outputs take main[i-1] before delta[j]
// when main[i-1] <= delta[j]).  It then writes the smaller head, main on a
// tie.  The streams are the live ranges only: main [0, min(m_neff, window))
// and delta [0, min(d_len, cap)); slots past their sum are INVALID with
// src 0, which is what the merge over the INVALID-padded streams gives
// (the main pads sort first among equal keys and outnumber those slots).
// The TPU kernel's bitonic network over a power-of-two buffer and its
// empty-slab short-circuit are not carried over: an empty slab is a merge
// with an empty stream.
//
// K3p cannot keep K3's design as it is: the co-rank search reads main and
// delta postings at arbitrary positions, and packed words have no random
// access.  So K3p is one block of 512 threads per query that first
// decodes the blocks holding the live main window and the live delta slab
// (decode.cuh, one warp per block) into one row, then runs K3's co-rank
// merge (merge_slot in merge.cuh, shared with K8) out of that row, each thread
// over every 512th output slot.  Attrs stay raw.  The row holds
// (ceil(window/128) + 1) * 128 + cap + 128 ints (18.4 KB at window 4096
// and cap 256) and lives in dynamic shared memory when it fits the card's
// opt-in limit; a larger window takes the second form, the same kernel
// over a per-query row of a global scratch the wrapper allocates.  The
// entry point takes both twins' words and descriptors and no raw posting
// pointer.  What bounds it: the packed words of the decoded blocks plus
// 12 descriptor bytes a block, the attrs of the slots that reach the
// output, and the three outputs; one block per query leaves most SMs idle
// at 32 queries.
#include "merge.cuh"

#define THREADS 256
#define P_THREADS 512

__global__ void __launch_bounds__(THREADS) delta_merge_kernel(
    const int* __restrict__ postings,    // [P]
    const int* __restrict__ attrs,       // [P]
    const int* __restrict__ m_off,       // [Q]
    const int* __restrict__ m_neff,      // [Q]
    const int* __restrict__ d_postings,  // [D]
    const int* __restrict__ d_attrs,     // [D]
    const int* __restrict__ d_offsets,   // [n_terms]
    const int* __restrict__ d_lengths,   // [n_terms]
    const int* __restrict__ terms,       // [Q]
    int* __restrict__ out_docs,          // [Q, window]
    int* __restrict__ out_attrs,         // [Q, window]
    int* __restrict__ out_src,           // [Q, window]
    int window, int n_terms, int cap)
{
    const int q = blockIdx.y;
    const int k = blockIdx.x * THREADS + threadIdx.x;
    if (k >= window) return;
    int tt, na, nb;
    stream_lengths(m_neff, d_lengths, terms, q, window, n_terms, cap, tt, na, nb);
    const int64_t m0 = m_off[q], d0 = d_offsets[tt];
    merge_slot(postings + m0, attrs + m0, d_postings + d0, d_attrs + d0, na, nb,
               k, (int64_t)q * window + k, out_docs, out_attrs, out_src);
}

__global__ void __launch_bounds__(P_THREADS) delta_merge_packed_kernel(
    const uint32_t* __restrict__ words,   // main twin [Wd]
    const int* __restrict__ blk_base, const int* __restrict__ blk_meta,
    const int* __restrict__ blk_woff,
    const int* __restrict__ attrs,       // [P]
    const int* __restrict__ m_off, const int* __restrict__ m_neff,
    const uint32_t* __restrict__ d_words,  // delta twin
    const int* __restrict__ d_base, const int* __restrict__ d_meta,
    const int* __restrict__ d_woff,
    const int* __restrict__ d_attrs,     // [D]
    const int* __restrict__ d_offsets, const int* __restrict__ d_lengths,
    const int* __restrict__ terms,
    int* __restrict__ out_docs, int* __restrict__ out_attrs,
    int* __restrict__ out_src,
    int* __restrict__ scratch,           // [Q, row] or null (shared memory)
    int window, int n_terms, int cap, int n_blocks, int d_n_blocks,
    int m_room, int row)
{
    extern __shared__ int dyn[];
    const int q = blockIdx.x;
    int* buf = scratch != nullptr ? scratch + (int64_t)q * row : dyn;
    const Packed main_pk{words, blk_base, blk_meta, blk_woff, n_blocks};
    const Packed delta_pk{d_words, d_base, d_meta, d_woff, d_n_blocks};
    packed_merge_row(q, window, buf, main_pk, delta_pk, attrs, m_off, m_neff,
                     d_attrs, d_offsets, d_lengths, terms, out_docs, out_attrs,
                     out_src, window, n_terms, cap, m_room);
}

extern "C" int delta_merge_launch(
    const void* postings, const void* attrs, const void* m_off,
    const void* m_neff, const void* d_postings, const void* d_attrs,
    const void* d_offsets, const void* d_lengths, const void* terms,
    void* out_docs, void* out_attrs, void* out_src,
    int q_n, int window, int n_terms, int cap, void* stream)
{
    dim3 grid((window + THREADS - 1) / THREADS, q_n);
    delta_merge_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)postings, (const int*)attrs, (const int*)m_off,
        (const int*)m_neff, (const int*)d_postings, (const int*)d_attrs,
        (const int*)d_offsets, (const int*)d_lengths, (const int*)terms,
        (int*)out_docs, (int*)out_attrs, (int*)out_src, window, n_terms, cap);
    return (int)cudaGetLastError();
}

// m_room: ints of the row that hold the main window's blocks; row: the
// whole row (m_room + cap + 128).  scratch null: the row is dynamic shared
// memory, which needs row * 4 bytes within the card's opt-in limit.
extern "C" int delta_merge_packed_launch(
    const void* words, const void* blk_base, const void* blk_meta,
    const void* blk_woff, const void* attrs, const void* m_off,
    const void* m_neff, const void* d_words, const void* d_base,
    const void* d_meta, const void* d_woff, const void* d_attrs,
    const void* d_offsets, const void* d_lengths, const void* terms,
    void* out_docs, void* out_attrs, void* out_src, void* scratch,
    int q_n, int window, int n_terms, int cap, int n_blocks, int d_n_blocks,
    int m_room, int row, void* stream)
{
    const int smem = scratch != nullptr ? 0 : row * (int)sizeof(int);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            delta_merge_packed_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    delta_merge_packed_kernel<<<q_n, P_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int*)blk_base, (const int*)blk_meta,
        (const int*)blk_woff, (const int*)attrs, (const int*)m_off,
        (const int*)m_neff, (const uint32_t*)d_words, (const int*)d_base,
        (const int*)d_meta, (const int*)d_woff, (const int*)d_attrs,
        (const int*)d_offsets, (const int*)d_lengths, (const int*)terms,
        (int*)out_docs, (int*)out_attrs, (int*)out_src, (int*)scratch,
        window, n_terms, cap, n_blocks, d_n_blocks, m_room, row);
    return (int)cudaGetLastError();
}
