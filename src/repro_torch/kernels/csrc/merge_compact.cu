// K8: the merge-on-read driver merge over a work list (K3's compacted
// twin), and K8p, its packed mode, which decodes both posting streams.
//
// Replaces the TPU kernel repro/kernels/delta_merge.py:_merge_compact_call
// (pallas_call at line 650, body _merge_compact_kernel at line 457;
// orchestrator merge_delta_windows_compact at line 676).  Python side and
// semantics: repro_torch/kernels/delta_merge.py (merge_compact_cuda and
// merge_compact_packed_cuda, and the plain versions they are held
// against, which execute the same table).
//
// What it computes: the work list (repro_torch/kernels/worklist.py,
// build_merge_worklist) holds, per live query q, one row [q, j, ...] for
// each main-window tile j < ceil(m_neff/TILE) (at least one), FIRST on the
// first and LAST on the last.  A live query's output is K3's whole merged
// row (docs, attrs, src) of its main window, read from the tiles its rows
// name, and its driver term's delta slab.  Inert queries have no row; the
// wrapper fills theirs with (INVALID_DOC, INVALID_ATTR, src 1).
//
// What bounds it on the H100: bytes and latency, as K3: the live main
// window and the live slab of each live query, three int32 output rows,
// 32 bytes a descriptor row.
//
// Design: K8 is K3's co-rank merge (merge_slot, merge.cuh) over a grid of
// (output chunk, live query), the live queries taken from the work list's
// group heads (heads[g] .. heads[g + 1] - 1 are query desc[heads[g], 0]'s
// tiles), the main stream bounded by the tiles the group names.  K8p is
// K3p's one-block-per-query decode row (packed_merge_row, merge.cuh), in
// dynamic shared memory or, past the opt-in limit, in a global scratch
// row per live query, launched over the live queries only.
#include "merge.cuh"

#define TILE 1024
#define THREADS 256
#define P_THREADS 512

// The live query of group g and the main postings its tiles cover.
__device__ __forceinline__ void group_query(
    const int* __restrict__ desc, const int* __restrict__ heads, int g,
    int& q, int& m_cap)
{
    const int r0 = heads[g];
    q = desc[8 * r0];
    m_cap = (heads[g + 1] - r0) * TILE;
}

__global__ void __launch_bounds__(THREADS) merge_compact_kernel(
    const int* __restrict__ desc,        // [n_pad, 8]
    const int* __restrict__ heads,       // [n_groups + 1]
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
    const int k = blockIdx.x * THREADS + threadIdx.x;
    if (k >= window) return;
    int q, m_cap, tt, na, nb;
    group_query(desc, heads, blockIdx.y, q, m_cap);
    stream_lengths(m_neff, d_lengths, terms, q, window, n_terms, cap, tt, na, nb);
    if (na > m_cap) na = m_cap;
    const int64_t m0 = m_off[q], d0 = d_offsets[tt];
    merge_slot(postings + m0, attrs + m0, d_postings + d0, d_attrs + d0, na, nb,
               k, (int64_t)q * window + k, out_docs, out_attrs, out_src);
}

__global__ void __launch_bounds__(P_THREADS) merge_compact_packed_kernel(
    const int* __restrict__ desc, const int* __restrict__ heads,
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
    int* __restrict__ scratch,           // [n_groups, row] or null (shared)
    int window, int n_terms, int cap, int n_blocks, int d_n_blocks,
    int m_room, int row)
{
    extern __shared__ int dyn[];
    const int g = blockIdx.x;
    int q, m_cap;
    group_query(desc, heads, g, q, m_cap);
    int* buf = scratch != nullptr ? scratch + (int64_t)g * row : dyn;
    const Packed main_pk{words, blk_base, blk_meta, blk_woff, n_blocks};
    const Packed delta_pk{d_words, d_base, d_meta, d_woff, d_n_blocks};
    packed_merge_row(q, m_cap, buf, main_pk, delta_pk, attrs, m_off, m_neff,
                     d_attrs, d_offsets, d_lengths, terms, out_docs, out_attrs,
                     out_src, window, n_terms, cap, m_room);
}

extern "C" int merge_compact_launch(
    const void* desc, const void* heads, const void* postings,
    const void* attrs, const void* m_off, const void* m_neff,
    const void* d_postings, const void* d_attrs, const void* d_offsets,
    const void* d_lengths, const void* terms, void* out_docs,
    void* out_attrs, void* out_src,
    int n_groups, int window, int n_terms, int cap, void* stream)
{
    dim3 grid((window + THREADS - 1) / THREADS, n_groups);
    merge_compact_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)desc, (const int*)heads, (const int*)postings,
        (const int*)attrs, (const int*)m_off, (const int*)m_neff,
        (const int*)d_postings, (const int*)d_attrs, (const int*)d_offsets,
        (const int*)d_lengths, (const int*)terms, (int*)out_docs,
        (int*)out_attrs, (int*)out_src, window, n_terms, cap);
    return (int)cudaGetLastError();
}

// m_room, row and scratch as in delta_merge_packed_launch (delta_merge.cu);
// scratch, when given, holds one row per group.
extern "C" int merge_compact_packed_launch(
    const void* desc, const void* heads, const void* words,
    const void* blk_base, const void* blk_meta, const void* blk_woff,
    const void* attrs, const void* m_off, const void* m_neff,
    const void* d_words, const void* d_base, const void* d_meta,
    const void* d_woff, const void* d_attrs, const void* d_offsets,
    const void* d_lengths, const void* terms, void* out_docs,
    void* out_attrs, void* out_src, void* scratch,
    int n_groups, int window, int n_terms, int cap, int n_blocks,
    int d_n_blocks, int m_room, int row, void* stream)
{
    const int smem = scratch != nullptr ? 0 : row * (int)sizeof(int);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            merge_compact_packed_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    merge_compact_packed_kernel<<<n_groups, P_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)desc, (const int*)heads, (const uint32_t*)words,
        (const int*)blk_base, (const int*)blk_meta, (const int*)blk_woff,
        (const int*)attrs, (const int*)m_off, (const int*)m_neff,
        (const uint32_t*)d_words, (const int*)d_base, (const int*)d_meta,
        (const int*)d_woff, (const int*)d_attrs, (const int*)d_offsets,
        (const int*)d_lengths, (const int*)terms, (int*)out_docs,
        (int*)out_attrs, (int*)out_src, (int*)scratch,
        window, n_terms, cap, n_blocks, d_n_blocks, m_room, row);
    return (int)cudaGetLastError();
}
