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
// 32 bytes a descriptor row.  The first design (one thread a slot, its
// co-rank searched in global memory behind five dependent lookups; K8p one
// block of 512 threads a live query decoding its whole window before any
// slot merged) ran 5.3x (K8) and 18x (K8p) its bound.
//
// Design: K3's (merge_path.cuh), with the work list as where a block
// finds its query (TableMerge): a grid of (output chunk of 256 slots, live
// group); block row g reads heads[g] and heads[g + 1], then the head row's
// query, whose main stream is clipped to the group's tiles; from there on
// it is K3's block: the main range staged while the driver's slab is
// looked up, the chunk's ranges staged in shared memory (K8p: their codec
// blocks decoded, a warp a block), each slot merged out of them.
// - K8 takes K3's stage switch: where the rooms pass the opt-in shared
//   memory (chunk_fits) it stages nothing and merges out of global memory.
// - K8p's chunk form runs wherever its rooms fit (chunk_fits); otherwise
//   its large-cap form, K3p's: one block of 512 threads a live group, the
//   query's window and slab decoded into a row of shared memory or of a
//   global scratch row (packed_merge_row, merge.cuh).  The host chooses,
//   as for K3p.
#include "merge_path.cuh"

#define K8_CHUNK 256     // K8's slots a block, one a thread
#define K8P_CHUNK 256    // K8p's slots a block, one a thread
#define ROW_THREADS 512  // K8p's large-cap form: threads a group

__global__ void __launch_bounds__(K8_CHUNK) merge_compact_kernel(
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
    int window, int n_terms, int cap, int m_room, int d_room)  // m_room 0: no staging
{
    merge_chunk_body<K8_CHUNK>(TableMerge{desc, heads}, postings, attrs, m_off, m_neff,
                               d_postings, d_attrs, d_offsets, d_lengths, terms,
                               out_docs, out_attrs, out_src, window, n_terms, cap,
                               m_room, d_room);
}

__global__ void __launch_bounds__(K8P_CHUNK) merge_compact_packed_kernel(
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
    int window, int n_terms, int cap, int n_blocks, int d_n_blocks,
    int m_room, int d_room)
{
    const Packed main_pk{words, blk_base, blk_meta, blk_woff, n_blocks};
    const Packed delta_pk{d_words, d_base, d_meta, d_woff, d_n_blocks};
    merge_chunk_packed_body<K8P_CHUNK>(
        TableMerge{desc, heads}, main_pk, delta_pk, attrs, m_off, m_neff, d_attrs,
        d_offsets, d_lengths, terms, out_docs, out_attrs, out_src, window, n_terms,
        cap, m_room, d_room);
}

__global__ void __launch_bounds__(ROW_THREADS) merge_compact_packed_row_kernel(
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
    int m_cap;
    const int q = TableMerge{desc, heads}.query(g, m_cap);
    int* buf = scratch != nullptr ? scratch + (int64_t)g * row : dyn;
    const Packed main_pk{words, blk_base, blk_meta, blk_woff, n_blocks};
    const Packed delta_pk{d_words, d_base, d_meta, d_woff, d_n_blocks};
    packed_merge_row(q, m_cap, buf, main_pk, delta_pk, attrs, m_off, m_neff,
                     d_attrs, d_offsets, d_lengths, terms, out_docs, out_attrs,
                     out_src, window, n_terms, cap, m_room);
}

// K8: shared memory a block as K3's (delta_merge_launch): 2 * (m_room +
// d_room) ints, none with stage 0.
extern "C" int merge_compact_launch(
    const void* desc, const void* heads, const void* postings,
    const void* attrs, const void* m_off, const void* m_neff,
    const void* d_postings, const void* d_attrs, const void* d_offsets,
    const void* d_lengths, const void* terms, void* out_docs,
    void* out_attrs, void* out_src,
    int n_groups, int window, int n_terms, int cap, int stage, void* stream)
{
    int m_room, d_room;
    merge_rooms(window, cap, K8_CHUNK, false, stage, m_room, d_room);
    const int smem = 2 * (m_room + d_room) * (int)sizeof(int);
    const cudaError_t e = merge_allow_smem(merge_compact_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((window + K8_CHUNK - 1) / K8_CHUNK, n_groups);
    merge_compact_kernel<<<grid, K8_CHUNK, smem, (cudaStream_t)stream>>>(
        (const int*)desc, (const int*)heads, (const int*)postings,
        (const int*)attrs, (const int*)m_off, (const int*)m_neff,
        (const int*)d_postings, (const int*)d_attrs, (const int*)d_offsets,
        (const int*)d_lengths, (const int*)terms, (int*)out_docs,
        (int*)out_attrs, (int*)out_src, window, n_terms, cap, m_room, d_room);
    return (int)cudaGetLastError();
}

// K8p's chunk form: shared memory a block as K3p's
// (delta_merge_packed_launch).
extern "C" int merge_compact_packed_launch(
    const void* desc, const void* heads, const void* words,
    const void* blk_base, const void* blk_meta, const void* blk_woff,
    const void* attrs, const void* m_off, const void* m_neff,
    const void* d_words, const void* d_base, const void* d_meta,
    const void* d_woff, const void* d_attrs, const void* d_offsets,
    const void* d_lengths, const void* terms, void* out_docs,
    void* out_attrs, void* out_src,
    int n_groups, int window, int n_terms, int cap, int n_blocks,
    int d_n_blocks, void* stream)
{
    int m_room, d_room;
    merge_rooms(window, cap, K8P_CHUNK, true, 1, m_room, d_room);
    const int smem = 2 * (m_room + d_room) * (int)sizeof(int);
    const cudaError_t e = merge_allow_smem(merge_compact_packed_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((window + K8P_CHUNK - 1) / K8P_CHUNK, n_groups);
    merge_compact_packed_kernel<<<grid, K8P_CHUNK, smem, (cudaStream_t)stream>>>(
        (const int*)desc, (const int*)heads, (const uint32_t*)words,
        (const int*)blk_base, (const int*)blk_meta, (const int*)blk_woff,
        (const int*)attrs, (const int*)m_off, (const int*)m_neff,
        (const uint32_t*)d_words, (const int*)d_base, (const int*)d_meta,
        (const int*)d_woff, (const int*)d_attrs, (const int*)d_offsets,
        (const int*)d_lengths, (const int*)terms, (int*)out_docs,
        (int*)out_attrs, (int*)out_src,
        window, n_terms, cap, n_blocks, d_n_blocks, m_room, d_room);
    return (int)cudaGetLastError();
}

// K8p's large-cap form: m_room, row and scratch as in
// delta_merge_packed_row_launch (delta_merge.cu); scratch, when given,
// holds one row per group.
extern "C" int merge_compact_packed_row_launch(
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
    const cudaError_t e = merge_allow_smem(merge_compact_packed_row_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    merge_compact_packed_row_kernel<<<n_groups, ROW_THREADS, smem, (cudaStream_t)stream>>>(
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
