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
// the merge itself is a few compares a slot.
//
// Design: a grid of (output chunk, query) blocks, one thread a slot.  The
// streams are the live ranges only: main [0, na = min(m_neff, window)) and
// delta [0, nb = min(d_len, cap)); slots past na + nb are INVALID with src
// 0, which is what the merge over the INVALID-padded streams gives (the
// main pads sort first among equal keys and outnumber those slots); a
// chunk wholly past na + nb writes them and reads nothing.  Equal docIDs
// take main first (a[i-1] <= b[j]).  A slot's co-rank lies in [max(0, k -
// nb), min(k, na)], so a chunk of S slots at k0 reads nothing outside main
// [max(0, k0 - nb), min(na, k0 + S)) and delta [max(0, k0 - na), min(nb,
// k0 + S)) (chunk_ranges, merge_path.cuh): at most cap + S and cap
// postings, whatever the window.  The block stages them into shared
// memory and each thread finds its slot's co-rank there
// (merge_staged_slot); no search in global memory.  The lookups take two
// dependent rounds (the query's terms / m_neff / m_off, then its driver's
// d_lengths / d_offsets); the main range is staged with cap in place of nb,
// [max(0, k0 - cap), min(na, k0 + S)) (staged_main), so its loads are in
// flight during the second round, and the delta range's after it.  Every
// load of a block is issued before its first store to shared memory
// (Held).
// - K3 (K3_CHUNK slots a block) stages the ranges' docIDs and attrs with
//   coalesced loads.  Staging every position a chunk can read, not the
//   exact ranges, spares a co-rank search of the chunk's ends in global
//   memory: two more dependent rounds of loads.
// - K3p (K3P_CHUNK slots a block): packed words have no random access, so
//   the block decodes the codec blocks that hold its ranges (at most 5
//   main and 3 delta blocks at cap 256, for any window), one warp a block
//   (decode.cuh; main blocks on the low warps, delta blocks on the high
//   ones), stages the ranges' raw attrs beside them, and merges as K3 does.
// The block bodies are merge_path.cuh's (merge_chunk_body,
// merge_chunk_packed_body) with DenseMerge, block row y query y; K8/K8p
// (merge_compact.cu) run the same bodies over the work list.
// Where a chunk's staged ranges pass the card's opt-in shared memory
// (chunk_rooms: caps past about 14,000 at window 65536), K3 stages nothing
// and each thread searches its co-rank in the global streams, the same
// merge (merge_staged_slot); K3p, whose streams have no random access,
// takes a large-cap form: one block of 512 threads a query, its whole
// window and slab decoded into a row of shared memory or of a global
// scratch (packed_merge_row, merge.cuh, shared with K8p).  The K3p entry
// points take both twins' words and descriptors and no raw posting
// pointer.
#include "merge_path.cuh"

#define K3_CHUNK 256     // K3's slots a block, one a thread
#define K3P_CHUNK 256    // K3p's slots a block, one a thread
#define ROW_THREADS 512  // K3p's large-cap form: threads a query

__global__ void __launch_bounds__(K3_CHUNK) delta_merge_kernel(
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
    merge_chunk_body<K3_CHUNK>(DenseMerge{}, postings, attrs, m_off, m_neff, d_postings,
                               d_attrs, d_offsets, d_lengths, terms, out_docs, out_attrs,
                               out_src, window, n_terms, cap, m_room, d_room);
}

__global__ void __launch_bounds__(K3P_CHUNK) delta_merge_packed_kernel(
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
    merge_chunk_packed_body<K3P_CHUNK>(
        DenseMerge{}, main_pk, delta_pk, attrs, m_off, m_neff, d_attrs, d_offsets,
        d_lengths, terms, out_docs, out_attrs, out_src, window, n_terms, cap, m_room,
        d_room);
}

__global__ void __launch_bounds__(ROW_THREADS) delta_merge_packed_row_kernel(
    const uint32_t* __restrict__ words,
    const int* __restrict__ blk_base, const int* __restrict__ blk_meta,
    const int* __restrict__ blk_woff,
    const int* __restrict__ attrs,
    const int* __restrict__ m_off, const int* __restrict__ m_neff,
    const uint32_t* __restrict__ d_words,
    const int* __restrict__ d_base, const int* __restrict__ d_meta,
    const int* __restrict__ d_woff,
    const int* __restrict__ d_attrs,
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

// K3: shared memory a block is 2 * (m_room + d_room) ints, m_room =
// min(window, cap + K3_CHUNK) for its main range and d_room = min(cap,
// window + K3_CHUNK) for its delta range (chunk_rooms); none with stage 0
// (the caller's choice where that passes the opt-in limit, chunk_fits).
extern "C" int delta_merge_launch(
    const void* postings, const void* attrs, const void* m_off,
    const void* m_neff, const void* d_postings, const void* d_attrs,
    const void* d_offsets, const void* d_lengths, const void* terms,
    void* out_docs, void* out_attrs, void* out_src,
    int q_n, int window, int n_terms, int cap, int stage, void* stream)
{
    int m_room, d_room;
    merge_rooms(window, cap, K3_CHUNK, false, stage, m_room, d_room);
    const int smem = 2 * (m_room + d_room) * (int)sizeof(int);
    const cudaError_t e = merge_allow_smem(delta_merge_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((window + K3_CHUNK - 1) / K3_CHUNK, q_n);
    delta_merge_kernel<<<grid, K3_CHUNK, smem, (cudaStream_t)stream>>>(
        (const int*)postings, (const int*)attrs, (const int*)m_off,
        (const int*)m_neff, (const int*)d_postings, (const int*)d_attrs,
        (const int*)d_offsets, (const int*)d_lengths, (const int*)terms,
        (int*)out_docs, (int*)out_attrs, (int*)out_src, window, n_terms, cap,
        m_room, d_room);
    return (int)cudaGetLastError();
}

// K3p's chunk form: shared memory a block is 2 * (m_room + d_room) ints,
// m_room for main ranges of at most min(window, cap + K3P_CHUNK) postings
// and d_room for delta ranges of at most min(cap, window + K3P_CHUNK).
extern "C" int delta_merge_packed_launch(
    const void* words, const void* blk_base, const void* blk_meta,
    const void* blk_woff, const void* attrs, const void* m_off,
    const void* m_neff, const void* d_words, const void* d_base,
    const void* d_meta, const void* d_woff, const void* d_attrs,
    const void* d_offsets, const void* d_lengths, const void* terms,
    void* out_docs, void* out_attrs, void* out_src,
    int q_n, int window, int n_terms, int cap, int n_blocks, int d_n_blocks,
    void* stream)
{
    int m_room, d_room;
    merge_rooms(window, cap, K3P_CHUNK, true, 1, m_room, d_room);
    const int smem = 2 * (m_room + d_room) * (int)sizeof(int);
    const cudaError_t e = merge_allow_smem(delta_merge_packed_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((window + K3P_CHUNK - 1) / K3P_CHUNK, q_n);
    delta_merge_packed_kernel<<<grid, K3P_CHUNK, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int*)blk_base, (const int*)blk_meta,
        (const int*)blk_woff, (const int*)attrs, (const int*)m_off,
        (const int*)m_neff, (const uint32_t*)d_words, (const int*)d_base,
        (const int*)d_meta, (const int*)d_woff, (const int*)d_attrs,
        (const int*)d_offsets, (const int*)d_lengths, (const int*)terms,
        (int*)out_docs, (int*)out_attrs, (int*)out_src,
        window, n_terms, cap, n_blocks, d_n_blocks, m_room, d_room);
    return (int)cudaGetLastError();
}

// K3p's large-cap form.  m_room: ints of the row that hold the main
// window's blocks; row: the whole row (m_room + cap + 128).  scratch null:
// the row is dynamic shared memory, which needs row * 4 bytes within the
// card's opt-in limit.
extern "C" int delta_merge_packed_row_launch(
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
    const cudaError_t e = merge_allow_smem(delta_merge_packed_row_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    delta_merge_packed_row_kernel<<<q_n, ROW_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int*)blk_base, (const int*)blk_meta,
        (const int*)blk_woff, (const int*)attrs, (const int*)m_off,
        (const int*)m_neff, (const uint32_t*)d_words, (const int*)d_base,
        (const int*)d_meta, (const int*)d_woff, (const int*)d_attrs,
        (const int*)d_offsets, (const int*)d_lengths, (const int*)terms,
        (int*)out_docs, (int*)out_attrs, (int*)out_src, (int*)scratch,
        window, n_terms, cap, n_blocks, d_n_blocks, m_room, row);
    return (int)cudaGetLastError();
}
