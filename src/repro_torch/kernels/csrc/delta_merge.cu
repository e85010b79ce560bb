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
#define STAGE_U 2        // staged ints a thread holds in registers a range (ptxas spills K3 at 3)

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
    extern __shared__ int4 dyn4[];
    int* sa = reinterpret_cast<int*>(dyn4);   // [m_room] main docIDs
    int* saa = sa + m_room;                   // [m_room] their attrs
    int* sb = saa + m_room;                   // [d_room] delta docIDs
    int* sba = sb + d_room;                   // [d_room] their attrs
    const int q = blockIdx.y;
    const int k0 = blockIdx.x * K3_CHUNK, k = k0 + threadIdx.x;
    const int64_t o = (int64_t)q * window + k;
    // round 1: the query's streams; round 2: the driver's slab, and the
    // main range staged meanwhile (bounded by cap, not yet by nb)
    const MainStream ms = main_stream(m_off, m_neff, terms, q, window, n_terms);
    const int len = d_lengths[ms.tt];
    const int64_t d0 = d_offsets[ms.tt];
    int mlo, mhi;
    staged_main(ms.na, k0, K3_CHUNK, cap, mlo, mhi);
    const bool stage = m_room > 0;
    const int la = stage && mhi > mlo ? mhi - mlo : 0;
    const int* a = postings + ms.m0 + mlo;
    const int* aa = attrs + ms.m0 + mlo;
    Held<STAGE_U, K3_CHUNK> ha, haa, hb, hba;
    ha.load(a, la);
    haa.load(aa, la);
    const int nb = delta_length(ms, len, cap);
    const int n = ms.na + nb;
    if (k0 >= n) {
        if (k < window) invalid_slot(o, out_docs, out_attrs, out_src);
        return;
    }
    if (nb == 0) {   // no slab: the window itself, no staging
        if (k < n) {
            out_docs[o] = postings[ms.m0 + k];
            out_attrs[o] = attrs[ms.m0 + k];
            out_src[o] = 0;
        } else if (k < window) {
            invalid_slot(o, out_docs, out_attrs, out_src);
        }
        return;
    }
    const ChunkRanges r = chunk_ranges(ms.na, nb, k0, K3_CHUNK);
    const int lb = stage ? r.jhi - r.jlo : 0;
    const int* b = d_postings + d0 + r.jlo;
    const int* ba = d_attrs + d0 + r.jlo;
    hb.load(b, lb);
    hba.load(ba, lb);
    ha.store(a, la, sa);
    haa.store(aa, la, saa);
    hb.store(b, lb, sb);
    hba.store(ba, lb, sba);
    __syncthreads();
    if (k >= window) return;
    if (k >= n) {
        invalid_slot(o, out_docs, out_attrs, out_src);
        return;
    }
    if (stage)
        merge_staged_slot(sa, saa, mlo, sb, sba, r.jlo, r, k, o, out_docs, out_attrs,
                          out_src);
    else
        merge_staged_slot(postings + ms.m0, attrs + ms.m0, 0, d_postings + d0,
                          d_attrs + d0, 0, r, k, o, out_docs, out_attrs, out_src);
}

// The blocks of pk that hold flat positions [p0 + lo, p0 + hi): the first
// block and how many (0 for an empty range).
__device__ __forceinline__ int64_t range_blocks(int64_t p0, int lo, int hi, int& n_blk)
{
    const int64_t first = (p0 + lo) >> 7;
    n_blk = hi > lo ? (int)(((p0 + hi - 1) >> 7) - first + 1) : 0;
    return first;
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
    extern __shared__ int4 dyn4[];
    int* sa = reinterpret_cast<int*>(dyn4);   // [m_room] decoded main blocks
    int* saa = sa + m_room;                   // [m_room] their attrs
    int* sb = saa + m_room;                   // [d_room] decoded delta blocks
    int* sba = sb + d_room;                   // [d_room] their attrs
    const int q = blockIdx.y;
    const int k0 = blockIdx.x * K3P_CHUNK, k = k0 + threadIdx.x;
    const int warp = threadIdx.x >> 5, n_warps = K3P_CHUNK / 32;
    const int64_t o = (int64_t)q * window + k;
    const Packed main_pk{words, blk_base, blk_meta, blk_woff, n_blocks};
    const Packed delta_pk{d_words, d_base, d_meta, d_woff, d_n_blocks};
    // round 1: the query's streams; then the main blocks decode (bounded by
    // cap, not yet by nb) while the driver's slab is looked up
    const MainStream ms = main_stream(m_off, m_neff, terms, q, window, n_terms);
    const int len = d_lengths[ms.tt];
    const int64_t d0 = d_offsets[ms.tt];
    int mlo, mhi, n_mb;
    staged_main(ms.na, k0, K3P_CHUNK, cap, mlo, mhi);
    const int64_t mb = range_blocks(ms.m0, mlo, mhi, n_mb);
    const int a_org = (int)((mb << 7) - ms.m0);
    const int la = mhi > mlo ? mhi - mlo : 0;
    const int* aa = attrs + ms.m0 + mlo;
    Held<STAGE_U, K3P_CHUNK> haa, hba;
    haa.load(aa, la);
    for (int w = warp; w < n_mb; w += n_warps)
        decode_block_warp(main_pk, mb + w, sa + w * PBLOCK);
    const int nb = delta_length(ms, len, cap);
    const int n = ms.na + nb;
    if (k0 >= n) {
        if (k < window) invalid_slot(o, out_docs, out_attrs, out_src);
        return;
    }
    const ChunkRanges r = chunk_ranges(ms.na, nb, k0, K3P_CHUNK);
    int n_db;
    const int64_t db = range_blocks(d0, r.jlo, r.jhi, n_db);
    const int b_org = (int)((db << 7) - d0);
    const int lb = r.jhi - r.jlo;
    const int* ba = d_attrs + d0 + r.jlo;
    hba.load(ba, lb);
    // delta block i on warp n_warps - 1 - i first: the main blocks took
    // the low warps
    for (int i = n_warps - 1 - warp; i < n_db; i += n_warps)
        decode_block_warp(delta_pk, db + i, sb + i * PBLOCK);
    haa.store(aa, la, saa + (mlo - a_org));
    hba.store(ba, lb, sba + (r.jlo - b_org));
    __syncthreads();
    if (k >= window) return;
    if (k >= n) {
        invalid_slot(o, out_docs, out_attrs, out_src);
        return;
    }
    merge_staged_slot(sa, saa, a_org, sb, sba, b_org, r, k, o, out_docs, out_attrs,
                      out_src);
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
    const int m_room = !stage ? 0 : window < cap + K3_CHUNK ? window : cap + K3_CHUNK;
    const int d_room = !stage ? 0 : cap < window + K3_CHUNK ? cap : window + K3_CHUNK;
    const int smem = 2 * (m_room + d_room) * (int)sizeof(int);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            delta_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((window + K3_CHUNK - 1) / K3_CHUNK, q_n);
    delta_merge_kernel<<<grid, K3_CHUNK, smem, (cudaStream_t)stream>>>(
        (const int*)postings, (const int*)attrs, (const int*)m_off,
        (const int*)m_neff, (const int*)d_postings, (const int*)d_attrs,
        (const int*)d_offsets, (const int*)d_lengths, (const int*)terms,
        (int*)out_docs, (int*)out_attrs, (int*)out_src, window, n_terms, cap,
        m_room, d_room);
    return (int)cudaGetLastError();
}

// Ints of K3p's staged blocks a stream: the blocks that hold a range of at
// most width postings starting anywhere (chunk_rooms).
static int blocks_room(int width)
{
    return ((width + PBLOCK - 1) / PBLOCK + 1) * PBLOCK;
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
    const int m_room = blocks_room(window < cap + K3P_CHUNK ? window : cap + K3P_CHUNK);
    const int d_room = blocks_room(cap < window + K3P_CHUNK ? cap : window + K3P_CHUNK);
    const int smem = 2 * (m_room + d_room) * (int)sizeof(int);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            delta_merge_packed_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
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
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            delta_merge_packed_row_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
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
