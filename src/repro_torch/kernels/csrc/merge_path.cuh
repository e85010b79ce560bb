// The chunked merge path of K3 and K3p (delta_merge.cu) and of their
// work-list twins K8 and K8p (merge_compact.cu): a block owns a chunk of
// output slots of one query's merge, stages into shared memory the main
// and delta postings the chunk can read, and each thread merges its slot
// out of them.  The block bodies (merge_chunk_body, merge_chunk_packed_body)
// are templated on where a block finds its query, as slave_join.cuh's are
// on a plan: DenseMerge (K3/K3p: query blockIdx.y) or TableMerge (K8/K8p:
// the live query of work-list group blockIdx.y, its main stream clipped
// to the tiles the group names).  merge.cuh (merge_slot, packed_merge_row)
// stays the large-cap form of K3p and K8p.  Python side:
// repro_torch/kernels/delta_merge.py (chunk_ranges, chunk_rooms and
// merge_chunks_replay replay this file's arithmetic on the host, with
// desc / heads the table form).
#pragma once
#include <climits>

#include "merge.cuh"

#define WL_TILE 1024   // main postings a work-list row names (worklist.py's TILE)
#define STAGE_U 2      // staged ints a thread holds in registers a range (ptxas spills K3 at 3)

// The positions the chunk of output slots [k0, k0 + chunk) can read, main
// [ilo, ihi) and delta [jlo, jhi): slot k's co-rank i (main postings
// among the first k outputs) lies in [max(0, k - nb), min(k, na)], and
// the slot reads main positions below i + 1 and delta positions below
// k - i + 1, none past the live ranges [0, na) and [0, nb).
struct ChunkRanges {
    int ilo, ihi, jlo, jhi;
};

__device__ __forceinline__ ChunkRanges chunk_ranges(int na, int nb, int k0, int chunk)
{
    return {max(0, k0 - nb), min(na, k0 + chunk), max(0, k0 - na), min(nb, k0 + chunk)};
}

// Query q's driver term (t, clamped to tt) and live main stream m0 + [0,
// na): the first round of a chunk's lookups (stream_lengths' clamps).
struct MainStream {
    int64_t m0;
    int t, tt, na;
};

__device__ __forceinline__ MainStream main_stream(
    const int* __restrict__ m_off, const int* __restrict__ m_neff,
    const int* __restrict__ terms, int q, int window, int n_terms)
{
    const int t = terms[q];
    const int neff = m_neff[q];
    return {m_off[q], t, t < 0 ? 0 : (t >= n_terms ? n_terms - 1 : t),
            neff < 0 ? 0 : (neff > window ? window : neff)};
}

// The live delta postings of the driver's slab (len = d_lengths[tt]).
__device__ __forceinline__ int delta_length(const MainStream& ms, int len, int cap)
{
    return ms.t < 0 || len < 0 ? 0 : (len > cap ? cap : len);
}

// The main positions a chunk at k0 stages before it knows nb: every
// position any slab of at most cap postings lets it read, [max(0, k0 -
// cap), min(na, k0 + chunk)), a superset of chunk_ranges' main range.
__device__ __forceinline__ void staged_main(int na, int k0, int chunk, int cap,
                                            int& lo, int& hi)
{
    lo = max(0, k0 - cap);
    hi = min(na, k0 + chunk);
}

// One thread's share of a range of n ints copied to shared memory: the
// ints t = u * THREADS + threadIdx.x (u < U) held in registers, so that a
// block issues every load of its ranges before the first store (a copy
// loop would wait on each load before the next); the rest of [0, n), past
// U * THREADS (large caps), is copied after them.
template <int U, int THREADS>
struct Held {
    int x[U];

    __device__ __forceinline__ void load(const int* __restrict__ src, int n)
    {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int t = u * THREADS + (int)threadIdx.x;
            if (t < n) x[u] = src[t];
        }
    }

    __device__ __forceinline__ void store(const int* __restrict__ src, int n,
                                          int* dst) const
    {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int t = u * THREADS + (int)threadIdx.x;
            if (t < n) dst[t] = x[u];
        }
        for (int t = U * THREADS + (int)threadIdx.x; t < n; t += THREADS)
            dst[t] = src[t];
    }
};

__device__ __forceinline__ void invalid_slot(int64_t o, int* __restrict__ out_docs,
                                             int* __restrict__ out_attrs,
                                             int* __restrict__ out_src)
{
    out_docs[o] = INVALID_DOC;
    out_attrs[o] = INVALID_ATTR;
    out_src[o] = 0;
}

// Output slot k (of the chunk at r) into row o of the outputs, out of
// shared memory: sa / saa hold the main docIDs / attrs of positions a_org,
// a_org + 1, ..., sb / sba the delta's from b_org, covering at least r's
// ranges, every position the search and the pick read.  j == r.jhi can
// only mean j == nb (take main), i == r.ihi i == na (take delta).
__device__ __forceinline__ void merge_staged_slot(
    const int* sa, const int* saa, int a_org, const int* sb, const int* sba,
    int b_org, const ChunkRanges& r, int k, int64_t o,
    int* __restrict__ out_docs, int* __restrict__ out_attrs,
    int* __restrict__ out_src)
{
    int lo = k - r.jhi > r.ilo ? k - r.jhi : r.ilo;
    int hi = k - r.jlo < r.ihi ? k - r.jlo : r.ihi;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sa[mid - a_org] <= sb[k - mid - 1 - b_org]) lo = mid + 1; else hi = mid;
    }
    const int i = lo, j = k - lo;
    const bool from_main = j >= r.jhi || (i < r.ihi && sa[i - a_org] <= sb[j - b_org]);
    if (from_main) {
        out_docs[o] = sa[i - a_org];
        out_attrs[o] = saa[i - a_org];
    } else {
        out_docs[o] = sb[j - b_org];
        out_attrs[o] = sba[j - b_org];
    }
    out_src[o] = from_main ? 0 : 1;
}

// The blocks of pk that hold flat positions [p0 + lo, p0 + hi): the first
// block and how many (0 for an empty range).
__device__ __forceinline__ int64_t range_blocks(int64_t p0, int lo, int hi, int& n_blk)
{
    const int64_t first = (p0 + lo) >> 7;
    n_blk = hi > lo ? (int)(((p0 + hi - 1) >> 7) - first + 1) : 0;
    return first;
}

// K3 / K3p: block row g is query g, its main stream the window's.
struct DenseMerge {
    __device__ __forceinline__ int query(int g, int& m_cap) const
    {
        m_cap = INT_MAX;
        return g;
    }
};

// K8 / K8p: block row g is group g of the work list
// (repro_torch/kernels/worklist.py), rows heads[g] .. heads[g + 1] - 1,
// each [q, j, ...] a main-window tile j of the same live query q; the
// query's main stream is clipped to the postings of the group's tiles.
// One dependent round more than DenseMerge (heads, then the head row)
// before the query's lookups.
struct TableMerge {
    const int* desc;    // [n_pad, 8]
    const int* heads;   // [n_groups + 1]

    __device__ __forceinline__ int query(int g, int& m_cap) const
    {
        const int r0 = heads[g];
        m_cap = (heads[g + 1] - r0) * WL_TILE;
        return desc[8 * (int64_t)r0];
    }
};

// K3 / K8: the block of output chunk blockIdx.x (CHUNK slots, one a thread)
// of the query Loc gives for block row blockIdx.y.  m_room 0: no staging,
// each thread searches its co-rank in the global streams (the caller's
// choice where the rooms pass the opt-in shared memory, chunk_fits);
// else 2 * (m_room + d_room) ints of dynamic shared memory.  The lookups
// take two dependent rounds after Loc's (the query's terms / m_neff /
// m_off, then its driver's d_lengths / d_offsets); the main range is
// staged with cap in place of nb (staged_main), so its loads are in
// flight during the second round, and the delta range's after it.  Every
// load of a block is issued before its first store to shared memory
// (Held, STAGE_U ints a thread a range in registers).
template <int CHUNK, class Loc>
__device__ __forceinline__ void merge_chunk_body(
    const Loc& loc,
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
    int window, int n_terms, int cap, int m_room, int d_room)
{
    extern __shared__ int4 dyn4[];
    int* sa = reinterpret_cast<int*>(dyn4);   // [m_room] main docIDs
    int* saa = sa + m_room;                   // [m_room] their attrs
    int* sb = saa + m_room;                   // [d_room] delta docIDs
    int* sba = sb + d_room;                   // [d_room] their attrs
    int m_cap;
    const int q = loc.query(blockIdx.y, m_cap);
    const int k0 = blockIdx.x * CHUNK, k = k0 + threadIdx.x;
    const int64_t o = (int64_t)q * window + k;
    // round 1: the query's streams; round 2: the driver's slab, and the
    // main range staged meanwhile (bounded by cap, not yet by nb)
    MainStream ms = main_stream(m_off, m_neff, terms, q, window, n_terms);
    if (ms.na > m_cap) ms.na = m_cap;
    const int len = d_lengths[ms.tt];
    const int64_t d0 = d_offsets[ms.tt];
    int mlo, mhi;
    staged_main(ms.na, k0, CHUNK, cap, mlo, mhi);
    const bool stage = m_room > 0;
    const int la = stage && mhi > mlo ? mhi - mlo : 0;
    const int* a = postings + ms.m0 + mlo;
    const int* aa = attrs + ms.m0 + mlo;
    Held<STAGE_U, CHUNK> ha, haa, hb, hba;
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
    const ChunkRanges r = chunk_ranges(ms.na, nb, k0, CHUNK);
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

// K3p / K8p: merge_chunk_body on block-codec twins.  Packed words have no
// random access, so the block decodes the codec blocks that hold its
// ranges (at most 5 main and 3 delta blocks at cap 256 and CHUNK 256, for
// any window), one warp a block (decode.cuh; main blocks on the low
// warps, delta blocks on the high ones), stages the ranges' raw attrs
// beside them, and merges as K3 does.  2 * (m_room + d_room) ints of
// dynamic shared memory (chunk_rooms).
template <int CHUNK, class Loc>
__device__ __forceinline__ void merge_chunk_packed_body(
    const Loc& loc, const Packed& main_pk, const Packed& delta_pk,
    const int* __restrict__ attrs,       // [P]
    const int* __restrict__ m_off, const int* __restrict__ m_neff,
    const int* __restrict__ d_attrs,     // [D]
    const int* __restrict__ d_offsets, const int* __restrict__ d_lengths,
    const int* __restrict__ terms,
    int* __restrict__ out_docs, int* __restrict__ out_attrs,
    int* __restrict__ out_src,
    int window, int n_terms, int cap, int m_room, int d_room)
{
    extern __shared__ int4 dyn4[];
    int* sa = reinterpret_cast<int*>(dyn4);   // [m_room] decoded main blocks
    int* saa = sa + m_room;                   // [m_room] their attrs
    int* sb = saa + m_room;                   // [d_room] decoded delta blocks
    int* sba = sb + d_room;                   // [d_room] their attrs
    int m_cap;
    const int q = loc.query(blockIdx.y, m_cap);
    const int k0 = blockIdx.x * CHUNK, k = k0 + threadIdx.x;
    const int warp = threadIdx.x >> 5, n_warps = CHUNK / 32;
    const int64_t o = (int64_t)q * window + k;
    // round 1: the query's streams; then the main blocks decode (bounded by
    // cap, not yet by nb) while the driver's slab is looked up
    MainStream ms = main_stream(m_off, m_neff, terms, q, window, n_terms);
    if (ms.na > m_cap) ms.na = m_cap;
    const int len = d_lengths[ms.tt];
    const int64_t d0 = d_offsets[ms.tt];
    int mlo, mhi, n_mb;
    staged_main(ms.na, k0, CHUNK, cap, mlo, mhi);
    const int64_t mb = range_blocks(ms.m0, mlo, mhi, n_mb);
    const int a_org = (int)((mb << 7) - ms.m0);
    const int la = mhi > mlo ? mhi - mlo : 0;
    const int* aa = attrs + ms.m0 + mlo;
    Held<STAGE_U, CHUNK> haa, hba;
    haa.load(aa, la);
    for (int w = warp; w < n_mb; w += n_warps)
        decode_block_warp(main_pk, mb + w, sa + w * PBLOCK);
    const int nb = delta_length(ms, len, cap);
    const int n = ms.na + nb;
    if (k0 >= n) {
        if (k < window) invalid_slot(o, out_docs, out_attrs, out_src);
        return;
    }
    const ChunkRanges r = chunk_ranges(ms.na, nb, k0, CHUNK);
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

// Host: the rooms of a chunk form, in ints a stream (chunk_rooms in
// delta_merge.py): a main range of at most min(window, cap + chunk)
// postings and a delta range of at most min(cap, window + chunk); packed,
// the codec blocks that hold such a range starting anywhere.  stage 0
// (raw only): none.
static inline void merge_rooms(int window, int cap, int chunk, bool packed, int stage,
                               int& m_room, int& d_room)
{
    const int mw = window < cap + chunk ? window : cap + chunk;
    const int dw = cap < window + chunk ? cap : window + chunk;
    if (packed) {
        m_room = ((mw + PBLOCK - 1) / PBLOCK + 1) * PBLOCK;
        d_room = ((dw + PBLOCK - 1) / PBLOCK + 1) * PBLOCK;
    } else {
        m_room = stage ? mw : 0;
        d_room = stage ? dw : 0;
    }
}

// Host: let kernel take `bytes` of dynamic shared memory (above 48 KB it
// must be allowed first).
template <class K>
static cudaError_t merge_allow_smem(K kernel, int bytes)
{
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
}
