// The chunked merge path of K3 and K3p (delta_merge.cu): a block owns a
// chunk of output slots of one query's merge, stages into shared memory
// the main and delta postings the chunk can read, and each thread merges
// its slot out of them.  merge.cuh (merge_slot, packed_merge_row) stays
// K8/K8p's, and K3p's large-cap form's.  Python side:
// repro_torch/kernels/delta_merge.py (chunk_ranges, chunk_rooms and
// merge_chunks_replay replay this file's arithmetic on the host).
#pragma once
#include "merge.cuh"

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
