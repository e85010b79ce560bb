// The large-cap form of the packed merges K3p (delta_merge.cu) and K8p
// (merge_compact.cu): one block a query decodes its whole main window and
// slab into a row (packed_merge_row) and merges each slot out of it
// (merge_slot).  Their chunk forms, and K3 / K8, are merge_path.cuh's.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

#define INVALID_ATTR (-1)

// Output slot k of the merge of the live streams a[0, na) (main) and
// b[0, nb) (delta), equal docIDs main first, into row o of the outputs.
// aa and ba are the streams' attrs.
__device__ __forceinline__ void merge_slot(
    const int* a, const int* __restrict__ aa, const int* b,
    const int* __restrict__ ba, int na, int nb, int k, int64_t o,
    int* __restrict__ out_docs, int* __restrict__ out_attrs,
    int* __restrict__ out_src)
{
    if (k >= na + nb) {
        out_docs[o] = INVALID_DOC;
        out_attrs[o] = INVALID_ATTR;
        out_src[o] = 0;
        return;
    }
    // co-rank: the number i of main postings among the first k outputs
    int lo = k - nb > 0 ? k - nb : 0;
    int hi = k < na ? k : na;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] <= b[k - mid - 1]) lo = mid + 1; else hi = mid;
    }
    const int i = lo, j = k - lo;
    const bool from_main = j >= nb || (i < na && a[i] <= b[j]);
    out_docs[o] = from_main ? a[i] : b[j];
    out_attrs[o] = from_main ? aa[i] : ba[j];
    out_src[o] = from_main ? 0 : 1;
}

// The live lengths of query q's two streams and its clamped driver term.
__device__ __forceinline__ void stream_lengths(
    const int* __restrict__ m_neff, const int* __restrict__ d_lengths,
    const int* __restrict__ terms, int q, int window, int n_terms, int cap,
    int& tt, int& na, int& nb)
{
    const int t = terms[q];
    tt = t < 0 ? 0 : (t >= n_terms ? n_terms - 1 : t);
    na = m_neff[q];
    na = na < 0 ? 0 : (na > window ? window : na);
    nb = t < 0 ? 0 : d_lengths[tt];
    nb = nb < 0 ? 0 : (nb > cap ? cap : nb);
}

// K3p's large-cap row (and K8p's): the whole block decodes query q's live main
// window (at most m_cap postings) and its live delta slab into buf (shared
// memory or a global scratch row of row ints), then merges out of it,
// each thread over every blockDim.x-th output slot of row q.
__device__ __forceinline__ void packed_merge_row(
    int q, int m_cap, int* buf, const Packed& main_pk, const Packed& delta_pk,
    const int* __restrict__ attrs, const int* __restrict__ m_off,
    const int* __restrict__ m_neff, const int* __restrict__ d_attrs,
    const int* __restrict__ d_offsets, const int* __restrict__ d_lengths,
    const int* __restrict__ terms,
    int* __restrict__ out_docs, int* __restrict__ out_attrs,
    int* __restrict__ out_src, int window, int n_terms, int cap, int m_room)
{
    int tt, na, nb;
    stream_lengths(m_neff, d_lengths, terms, q, window, n_terms, cap, tt, na, nb);
    if (na > m_cap) na = m_cap;
    const int64_t m0 = m_off[q], d0 = d_offsets[tt];
    const int lead_a = decode_range(main_pk, m0, na, buf);
    const int lead_b = decode_range(delta_pk, d0, nb, buf + m_room);
    __syncthreads();   // also orders the global scratch row's writes
    const int* a = buf + lead_a;
    const int* b = buf + m_room + lead_b;
    for (int k = threadIdx.x; k < window; k += blockDim.x)
        merge_slot(a, attrs + m0, b, d_attrs + d0, na, nb, k,
                   (int64_t)q * window + k, out_docs, out_attrs, out_src);
}
