// K3: the merge-on-read driver merge, main window + the driver's delta slab.
//
// Replaces the TPU kernel repro/kernels/delta_merge.py:merge_delta_windows
// (pallas_call at line 394, body _merge_kernel at line 165).  Python side
// and semantics: repro_torch/kernels/delta_merge.py (merge_delta_windows_cuda,
// and merge_delta_windows_torch, the plain version it is held against).
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
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define INVALID_DOC 2147483647
#define INVALID_ATTR (-1)

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

    const int t = terms[q];
    const int tt = t < 0 ? 0 : (t >= n_terms ? n_terms - 1 : t);
    int na = m_neff[q];
    na = na < 0 ? 0 : (na > window ? window : na);
    int nb = t < 0 ? 0 : d_lengths[tt];
    nb = nb < 0 ? 0 : (nb > cap ? cap : nb);
    const int* a = postings + (int64_t)m_off[q];
    const int* aa = attrs + (int64_t)m_off[q];
    const int* b = d_postings + (int64_t)d_offsets[tt];
    const int* ba = d_attrs + (int64_t)d_offsets[tt];

    const int64_t o = (int64_t)q * window + k;
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
