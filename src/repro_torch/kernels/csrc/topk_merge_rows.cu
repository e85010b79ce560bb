// K2: the master merge, row-wise best-k of concatenated candidates.
//
// Replaces the TPU kernel repro/kernels/topk_merge.py:merge_topk_rows
// (pallas_call at line 122, body _sort_kernel / _bitonic_sort_flat at
// lines 28-52).  Python side: repro_torch/kernels/topk_merge.py
// (merge_topk_rows_cuda, held against merge_topk_rows_torch).
//
// What it computes: each row of cands int32[Q, m], padded with INVALID_DOC
// to mpad = max(256, next_pow2(m)), sorted ascending; the first k values
// of each row are written to out int32[Q, k].
//
// What bounds it on the H100: latency.  The bytes are tiny (Q*m*4 in,
// Q*k*4 out: 16 KB per 32-query row set at m = 128) and the compare count
// of a bitonic network is mpad/2 * log2(mpad)*(log2(mpad)+1)/2 per row, so
// the time is the launch plus log2(mpad)*(log2(mpad)+1)/2 dependent
// shared-memory stages separated by __syncthreads.
//
// Design: one block per row, the padded row in dynamic shared memory
// (loaded coalesced), the bitonic network run in place by up to 1024
// threads, each doing mpad/2/threads compare-exchanges per stage, then
// the first k values written back coalesced.  No TPU reshape/relayout
// tricks carry over: a compare-exchange partner is just lo + stride.
#include <cuda_runtime.h>
#include <stdint.h>

#define INVALID_DOC 2147483647

__global__ void topk_merge_rows_kernel(
    const int* __restrict__ cands, int* __restrict__ out,
    int m, int mpad, int k)
{
    extern __shared__ int s[];
    const int64_t row = blockIdx.x;
    const int* src = cands + row * m;
    for (int j = threadIdx.x; j < mpad; j += blockDim.x)
        s[j] = j < m ? src[j] : INVALID_DOC;
    __syncthreads();

    const int half = mpad >> 1;
    for (int size = 2; size <= mpad; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int p = threadIdx.x; p < half; p += blockDim.x) {
                const int lo = 2 * stride * (p / stride) + (p % stride);
                const int hi = lo + stride;
                const bool ascending = (lo & size) == 0;
                const int x = s[lo], y = s[hi];
                if ((x > y) == ascending) {
                    s[lo] = y;
                    s[hi] = x;
                }
            }
            __syncthreads();
        }
    }

    int* dst = out + row * k;
    for (int j = threadIdx.x; j < k; j += blockDim.x) dst[j] = s[j];
}

extern "C" int topk_merge_rows_launch(
    const void* cands, void* out, int q_n, int m, int mpad, int k,
    void* stream)
{
    const size_t smem = (size_t)mpad * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        topk_merge_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = (mpad / 2) < 1024 ? (mpad / 2) : 1024;
    topk_merge_rows_kernel<<<q_n, threads, smem, (cudaStream_t)stream>>>(
        (const int*)cands, (int*)out, m, mpad, k);
    return (int)cudaGetLastError();
}
