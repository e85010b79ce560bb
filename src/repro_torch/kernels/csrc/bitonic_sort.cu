// K11: the flat ascending sort behind ops.sort and ops.topk_merge.
//
// Replaces the TPU kernel repro/kernels/topk_merge.py:bitonic_sort
// (pallas_call at line 79, body _sort_kernel / _bitonic_sort_flat at lines
// 51 and 28; merge_topk at line 89 keeps its first k).  Python side:
// repro_torch/kernels/topk_merge.py (bitonic_sort_cuda, held against
// bitonic_sort_torch).
//
// What it computes: a vector src of n int32 or float32 keys, padded with
// INVALID_DOC cast to the key type (2147483648.0f for float32) to m =
// max(256, next_pow2(n)), sorted ascending into dst[0, m); the caller keeps
// dst[0, n).  As in the reference, a float key above the pad comes back as
// the pad.  Compare-exchange is by `<` (no fminf/fmaxf); NaN is outside the
// contract.
//
// What bounds it on the H100: for m up to 32768 latency (one block, the
// log2(m)*(log2(m)+1)/2 dependent stages separated by __syncthreads); past
// that the passes over device memory: each global stage reads and writes
// all m keys, log2(m/32768) * (log2(m/32768) + 1) / 2 of them, plus one
// shared-memory pass per merge size.
//
// Design: the bitonic network of the reference, with the direction of a
// compare-exchange at position lo given by (lo & size) == 0.  A chunk of
// up to 32768 keys (128 KB of dynamic shared memory, opt-in above 48 KB)
// is sorted by one block of up to 1024 threads.  Larger vectors: one such
// block per chunk sorts every merge size up to the chunk (directions from
// the global index); then, per merge size above it, one launch per stride
// of a chunk or more (a thread per compare-exchange in device memory) and
// one launch that runs the strides below a chunk in shared memory.  The
// TPU's reshapes and relayouts do not carry over; nothing is shared with
// K2's row layout (topk_merge_rows.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#define INVALID_DOC 2147483647
#define MAX_CHUNK 32768   // keys one block sorts in shared memory (128 KB)

template <class T>
__device__ __forceinline__ void compare_exchange(T* s, int64_t lo, int64_t hi,
                                                 bool ascending)
{
    const T x = s[lo], y = s[hi];
    if (ascending ? y < x : x < y) {
        s[lo] = y;
        s[hi] = x;
    }
}

// One block per chunk of `chunk` keys at global position blockIdx.x *
// chunk: loads the chunk (from src, padded, when src is given; else from
// d), runs the merge sizes size_lo..size_hi with their strides below the
// chunk in shared memory, and writes the chunk back to d.
template <class T>
__global__ void bitonic_local(const T* __restrict__ src, int n,
                              T* __restrict__ d, int chunk, int size_lo,
                              int size_hi)
{
    extern __shared__ unsigned char smem[];
    T* s = reinterpret_cast<T*>(smem);
    const int64_t base = (int64_t)blockIdx.x * chunk;
    for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
        const int64_t g = base + j;
        s[j] = src == nullptr ? d[g] : (g < n ? src[g] : (T)INVALID_DOC);
    }
    __syncthreads();
    const int half = chunk >> 1;
    for (int64_t size = size_lo; size <= size_hi; size <<= 1) {
        for (int stride = (size < chunk ? (int)size : chunk) >> 1; stride > 0;
             stride >>= 1) {
            for (int p = threadIdx.x; p < half; p += blockDim.x) {
                const int lo = 2 * stride * (p / stride) + (p % stride);
                compare_exchange(s, lo, lo + stride, ((base + lo) & size) == 0);
            }
            __syncthreads();
        }
    }
    for (int j = threadIdx.x; j < chunk; j += blockDim.x) d[base + j] = s[j];
}

// One compare-exchange a thread at merge size `size`, stride `stride`.
template <class T>
__global__ void bitonic_global(T* __restrict__ d, int64_t half, int size,
                               int stride)
{
    const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= half) return;
    const int64_t lo = 2 * (int64_t)stride * (p / stride) + (p % stride);
    compare_exchange(d, lo, lo + stride, (lo & size) == 0);
}

template <class T>
static int bitonic_sort_launch(const void* src, int n, void* dst, int m,
                               void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    const int chunk = m < MAX_CHUNK ? m : MAX_CHUNK;
    const size_t smem = (size_t)chunk * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        bitonic_local<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = chunk / 2 < 1024 ? chunk / 2 : 1024;
    const int blocks = m / chunk;
    T* d = (T*)dst;
    bitonic_local<T><<<blocks, threads, smem, st>>>((const T*)src, n, d, chunk,
                                                   2, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int64_t half = m / 2;
    for (int64_t size = 2 * (int64_t)chunk; size <= m; size <<= 1) {
        for (int stride = (int)(size >> 1); stride >= chunk; stride >>= 1)
            bitonic_global<T><<<(unsigned)((half + 255) / 256), 256, 0, st>>>(
                d, half, (int)size, stride);
        bitonic_local<T><<<blocks, threads, smem, st>>>(nullptr, n, d, chunk,
                                                       (int)size, (int)size);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

extern "C" int bitonic_sort_i32_launch(const void* src, int n, void* dst,
                                       int m, void* stream)
{
    return bitonic_sort_launch<int>(src, n, dst, m, stream);
}

extern "C" int bitonic_sort_f32_launch(const void* src, int n, void* dst,
                                       int m, void* stream)
{
    return bitonic_sort_launch<float>(src, n, dst, m, stream);
}
