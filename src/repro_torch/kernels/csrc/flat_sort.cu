// K11: the flat ascending sort behind ops.sort and ops.topk_merge.
//
// Replaces the TPU kernel repro/kernels/topk_merge.py:bitonic_sort
// (pallas_call at line 79, body _sort_kernel / _bitonic_sort_flat at lines
// 51 and 28; merge_topk at line 89 keeps its first k).  Python side:
// repro_torch/kernels/topk_merge.py (bitonic_sort_cuda, held against
// bitonic_sort_torch; the names are the reference's).
//
// What it computes: a vector src of n int32 or float32 keys, padded with
// INVALID_DOC cast to the key type (2147483648.0f for float32) to m =
// max(256, next_pow2(n)), sorted ascending into dst[0, m); the caller keeps
// dst[0, n).  As in the reference, a float key above the pad comes back as
// the pad.  Keys compare by `<` alone (no fminf/fmaxf), so any correct sort
// of the padded vector gives the same bits; NaN is outside the contract,
// and so is the order of -0.0 against 0.0.
//
// What bounds it on the H100: bytes.  Reading and writing the m keys once
// is 8 m bytes (2.5 us at 2^20 and 3.35 TB/s); m log2(m) compares are far
// below the card's rate.  The TPU's network of log2(m)(log2(m)+1)/2
// dependent stages does not carry over: past one block it costs a pass
// over device memory per stage.
//
// Design: a merge sort with merge-path partitions, log2(m / TILE) + 1
// launches.
// 1. flat_sort_tile: one block of 256 threads per tile of TILE = 4096 keys
//    (a smaller m is one tile of m keys and m / 16 threads), padding on the
//    load.  Each thread sorts its 16 keys in registers with a bitonic
//    network, then the block merges runs of 16, 32, ... in shared memory:
//    each thread finds the start of its 16 outputs in the pair of runs by
//    a co-rank (merge-path) binary search, as merge_slot in merge.cuh does,
//    and merges them sequentially.  Shared memory holds one pad word per 32
//    keys so that a thread's 16 consecutive keys fall in distinct banks.
// 2. flat_sort_merge: one pass per run length L = TILE, 2 TILE, ..., m / 2,
//    merging pairs of sorted runs into runs of 2L.  Each block emits one
//    fixed TILE of output: it co-ranks its first and last output in the two
//    runs in device memory (two halves of the block narrow the range 128
//    probes at a time, so a 2^19-key run takes 3 rounds, not 19 dependent
//    loads), stages the two input slices in shared memory, merges them as
//    in the tile sort, and writes its tile coalesced.
// 3. Passes alternate between dst and a scratch vector of m keys that the
//    wrapper allocates; the tile sort writes to the one that makes the last
//    pass land in dst.  With m <= TILE there is one launch and no scratch;
//    past one tile a null scratch is refused with cudaErrorInvalidValue.
// All shared memory is static (33.8 KB a block): no opt-in attribute.
#include <cuda_runtime.h>
#include <stdint.h>

#define INVALID_DOC 2147483647
#define KPT 16                       // keys a thread
#define TILE_THREADS 256
#define TILE (KPT * TILE_THREADS)    // keys a block
#define SKEW(j) ((j) + ((j) >> 5))   // one pad word every 32 keys
#define TILE_WORDS (TILE + TILE / 32)

// The number of a's keys among the first k outputs of the merge of a[0, na)
// and b[0, nb), ties from a first.  a and b index a skewed shared buffer.
template <class T>
__device__ __forceinline__ int co_rank(const T* s, int a, int na, int b, int nb, int k)
{
    int lo = k - nb > 0 ? k - nb : 0;
    int hi = k < na ? k : na;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!(s[SKEW(b + k - mid - 1)] < s[SKEW(a + mid)])) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// KPT outputs of the merge of runs a[0, na) and b[0, nb) of `in`, from
// output k on, written to out[o, o + KPT) (both buffers skewed).
template <class T>
__device__ __forceinline__ void merge_kpt(const T* in, int a, int na, int b, int nb,
                                          int k, T* out, int o)
{
    int i = co_rank(in, a, na, b, nb, k);
    int j = k - i;
#pragma unroll
    for (int x = 0; x < KPT; ++x) {
        const bool from_a = j >= nb || (i < na && !(in[SKEW(b + j)] < in[SKEW(a + i)]));
        out[SKEW(o + x)] = from_a ? in[SKEW(a + i)] : in[SKEW(b + j)];
        i += from_a;
        j += !from_a;
    }
}

// Sort each tile of `tile` keys (tile / KPT threads a block) into dst.
template <class T>
__global__ void __launch_bounds__(TILE_THREADS)
flat_sort_tile(const T* __restrict__ src, int n, T* __restrict__ dst, int tile)
{
    __shared__ T buf[2][TILE_WORDS];
    const int64_t base = (int64_t)blockIdx.x * tile;
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
        const int64_t g = base + j;
        buf[0][SKEW(j)] = g < n ? src[g] : (T)INVALID_DOC;
    }
    __syncthreads();

    // a bitonic network over this thread's KPT keys, in registers
    const int first = threadIdx.x * KPT;
    T r[KPT];
#pragma unroll
    for (int x = 0; x < KPT; ++x) r[x] = buf[0][SKEW(first + x)];
#pragma unroll
    for (int size = 2; size <= KPT; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
            for (int x = 0; x < KPT; ++x) {
                const int y = x ^ stride;
                if (y > x) {
                    const T lo = r[x], hi = r[y];
                    const bool swap = (x & size) == 0 ? hi < lo : lo < hi;
                    r[x] = swap ? hi : lo;
                    r[y] = swap ? lo : hi;
                }
            }
        }
    }
#pragma unroll
    for (int x = 0; x < KPT; ++x) buf[0][SKEW(first + x)] = r[x];
    __syncthreads();

    // merge runs of L into runs of 2 L, L = KPT .. tile / 2
    int cur = 0;
    for (int L = KPT; L < tile; L <<= 1) {
        const int pair = first & ~(2 * L - 1);
        merge_kpt(buf[cur], pair, L, pair + L, L, first - pair, buf[cur ^ 1], first);
        cur ^= 1;
        __syncthreads();
    }
    for (int j = threadIdx.x; j < tile; j += blockDim.x) dst[base + j] = buf[cur][SKEW(j)];
}

// One merge pass: runs of L keys in `in` pairwise into runs of 2 L in
// `out`, one output TILE a block.
template <class T>
__global__ void __launch_bounds__(TILE_THREADS)
flat_sort_merge(const T* __restrict__ in, T* __restrict__ out, int64_t L)
{
    __shared__ T buf[2][TILE_WORDS];   // staged slices, merged tile
    __shared__ int64_t s_lo[2], s_hi[2];
    __shared__ int s_count[2];
    const int64_t g0 = (int64_t)blockIdx.x * TILE;
    const int64_t pair = g0 & ~(2 * L - 1);
    const T* a = in + pair;
    const T* b = a + L;
    const int64_t k0 = g0 - pair;      // this tile's outputs are [k0, k0 + TILE)

    // co-ranks of k0 (threads 0-127) and k0 + TILE (128-255): each half
    // narrows [lo, hi) by 128 probes a round
    const int half = threadIdx.x >> 7, t = threadIdx.x & 127;
    const int64_t k = k0 + half * TILE;
    if (t == 0) {
        s_lo[half] = k - L > 0 ? k - L : 0;
        s_hi[half] = k < L ? k : L;
        s_count[half] = 0;
    }
    __syncthreads();
    while (s_lo[0] < s_hi[0] || s_lo[1] < s_hi[1]) {
        const int64_t lo = s_lo[half], hi = s_hi[half];
        const int64_t step = (hi - lo + 127) >> 7;
        const int64_t mid = lo + t * step;
        // true below the co-rank, false from it on
        const bool below = mid < hi && !(b[k - mid - 1] < a[mid]);
        const unsigned vote = __ballot_sync(0xffffffffu, below);
        if ((threadIdx.x & 31) == 0 && vote) atomicAdd(&s_count[half], __popc(vote));
        __syncthreads();
        if (t == 0) {
            const int c = s_count[half];
            if (lo < hi) {
                s_lo[half] = c == 0 ? lo : lo + (c - 1) * step + 1;
                s_hi[half] = lo + c * step < hi ? lo + c * step : hi;
            }
            s_count[half] = 0;
        }
        __syncthreads();
    }
    const int64_t i0 = s_lo[0], j0 = k0 - i0;
    const int na = (int)(s_lo[1] - i0);          // keys from a; TILE - na from b
    for (int x = threadIdx.x; x < TILE; x += TILE_THREADS)
        buf[0][SKEW(x)] = x < na ? a[i0 + x] : b[j0 + x - na];
    __syncthreads();
    const int first = threadIdx.x * KPT;
    merge_kpt(buf[0], 0, na, na, TILE - na, first, buf[1], first);
    __syncthreads();
    for (int x = threadIdx.x; x < TILE; x += TILE_THREADS) out[g0 + x] = buf[1][SKEW(x)];
}

template <class T>
static int flat_sort_launch(const void* src, int n, void* dst, void* scratch, int m,
                            void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    const int tile = m < TILE ? m : TILE;
    int passes = 0;
    for (int64_t L = tile; L < m; L <<= 1) ++passes;
    if (passes > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    T* const bufs[2] = {(T*)dst, (T*)scratch};
    T* cur = bufs[passes & 1];   // so that the last pass writes dst
    flat_sort_tile<T><<<m / tile, tile / KPT, 0, st>>>((const T*)src, n, cur, tile);
    cudaError_t err = cudaGetLastError();
    for (int64_t L = tile; L < m && err == cudaSuccess; L <<= 1) {
        T* next = cur == bufs[0] ? bufs[1] : bufs[0];
        flat_sort_merge<T><<<m / TILE, TILE_THREADS, 0, st>>>(cur, next, L);
        err = cudaGetLastError();
        cur = next;
    }
    return (int)err;
}

extern "C" int flat_sort_i32_launch(const void* src, int n, void* dst, void* scratch,
                                    int m, void* stream)
{
    return flat_sort_launch<int>(src, n, dst, scratch, m, stream);
}

extern "C" int flat_sort_f32_launch(const void* src, int n, void* dst, void* scratch,
                                    int m, void* stream)
{
    return flat_sort_launch<float>(src, n, dst, scratch, m, stream);
}
