// K2: the master merge, row-wise best-k of concatenated candidates.
//
// Replaces the TPU kernel repro/kernels/topk_merge.py:merge_topk_rows
// (pallas_call at line 122, body _sort_kernel / _bitonic_sort_flat at
// lines 28-52).  Python side: repro_torch/kernels/topk_merge.py
// (merge_topk_rows_cuda, held against merge_topk_rows_torch;
// warp_sort_run, merge_rounds and merge_topk_rows_replay replay this file
// on the host).
//
// What it computes: each row of cands int32[Q, m], padded with INVALID_DOC
// to mpad = max(256, next_pow2(m)), sorted ascending; the first k values
// of each row are written to out int32[Q, k] (k <= mpad).  Any int32 row:
// the merge assumes nothing of its order.
//
// What bounds it on the H100: latency.  The bytes are tiny (16 KB a row
// set at m = 128) and so are the compares (m * ceil(log2 k) a row for a
// selection), so the time is the launch and the dependent steps of a row:
// no block barrier where a warp can do the work, and no sort of keys that
// cannot reach the first k.
//
// Design.  A warp sorts a run of RUN = 256 keys in registers, KEYS = 8 a
// lane (loaded coalesced; network position lane * 8 + r in register r):
// network strides below 8 are compare-exchanges between a lane's
// registers, strides 8 .. 128 __shfl_xor_sync with lane ^ (stride / 8); no
// shared memory, no barrier.
// - mpad = 256: that is the whole row.  ROWS_PER_BLOCK warps a block, one
//   row each (topk_merge_warp_kernel).
// - mpad >= 512 (topk_merge_runs_kernel, one block a row, a warp a run,
//   at most MAX_THREADS threads): the row's ceil(m / 256) runs (the last
//   padded with INVALID_DOC in registers; the rest of the padding is
//   implicit: INVALID_DOC is the largest int32, so the padded sort is the
//   sorted runs followed by INVALID_DOC) are sorted into shared memory,
//   then merged in pairs, round by round.  A round keeps the first
//   min(k, length) keys of each merged pair (the first k of a union are
//   the first k of the merge of each part's first k), so past the first
//   round a row holds at most 2k keys a pair.  Each thread merges chunks
//   of ITEMS output keys: a co-rank search (merge path, first run first on
//   ties) in shared memory, then ITEMS sequential steps into registers;
//   after a barrier the chunks are written back in place (a pair's output
//   lies inside its own input), the last round straight to the output
//   row.  The buffer holds one int of padding every 32 (pad), against
//   bank conflicts.  Slots past the merged length (k > the row's runs) are
//   INVALID_DOC.  One block a row, not a cluster of blocks: at 32 rows of
//   4000 keys, 12 more runs sorted on one SM cost about 0.004 ms on an
//   H100 (PERF.md), the most a cluster could save, and 128 tournament rows
//   already fill the SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#define INVALID_DOC 2147483647
#define RUN 256            // keys a warp sorts in registers
#define KEYS 8             // keys a lane (RUN / 32)
#define ROWS_PER_BLOCK 4   // warps (rows) a block at mpad 256
#define ITEMS 8            // merged keys a thread a chunk
#define MAX_CHUNKS 4       // chunks a thread a round (mpad <= 32768)
#define MAX_THREADS 1024

// Shared-memory index of key p of the runs kernel's buffer: one int of
// padding every 32, so that the lanes of a warp, whose chunks start 8 keys
// apart, and the lanes storing a sorted run, 8 keys a lane, fall in 32
// different banks (without it, 8 lanes share each bank).
__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

// Sort the warp's RUN keys ascending: key lane * KEYS + r is x[r].
__device__ __forceinline__ void warp_sort_run(int (&x)[KEYS], int lane)
{
#pragma unroll
    for (int ls = 1; ls <= 8; ++ls) {            // size = 2 .. 256
        const int size = 1 << ls;
#pragma unroll
        for (int lt = ls - 1; lt >= 0; --lt) {   // stride = size / 2 .. 1
            const int stride = 1 << lt;
            if (stride >= KEYS) {
                const int lx = stride / KEYS;
                const bool upper = (lane & lx) != 0;
                const bool desc = ((lane * KEYS) & size) != 0;
                const bool keep_min = upper == desc;
#pragma unroll
                for (int r = 0; r < KEYS; ++r) {
                    const int y = __shfl_xor_sync(0xFFFFFFFFu, x[r], lx);
                    x[r] = keep_min ? min(x[r], y) : max(x[r], y);
                }
            } else {
#pragma unroll
                for (int r = 0; r < KEYS; ++r) {
                    if ((r & stride) == 0) {
                        const int h = r | stride;
                        const bool desc = ((lane * KEYS + r) & size) != 0;
                        const int a = x[r], b = x[h];
                        x[r] = desc ? max(a, b) : min(a, b);
                        x[h] = desc ? min(a, b) : max(a, b);
                    }
                }
            }
        }
    }
}

// Load the run of keys [base, base + RUN) of src (m keys), INVALID_DOC past
// m, coalesced: lane l's register r gets key base + 32 r + l (the network
// sorts whatever the registers hold).
__device__ __forceinline__ void load_run(const int* __restrict__ src, int m,
                                         int base, int lane, int (&x)[KEYS])
{
#pragma unroll
    for (int r = 0; r < KEYS; ++r) {
        const int j = base + 32 * r + lane;
        x[r] = j < m ? src[j] : INVALID_DOC;
    }
}

__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK) topk_merge_warp_kernel(
    const int* __restrict__ cands, int* __restrict__ out, int q_n, int m, int k)
{
    const int lane = threadIdx.x & 31;
    const int64_t row = (int64_t)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= q_n) return;
    int x[KEYS];
    load_run(cands + row * m, m, 0, lane, x);
    warp_sort_run(x, lane);
    int* dst = out + row * k;
#pragma unroll
    for (int r = 0; r < KEYS; ++r)
        if (lane * KEYS + r < k) dst[lane * KEYS + r] = x[r];
}

// Keys pos0 .. pos0 + ITEMS - 1 of the merge of the runs at buf keys a0
// (la keys) and b0 (lb keys), the first run first on ties; slots past
// la + lb are INVALID_DOC.
__device__ __forceinline__ void merge_chunk(const int* buf, int a0, int la, int b0,
                                            int lb, int pos0, int (&v)[ITEMS])
{
    int lo = pos0 - lb > 0 ? pos0 - lb : 0;
    int hi = pos0 < la ? pos0 : la;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (buf[pad(a0 + mid)] <= buf[pad(b0 + pos0 - mid - 1)]) lo = mid + 1;
        else hi = mid;
    }
    int i = lo, j = pos0 - lo;
#pragma unroll
    for (int e = 0; e < ITEMS; ++e) {
        const int x = i < la ? buf[pad(a0 + i)] : INVALID_DOC;
        const int y = j < lb ? buf[pad(b0 + j)] : INVALID_DOC;
        const bool take_a = i < la && (j >= lb || x <= y);
        v[e] = take_a ? x : y;
        i += take_a;
        j += !take_a;
    }
}

__global__ void __launch_bounds__(MAX_THREADS) topk_merge_runs_kernel(
    const int* __restrict__ cands, int* __restrict__ out, int m, int k)
{
    extern __shared__ int4 smem4[];
    int* buf = reinterpret_cast<int*>(smem4);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const int64_t row = blockIdx.x;
    const int n_runs = (m + RUN - 1) / RUN;
    const int* src = cands + row * m;
    for (int run = warp; run < n_runs; run += n_warps) {
        int x[KEYS];
        load_run(src, m, run * RUN, lane, x);
        warp_sort_run(x, lane);
#pragma unroll
        for (int r = 0; r < KEYS; ++r) buf[pad(run * RUN + lane * KEYS + r)] = x[r];
    }
    __syncthreads();

    // Runs of length len at stride len; the last run's length is len_last.
    int* dst_row = out + row * k;
    int n = n_runs, len = RUN, len_last = RUN;
    while (n > 1) {
        const int groups = (n + 1) >> 1;
        const int glen = min(k, 2 * len);
        const int last_a = (n & 1) ? len_last : len;
        const int last_b = (n & 1) ? 0 : len_last;
        const int last_len = min(k, last_a + last_b);
        const int cpg = (glen + ITEMS - 1) / ITEMS;
        const int total = groups * cpg;
        int v[MAX_CHUNKS][ITEMS];
#pragma unroll
        for (int ci = 0; ci < MAX_CHUNKS; ++ci) {
            const int c = threadIdx.x + ci * blockDim.x;
            if (c < total) {
                const int g = c / cpg;
                const bool lastg = g == groups - 1;
                merge_chunk(buf, 2 * g * len, lastg ? last_a : len, (2 * g + 1) * len,
                            lastg ? last_b : len, (c - g * cpg) * ITEMS, v[ci]);
            }
        }
        __syncthreads();
#pragma unroll
        for (int ci = 0; ci < MAX_CHUNKS; ++ci) {
            const int c = threadIdx.x + ci * blockDim.x;
            if (c < total) {
                const int g = c / cpg, pos0 = (c - g * cpg) * ITEMS;
                const int olen = g == groups - 1 ? last_len : glen;
#pragma unroll
                for (int e = 0; e < ITEMS; ++e) {
                    if (pos0 + e >= olen) continue;
                    if (groups == 1) dst_row[pos0 + e] = v[ci][e];
                    else buf[pad(g * glen + pos0 + e)] = v[ci][e];
                }
            }
        }
        __syncthreads();
        n = groups;
        len = glen;
        len_last = last_len;
    }
    for (int j = len_last + threadIdx.x; j < k; j += blockDim.x)
        dst_row[j] = INVALID_DOC;
}

// The runs kernel's threads for m keys a row; 0 when a round would need
// more than MAX_CHUNKS chunks a thread (never for mpad <= 32768).
static int runs_threads(int m, int k)
{
    const int n_runs = (m + RUN - 1) / RUN;
    const int threads = 32 * n_runs < MAX_THREADS ? 32 * n_runs : MAX_THREADS;
    for (int n = n_runs, len = RUN; n > 1; n = (n + 1) >> 1) {
        len = k < 2 * len ? k : 2 * len;
        const int total = ((n + 1) >> 1) * ((len + ITEMS - 1) / ITEMS);
        if (total > MAX_CHUNKS * threads) return 0;
    }
    return threads;
}

extern "C" int topk_merge_rows_launch(
    const void* cands, void* out, int q_n, int m, int mpad, int k,
    void* stream)
{
    if (mpad <= RUN) {
        const int grid = (q_n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
        topk_merge_warp_kernel<<<grid, 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
            (const int*)cands, (int*)out, q_n, m, k);
        return (int)cudaGetLastError();
    }
    const int threads = runs_threads(m, k);
    if (threads == 0) return (int)cudaErrorInvalidValue;
    const int keys = (m + RUN - 1) / RUN * RUN;
    const size_t smem = (size_t)(keys + keys / 32) * sizeof(int);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            topk_merge_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    topk_merge_runs_kernel<<<q_n, threads, smem, (cudaStream_t)stream>>>(
        (const int*)cands, (int*)out, m, k);
    return (int)cudaGetLastError();
}
