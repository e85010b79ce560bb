// K9: the batched join over staged (materialized) windows, with block
// skipping, and K10, the same join of one list against another.
//
// Replace the TPU kernels repro/kernels/posting_intersect.py:
// intersect_batched_block_skip (pallas_call at line 533, body
// _intersect_batched_kernel at line 409) and intersect_block_skip
// (pallas_call at line 396, body _intersect_kernel at line 92).  Python
// side and semantics: repro_torch/kernels/posting_intersect.py
// (batched_block_skip_join_cuda, block_skip_join_cuda, and the plain
// versions they are held against; skip_streams states these kernels'
// streams on the host).
//
// What K9 computes: for each slot of a TILE-padded driver window a_docs
// [Q, W_a] that is valid, live (a_live, null: all live) and passes the
// attribute predicate (attr_filter >= 0), and each active slot t of the
// other-term windows b_docs [Q, T, W_b] (each row ascending and
// INVALID-padded), the slot is a member when its docID occurs in b's
// positions [b_start*TILE, (b_start+n_b)*TILE) of its driver tile's skip
// map (compute_skip_map, computed on the card before the launch; n_b is 0
// for inactive slots).  The mask is 1 where every active slot holds.  K10
// is K9 at Q = T = 1 with every slot active and live: a_docs [num_a*TILE]
// against one ascending list b_docs [W_b], attr_filter int32[1].
//
// What bounds them on the H100: the latency of dependent loads, as K4.  A
// block reads its driver slots (docIDs, attrs, live) and, per active slot,
// the B tiles of its skip range (for sorted windows about one or two tiles
// of 4 KB); the work per byte is one binary search of a few steps.  The
// first design (one block of 256 threads a driver tile and query, each
// term's range staged 2048 postings at a time behind two barriers, nothing
// in flight during a search) ran 15-17x its bound for K9 and about 250x
// for K10 at 4096 x 8192, whose 4 driver tiles made 4 blocks.
//
// Design: K4's static body and probe (slave_join.cuh, probe_async.cuh)
// with the skip map as its plan (SkipPlan): (num_a * 4, Q) blocks of
// JOIN_SUB = 256 slots and a producer warp, which reads every term's skip
// map entry at once and sets each term's one stream to its skip range in
// the flat b_docs; the ranges are staged by TMA bulk copies, two rounds in
// flight, while the consumers read the driver.  The staged windows already
// hold main and delta, so there is no delta stream and no flag.  Every
// range starts at (q * T + t) * W_b + b_start * TILE, a multiple of 4
// postings when W_b is TILE-padded, so its copy reads nothing before it;
// the wrappers refuse a b_docs that does not start on 16 bytes
// (_build.check_aligned).  K10 runs the same body on a (num_a * 4, 1)
// grid with one stream (skip_join_kernel).  The TPU kernels' eight
// (8,128,128) broadcast compares and their sequential grids are not
// carried over.
#include "slave_join.cuh"

__global__ void __launch_bounds__(JOIN_SUB + 32) staged_join_kernel(
    const int* __restrict__ a_docs,       // [Q, num_a*TILE]
    const int* __restrict__ a_attrs,      // [Q, num_a*TILE]
    const int* __restrict__ a_live,       // [Q, num_a*TILE] or null
    const int* __restrict__ b_docs,       // [Q, T, w_b]
    const int* __restrict__ active,       // [Q, T]
    const int* __restrict__ attr_filter,  // [Q]
    const int* __restrict__ b_start,      // [Q, T, num_a]
    const int* __restrict__ n_b,          // [Q, T, num_a]
    int* __restrict__ out_mask,           // [Q, num_a*TILE]
    int t_slots, int num_a, int w_b)
{
    const Packed none{nullptr, nullptr, nullptr, nullptr, 0};
    const SkipPlan plan{active, b_start, n_b, t_slots, num_a, w_b};
    streamed_join_body<false>(plan, b_docs, b_docs, none, none, a_docs, a_attrs, a_live,
                              nullptr, attr_filter, out_mask, t_slots, num_a * TILE, 0);
}

extern "C" int batched_block_skip_launch(
    const void* a_docs, const void* a_attrs, const void* a_live,
    const void* b_docs, const void* active, const void* attr_filter,
    const void* b_start, const void* n_b, void* out_mask,
    int q_n, int t_slots, int num_a, int w_b, void* stream)
{
    static int allowed = 48 * 1024;
    const int smem = probe_layout(t_slots, false).total;
    const cudaError_t err = allow_smem(staged_join_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(num_a * NSUB, q_n);
    staged_join_kernel<<<grid, JOIN_SUB + 32, smem, (cudaStream_t)stream>>>(
        (const int*)a_docs, (const int*)a_attrs, (const int*)a_live,
        (const int*)b_docs, (const int*)active, (const int*)attr_filter,
        (const int*)b_start, (const int*)n_b, (int*)out_mask, t_slots, num_a, w_b);
    return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(JOIN_SUB + 32) skip_join_kernel(
    const int* __restrict__ a_docs,       // [num_a*TILE]
    const int* __restrict__ a_attrs,      // [num_a*TILE]
    const int* __restrict__ b_docs,       // [w_b]
    const int* __restrict__ attr_filter,  // [1]
    const int* __restrict__ b_start,      // [num_a]
    const int* __restrict__ n_b,          // [num_a]
    int* __restrict__ out_mask,           // [num_a*TILE]
    int num_a, int w_b)
{
    const Packed none{nullptr, nullptr, nullptr, nullptr, 0};
    const SkipPlan plan{nullptr, b_start, n_b, 1, num_a, w_b};
    streamed_join_body<false>(plan, b_docs, b_docs, none, none, a_docs, a_attrs, nullptr,
                              nullptr, attr_filter, out_mask, 1, num_a * TILE, 0);
}

extern "C" int block_skip_launch(
    const void* a_docs, const void* a_attrs, const void* b_docs,
    const void* attr_filter, const void* b_start, const void* n_b,
    void* out_mask, int num_a, int w_b, void* stream)
{
    static int allowed = 48 * 1024;
    const int smem = probe_layout(1, false).total;
    const cudaError_t err = allow_smem(skip_join_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(num_a * NSUB, 1);
    skip_join_kernel<<<grid, JOIN_SUB + 32, smem, (cudaStream_t)stream>>>(
        (const int*)a_docs, (const int*)a_attrs, (const int*)b_docs,
        (const int*)attr_filter, (const int*)b_start, (const int*)n_b, (int*)out_mask,
        num_a, w_b);
    return (int)cudaGetLastError();
}
