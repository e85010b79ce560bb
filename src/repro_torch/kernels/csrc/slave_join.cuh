// The block bodies of the slave joins, shared by the dense kernels K1
// (driver_streamed.cu) and K4 (streamed_join.cu), their work-list twins
// K6 (driver_compact.cu) and K7 (streamed_compact.cu), raw and packed, and
// the staged joins K9 and K10 (staged_join.cu).
//
// A body is K1's (driver read from the flat arrays by position) or K4's
// (driver a materialized window with live stream and flags); both probe
// with probe_async.cuh.  The only difference between a dense kernel and
// its twin is where a block finds its (query q, driver tile i) and its
// streams, which a Plan says: locate() gives (q, i), and the plan, called
// by the producer warp as probe_begin's fill, sets the stream table.
//
// - DensePlan: the grid is (tiles * NSUB, Q); block (x, y) is query y,
//   tile x / NSUB, and the producer warp reads the plan arrays (active,
//   b_tile, n_b, bounds, and under merge-on-read the delta plan) of every
//   term at (q, i).
// - TablePlan: the grid is (groups * NSUB); block b is group b / NSUB of
//   the work list (repro_torch/kernels/worklist.py), rows heads[g] ..
//   heads[g + 1] - 1, each [q, i, t, main_tile, flags, delta_tile, 0, 0].
//   The consumers read (q, i) from the group's head row; the producer warp
//   reads the group's rows, 32 a pass, and sets each term slot's streams:
//   active when a row of the slot carries FLAG_TERM_START, and each kind's
//   range the planned range (plan_range) of the first of that kind's tiles
//   and their number.  The rows of a (q, i, t) cell are the steps of the
//   dense plan (main tile b_tile + s while s < n_b, delta d_tile + s while
//   s < n_d), so that is K1's (K4's) planned range, and the union of the
//   rows' clipped tiles when they are consecutive (table_streams in
//   posting_intersect.py states the derivation and checks it).  A
//   dead-term group (one TERM_START|TERM_END row, no tile) gives an active
//   empty stream, so every slot dies; a no-op group (FIRST|LAST, no term
//   flag) none, so validity and the filter decide.
// - SkipPlan (K9 and K10, K4's body): the grid is DensePlan's, over a
//   staged driver window; term t's one stream is the skip range of the
//   staged other-term window [q, t] (b_docs [Q, T, W_b], flat): the planned
//   range of the skip map's b_start, n_b at (q, t, i), clipped to [0, W_b)
//   and offset by (q * T + t) * W_b.  An active slot with an empty range
//   kills every slot, as K4's dead term does.  K10 is the plan at Q = T =
//   1 with active null.
//
// In every plan block x % NSUB is the sub-tile: JOIN_SUB slots from
// i * TILE + (x % NSUB) * JOIN_SUB.
#pragma once
#include "probe_async.cuh"

#define NSUB (TILE / JOIN_SUB)   // blocks a driver tile
#define DOC_DEAD 1
#define DOC_SUPERSEDED 2
#define FLAG_TERM_START 2

__shared__ int group_qi[2];   // TablePlan: the group's (q, i)

// The streams of term t: t * spt the main range, + 1 the delta range.
__device__ __forceinline__ void set_term(StreamRange* st, int t, int spt, int act,
                                         long long rlo, long long rhi,
                                         long long dlo, long long dhi)
{
    if (!act) rlo = rhi = dlo = dhi = 0;
    stream_set(st[t * spt], rlo, rhi, act);
    if (spt == 2) stream_set(st[t * spt + 1], dlo, dhi, act);
}

struct DensePlan {
    const int* active;                        // [Q, T]
    const int *b_tile, *n_b, *bounds;         // [Q, T, A], [Q, T, A], [Q, T, 2]
    const int *d_tile, *n_d, *d_bounds;       // the delta's (has_delta)
    int t_slots, num_a, has_delta;

    __device__ __forceinline__ void locate(int& q, int& i) const
    {
        q = blockIdx.y;
        i = blockIdx.x / NSUB;
    }

    __device__ __forceinline__ void relocate(int& q, int& i) const { locate(q, i); }

    // The producer warp's fill (probe_begin): the plan of every term at
    // (q, i).
    __device__ __forceinline__ void operator()(StreamRange* st, int lane) const
    {
        const int spt = has_delta ? 2 : 1;
        const int q = blockIdx.y, i = blockIdx.x / NSUB;
        for (int t = lane; t < t_slots; t += 32) {
            // every load at once: the plan rows do not wait for active
            const long long qt = (long long)q * t_slots + t;
            const long long qti = qt * num_a + i;
            const int act = active[qt] != 0;
            const int bt = b_tile[qti], nb = n_b[qti];
            const int lo = bounds[2 * qt], hi = bounds[2 * qt + 1];
            int dt = 0, nd = 0, dlo = 0, dhi = 0;
            if (has_delta) {
                dt = d_tile[qti];
                nd = n_d[qti];
                dlo = d_bounds[2 * qt];
                dhi = d_bounds[2 * qt + 1];
            }
            // (not under `if (act)`: the loads would wait for active)
            long long rlo, rhi, rdlo = 0, rdhi = 0;
            plan_range(bt, nb, lo, hi, rlo, rhi);
            if (has_delta) plan_range(dt, nd, dlo, dhi, rdlo, rdhi);
            set_term(st, t, spt, act, rlo, rhi, rdlo, rdhi);
        }
    }
};

struct TablePlan {
    const int* desc;                          // [n_pad, 8]
    const int* heads;                         // [n_groups + 1]
    const int *bounds, *d_bounds;             // [Q, T, 2] (d_bounds: has_delta)
    int t_slots, has_delta;

    // The consumers: (q, i) of the group's head row, which thread 0 also
    // keeps in shared memory for relocate.  The producer warp reads no
    // driver slot and writes no output, so it takes (0, 0) and does not
    // wait for the row: its fill reads the group's rows itself.
    __device__ __forceinline__ void locate(int& q, int& i) const
    {
        q = i = 0;
        if (threadIdx.x >= JOIN_SUB) return;
        const int* d = desc + 8 * (long long)heads[blockIdx.x / NSUB];
        q = d[0];
        i = d[1];
        if (threadIdx.x == 0) {
            group_qi[0] = q;
            group_qi[1] = i;
        }
    }

    // (q, i) again after the probe (whose block barriers order thread 0's
    // store before these loads): loaded values kept in registers across
    // the probe would be spilled, where a dense plan's are recomputed from
    // blockIdx.
    __device__ __forceinline__ void relocate(int& q, int& i) const
    {
        q = group_qi[0];
        i = group_qi[1];
    }

    // The producer warp's fill (probe_begin): each kind's first tile and
    // tile count per term slot, gathered in the stream table's b0 and b1
    // (shared-memory atomics: a pass's lanes may share a slot), then the
    // planned ranges.
    __device__ __forceinline__ void operator()(StreamRange* st, int lane) const
    {
        const int spt = has_delta ? 2 : 1;
        const int g = blockIdx.x / NSUB;
        const int r0 = heads[g], r1 = heads[g + 1];
        for (int j = lane; j < t_slots * spt; j += 32) {
            st[j].b0 = INT_MAX;
            st[j].b1 = 0;
            st[j].act = 0;
        }
        __syncwarp();
        int q = 0;
        for (int n = r0 + lane; n - lane < r1; n += 32) {
            if (n < r1) {
                const int* d = desc + 8 * (long long)n;
                const int t = d[2], mt = d[3], flags = d[4];
                const int dt = has_delta ? d[5] : -1;
                if (n == r0) q = d[0];
                StreamRange* s = st + t * spt;
                if (flags & FLAG_TERM_START) atomicOr(&s->act, 1);
                if (mt >= 0) {
                    atomicMin(&s->b0, mt);
                    atomicAdd(&s->b1, 1);
                }
                if (dt >= 0) {
                    atomicMin(&s[1].b0, dt);
                    atomicAdd(&s[1].b1, 1);
                }
            }
        }
        q = __shfl_sync(FULL_MASK, q, 0);
        __syncwarp();
        for (int t = lane; t < t_slots; t += 32) {
            const long long qt = (long long)q * t_slots + t;
            const int lo = bounds[2 * qt], hi = bounds[2 * qt + 1];
            int dlo = 0, dhi = 0;
            if (has_delta) {
                dlo = d_bounds[2 * qt];
                dhi = d_bounds[2 * qt + 1];
            }
            const StreamRange* s = st + t * spt;
            const int act = s->act;
            long long rlo = 0, rhi = 0, rdlo = 0, rdhi = 0;
            if (s->b1 > 0) plan_range(s->b0, s->b1, lo, hi, rlo, rhi);
            if (has_delta && s[1].b1 > 0) plan_range(s[1].b0, s[1].b1, dlo, dhi, rdlo, rdhi);
            set_term(st, t, spt, act, rlo, rhi, rdlo, rdhi);
        }
    }
};

struct SkipPlan {
    const int* active;                        // [Q, T] or null (all active)
    const int *b_start, *n_b;                 // [Q, T, A]
    int t_slots, num_a, w_b;

    __device__ __forceinline__ void locate(int& q, int& i) const
    {
        q = blockIdx.y;
        i = blockIdx.x / NSUB;
    }

    __device__ __forceinline__ void relocate(int& q, int& i) const { locate(q, i); }

    // The producer warp's fill (probe_begin): every term's skip range at
    // (q, i), all loads at once.
    __device__ __forceinline__ void operator()(StreamRange* st, int lane) const
    {
        const int q = blockIdx.y, i = blockIdx.x / NSUB;
        for (int t = lane; t < t_slots; t += 32) {
            const long long qt = (long long)q * t_slots + t;
            const long long qti = qt * num_a + i;
            const int act = active == nullptr || active[qt] != 0;
            const int bs = b_start[qti], nb = n_b[qti];
            long long rlo, rhi;
            plan_range(bs, nb, 0, w_b, rlo, rhi);
            const long long row = qt * w_b;
            set_term(st, t, 1, act, row + rlo, row + rhi, 0, 0);
        }
    }
};

// K1 / K6: the driver read by position from the flat arrays (K1p / K6p:
// its blocks decoded into shared memory), one stream a term.
template <bool PACKED, class Plan>
__device__ __forceinline__ void driver_join_body(
    const Plan& plan,
    const int* __restrict__ postings,     // [P] (raw)
    const Packed& pk,                     // (packed)
    const int* __restrict__ d_off,        // [Q]
    const int* __restrict__ d_neff,       // [Q]
    const int* __restrict__ attr_filter,  // [Q]
    const int* __restrict__ attrs,        // [P]
    int* __restrict__ out_docs,           // [Q, window]
    int* __restrict__ out_mask,           // [Q, window]
    int t_slots, int window)
{
    extern __shared__ __align__(128) unsigned char smem[];
    const ProbeLayout L = probe_layout(t_slots, PACKED);
    int q, i;
    plan.locate(q, i);
    const int t0 = i * TILE + (blockIdx.x % NSUB) * JOIN_SUB;   // first slot
    const long long off = d_off[q];
    const int neff = d_neff[q];
    const int filt = attr_filter[q];
    const Sources src{{postings, postings}, {pk, pk}};

    Cursor c;
    probe_begin<PACKED>(smem, src, t_slots, 1, plan, c);

    const int n_sub = neff - t0 < 0 ? 0 : (neff - t0 < JOIN_SUB ? neff - t0 : JOIN_SUB);
    const int* drv = postings + off + t0;
    if (PACKED) {
        int* dec = (int*)(smem + L.dec);
        const int lead = decode_range(pk, off + t0, n_sub, dec);
        __syncthreads();
        drv = dec + lead;
    }
    const int k = threadIdx.x;
    const bool in_win = k < JOIN_SUB && k < n_sub;
    const int x = in_win ? drv[k] : INVALID_DOC;
    const int at = in_win ? attrs[off + t0 + k] : INVALID_ATTR;
    bool keep = x != INVALID_DOC && (filt < 0 || at == filt);

    probe_streams<PACKED>(smem, src, t_slots, 1, x, 1u, keep, c);

    plan.relocate(q, i);
    const int w = i * TILE + (blockIdx.x % NSUB) * JOIN_SUB + k;
    if (k < JOIN_SUB && w < window) {
        out_docs[(long long)q * window + w] = x;
        out_mask[(long long)q * window + w] = keep ? 1 : 0;
    }
}

// K4 / K7 / K9: the driver a materialized window (docIDs, attrs, live
// (a_live null: all live), and under merge-on-read flags), each term a
// main and (has_delta) a delta stream; a slot is searched in a stream only
// where its flags let that stream count.
template <bool PACKED, class Plan>
__device__ __forceinline__ void streamed_join_body(
    const Plan& plan,
    const int* __restrict__ postings,     // [P] (raw)
    const int* __restrict__ d_postings,   // [D] (raw)
    const Packed& pk, const Packed& dpk,  // (packed)
    const int* __restrict__ a_docs,       // [Q, window]
    const int* __restrict__ a_attrs,      // [Q, window]
    const int* __restrict__ a_live,       // [Q, window] or null
    const int* __restrict__ a_flags,      // [Q, window] (has_delta)
    const int* __restrict__ attr_filter,  // [Q]
    int* __restrict__ out_mask,           // [Q, window]
    int t_slots, int window, int has_delta)
{
    extern __shared__ __align__(128) unsigned char smem[];
    const int spt = has_delta ? 2 : 1;
    int q, i;
    plan.locate(q, i);
    const int t0 = i * TILE + (blockIdx.x % NSUB) * JOIN_SUB;   // first slot
    const Sources src{{postings, d_postings}, {pk, dpk}};
    const int filt = attr_filter[q];
    const int w = t0 + threadIdx.x;
    const bool in_win = threadIdx.x < JOIN_SUB && w < window;
    const long long o = (long long)q * window + w;
    const int x = in_win ? a_docs[o] : INVALID_DOC;
    const int at = in_win ? a_attrs[o] : INVALID_ATTR;
    const int lv = !in_win ? 0 : a_live == nullptr ? 1 : a_live[o];
    const int fl = in_win && has_delta ? a_flags[o] : 0;
    bool keep = x != INVALID_DOC && (filt < 0 || at == filt) && lv != 0;
    // bit 0: the main stream counts, bit 1: the delta
    const unsigned ok = ((fl & (DOC_DEAD | DOC_SUPERSEDED)) == 0 ? 1u : 0u) |
                        ((fl & DOC_DEAD) == 0 ? 2u : 0u);

    Cursor c;
    probe_begin<PACKED>(smem, src, t_slots * spt, spt, plan, c);

    probe_streams<PACKED>(smem, src, t_slots * spt, spt, x, ok, keep, c);

    plan.relocate(q, i);
    if (in_win)
        out_mask[(long long)q * window + i * TILE + (blockIdx.x % NSUB) * JOIN_SUB +
                 threadIdx.x] = keep ? 1 : 0;
}
