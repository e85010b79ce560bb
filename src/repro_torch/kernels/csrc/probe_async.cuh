// The membership probe of the slave joins K1 (driver_streamed.cu), K4
// (streamed_join.cu) and their work-list twins K6 (driver_compact.cu) and
// K7 (streamed_compact.cu), of their packed modes K1p, K4p, K6p and K7p,
// and of the staged joins K9 and K10 (staged_join.cu), staged
// asynchronously for Hopper; their block bodies are in slave_join.cuh.
//
// What bounds a probe on the H100: latency, not bytes or operations.  The
// work is a binary search of a few steps per byte read, and at the main
// path's shapes (Q 32, window 4096) the bytes a launch must move take
// about 0.6 us at the card's memory rate.  A load that depends on another
// costs a round trip of about 650 cycles; a search can start only when
// its data has landed; so a block's time is the number of round trips on
// its chain, plus its searches, and the kernel's time is its slowest
// block's.
//
// What the design does about it:
//
// 1. A sub-tiled grid.  A block owns JOIN_SUB = 256 slots of one
//    1024-slot driver tile (the plan's TILE), one slot a consumer thread,
//    so a tile is split over four blocks and several blocks are resident
//    on each SM: one block's loads overlap another's search.  The plan
//    stays per TILE; a sub-tile uses its parent tile's planned range.
//    (256 was the fastest of 128, 256, 512 and 1024 slots a block at the
//    main path's shapes: PERF.md section 6.)
// 2. A producer warp.  Beside the consumer threads, one warp reads the
//    plan, forms the rounds (below) and issues their copies, one lane a
//    stream.  A raw range is staged whole, its copies issued with the plan
//    while the consumers read the driver, so they are in flight before the
//    driver has landed.  (Narrowing raw ranges to the block's docIDs first
//    cost more than the bytes it saved: PERF.md section 6.)
// 3. Packed: only what a sub-tile can match.  The consumers reduce the
//    smallest and largest docID of their live slots [smin, smax], and each
//    packed range is narrowed to the 128-posting blocks that can hold a
//    docID in that interval, from the codec's blk_base (each block's first
//    docID), so blocks outside the interval are never copied or decoded.
//    One warp narrows one stream: each lane reads two blocks' descriptors
//    (one round trip for ranges of up to 64 blocks) and two ballots count
//    the blocks that start at or below smin and smax.
// 4. Asynchronous staging.  The streams (K1: one per term; K4: the main
//    and the delta range of each term) are cut into segments and packed
//    into rounds, each round one shared-memory buffer filled by TMA 1-D
//    bulk copies (cp.async.bulk) that complete on the buffer's mbarrier.
//    Two buffers: round r + 1 is in flight while round r is searched, so
//    the first two rounds cost one round trip, and usually every term fits
//    in them.  A term's membership is folded into the slots' keep flags
//    once all its segments have been searched; a block whose slots have
//    all died stops (__syncthreads_or) after the copy still in flight has
//    landed.
// 5. Short searches.  DocIDs within a list are close to uniform, so a
//    search first interpolates x's position from the segment's first and
//    last docID and, when the window of +-INTERP postings around it
//    brackets x, binary-searches only that window: about 7 dependent
//    shared-memory loads in place of 12 for a 4096-posting segment.
//
// Alignment: a bulk copy moves whole 16-byte chunks between 16-byte
// aligned addresses.  A segment's copy starts at its first posting (raw)
// or word (packed) rounded down to 16 bytes and ends rounded up; the
// segment is searched from its own first position in the buffer.  So any
// list offset, term capacity or word offset is taken; the copy stays
// inside the array when the array starts on 16 bytes and holds a whole
// number of 16-byte chunks, which the wrappers check
// (_build.check_aligned).  The index and delta layouts start every range
// on 16 bytes (probe_staging_check in posting_intersect.py checks a plan),
// so on them a copy reads nothing before its range.
#pragma once
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"
#include "hopper.cuh"

#define TILE 1024          // driver slots per plan tile
#define JOIN_SUB 256       // driver slots a block owns, one a consumer thread
#define JOIN_WARPS (JOIN_SUB / 32)   // consumer warps; warp JOIN_WARPS produces
#define INVALID_ATTR (-1)
#define RAW_CAP 4096       // postings a raw round buffer holds (16 KB)
#define WORD_CAP 4096      // words a packed round buffer holds (16 KB)
#define DEC_BLKS 32        // blocks a packed round decodes (16 KB)
#define MAX_SEG 16         // segments a round holds
#define MAX_OPEN 31        // streams a round may touch (found bits: stream & 31)
#define INTERP 32          // half-width of a search's interpolated window
#define FULL_MASK 0xFFFFFFFFu

// One stream: a planned range, then narrowed.
struct StreamRange {
    long long lo, hi;   // positions [lo, hi) of the flat array
    int b0, b1;         // packed: the blocks to decode, [b0, b1] (b1 < b0: none)
    int w0, w1;         // packed: their words [w0, w1)
    int act;            // the stream's term is active
};

// A piece of one stream staged in a round.
struct Seg {
    long long p0;       // raw: first position; packed: first block
    int j;              // stream
    int off;            // raw: offset of p0 in the round buffer; packed: first
                        // decode slot
    int n;              // positions searched (from p0, or block p0's start + lead)
    int wsm;            // packed: word offset of block p0 in the round buffer
    int w0;             // packed: word offset of block p0 in the flat words
    int lead;           // packed: positions of block p0 before the range
};

struct Round {
    int nseg;
    int used;           // raw: ints copied; packed: blocks to decode
    int fold_upto, last;
    Seg seg[MAX_SEG];
};

// The arrays a stream reads, by its kind (0: the main lists, 1: the delta
// slabs): raw postings, or a block-codec twin.
struct Sources {
    const int* p[2];
    Packed pk[2];

    // selected, not indexed: a runtime index would put the struct in local
    // memory
    __device__ __forceinline__ const int* raw(int kind) const
    {
        return kind ? p[1] : p[0];
    }
    __device__ __forceinline__ Packed packed(int kind) const
    {
        return kind ? pk[1] : pk[0];
    }
};

struct ProbeHead {
    uint64_t bar[2];    // one mbarrier per round buffer
    Round round[2];
    int red[3][32];     // per consumer warp: smin, smax, alive
};

// Byte offsets of the dynamic shared memory: head, stream table, two round
// buffers (raw postings or packed words), and for a packed source one
// decode buffer (also K1p's decoded driver sub-tile).
struct ProbeLayout {
    int st, buf, dec, total;
};

__host__ __device__ inline ProbeLayout probe_layout(int nstr, bool packed)
{
    ProbeLayout L;
    L.st = (int)((sizeof(ProbeHead) + 15) & ~(size_t)15);
    L.buf = (L.st + nstr * (int)sizeof(StreamRange) + 127) & ~127;
    L.dec = L.buf + 2 * (packed ? WORD_CAP : RAW_CAP) * 4;
    L.total = L.dec + (packed ? DEC_BLKS * PBLOCK * 4 : 0);
    return L;
}

// The planned range [rlo, rhi) of one (query, term, driver tile): tiles
// b_tile .. b_tile + n_b - 1 clipped to the term's window [lo, hi).
__device__ __forceinline__ void plan_range(
    int b_tile, int n_b, long long lo, long long hi, long long& rlo, long long& rhi)
{
    const long long tile0 = (long long)b_tile * TILE;
    rlo = tile0 > lo ? tile0 : lo;
    rhi = tile0 + (long long)n_b * TILE;
    if (rhi > hi) rhi = hi;
    if (n_b <= 0 || rhi < rlo) rhi = rlo;
}

__device__ __forceinline__ void stream_set(StreamRange& s, long long lo,
                                           long long hi, int act)
{
    s.lo = lo; s.hi = hi; s.b0 = 0; s.b1 = -1; s.w0 = 0; s.w1 = 0;
    s.act = act;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// Decode one block from words already in shared memory into out[0, 128):
// the arithmetic of decode_block_warp (decode.cuh) with the descriptor in
// registers.
__device__ __forceinline__ void decode_staged_warp(const uint32_t* wb, int meta,
                                                   int base, int* out)
{
    const int lane = threadIdx.x & 31;
    const uint32_t w = (uint32_t)meta & 63u;
    const int cnt = meta >> 6;
    uint32_t s[4];
    uint32_t acc = 0;
    if (w != 0) {
        const uint32_t mask = w >= 32u ? 0xFFFFFFFFu : ((1u << w) - 1u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint32_t bit = (uint32_t)(4 * lane + j) * w;
            acc += (wb[bit >> 5] >> (bit & 31u)) & mask;
            s[j] = acc;
        }
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = 0;
    }
    uint32_t incl = acc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t t = __shfl_up_sync(FULL_MASK, incl, d);
        if (lane >= d) incl += t;
    }
    const uint32_t lvl = (uint32_t)base + (incl - acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int l = 4 * lane + j;
        out[l] = l < cnt ? (int)(lvl + s[j]) : INVALID_DOC;
    }
}

// Warp-wide: narrow packed stream sr to the blocks whose docIDs can fall
// in [smin, smax], and to their words.  Block b holds docIDs in [first(b),
// first(b + 1)), so the blocks to keep run from the last block with first
// <= smin (or the first block) to the last block with first <= smax; none
// when the first block starts above smax.
__device__ __forceinline__ void narrow_stream(StreamRange& sr, const Packed& pk,
                                              int smin, int smax)
{
    const int lane = threadIdx.x & 31;
    const long long lo = sr.lo, hi = sr.hi;
    const long long B0 = lo >> 7;
    const int nblk = (int)(((hi - 1) >> 7) - B0 + 1);
    int c_lo = 0, c_hi = 0, last_k0 = 0;
    int mt[2] = {0, 0}, wo[2] = {0, 0};
    for (int k0 = 0; k0 < nblk; k0 += 64) {
        last_k0 = k0;
        int f[2];
        bool v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int k = k0 + 32 * u + lane;
            v[u] = k < nblk;
            const long long b = B0 + k;
            f[u] = v[u] ? pk.base[b] : 0;
            mt[u] = v[u] ? pk.meta[b] : 0;
            wo[u] = v[u] ? pk.woff[b] : 0;
        }
        bool past = false;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            c_lo += __popc(__ballot_sync(FULL_MASK, v[u] && f[u] <= smin));
            c_hi += __popc(__ballot_sync(FULL_MASK, v[u] && f[u] <= smax));
            past |= v[u] && f[u] > smax;
        }
        // first docIDs ascend: every later block starts above smax
        if (__any_sync(FULL_MASK, past)) break;
    }
    const int klo = c_lo > 0 ? c_lo - 1 : 0;
    const int khi = c_hi - 1;
    if (khi < 0) {
        if (lane == 0) sr.hi = lo;
        return;
    }
    const long long nlo = (B0 + klo) * PBLOCK;
    long long nhi = (B0 + khi + 1) * PBLOCK;
    if (nhi > hi) nhi = hi;
    int w0, w1;
    if (klo >= last_k0 && khi < last_k0 + 64) {
        // both blocks were read by the last pass: take their words from it
        const int a = klo - last_k0, b = khi - last_k0;
        w0 = __shfl_sync(FULL_MASK, (a >> 5) ? wo[1] : wo[0], a & 31);
        const int wb = __shfl_sync(FULL_MASK, (b >> 5) ? wo[1] : wo[0], b & 31);
        const int mb = __shfl_sync(FULL_MASK, (b >> 5) ? mt[1] : mt[0], b & 31);
        w1 = wb + 4 * (mb & 63);
    } else {
        w0 = pk.woff[B0 + klo];
        w1 = pk.woff[B0 + khi + 1];
    }
    if (lane == 0) {
        sr.lo = nlo > lo ? nlo : lo;
        sr.hi = nhi;
        sr.b0 = (int)(B0 + klo);
        sr.b1 = (int)(B0 + khi);
        sr.w0 = w0;
        sr.w1 = w1;
    }
}

// The producer warp's cursor, the same in every lane: the stream j where
// the next round starts and where it resumes in it (raw: position pos;
// packed: block cb and its word offset cw), and the rounds formed so far.
// A round is formed only while a stream is left (round 0 always: it
// carries the terms to fold).
struct Cursor {
    int j;
    long long pos;
    int cb, cw;
    int formed;
};

__device__ __forceinline__ void cursor_to(Cursor& c, const StreamRange* st,
                                          int j, int nstr)
{
    c.j = j;
    if (j < nstr) {
        c.pos = st[j].lo;
        c.cb = st[j].b0;
        c.cw = st[j].w0;
    }
}

__device__ __forceinline__ int warp_incl_sum(int v)
{
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(FULL_MASK, v, d);
        if (lane >= d) v += t;
    }
    return v;
}

// The producer warp: form the next round into rd and issue its copies on
// bar.  Lane l takes stream c.j + l (l < MAX_OPEN), lane 0 from where the
// cursor resumes: its segment is what fits in the round after the streams
// of the lanes before it (prefix sums), and the lane issues its own bulk
// copy at once, from its first posting (raw) or word (packed) rounded down
// to 16 bytes to its last rounded up; lane 0 then publishes the round's
// table with its arrival on bar (a release: the consumers read the table
// after their wait on bar).  The bytes are expected after the copies are
// issued: the phase cannot complete before that arrival.  The lanes that
// stage take consecutive pieces of the buffer, so the bytes expected are
// the end of the last piece.  The cursor moves to the first stream not
// consumed.  `reuse`: the buffer held an earlier round.
template <bool PACKED>
__device__ __forceinline__ void form_round(Round& rd, uint64_t* bar, int* rbuf,
                                           const Sources& src, const StreamRange* st,
                                           int nstr, int spt, Cursor& c, bool reuse)
{
    const int lane = threadIdx.x & 31;
    const int j = c.j + lane;
    const bool mine = lane < MAX_OPEN && j < nstr;
    long long lo = 0, hi = 0;
    int cb = 0, b1 = -1, cw = 0, w1 = 0;
    if (mine) {
        const StreamRange& s = st[j];
        hi = s.hi;
        lo = lane == 0 ? c.pos : s.lo;
        cb = lane == 0 ? c.cb : s.b0;
        cw = lane == 0 ? c.cw : s.w0;
        b1 = s.b1;
        w1 = s.w1;
    }
    // left: what remains (raw: postings; packed: blocks); take: what this
    // round stages, at start (packed: blocks at start, words at wstart);
    // lead: the ints copied before the first (the copy starts on 16 bytes)
    long long left;
    int take, start, lead, wstart = 0, wend = 0;
    if (!PACKED) {
        left = hi > lo ? hi - lo : 0;
        lead = (int)(lo & 3);
        const long long need = left > 0 ? (lead + left + 3) & ~3LL : 0;
        const int size = (int)(need < RAW_CAP ? need : RAW_CAP);
        start = warp_incl_sum(size) - size;
        const int room = start < RAW_CAP - lead ? RAW_CAP - start - lead : 0;
        take = (int)(left < room ? left : room);
    } else {
        left = b1 >= cb ? b1 - cb + 1 : 0;
        lead = cw & 3;
        const int size = (int)(left < DEC_BLKS ? left : DEC_BLKS);
        const int nw = left > 0 ? ((w1 + 3) & ~3) - (cw - lead) : 0;
        const int nwc = nw < WORD_CAP ? nw : WORD_CAP;
        start = warp_incl_sum(size) - size;
        wstart = warp_incl_sum(nwc) - nwc;
        if (start >= DEC_BLKS || wstart >= WORD_CAP) {
            take = 0;
        } else if (start + left <= DEC_BLKS && wstart + nw <= WORD_CAP) {
            take = (int)left;
            wend = w1;
        } else {
            // cut where the words surely fit: a block holds at most 128
            take = (int)(left < DEC_BLKS - start ? left : DEC_BLKS - start);
            const int fit = (WORD_CAP - wstart - lead) / 128;
            if (take > fit) take = fit;
            if (take > 0) wend = src.packed(j & (spt - 1)).woff[cb + take];
        }
    }
    bool has = take > 0;
    const int idx = __popc(__ballot_sync(FULL_MASK, has) & ((1u << lane) - 1u));
    if (idx >= MAX_SEG) {
        has = false;
        take = 0;
    }
    // the ints this lane copies, into its piece of the buffer
    const int copied = !has ? 0
                       : PACKED ? ((wend + 3) & ~3) - (cw - lead)
                                : (lead + take + 3) & ~3;
    if (reuse) fence_proxy_async();
    const int kind = j & (spt - 1);
    if (!PACKED && has)
        bulk_load(rbuf + start, src.raw(kind) + (lo - lead), (uint32_t)copied * 4u, bar);
    if (PACKED && copied > 0)
        bulk_load(rbuf + wstart, src.packed(kind).words + (cw - lead),
                  (uint32_t)copied * 4u, bar);
    const bool done = left == 0 || (has && take == left);
    const unsigned open = __ballot_sync(FULL_MASK, mine && !done);
    const int n_mine = nstr - c.j < MAX_OPEN ? nstr - c.j : MAX_OPEN;
    const int stop = open ? __ffs(open) - 1 : n_mine;
    // where the stream at `stop` resumes (where its lane began, if it took
    // nothing)
    const long long npos = __shfl_sync(FULL_MASK, lo + take, stop & 31);
    const int ncb = __shfl_sync(FULL_MASK, cb + take, stop & 31);
    const int ncw = __shfl_sync(FULL_MASK, take > 0 ? wend : cw, stop & 31);
    const int used = __reduce_max_sync(
        FULL_MASK, has ? (PACKED ? start + take : start + copied) : 0);
    const int words =
        PACKED ? __reduce_max_sync(FULL_MASK, has ? wstart + copied : 0) : used;
    const int nseg = __popc(__ballot_sync(FULL_MASK, has));
    if (has) {
        Seg& g = rd.seg[idx];
        g.j = j;
        if (!PACKED) {
            g.p0 = lo;
            g.off = start + lead;
            g.n = take;
            g.wsm = 0; g.w0 = 0; g.lead = 0;
        } else {
            long long plo = (long long)cb * PBLOCK;
            const int plead = st[j].lo > plo ? (int)(st[j].lo - plo) : 0;
            plo += plead;
            long long phi = (long long)(cb + take) * PBLOCK;
            if (phi > hi) phi = hi;
            g.p0 = cb;
            g.off = start;
            g.n = (int)(phi - plo);
            g.wsm = wstart + lead;
            g.w0 = cw;
            g.lead = plead;
        }
    }
    const int nj = c.j + stop;
    ++c.formed;
    __syncwarp();
    if (lane == 0) {
        rd.nseg = nseg;
        rd.used = used;
        rd.fold_upto = nj / spt;
        rd.last = nj >= nstr;
        mbar_arrive_expect_tx(bar, (uint32_t)words * 4u);
    }
    // the stream at `stop` resumes where its lane stopped; when every
    // stream was consumed, the next one starts fresh
    if (open) {
        c.j = nj;
        c.pos = npos;
        c.cb = ncb;
        c.cw = ncw;
    } else {
        cursor_to(c, st, nj, nstr);
    }
}

// Consumer warps: decode a packed round's blocks from its staged words
// into dec, block slot k at dec[k * 128].  Lane l of warp w first reads
// the descriptor of the warp's l-th block (slot w + l * JOIN_WARPS), so
// the warp pays one round trip for all of its blocks.
__device__ __forceinline__ void decode_round(const Round& rd, const Sources& src,
                                             int spt, const uint32_t* wbuf, int* dec)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int k = warp + lane * JOIN_WARPS;
    int base = 0, meta = 0, wsm = 0;
    if (k < rd.used) {
        int g = 0;
        while (g + 1 < rd.nseg && rd.seg[g + 1].off <= k) ++g;
        const Seg& s = rd.seg[g];
        const Packed pk = src.packed(s.j & (spt - 1));
        const long long b = s.p0 + (k - s.off);
        base = pk.base[b];
        meta = pk.meta[b];
        wsm = s.wsm + (pk.woff[b] - s.w0);
    }
    for (int i = 0; warp + i * JOIN_WARPS < rd.used; ++i) {
        const int bb = __shfl_sync(FULL_MASK, base, i);
        const int mm = __shfl_sync(FULL_MASK, meta, i);
        const int ww = __shfl_sync(FULL_MASK, wsm, i);
        decode_staged_warp(wbuf + ww, mm, bb, dec + (warp + i * JOIN_WARPS) * PBLOCK);
    }
}

// The consumers' barrier (named barrier 1): the producer warp does not
// take part.
__device__ __forceinline__ void consumer_sync()
{
    asm volatile("bar.sync 1, %0;" :: "r"(JOIN_SUB) : "memory");
}

// Named barrier 2 hands the initialised round barriers from the producer
// warp (arrive, without waiting) to the consumers (sync, before their
// first wait on a round).
__device__ __forceinline__ void init_handoff(bool producer)
{
    if (producer)
        asm volatile("bar.arrive 2, %0;" :: "r"(JOIN_SUB + 32) : "memory");
    else
        asm volatile("bar.sync 2, %0;" :: "r"(JOIN_SUB + 32) : "memory");
}

// Start a probe: every thread of the block (JOIN_SUB consumers and the
// producer warp) calls this first.  The producer warp sets up the round
// barriers (handed to the consumers by init_handoff), fills the stream
// table (fill(st, lane) sets streams lane, lane + 32, ... with
// stream_set) and, for a raw source, issues the first two rounds at once;
// the consumers go on to read their driver slots.
template <bool PACKED, class Fill>
__device__ __forceinline__ void probe_begin(unsigned char* smem, const Sources& src,
                                            int nstr, int spt, Fill fill, Cursor& c)
{
    if (threadIdx.x < JOIN_SUB) return;
    ProbeHead* h = (ProbeHead*)smem;
    const ProbeLayout L = probe_layout(nstr, PACKED);
    StreamRange* st = (StreamRange*)(smem + L.st);
    if (threadIdx.x == JOIN_SUB) {
        mbar_init(&h->bar[0], 1);
        mbar_init(&h->bar[1], 1);
        mbar_fence_init();
    }
    __syncwarp();
    init_handoff(true);
    fill(st, threadIdx.x & 31);
    __syncwarp();
    if (PACKED) return;
    int* buf = (int*)(smem + L.buf);
    c.formed = 0;
    cursor_to(c, st, 0, nstr);
    form_round<PACKED>(h->round[0], &h->bar[0], buf, src, st, nstr, spt, c, false);
    if (c.j < nstr)
        form_round<PACKED>(h->round[1], &h->bar[1], buf + RAW_CAP, src, st, nstr, spt,
                           c, false);
}

// Probe every stream for the consumer's slot x and fold the terms'
// membership into keep.  Streams are numbered term * spt + kind (spt 1 or
// 2; kind 0 the main range, 1 the delta range); the slot is searched in
// stream j only where keep and bit (j % spt) of ok hold.  probe_begin
// comes first, with the same cursor c; every thread of the block calls
// this (the producer warp's keep is false).  Term t is folded, when its
// act flag is set, as keep &= (found in any of its streams).
template <bool PACKED>
__device__ __forceinline__ void probe_streams(unsigned char* smem, const Sources& src,
                                              int nstr, int spt, int x, unsigned ok,
                                              bool& keep, Cursor& c)
{
    constexpr int BUF = PACKED ? WORD_CAP : RAW_CAP;
    ProbeHead* h = (ProbeHead*)smem;
    const ProbeLayout L = probe_layout(nstr, PACKED);
    StreamRange* st = (StreamRange*)(smem + L.st);
    int* buf = (int*)(smem + L.buf);
    int* dec = (int*)(smem + L.dec);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const bool consumer = warp < JOIN_WARPS;
    if (consumer) init_handoff(false);

    if (PACKED) {
        // the docID interval of the live slots, then the narrowing: one
        // warp a stream (only that warp reads it until the barrier)
        const int lmin = __reduce_min_sync(FULL_MASK, keep ? x : INT_MAX);
        const int lmax = __reduce_max_sync(FULL_MASK, keep ? x : INT_MIN);
        const unsigned lal = __ballot_sync(FULL_MASK, keep);
        if (consumer && lane == 0) {
            h->red[0][warp] = lmin;
            h->red[1][warp] = lmax;
            h->red[2][warp] = lal != 0;
        }
        __syncthreads();
        int smin = INT_MAX, smax = INT_MIN, alive = 0;
#pragma unroll
        for (int w = 0; w < JOIN_WARPS; ++w) {
            smin = h->red[0][w] < smin ? h->red[0][w] : smin;
            smax = h->red[1][w] > smax ? h->red[1][w] : smax;
            alive |= h->red[2][w];
        }
        if (!alive) return;   // no copy was issued
        for (int j = warp; j < nstr; j += JOIN_WARPS + 1)
            if (st[j].hi > st[j].lo)
                narrow_stream(st[j], src.packed(j & (spt - 1)), smin, smax);
        __syncthreads();
        if (!consumer) {
            c.formed = 0;
            cursor_to(c, st, 0, nstr);
            form_round<PACKED>(h->round[0], &h->bar[0], buf, src, st, nstr, spt, c,
                               false);
            if (c.j < nstr)
                form_round<PACKED>(h->round[1], &h->bar[1], buf + BUF, src, st, nstr,
                                   spt, c, false);
        }
    }

    uint32_t hit = 0;
    int folded = 0;
    for (int r = 0;; ++r) {
        const int slot = r & 1;
        const Round& rd = h->round[slot];   // published by the arrival on bar
        int* data = buf + slot * BUF;
        if (consumer) {
            // (the producer reads no data: it waits only, at the end, for a
            // round still in flight)
            mbar_wait(&h->bar[slot], (uint32_t)(r >> 1) & 1u);
            if (PACKED) {
                decode_round(rd, src, spt, (const uint32_t*)data, dec);
                consumer_sync();
                data = dec;
            }
            for (int g = 0; g < rd.nseg; ++g) {
                const Seg& s = rd.seg[g];
                const int base = PACKED ? s.off * PBLOCK + s.lead : s.off;
                const int len = s.n;
                const int* sb = data + base;
                const int cmin = sb[0], cmax = sb[len - 1];
                const uint32_t bit = 1u << (s.j & 31);
                const unsigned kind = (unsigned)(s.j & (spt - 1));
                if (!keep || !((ok >> kind) & 1u) || (hit & bit) || x < cmin ||
                    x > cmax)
                    continue;
                // first index with sb[idx] >= x: in the window of +-INTERP
                // around the interpolated position when it brackets x (so
                // holds x if the segment does), else in the segment
                int l = 0, hh = len - 1;
                if (len > 4 * INTERP) {
                    // positions per docID
                    const float scale =
                        cmax > cmin ? (float)(len - 1) / (float)(cmax - cmin) : 0.f;
                    const int gs = (int)((float)(x - cmin) * scale);
                    const int wl = gs > INTERP ? gs - INTERP : 0;
                    const int wh = gs + INTERP < len - 1 ? gs + INTERP : len - 1;
                    if (sb[wl] <= x && x <= sb[wh]) {
                        l = wl;
                        hh = wh;
                    }
                }
                while (l < hh) {
                    const int m = (l + hh) >> 1;
                    if (sb[m] < x) l = m + 1; else hh = m;
                }
                if (sb[l] == x) hit |= bit;
            }
            for (; folded < rd.fold_upto; ++folded) {
                uint32_t m = 0;
                for (int u = 0; u < spt; ++u) m |= 1u << ((folded * spt + u) & 31);
                if (st[folded * spt].act != 0) keep = keep && (hit & m) != 0;
                hit &= ~m;
            }
        }
        const int last = rd.last;
        // all reads of this round's buffer and table are done past here
        if (!__syncthreads_or(keep) || last) {
            if (!consumer && lane == 0 && c.formed > r + 1)
                mbar_wait(&h->bar[slot ^ 1], (uint32_t)((r + 1) >> 1) & 1u);
            break;
        }
        if (!consumer && c.j < nstr)
            form_round<PACKED>(h->round[slot], &h->bar[slot], buf + slot * BUF, src,
                               st, nstr, spt, c, true);
    }
}

// Host: let kernel use `bytes` of dynamic shared memory (above 48 KB it
// must be allowed first); `allowed` remembers what was allowed.
template <class K>
static cudaError_t allow_smem(K kernel, int bytes, int& allowed)
{
    if (bytes <= allowed) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) allowed = bytes;
    return err;
}
