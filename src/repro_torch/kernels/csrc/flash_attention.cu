// K12: GQA flash-attention forward, online softmax in float32.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention_fwd
// (pallas_call at line 136, body _flash_kernel at line 49).  Python side:
// repro_torch/kernels/flash_attention.py (flash_attention_fwd_cuda, held
// against flash_attention_fwd_torch and flash_attention_ref).
//
// What it computes: q [B, S, H, hd], k and v [B, T, KV, hd] (float32 or
// bfloat16, contiguous), o [B, S, H, hd] in q's type.  Rows are flattened
// (B, KV, G) with G = H / KV, so q head h reads k/v head h / G.  Logits are
// (q . k) * scale with scale = 1/sqrt(hd) rounded to float; under causal a
// key at kpos > qpos (positions from 0) is masked to -1e30, and with a
// window W > 0 (causal only; 0 is none) so is a key at kpos <= qpos - W:
// query i sees keys i - W + 1 .. i, the reference's _flash_gqa mask
// (repro/models/layers.py:148-149).  The running max
// m, denominator l and accumulator acc are float32; o = acc / max(l, 1e-30).
// Keys past T (the ragged last tile) are left out (-inf logit, weight 0);
// query rows past S are neither read nor stored.
//
// What bounds it on the H100: operations, 4 * B * H * S * T * hd flops
// (halved under causal) against reading q, k, v and writing o once: at
// hd = 128 hundreds of flops a byte.  Two kernels, one per type, both on
// the tensor cores with the same frame: grid (B * H, S / BQ), q tiles in
// reverse order so the longest causal rows start first; a producer
// warpgroup loads the q tile once by TMA and streams k and v tiles through
// a ring in shared memory (4-D tensor maps of the (B, S, H, hd) and (B, T,
// KV, hd) layouts, boxes of 128 bytes a row with 128-byte swizzle; rows
// past S or T arrive as zeros), mbarriers signal full and empty slots; 64
// query rows a consumer warpgroup, which computes S = Q.K^T with wgmma,
// runs the online softmax in float32 on the accumulator fragment (a thread
// holds parts of two rows; the row max reduces across its quad by two
// shuffles, the row sum is kept per thread and reduced once at the end)
// and uses P from registers as wgmma's A operand for O += P.V, so P never
// goes through shared memory.  With two consumer warpgroups they take
// turns on the tensor cores (named barriers): a turn issues P_{r-1}.V_{r-1}
// and Q.K_r^T as one group, and the softmax of tile r runs while the other
// warpgroup's turn keeps the tensor cores busy.  Every turn issues the same
// products (ptxas serialises wgmma under divergent branches), so under
// causal the block skips the k tiles wholly past its last row and a
// warpgroup runs the all-masked tiles it shares with the other; only tiles
// that cross the diagonal or the end of T pay for the mask.  With a window
// the block also skips every k tile before the one that holds key q0 - W +
// 1 (its first row's first key): its tiles are kt0 .. n_kt - 1, and the
// ring's slots and phases count from kt0 (turn r loads tile kt0 + r), in
// the producer and the consumers alike.  A tile that holds a key before
// the window of any row of a warpgroup is an edge tile too; such a key
// gets -inf, not -1e30, so a row whose first tiles lie wholly before its
// window keeps m = -1e30, l = 0 and acc = 0 until its first live key (the
// reference's -1e30 there gives weights of 1 that the first live key's
// rescale by exp(-1e30 - m) = 0 then wipes: the same result).  At S = T =
// 4096 and W = 2048 a row sees at most 2048 keys, 75% of the causal work.
// The scale is folded with log2(e) into ex2.approx.ftz.
//
// float32 (flash_attention_tf32_kernel): split TF32, 495 TFLOP/s dense on
// the tensor cores against 67 on the CUDA cores.  One TF32 product keeps
// 11 significant bits, too few for the 2e-5 contract; each float32 operand
// x is split into hi = tf32(x) (cvt.rna: to nearest, ties away) and lo =
// tf32(x - hi), and every product is hi.hi + hi.lo + lo.hi with float32
// accumulators (the lo.lo term is below 2^-22 of the product), so Q.K^T
// and P.V each cost three wgmma m64nNk8 .tf32 and the bound is 3 x flops /
// 495 TFLOP/s.  wgmma ignores a TF32 operand's low 13 bits and reads .tf32
// from shared memory only K-major, so:
//   - Q lands by TMA as float32 and stays so; each tile, a consumer loads
//     its A fragments (4 values a k-step of 8) from the swizzled tile,
//     splits them in registers and issues them as the register A operand,
//     in chunks of QC k-steps held in two register sets (a chunk is loaded
//     once the chunk two back has completed, wgmma.wait_group 1).
//   - K lands in its slot; a converter (warps 1-3 of the producer
//     warpgroup, 96 threads) rewrites it in place as hi and writes lo into
//     a second slot of the same layout: both K-major B operands.
//   - V lands in a staging slot; the converter writes V^T hi and lo (row d,
//     the tile's keys along the row) in the 128-byte swizzled K-major
//     layout, 32 keys a row, so at hd 256 (16-key tiles) the two ring slots
//     share each row.  In the k-step of 8 keys the keys sit in the order 0,
//     2, 4, 6, 1, 3, 5, 7: TF32's A fragment holds keys t and t + 4 where
//     the accumulator fragment of S holds 2t and 2t + 1, and the sum over
//     the keys does not depend on their order, so P goes from the
//     accumulator to the A operand in place.  P is split in registers; l
//     is summed from the unsplit P.
//   - Warp 0 of the producer warpgroup issues the TMA loads of tile r
//     once Q.K^T of tile r - 2 is done (kfree) and its V read (vready).
//     The converter splits K_r as soon as it lands (kready), then V_r once
//     P.V of tile r - 2 has freed its V^T slot (vfree, vready): a turn
//     needs K_r and V_{r-1}, so V_r has a whole turn to be converted.  The
//     converter fences its writes to the async proxy (fence.proxy.async)
//     before it arrives.
// Tiles, 16 KB a k or v tile: hd 64 two consumer warpgroups (BQ 128), 64
// keys; hd 128 two (BQ 128), 32 keys; hd 256 one (BQ 64; two would need a
// 128 KB q tile), 16 keys.  Shared memory: the q tile, then two slots of K
// (hi), K lo, V as landed, V^T hi and V^T lo (160 KB), then 11 mbarriers:
// 197,720 bytes at hd 64, 230,488 at hd 128 and hd 256.  Registers:
// setmaxnreg 224 a consumer thread and 56 a producer thread with two
// consumer warpgroups; with one, no setmaxnreg (at most 255 a thread under
// the launch bound of 256 threads).
//
// bfloat16 (flash_attention_wgmma_kernel): 989 TFLOP/s.  Grid (B * H,
// S / 128), 384 threads: two consumer warpgroups and a producer warpgroup
// (setmaxnreg: 232 registers a consumer thread, 40 a producer thread).  One
// producer thread loads the q tile once and then streams k and v tiles of
// BK keys (128 at hd <= 128, 64 at hd 256) through a ring in shared memory
// (3 slots at hd <= 128, 2 at hd 256), 64-wide boxes (a row of hd 128 is
// two boxes).  S = Q.K^T is wgmma m64nBKk16 (both operands K-major in
// shared memory); P is converted to bf16 in registers for O += P.V, with V
// read from the same shared tile as an MN-major operand (the transpose
// bit).
//
// Tolerance of the float32 kernel: the split products lose below 2^-21 of
// each operand, and the tensor cores sum in float32 in their own order; the
// rtol = atol = 2e-5 contract of the plain version holds (the CPU emulation
// of this arithmetic, tests/test_torch_flash_tf32.py, and phase 14 on the
// card).  Tolerance of the bf16 kernel: P is rounded to bf16 before P.V,
// as in every tensor-core flash kernel (l is summed from the unrounded P),
// and the logits are summed by the tensor cores in float32 in their own
// order; the plain version keeps P in float32.  On random-normal inputs
// the largest difference from the plain version is 0.0078-0.0156 at hd 64,
// 128 and 256, one or two bf16 steps of an output near 1-4, inside the
// rtol = atol = 2e-2 bf16 contract (whose bound grows with |o|).
//
// Dynamic shared memory above 48 KB is opted into once per instantiation,
// device and process: the float32 kernel's figures above; 230,456 bytes for
// the bf16 kernel at hd = 128 (q 32 KB, k and v 3 x 64 KB) and 197,672 at
// hd = 256 (q 64 KB, k and v 2 x 64 KB).
#include <atomic>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

#define MASKED -1e30f    // the reference's NEG_INF

// Opt `kernel` into `bytes` of dynamic shared memory on the current device,
// once: `opted` (one per instantiation) holds a bit a device.
template <class K>
static cudaError_t smem_opt_in(K* kernel, size_t bytes,
                               std::atomic<unsigned long long>& opted)
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (opted.load() & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess) opted.fetch_or(bit);
    return err;
}

// 2^x on the SFU with subnormal results flushed to 0: a P entry below
// 2^-126 vanishes anyway beside its row's largest entry, 1
__device__ __forceinline__ float exp2_ftz(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float quad_max(float x)
{
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x)
{
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The two consumer warpgroups take turns on the tensor cores (named
// barriers 1 and 2; 0 is __syncthreads): warpgroup w waits on barrier
// 1 + w before it issues its products and then lets the other one go, so
// one warpgroup's softmax runs under the other's products.
__device__ __forceinline__ void turn_wait(int wg)
{
    asm volatile("bar.sync %0, 256;" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg)
{
    asm volatile("bar.arrive %0, 256;" :: "r"(2 - wg) : "memory");
}

// The online softmax of one k tile on the accumulator fragment of S
// (m64nBK): sc[4j + e] is row qp0 (e < 2) or qp1 = qp0 + 8, key k0 + 8 j +
// col + (e & 1).  Scales by scale_log2, masks, updates the running max and
// the per-thread sums, turns sc into P and returns the two rows' rescale
// factors.  A key past T_len or before its row's window gets -inf (weight
// 0 even while the row has seen no live key), one past its row under
// causal -1e30.
template <int BKT>
__device__ __forceinline__ void online_softmax(float (&sc)[BKT / 2], float& m0, float& m1,
                                               float& l0, float& l1, float& a0, float& a1,
                                               int k0, int col, int qp0, int qp1,
                                               bool edge, int T_len, int causal,
                                               int window, float scale_log2)
{
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * scale_log2;
            if (edge) {
                const int kp = k0 + 8 * j + col + (e & 1);
                const int qp = e < 2 ? qp0 : qp1;
                if (kp >= T_len || (window > 0 && kp + window <= qp))
                    x = -INFINITY;
                else if (causal && kp > qp)
                    x = MASKED;
            }
            sc[4 * j + e] = x;
            if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    a0 = exp2_ftz(m0 - mn0);
    a1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = exp2_ftz(sc[4 * j + e] - (e < 2 ? mn0 : mn1));
            sc[4 * j + e] = p;
            if (e < 2) ls0 += p; else ls1 += p;
        }
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float a0, float a1)
{
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
        acc[4 * j] *= a0;
        acc[4 * j + 1] *= a0;
        acc[4 * j + 2] *= a1;
        acc[4 * j + 3] *= a1;
    }
}

// ------------------------------------------------------------------------
// float32: split TF32 on the tensor cores
// ------------------------------------------------------------------------
#define F_STAGES 2        // ring slots
#define F_CONVERTERS 96   // warps 1-3 of the producer warpgroup

// consumer warpgroups: two where a 128-row q tile fits beside the ring
template <int HD>
__host__ __device__ constexpr int f_nc() { return HD <= 128 ? 2 : 1; }

template <int HD>
__host__ __device__ constexpr int f_bq() { return 64 * f_nc<HD>(); }

// keys a tile: a k or v tile is 4096 floats (16 KB)
template <int HD>
__host__ __device__ constexpr int f_bk() { return 4096 / HD; }

// Q k-steps a register set holds (two sets, 8 registers a k-step)
template <int HD>
__host__ __device__ constexpr int f_qc() { return HD == 128 ? 4 : 2; }

template <int HD>
constexpr size_t f_smem_bytes()
{
    return 1024 /* alignment */ +
           4 * ((size_t)f_bq<HD>() * HD + 5 * (size_t)F_STAGES * f_bk<HD>() * HD) +
           8 * (1 + 5 * F_STAGES) /* mbarriers */;
}

__device__ __forceinline__ float4 split4(float4& x)
{
    uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
    split_tf32(x.x, h0, l0);
    split_tf32(x.y, h1, l1);
    split_tf32(x.z, h2, l2);
    split_tf32(x.w, h3, l3);
    x = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(h2),
                    __uint_as_float(h3));
    return make_float4(__uint_as_float(l0), __uint_as_float(l1), __uint_as_float(l2),
                       __uint_as_float(l3));
}

// Shared memory, each tile 1024-byte aligned: q [HD/32 boxes][BQ][32];
// then, each [F_STAGES][HD/32 boxes][BK][32], K (landed, then hi), K lo,
// V as landed; then V^T hi and V^T lo, each [F_STAGES * BK / 32][HD][32]
// (ring position g = slot * BK + key: row d, 128-byte row g / 32); then
// the mbarriers.
template <int HD>
__global__ void __launch_bounds__(128 * (f_nc<HD>() + 1), 1)
flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            float* __restrict__ o, int S, int T_len, int H, int KV,
                            int causal, int window, float scale_log2)
{
    constexpr int NC = f_nc<HD>(), BQ = f_bq<HD>(), BKT = f_bk<HD>();
    constexpr int NBX = HD / 32;           // 32-float boxes a row
    constexpr int TILE = BKT * HD;         // floats of a k or v tile
    constexpr int QC = f_qc<HD>();
    constexpr int NCH = HD / 8 / QC;       // Q chunks a tile
    extern __shared__ unsigned char smem_raw[];
    float* base = reinterpret_cast<float*>(
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
    float* qs = base;
    float* kh = qs + BQ * HD;
    float* kl = kh + F_STAGES * TILE;
    float* vr = kl + F_STAGES * TILE;
    float* vth = vr + F_STAGES * TILE;
    float* vtl = vth + F_STAGES * TILE;
    uint64_t* q_full = reinterpret_cast<uint64_t*>(vtl + F_STAGES * TILE);
    uint64_t* kfull = q_full + 1;          // a tile's K and V landed
    uint64_t* kready = kfull + F_STAGES;   // K split
    uint64_t* vready = kready + F_STAGES;  // V split and transposed
    uint64_t* kfree = vready + F_STAGES;   // Q.K^T of the slot's tile done
    uint64_t* vfree = kfree + F_STAGES;    // P.V of the slot's tile done

    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int kvh = h / (H / KV);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    int n_kt = (T_len + BKT - 1) / BKT;
    if (causal) {
        // k tiles wholly past this q tile's last row add nothing
        const int live = (q0 + BQ - 1) / BKT + 1;
        n_kt = live < n_kt ? live : n_kt;
    }
    // k tiles wholly before the first row's window add nothing either:
    // turn r runs tile kt0 + r, n_t turns
    const int kt0 = window > 0 && q0 >= window ? (q0 - window + 1) / BKT : 0;
    const int n_t = n_kt - kt0;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < F_STAGES; ++s) {
            mbar_init(&kfull[s], 1);
            mbar_init(&kready[s], F_CONVERTERS);
            mbar_init(&vready[s], F_CONVERTERS);
            mbar_init(&kfree[s], 4 * NC);   // one arrival a consumer warp
            mbar_init(&vfree[s], 4 * NC);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    if (wg == NC) {
        if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
        const int pw = (threadIdx.x / 32) % 4;
        if (pw == 0) {
            // ---- warp 0: one thread issues every TMA load
            if (lane == 0) {
                mbar_arrive_expect_tx(q_full, BQ * HD * 4);
                for (int c = 0; c < NBX; ++c)
                    tma_load_4d(qs + c * BQ * 32, &tq, q_full, c * 32, h, q0, b);
                for (int kt = 0; kt < n_t; ++kt) {
                    const int s = kt % F_STAGES;
                    const uint32_t ph = ((kt / F_STAGES) & 1) ^ 1;
                    mbar_wait(&kfree[s], ph);    // Q.K^T of turn kt - 2 done
                    mbar_wait(&vready[s], ph);   // V of turn kt - 2 read
                    mbar_arrive_expect_tx(&kfull[s], 2 * TILE * 4);
                    const int key0 = (kt0 + kt) * BKT;
                    for (int c = 0; c < NBX; ++c) {
                        tma_load_4d(kh + s * TILE + c * BKT * 32, &tk, &kfull[s], c * 32,
                                    kvh, key0, b);
                        tma_load_4d(vr + s * TILE + c * BKT * 32, &tv, &kfull[s], c * 32,
                                    kvh, key0, b);
                    }
                }
            }
        } else {
            // ---- warps 1-3: split K in place (hi) and into K lo as soon as
            // it lands; then V into V^T hi and lo, keys of a k-step in the
            // order 0 2 4 6 1 3 5 7, once P.V of tile kt - 2 has freed them
            const int ct = threadIdx.x - NC * 128 - 32, cw = ct / 32;
            for (int kt = 0; kt < n_t; ++kt) {
                const int s = kt % F_STAGES;
                const uint32_t ph = (kt / F_STAGES) & 1;
                mbar_wait(&kfull[s], ph);
                float4* k4 = reinterpret_cast<float4*>(kh + s * TILE);
                float4* l4 = reinterpret_cast<float4*>(kl + s * TILE);
                for (int i = ct; i < TILE / 4; i += F_CONVERTERS) {
                    float4 x = k4[i];
                    const float4 lo = split4(x);
                    k4[i] = x;
                    l4[i] = lo;
                }
                fence_proxy_async();
                mbar_arrive(&kready[s]);
                mbar_wait(&vfree[s], ph ^ 1);
                // a warp item: 32 neighbouring d (one 128-byte row of the
                // landed tile a key) by the 4 even or odd keys of an 8-key
                // group, one 16-byte chunk of V^T hi and of lo a lane
                const float* vs = vr + s * TILE;
                for (int it = cw; it < TILE / 128; it += F_CONVERTERS / 32) {
                    const int I = it * 32 + lane;
                    const int d = I % HD, rest = I / HD, j = rest >> 1, odd = rest & 1;
                    const float* box = vs + (d >> 5) * BKT * 32;
                    auto at = [&](int u) {
                        const int key = 8 * j + odd + 2 * u;
                        return box[key * 32 + ((((d & 31) >> 2) ^ (key & 7)) << 2) + (d & 3)];
                    };
                    float4 x = make_float4(at(0), at(1), at(2), at(3));
                    const float4 lo = split4(x);
                    const int g = s * BKT + 8 * j + 4 * odd;
                    const int off = (g >> 5) * HD * 32 + d * 32 + ((((g & 31) >> 2) ^ (d & 7)) << 2);
                    *reinterpret_cast<float4*>(vth + off) = x;
                    *reinterpret_cast<float4*>(vtl + off) = lo;
                }
                fence_proxy_async();
                mbar_arrive(&vready[s]);
            }
        }
    } else {
        // ---- consumers: warpgroup wg owns block rows 64 wg .. 64 wg + 63.
        // Turn r issues O += P_{r-1} . V_{r-1} and S_r = Q . K_r^T, then
        // (off the tensor cores) releases K_r and V_{r-1} and runs the
        // softmax of tile r, which rescales O and splits P_r for the next
        // turn.
        if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
        const int warp = (threadIdx.x % 128) / 32, g = lane / 4, tq4 = lane % 4;
        const int r0 = 64 * wg + 16 * warp + g;             // block rows r0, r0 + 8
        const int qp0 = q0 + r0, qp1 = qp0 + 8;
        const int wg_first = q0 + 64 * wg;
        const int col = 2 * tq4;                             // first of 2 columns
        float acc[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
        float sc[BKT / 2];                    // S, then P, of the current tile
        uint32_t pah[BKT / 2], pal[BKT / 2];  // P hi and lo as wgmma's A fragments
        uint32_t qah[2][4 * QC], qal[2][4 * QC];  // Q hi and lo, two chunks
        float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;  // per-thread l

        // Q's A fragments of chunk c into set c % 2: k-step kk holds (row
        // r0, col 8 kk + tq4), (r0 + 8, same), (r0, +4), (r0 + 8, +4)
        auto load_q = [&](int c) {
#pragma unroll
            for (int u = 0; u < QC; ++u) {
                const int kk = c * QC + u, ch = 2 * (kk % 4);
                const float* box = qs + (kk / 4) * BQ * 32;
                const int c0 = ((ch ^ g) << 2) + tq4, c1 = (((ch + 1) ^ g) << 2) + tq4;
                split_tf32(box[r0 * 32 + c0], qah[c & 1][4 * u], qal[c & 1][4 * u]);
                split_tf32(box[(r0 + 8) * 32 + c0], qah[c & 1][4 * u + 1],
                           qal[c & 1][4 * u + 1]);
                split_tf32(box[r0 * 32 + c1], qah[c & 1][4 * u + 2], qal[c & 1][4 * u + 2]);
                split_tf32(box[(r0 + 8) * 32 + c1], qah[c & 1][4 * u + 3],
                           qal[c & 1][4 * u + 3]);
            }
        };
        auto qk_chunk = [&](int r, int c) {
            const int s = r % F_STAGES;
#pragma unroll
            for (int u = 0; u < QC; ++u) {
                const int kk = c * QC + u;
                const int off = s * TILE + (kk / 4) * BKT * 32 + (kk % 4) * 8;
                const uint64_t dh = desc_sw128(kh + off, 16, 1024);
                const uint64_t dl = desc_sw128(kl + off, 16, 1024);
                wgmma_tf32(sc, &qah[c & 1][4 * u], dh, kk > 0);
                wgmma_tf32(sc, &qah[c & 1][4 * u], dl, 1);
                wgmma_tf32(sc, &qal[c & 1][4 * u], dh, 1);
            }
        };
        // S_r = Q . K_r^T: chunks 0 and 1 loaded before the turn; chunk c
        // >= 2 once chunk c - 2, which used its set, has completed
        auto issue_qk = [&](int r) {
            qk_chunk(r, 0);
            wgmma_commit();
            qk_chunk(r, 1);
            wgmma_commit();
#pragma unroll
            for (int c = 2; c < NCH; ++c) {
                wgmma_wait<1>();
                load_q(c);
                wgmma_fence();
                qk_chunk(r, c);
                wgmma_commit();
            }
        };
        auto issue_pv = [&](int r) {
#pragma unroll
            for (int t2 = 0; t2 < BKT / 8; ++t2) {
                const int gp = (r % F_STAGES) * BKT + 8 * t2;
                const int off = (gp >> 5) * HD * 32 + (gp & 31);
                const uint64_t dh = desc_sw128(vth + off, 16, 1024);
                const uint64_t dl = desc_sw128(vtl + off, 16, 1024);
                wgmma_tf32(acc, &pah[4 * t2], dh, 1);
                wgmma_tf32(acc, &pah[4 * t2], dl, 1);
                wgmma_tf32(acc, &pal[4 * t2], dh, 1);
            }
        };
        auto wait_ready = [&](uint64_t* bars, int r) {
            mbar_wait(&bars[r % F_STAGES], (r / F_STAGES) & 1);
        };
        auto release = [&](uint64_t* bars, int r) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&bars[r % F_STAGES]);
        };
        auto take_turn = [&]() { if constexpr (NC == 2) turn_wait(wg); };
        auto pass_turn = [&]() { if constexpr (NC == 2) turn_pass(wg); };
        auto softmax = [&](int r) {
            const int k0 = (kt0 + r) * BKT;
            const bool edge = k0 + BKT > T_len || (causal && k0 + BKT - 1 > wg_first) ||
                              (window > 0 && k0 + window <= wg_first + 63);
            float a0, a1;
            online_softmax<BKT>(sc, m0, m1, l0, l1, a0, a1, k0, col, qp0, qp1, edge,
                                T_len, causal, window, scale_log2);
            // A fragment of k-step t: keys (t, t + 4) of the permuted order
            // are keys (2 t, 2 t + 1): sc[4 t + 0, 2, 1, 3]
#pragma unroll
            for (int t = 0; t < BKT / 8; ++t) {
                split_tf32(sc[4 * t], pah[4 * t], pal[4 * t]);
                split_tf32(sc[4 * t + 2], pah[4 * t + 1], pal[4 * t + 1]);
                split_tf32(sc[4 * t + 1], pah[4 * t + 2], pal[4 * t + 2]);
                split_tf32(sc[4 * t + 3], pah[4 * t + 3], pal[4 * t + 3]);
            }
            rescale(acc, a0, a1);
        };

        mbar_wait(q_full, 0);
        if constexpr (NC == 2) {
            if (wg == 1) turn_pass(wg);      // warpgroup 0 goes first
        }
        // turn 0: S_0 alone
        wait_ready(kready, 0);
        load_q(0);
        load_q(1);
        take_turn();
        wgmma_fence();
        issue_qk(0);
        pass_turn();
        wgmma_wait<0>();
        reg_fence(sc);
        release(kfree, 0);
        softmax(0);
        for (int r = 1; r < n_t; ++r) {
            wait_ready(kready, r);
            wait_ready(vready, r - 1);
            load_q(0);
            load_q(1);
            reg_fence(pah);
            reg_fence(pal);
            reg_fence(acc);
            take_turn();
            wgmma_fence();
            issue_pv(r - 1);
            issue_qk(r);
            pass_turn();
            wgmma_wait<0>();
            reg_fence(acc);
            reg_fence(sc);
            release(kfree, r);
            release(vfree, r - 1);
            softmax(r);
        }
        // the last turn: P_{n-1} . V_{n-1} alone; every wait has its pass
        wait_ready(vready, n_t - 1);
        reg_fence(pah);
        reg_fence(pal);
        reg_fence(acc);
        take_turn();
        wgmma_fence();
        issue_pv(n_t - 1);
        wgmma_commit();
        if constexpr (NC == 2) {
            if (wg == 0) turn_pass(wg);
        }
        wgmma_wait<0>();
        reg_fence(acc);
        release(vfree, n_t - 1);

        const float d0 = fmaxf(quad_sum(l0), 1e-30f);
        const float d1 = fmaxf(quad_sum(l1), 1e-30f);
        if (qp0 < S) {
            float* row = o + ((int64_t)b * S + qp0) * H * HD + (int64_t)h * HD;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                *reinterpret_cast<float2*>(row + 8 * j + col) =
                    make_float2(acc[4 * j] / d0, acc[4 * j + 1] / d0);
        }
        if (qp1 < S) {
            float* row = o + ((int64_t)b * S + qp1) * H * HD + (int64_t)h * HD;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                *reinterpret_cast<float2*>(row + 8 * j + col) =
                    make_float2(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
        }
    }
}

// ------------------------------------------------------------------------
// bfloat16: wgmma fed by a TMA ring
// ------------------------------------------------------------------------
#define TC_BQ 128         // query rows a block (two consumer warpgroups of 64)
#define TC_THREADS 384    // consumer warpgroups 0 and 1, producer warpgroup 2

template <int HD>
__host__ __device__ constexpr int tc_bk() { return HD <= 128 ? 128 : 64; }

// k/v ring slots: 3 where they fit in shared memory (hd <= 128), else 2
template <int HD>
__host__ __device__ constexpr int tc_stages() { return HD <= 128 ? 3 : 2; }

template <int HD>
constexpr size_t tc_smem_bytes()
{
    return 1024 /* alignment */ +
           2 * ((size_t)TC_BQ * HD + 2 * (size_t)tc_stages<HD>() * tc_bk<HD>() * HD) +
           8 * (1 + 2 * tc_stages<HD>()) /* mbarriers */;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory, each tile 1024-byte aligned: q [HD/64 boxes][BQ][64], then
// k and v [STAGES][HD/64 boxes][BK][64], then the mbarriers.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int S, int T_len,
                             int H, int KV, int causal, int window, float scale_log2)
{
    constexpr int BKT = tc_bk<HD>();
    constexpr int STAGES = tc_stages<HD>();
    constexpr int NB = HD / 64;            // 64-wide boxes a row
    constexpr int BOX_Q = TC_BQ * 64;      // elements of a q box
    constexpr int BOX_K = BKT * 64;        // elements of a k or v box
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* ks = qs + NB * BOX_Q;
    __nv_bfloat16* vs = ks + STAGES * NB * BOX_K;
    uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * NB * BOX_K);
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + STAGES;

    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int kvh = h / (H / KV);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
    int n_kt = (T_len + BKT - 1) / BKT;
    if (causal) {
        // k tiles wholly past this q tile's last row add nothing
        const int live = (q0 + TC_BQ - 1) / BKT + 1;
        n_kt = live < n_kt ? live : n_kt;
    }
    // k tiles wholly before the first row's window add nothing either:
    // turn r runs tile kt0 + r, n_t turns
    const int kt0 = window > 0 && q0 >= window ? (q0 - window + 1) / BKT : 0;
    const int n_t = n_kt - kt0;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);   // one arrival a consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {
        // ---- producer: one thread issues every TMA load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 2 * 128) {
            mbar_arrive_expect_tx(q_full, TC_BQ * HD * 2);
            for (int c = 0; c < NB; ++c)
                tma_load_4d(qs + c * BOX_Q, &tq, q_full, c * 64, h, q0, b);
            for (int kt = 0; kt < n_t; ++kt) {
                const int s = kt % STAGES;
                mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(&full[s], 2 * BKT * HD * 2);
                const int key0 = (kt0 + kt) * BKT;
                for (int c = 0; c < NB; ++c) {
                    tma_load_4d(ks + (s * NB + c) * BOX_K, &tk, &full[s], c * 64,
                                kvh, key0, b);
                    tma_load_4d(vs + (s * NB + c) * BOX_K, &tv, &full[s], c * 64,
                                kvh, key0, b);
                }
            }
        }
    } else {
        // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63.  Turn
        // r issues O += P_{r-1} . V_{r-1} and S_r = Q . K_r^T together, then
        // (off the tensor cores) releases slot r-1 and runs the softmax of
        // tile r, which rescales O and packs P_r for the next turn.  Every
        // turn of the loop issues the same products: a warpgroup also runs
        // a tile past its own rows that the block loads for the other one
        // (hd 256, causal), all masked, which changes nothing.
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
        const int qp0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and qp0 + 8
        const int qp1 = qp0 + 8;
        const int wg_first = q0 + 64 * wg;
        const int col = 2 * (lane % 4);      // first of this thread's 2 columns
        float acc[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
        float sc[BKT / 2];                   // S, then P, of the current tile
        uint32_t pa[BKT / 4];                // P as wgmma's A fragment
        float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;  // per-thread l

        auto issue_qk = [&](int r) {
            const int s = r % STAGES;
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const __nv_bfloat16* qa = qs + (kk / 4) * BOX_Q + wg * 64 * 64 + (kk % 4) * 16;
                const __nv_bfloat16* kb = ks + (s * NB + kk / 4) * BOX_K + (kk % 4) * 16;
                wgmma_ss(sc, desc_sw128(qa, 16, 1024), desc_sw128(kb, 16, 1024), kk > 0);
            }
        };
        auto issue_pv = [&](int r) {
            const __nv_bfloat16* vr = vs + (r % STAGES) * NB * BOX_K;
#pragma unroll
            for (int t2 = 0; t2 < BKT / 16; ++t2)
                wgmma_rs(acc, &pa[4 * t2], desc_sw128(vr + t2 * 16 * 64, BKT * 128, 1024), 1);
        };
        auto wait_full = [&](int r) { mbar_wait(&full[r % STAGES], (r / STAGES) & 1); };
        auto release = [&](int r) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[r % STAGES]);
        };
        auto softmax = [&](int r) {
            const int k0 = (kt0 + r) * BKT;
            const bool edge = k0 + BKT > T_len || (causal && k0 + BKT - 1 > wg_first) ||
                              (window > 0 && k0 + window <= wg_first + 63);
            float a0, a1;
            online_softmax<BKT>(sc, m0, m1, l0, l1, a0, a1, k0, col, qp0, qp1, edge,
                                T_len, causal, window, scale_log2);
            // register 4 t + i of k-step t holds sc[8 t + 2 i], sc[8 t + 2 i + 1]
#pragma unroll
            for (int i = 0; i < BKT / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
            rescale(acc, a0, a1);
        };

        mbar_wait(q_full, 0);
        if (wg == 1) turn_pass(wg);          // warpgroup 0 goes first
        // turn 0: S_0 alone
        wait_full(0);
        turn_wait(wg);
        wgmma_fence();
        issue_qk(0);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        reg_fence(sc);
        softmax(0);
        for (int r = 1; r < n_t; ++r) {
            wait_full(r);
            reg_fence(pa);
            reg_fence(acc);
            turn_wait(wg);
            wgmma_fence();
            issue_pv(r - 1);
            issue_qk(r);
            wgmma_commit();
            turn_pass(wg);
            wgmma_wait<0>();
            reg_fence(acc);
            reg_fence(sc);
            release(r - 1);
            softmax(r);
        }
        // the last turn: P_{n-1} . V_{n-1} alone; every wait has its pass
        reg_fence(pa);
        reg_fence(acc);
        turn_wait(wg);
        wgmma_fence();
        issue_pv(n_t - 1);
        wgmma_commit();
        if (wg == 0) turn_pass(wg);
        wgmma_wait<0>();
        reg_fence(acc);
        release(n_t - 1);

        const float d0 = fmaxf(quad_sum(l0), 1e-30f);
        const float d1 = fmaxf(quad_sum(l1), 1e-30f);
        if (qp0 < S) {
            __nv_bfloat16* row = o + ((int64_t)b * S + qp0) * H * HD + (int64_t)h * HD;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + col) =
                    __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
        }
        if (qp1 < S) {
            __nv_bfloat16* row = o + ((int64_t)b * S + qp1) * H * HD + (int64_t)h * HD;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + col) =
                    __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
        }
    }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// is not linked against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled tensor_map_encoder()
{
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? (EncodeTiled)p : (EncodeTiled) nullptr;
    }();
    return fn;
}

// A 4-D map of a contiguous [batch, len, heads, HD] tensor of `type` (`esize`
// bytes an element), innermost first, with boxes of (128 / esize) x 1 x
// rows x 1 and 128-byte swizzle.
static bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                       CUtensorMapDataType type, int esize, int hd, int heads,
                       int len, int batch, int rows)
{
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)len,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)hd * esize, (cuuint64_t)heads * hd * esize,
                                   (cuuint64_t)len * heads * hd * esize};
    const cuuint32_t box[4] = {(cuuint32_t)(128 / esize), 1, (cuuint32_t)rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
static int launch_tf32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int T_len, int H, int KV, int causal,
                       int window, cudaStream_t st)
{
    static std::atomic<unsigned long long> opted{0};
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    CUtensorMap mq, mk, mv;
    if (!tensor_map(encode, &mq, q, f32, 4, HD, H, S, B, f_bq<HD>()) ||
        !tensor_map(encode, &mk, k, f32, 4, HD, KV, T_len, B, f_bk<HD>()) ||
        !tensor_map(encode, &mv, v, f32, 4, HD, KV, T_len, B, f_bk<HD>()))
        return (int)cudaErrorInvalidValue;
    const size_t smem = f_smem_bytes<HD>();
    const cudaError_t err = smem_opt_in(flash_attention_tf32_kernel<HD>, smem, opted);
    if (err != cudaSuccess) return (int)err;
    const float scale = (float)(1.0 / sqrt((double)HD));
    const float scale_log2 = scale * 1.4426950408889634f;
    const dim3 grid((unsigned)(B * H), (unsigned)((S + f_bq<HD>() - 1) / f_bq<HD>()));
    flash_attention_tf32_kernel<HD><<<grid, 128 * (f_nc<HD>() + 1), smem, st>>>(
        mq, mk, mv, (float*)o, S, T_len, H, KV, causal, causal ? window : 0, scale_log2);
    return (int)cudaGetLastError();
}

template <int HD>
static int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T_len, int H, int KV, int causal,
                        int window, cudaStream_t st)
{
    static std::atomic<unsigned long long> opted{0};
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    CUtensorMap mq, mk, mv;
    if (!tensor_map(encode, &mq, q, bf, 2, HD, H, S, B, TC_BQ) ||
        !tensor_map(encode, &mk, k, bf, 2, HD, KV, T_len, B, tc_bk<HD>()) ||
        !tensor_map(encode, &mv, v, bf, 2, HD, KV, T_len, B, tc_bk<HD>()))
        return (int)cudaErrorInvalidValue;
    const size_t smem = tc_smem_bytes<HD>();
    const cudaError_t err = smem_opt_in(flash_attention_wgmma_kernel<HD>, smem, opted);
    if (err != cudaSuccess) return (int)err;
    const float scale = (float)(1.0 / sqrt((double)HD));
    const float scale_log2 = scale * 1.4426950408889634f;
    const dim3 grid((unsigned)(B * H), (unsigned)((S + TC_BQ - 1) / TC_BQ));
    flash_attention_wgmma_kernel<HD><<<grid, TC_THREADS, smem, st>>>(
        mq, mk, mv, (__nv_bfloat16*)o, S, T_len, H, KV, causal, causal ? window : 0,
        scale_log2);
    return (int)cudaGetLastError();
}

extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, int B, int S,
                                          int T_len, int H, int KV, int hd,
                                          int causal, int window, void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
    case 64: return launch_tf32<64>(q, k, v, o, B, S, T_len, H, KV, causal, window, st);
    case 128: return launch_tf32<128>(q, k, v, o, B, S, T_len, H, KV, causal, window, st);
    case 256: return launch_tf32<256>(q, k, v, o, B, S, T_len, H, KV, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S, int T_len, int H, int KV,
                                           int hd, int causal, int window,
                                           void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
    case 64: return launch_wgmma<64>(q, k, v, o, B, S, T_len, H, KV, causal, window, st);
    case 128: return launch_wgmma<128>(q, k, v, o, B, S, T_len, H, KV, causal, window, st);
    case 256: return launch_wgmma<256>(q, k, v, o, B, S, T_len, H, KV, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
    }
}
