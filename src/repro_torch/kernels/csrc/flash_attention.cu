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
// key at kpos > qpos (positions from 0) is masked to -1e30; the running max
// m, denominator l and accumulator acc are float32; o = acc / max(l, 1e-30).
// Keys past T (the ragged last tile) are left out (-inf logit, weight 0);
// query rows past S are neither read nor stored.
//
// What bounds it on the H100: operations, 4 * B * H * S * T * hd flops
// (halved under causal) against reading q, k, v and writing o once: at
// hd = 128 hundreds of flops a byte.  Two kernels, one per type:
//
// float32 (flash_attention_kernel): float32 FMA on the CUDA cores (67
// TFLOP/s), since the contract is float32 arithmetic within 2e-5, which
// TF32 tensor cores would break.  Grid (B * H, S / 64), q tiles in reverse
// order so the longest causal rows start first; a 256-thread block stages
// its q tile and each 64-key k and v tile in shared memory as float,
// skipping k tiles wholly past its last query under causal.  A thread owns
// 4 query rows (ty + 16 i), 4 x 4 logits (keys tx + 16 j) and 4 x hd/16
// output columns in registers; row max and sum reduce over a half warp by
// shuffles; P goes through shared memory for P.V.  q and k rows are padded
// to hd + 1 floats so a half warp's 16 keys sit in 16 banks.
//
// bfloat16 (flash_attention_wgmma_kernel): the tensor cores (989 TFLOP/s).
// Grid (B * H, S / 128), q tiles in reverse order; 384 threads: two
// consumer warpgroups, each owning 64 of the block's 128 query rows, and a
// producer warpgroup (setmaxnreg: 232 registers a consumer thread, 40 a
// producer thread).  One producer thread loads the q tile once and then
// streams k and v tiles of BK keys (128 at hd <= 128, 64 at hd 256)
// through a ring in shared memory (3 slots at hd <= 128, 2 at hd 256) by
// TMA, straight from the (B, S, H, hd) and (B, T, KV, hd) layouts (4-D
// tensor maps built on the host, 64-wide boxes with 128-byte swizzle, so a
// row of hd 128 is two boxes; rows past S or T arrive as zeros); mbarriers
// signal full and empty slots.  A consumer computes S = Q.K^T with wgmma
// m64nBKk16 (both operands K-major in shared memory), runs the online
// softmax in float32 on the accumulator fragment (a thread holds parts of
// two rows; the row max reduces across its quad by two shuffles, the row
// sum is kept per thread and reduced once at the end), converts P to bf16
// in registers and uses it as wgmma's register A operand for O += P.V,
// with V read from the same shared tile as an MN-major operand (the
// transpose bit), so P never goes through shared memory.  The two
// consumers take turns on the tensor cores (named barriers): a turn issues
// P_{r-1}.V_{r-1} and Q.K_r^T as one group, and the softmax of tile r runs
// while the other warpgroup's turn keeps the tensor cores busy.  Every
// turn issues the same products (ptxas serialises wgmma under divergent
// branches), so under causal the block skips the k tiles wholly past its
// last row and a warpgroup runs the one all-masked tile it shares with
// the other (hd 256); only tiles that cross the diagonal or the end of T
// pay for the mask.  The scale is folded with log2(e) into ex2.approx.ftz.
//
// Tolerance of the bf16 kernel: P is rounded to bf16 before P.V, as in
// every tensor-core flash kernel (l is summed from the unrounded P), and
// the logits are summed by the tensor cores in float32 in their own order;
// the plain version keeps P in float32.  On random-normal inputs the
// largest difference from the plain version is 0.0078-0.0156 at hd 64, 128
// and 256, one or two bf16 steps of an output near 1-4, inside the
// rtol = atol = 2e-2 bf16 contract (whose bound grows with |o|).
//
// Dynamic shared memory above 48 KB is opted into once per instantiation,
// device and process: 213,760 bytes for the float32 kernel at hd = 256,
// 230,456 for the bf16 kernel at hd = 128 (q 32 KB, k and v 3 x 64 KB)
// and 197,672 at hd = 256 (q 64 KB, k and v 2 x 64 KB).
#include <atomic>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

#define BQ 64            // query rows a block
#define BK 64            // keys a tile
#define THREADS 256
#define MASKED -1e30f    // the reference's NEG_INF

template <int HD>
constexpr size_t smem_bytes()
{
    return sizeof(float) * ((size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) +
                            (size_t)BK * HD + (size_t)BQ * (BK + 1));
}

// At least 2 blocks an SM: ptxas then gives hd 64 96 registers; left to
// itself it took 64 and spilled 8 bytes.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int S,
                       int T_len, int H, int KV, int causal, float scale)
{
    constexpr int LD = HD + 1;   // padded q / k row
    constexpr int DJ = HD / 16;  // output columns a thread owns
    constexpr int PD = BK + 1;   // padded P row
    extern __shared__ float smem[];
    float* qs = smem;            // [BQ][LD]
    float* ks = qs + BQ * LD;    // [BK][LD]
    float* vs = ks + BK * LD;    // [BK][HD]
    float* ps = vs + BK * HD;    // [BQ][PD]

    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int kvh = h / (H / KV);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

    for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
        const int r = i / HD, d = i % HD, s = q0 + r;
        qs[r * LD + d] =
            s < S ? q[((int64_t)b * S + s) * H * HD + (int64_t)h * HD + d]
                  : 0.f;
    }
    float m[4], l[4], acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = MASKED;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    }

    int n_kt = (T_len + BK - 1) / BK;
    if (causal) {
        // k tiles wholly past this q tile's last row add nothing
        const int live = (q0 + BQ - 1) / BK + 1;
        n_kt = live < n_kt ? live : n_kt;
    }
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();  // the previous tile's k, v and P are consumed
        for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
            const int r = i / HD, d = i % HD, t = k0 + r;
            const int64_t off = ((int64_t)b * T_len + t) * KV * HD +
                                (int64_t)kvh * HD + d;
            ks[r * LD + d] = t < T_len ? k[off] : 0.f;
            vs[r * HD + d] = t < T_len ? v[off] : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float a[4], c[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + ty + 16 * i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + tx + 16 * j;
                float x = s[i][j] * scale;
                if (kpos >= T_len)
                    x = -INFINITY;
                else if (causal && kpos > qpos)
                    x = MASKED;
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                sum += s[i][j];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
            for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * PD + tx + 16 * j] = s[i][j];
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PD + c];
#pragma unroll
            for (int j = 0; j < DJ; ++j) {
                const float vv = vs[c * HD + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = q0 + ty + 16 * i;
        if (s >= S) continue;
        const float den = fmaxf(l[i], 1e-30f);
        float* row = o + ((int64_t)b * S + s) * H * HD + (int64_t)h * HD;
#pragma unroll
        for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = acc[i][j] / den;
    }
}

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

template <int HD>
static int launch_f32(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int T_len, int H, int KV, int causal,
                     cudaStream_t st)
{
    static std::atomic<unsigned long long> opted{0};
    const size_t smem = smem_bytes<HD>();
    const cudaError_t err =
        smem_opt_in(flash_attention_kernel<HD>, smem, opted);
    if (err != cudaSuccess) return (int)err;
    const float scale = (float)(1.0 / sqrt((double)HD));
    const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
    flash_attention_kernel<HD><<<grid, THREADS, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, S, T_len, H,
        KV, causal, scale);
    return (int)cudaGetLastError();
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

// Shared memory, each tile 1024-byte aligned: q [HD/64 boxes][BQ][64], then
// k and v [STAGES][HD/64 boxes][BK][64], then the mbarriers.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int S, int T_len,
                             int H, int KV, int causal, float scale_log2)
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
            for (int kt = 0; kt < n_kt; ++kt) {
                const int s = kt % STAGES;
                mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(&full[s], 2 * BKT * HD * 2);
                for (int c = 0; c < NB; ++c) {
                    tma_load_4d(ks + (s * NB + c) * BOX_K, &tk, &full[s], c * 64,
                                kvh, kt * BKT, b);
                    tma_load_4d(vs + (s * NB + c) * BOX_K, &tv, &full[s], c * 64,
                                kvh, kt * BKT, b);
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
        // online softmax of tile r on the fragment: sc[4j + e] is row qp0
        // (e < 2) or qp1, key k0 + 8 j + col + (e & 1)
        auto softmax = [&](int r) {
            const int k0 = r * BKT;
            const bool edge = k0 + BKT > T_len || (causal && k0 + BKT - 1 > wg_first);
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int j = 0; j < BKT / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = sc[4 * j + e] * scale_log2;
                    if (edge) {
                        const int kp = k0 + 8 * j + col + (e & 1);
                        if (kp >= T_len)
                            x = -INFINITY;
                        else if (causal && kp > (e < 2 ? qp0 : qp1))
                            x = MASKED;
                    }
                    sc[4 * j + e] = x;
                    if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
                }
            }
            const float mn0 = fmaxf(m0, quad_max(mx0));
            const float mn1 = fmaxf(m1, quad_max(mx1));
            const float a0 = exp2_ftz(m0 - mn0), a1 = exp2_ftz(m1 - mn1);
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
            // register 4 t + i of k-step t holds sc[8 t + 2 i], sc[8 t + 2 i + 1]
#pragma unroll
            for (int i = 0; i < BKT / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                acc[4 * j] *= a0;
                acc[4 * j + 1] *= a0;
                acc[4 * j + 2] *= a1;
                acc[4 * j + 3] *= a1;
            }
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
        wgmma_wait_all();
        reg_fence(sc);
        softmax(0);
        for (int r = 1; r < n_kt; ++r) {
            wait_full(r);
            reg_fence(pa);
            reg_fence(acc);
            turn_wait(wg);
            wgmma_fence();
            issue_pv(r - 1);
            issue_qk(r);
            wgmma_commit();
            turn_pass(wg);
            wgmma_wait_all();
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
        issue_pv(n_kt - 1);
        wgmma_commit();
        if (wg == 0) turn_pass(wg);
        wgmma_wait_all();
        reg_fence(acc);
        release(n_kt - 1);

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

// A 4-D map of a contiguous bf16 [batch, len, heads, HD] tensor, innermost
// first, with boxes of 64 x 1 x rows x 1 and 128-byte swizzle.
static bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                       int hd, int heads, int len, int batch, int rows)
{
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)len,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                   (cuuint64_t)len * heads * hd * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                  dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
static int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T_len, int H, int KV, int causal,
                        cudaStream_t st)
{
    static std::atomic<unsigned long long> opted{0};
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    CUtensorMap mq, mk, mv;
    if (!tensor_map(encode, &mq, q, HD, H, S, B, TC_BQ) ||
        !tensor_map(encode, &mk, k, HD, KV, T_len, B, tc_bk<HD>()) ||
        !tensor_map(encode, &mv, v, HD, KV, T_len, B, tc_bk<HD>()))
        return (int)cudaErrorInvalidValue;
    const size_t smem = tc_smem_bytes<HD>();
    const cudaError_t err = smem_opt_in(flash_attention_wgmma_kernel<HD>, smem, opted);
    if (err != cudaSuccess) return (int)err;
    const float scale = (float)(1.0 / sqrt((double)HD));
    const float scale_log2 = scale * 1.4426950408889634f;
    const dim3 grid((unsigned)(B * H), (unsigned)((S + TC_BQ - 1) / TC_BQ));
    flash_attention_wgmma_kernel<HD><<<grid, TC_THREADS, smem, st>>>(
        mq, mk, mv, (__nv_bfloat16*)o, S, T_len, H, KV, causal, scale_log2);
    return (int)cudaGetLastError();
}

extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, int B, int S,
                                          int T_len, int H, int KV, int hd,
                                          int causal, void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
    case 64: return launch_f32<64>(q, k, v, o, B, S, T_len, H, KV, causal, st);
    case 128: return launch_f32<128>(q, k, v, o, B, S, T_len, H, KV, causal, st);
    case 256: return launch_f32<256>(q, k, v, o, B, S, T_len, H, KV, causal, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S, int T_len, int H, int KV,
                                           int hd, int causal, void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
    case 64: return launch_wgmma<64>(q, k, v, o, B, S, T_len, H, KV, causal, st);
    case 128: return launch_wgmma<128>(q, k, v, o, B, S, T_len, H, KV, causal, st);
    case 256: return launch_wgmma<256>(q, k, v, o, B, S, T_len, H, KV, causal, st);
    default: return (int)cudaErrorInvalidValue;
    }
}
