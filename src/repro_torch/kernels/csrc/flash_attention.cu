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
// Keys past T (the ragged last tile) are left out (-inf logit, weight 0).
//
// What bounds it on the H100: operations.  4 * B * H * S * T * hd flops
// (halved under causal) against reading q, k, v and writing o once; at
// hd = 128 that is hundreds of flops a byte.  In this form the products are
// float32 FMA on the CUDA cores (67 TFLOP/s peak), fed from shared memory,
// so shared-memory bandwidth and the FMA rate bound it, far above the tensor
// cores' bound; wgmma and TMA are the later redesign, with a tolerance of
// their own.
//
// Design: the TPU's sequential k-chunk grid dimension (scratch carried from
// step to step) becomes a loop inside the block.  Grid (B * H, S / 64): one
// 256-thread block per (row, 64-query tile), q tiles in reverse order so
// that the longest causal rows start first.  The block stages its q tile
// and then each 64-key k and v tile in shared memory (converted to float on
// load; bf16 by __bfloat162float), skipping the k tiles wholly past its last
// query under causal.  A thread owns 4 query rows (ty + 16 i) and computes
// 4 x 4 logits (keys tx + 16 j) and 4 x hd/16 output columns (tx + 16 j) in
// registers; the row max and sum reduce over the 16 lanes of a half warp by
// shuffles, and P goes through shared memory for the P.V product.  The q and
// k tiles are padded to hd + 1 floats a row so that the 16 keys a half warp
// reads sit in 16 banks.  Dynamic shared memory above 48 KB is opted into
// per instantiation (213,760 bytes at hd = 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BQ 64            // query rows a block
#define BK 64            // keys a tile
#define THREADS 256
#define MASKED -1e30f    // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
constexpr size_t smem_bytes()
{
    return sizeof(float) * ((size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) +
                            (size_t)BK * HD + (size_t)BQ * (BK + 1));
}

template <class T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
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
            s < S ? to_f32(q[((int64_t)b * S + s) * H * HD + (int64_t)h * HD + d])
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
            ks[r * LD + d] = t < T_len ? to_f32(k[off]) : 0.f;
            vs[r * HD + d] = t < T_len ? to_f32(v[off]) : 0.f;
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
        T* row = o + ((int64_t)b * S + s) * H * HD + (int64_t)h * HD;
#pragma unroll
        for (int j = 0; j < DJ; ++j) store(row + tx + 16 * j, acc[i][j] / den);
    }
}

template <class T, int HD>
static int launch_hd(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int T_len, int H, int KV, int causal,
                     cudaStream_t st)
{
    const size_t smem = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const float scale = (float)(1.0 / sqrt((double)HD));
    const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
    flash_attention_kernel<T, HD><<<grid, THREADS, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, S, T_len, H, KV, causal,
        scale);
    return (int)cudaGetLastError();
}

template <class T>
static int launch(const void* q, const void* k, const void* v, void* o, int B,
                  int S, int T_len, int H, int KV, int hd, int causal,
                  void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
    case 64: return launch_hd<T, 64>(q, k, v, o, B, S, T_len, H, KV, causal, st);
    case 128: return launch_hd<T, 128>(q, k, v, o, B, S, T_len, H, KV, causal, st);
    case 256: return launch_hd<T, 256>(q, k, v, o, B, S, T_len, H, KV, causal, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, int B, int S,
                                          int T_len, int H, int KV, int hd,
                                          int causal, void* stream)
{
    return launch<float>(q, k, v, o, B, S, T_len, H, KV, hd, causal, stream);
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S, int T_len, int H, int KV,
                                           int hd, int causal, void* stream)
{
    return launch<__nv_bfloat16>(q, k, v, o, B, S, T_len, H, KV, hd, causal,
                                 stream);
}
