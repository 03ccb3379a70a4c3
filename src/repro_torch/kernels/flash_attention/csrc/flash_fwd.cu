// Flash-attention forward for Hopper (sm_90a): online softmax, f32 math.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_kernel, flash_attention_fwd). Same function: causal / full, sliding
// window, tanh logit softcap applied before the mask, a static kv_length
// valid prefix, GQA (query head h reads KV head h*Hkv/Hq, never a repeated
// K/V), f32 accumulation, output in the input dtype. Queries sit at
// positions 0..S-1 and keys at 0..T-1.
//
// What bounds it on this card: at the serve shape (B4 S2048 Hq32 dh64,
// causal) the work is ~69 GFLOP against ~84 MB of q/k/v/o, so the bound is
// the tensor-core rate. This first kernel does its products on the CUDA
// cores in f32 and reads both operands of every product from shared memory,
// so in practice it is bound by shared-memory load issue, far above the
// bound. Making it fast (wgmma, TMA, a pipelined K/V ring) is later work.
//
// Design:
//   - one thread block per (query tile, query head, batch); the sequential
//     kv grid axis of the TPU kernel becomes a loop inside the block, and the
//     running max / denominator / accumulator live in registers;
//   - the tiles the TPU kernel skips with pl.when (fully in the future under
//     causal, fully older than the window, here also fully past kv_length)
//     are simply outside the loop bounds;
//   - G = 8 threads share one query row: for the scores each owns BKV/G keys,
//     for the output each owns DH/G columns. Row max and row sum reduce over
//     the group with warp shuffles;
//   - q, K^T, V and the probability tile are staged in shared memory as f32,
//     padded so that neither the score loop nor the PV loop has bank
//     conflicts; tiles above 48 KB use the dynamic shared-memory opt-in;
//   - a masked score is the finite NEG_INF = -1e30, never -inf: a row fully
//     masked inside a live tile then gets exp(0) = 1 garbage that the next
//     live tile erases with corr = exp(-1e30 - m) = 0, where -inf would give
//     inf - inf = NaN. The final divide floors the denominator at 1e-30.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py). Plain C entry
//        point, loaded with ctypes; returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int G = 8;  // threads per query row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

template <int DH, int BQ, int BKV>
struct Smem {
    static constexpr int Q_LD = DH + 1;    // q rows, padded: rows of a warp hit distinct banks
    static constexpr int KT_LD = BKV + 1;  // K^T rows, padded: the transposing store is conflict-free
    static constexpr int P_LD = BKV + 1;   // probability rows, padded like q
    static constexpr int Q = 0;
    static constexpr int KT = Q + BQ * Q_LD;
    static constexpr int V = KT + DH * KT_LD;
    static constexpr int P = V + BKV * DH;
    static constexpr int FLOATS = P + BQ * P_LD;
    static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <typename T, int DH, int BQ, int BKV>
__global__ void __launch_bounds__(BQ * G)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int T_len, int Hq, int Hkv, int causal, int window,
                 float softcap, float scale, int t_valid) {
    static_assert(DH % G == 0 && BKV % G == 0, "tile must split over the row group");
    constexpr int NT = BQ * G;
    constexpr int NS = BKV / G;  // scores per thread
    constexpr int NA = DH / G;   // output columns per thread
    using L = Smem<DH, BQ, BKV>;

    extern __shared__ float smem[];
    float* qs = smem + L::Q;
    float* kt = smem + L::KT;
    float* vs = smem + L::V;
    float* ps = smem + L::P;

    const int q_start = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h * Hkv / Hq;
    const int tid = threadIdx.x;
    const int row = tid / G;
    const int lane = tid % G;
    const int q_pos = q_start + row;

    const long q_row_stride = (long)Hq * DH;
    const long kv_row_stride = (long)Hkv * DH;
    const T* qb = q + ((long)b * S) * q_row_stride + (long)h * DH;
    const T* kb = k + ((long)b * T_len) * kv_row_stride + (long)hk * DH;
    const T* vb = v + ((long)b * T_len) * kv_row_stride + (long)hk * DH;

    for (int idx = tid; idx < BQ * DH; idx += NT) {
        const int r = idx / DH, d = idx % DH;
        const int s = q_start + r;
        qs[r * L::Q_LD + d] = s < S ? to_f32(qb[s * q_row_stride + d]) * scale : 0.f;
    }

    // keys that can be live for some row of this tile: [kv_lo, kv_hi)
    int kv_hi = min(T_len, t_valid);
    if (causal) kv_hi = min(kv_hi, q_start + BQ);
    const int kv_lo = window > 0 ? max(0, q_start - window + 1) : 0;
    const int tile_lo = kv_lo / BKV;
    const int tile_hi = (kv_hi + BKV - 1) / BKV;

    float m_run = NEG_INF, l_run = 0.f;
    float acc[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = 0.f;

    for (int tile = tile_lo; tile < tile_hi; ++tile) {
        const int k_start = tile * BKV;
        __syncthreads();  // the previous tile's K/V/P reads are done
        for (int idx = tid; idx < BKV * DH; idx += NT) {
            const int j = idx / DH, d = idx % DH;
            const int t = k_start + j;
            const bool in = t < T_len;
            kt[d * L::KT_LD + j] = in ? to_f32(kb[t * kv_row_stride + d]) : 0.f;
            vs[j * DH + d] = in ? to_f32(vb[t * kv_row_stride + d]) : 0.f;
        }
        __syncthreads();

        float s[NS];
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) s[jj] = 0.f;
        const float* qrow = qs + row * L::Q_LD;
#pragma unroll 4
        for (int d = 0; d < DH; ++d) {
            const float qd = qrow[d];
            const float* krow = kt + d * L::KT_LD + lane;
#pragma unroll
            for (int jj = 0; jj < NS; ++jj) s[jj] = fmaf(qd, krow[jj * G], s[jj]);
        }

        float m_tile = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) {
            const int k_pos = k_start + lane + jj * G;
            float x = s[jj];
            if (softcap != 0.f) x = softcap * tanhf(x / softcap);
            bool live = k_pos < t_valid;
            if (causal) live = live && k_pos <= q_pos;
            if (window > 0) live = live && q_pos - k_pos < window;
            s[jj] = live ? x : NEG_INF;
            m_tile = fmaxf(m_tile, s[jj]);
        }
#pragma unroll
        for (int off = G / 2; off > 0; off /= 2)
            m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));

        const float m_new = fmaxf(m_run, m_tile);
        const float corr = expf(m_run - m_new);
        float l_tile = 0.f;
        float* prow = ps + row * L::P_LD;
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) {
            const float p = expf(s[jj] - m_new);
            prow[lane + jj * G] = p;
            l_tile += p;
        }
#pragma unroll
        for (int off = G / 2; off > 0; off /= 2)
            l_tile += __shfl_xor_sync(0xffffffffu, l_tile, off);
        l_run = l_run * corr + l_tile;
        m_run = m_new;
        __syncwarp();  // the row group lives in one warp: its P row is visible

#pragma unroll
        for (int a = 0; a < NA; ++a) acc[a] *= corr;
#pragma unroll 4
        for (int j = 0; j < BKV; ++j) {
            const float p = prow[j];
            const float* vrow = vs + j * DH + lane;
#pragma unroll
            for (int a = 0; a < NA; ++a) acc[a] = fmaf(p, vrow[a * G], acc[a]);
        }
    }

    if (q_pos < S) {
        const float inv = 1.f / fmaxf(l_run, 1e-30f);
        T* orow = o + ((long)b * S + q_pos) * q_row_stride + (long)h * DH + lane;
#pragma unroll
        for (int a = 0; a < NA; ++a) from_f32(acc[a] * inv, orow + a * G);
    }
}

template <typename T, int DH, int BQ, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T_len, int Hq, int Hkv, int causal,
                   int window, float softcap, float scale, int t_valid,
                   cudaStream_t stream) {
    constexpr size_t smem = Smem<DH, BQ, BKV>::BYTES;
    auto kernel = flash_fwd_kernel<T, DH, BQ, BKV>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    dim3 grid((S + BQ - 1) / BQ, Hq, B);
    kernel<<<grid, BQ * G, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        S, T_len, Hq, Hkv, causal, window, softcap, scale, t_valid);
    return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t by_tiles(int block_q, int block_kv, const void* q, const void* k,
                     const void* v, void* o, int B, int S, int T_len, int Hq,
                     int Hkv, int causal, int window, float softcap,
                     float scale, int t_valid, cudaStream_t st) {
#define FLASH_TILES(BQ_, BKV_)                                                  \
    if (block_q == BQ_ && block_kv == BKV_)                                     \
        return launch<T, DH, BQ_, BKV_>(q, k, v, o, B, S, T_len, Hq, Hkv,       \
                                        causal, window, softcap, scale,         \
                                        t_valid, st);
    FLASH_TILES(32, 32)
    FLASH_TILES(32, 64)
    FLASH_TILES(64, 32)
    FLASH_TILES(64, 64)
#undef FLASH_TILES
    return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_head_dim(int dh, int block_q, int block_kv, const void* q,
                        const void* k, const void* v, void* o, int B, int S,
                        int T_len, int Hq, int Hkv, int causal, int window,
                        float softcap, float scale, int t_valid,
                        cudaStream_t st) {
    switch (dh) {
        case 16: return by_tiles<T, 16>(block_q, block_kv, q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, softcap, scale, t_valid, st);
        case 32: return by_tiles<T, 32>(block_q, block_kv, q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, softcap, scale, t_valid, st);
        case 64: return by_tiles<T, 64>(block_q, block_kv, q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, softcap, scale, t_valid, st);
        case 128: return by_tiles<T, 128>(block_q, block_kv, q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, softcap, scale, t_valid, st);
        case 256: return by_tiles<T, 256>(block_q, block_kv, q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, softcap, scale, t_valid, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int dtype, int B, int S, int T_len, int Hq, int Hkv,
                         int dh, int block_q, int block_kv, int causal,
                         int window, float softcap, float scale, int t_valid,
                         void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return by_head_dim<float>(dh, block_q, block_kv, q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, softcap, scale, t_valid, st);
    if (dtype == 1)
        return by_head_dim<__nv_bfloat16>(dh, block_q, block_kv, q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, softcap, scale, t_valid, st);
    return cudaErrorInvalidValue;
}
