// Mamba (S6) selective scan for Hopper (sm_90a): f32 state, f32 math.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (_kernel, ssm_scan). Same function, over the factored inputs
// dt, u (B, S, di), b_t, c_t (B, S, N) and a (di, N):
//
//     h_t = exp(dt_t * a) * h_{t-1} + (dt_t * u_t) * b_t     (per channel d)
//     y_t = sum_n h_t[n] * c_t[n]
//
// with h_0 = 0, the state and every product in f32, y in the input dtype.
// The caller adds the D-skip and the gating. The (B, S, di, N) outer
// products are never written to device memory.
//
// What bounds it on this card: at the full-width Jamba-1.5-Large cell
// (B1 S4096 di16384 N16, bf16) the function moves 403,439,616 bytes (dt, u
// and y at 134 MB each, plus b_t, c_t and a, each once): 0.120 ms at
// 3.35 TB/s. Its f32 arithmetic is ~6.5 GFLOP, 0.097 ms at 67 TFLOP/s, so
// the bytes bound it. It also takes 1.07e9 exponentials, one per (t, d, n);
// at the special-function units' 16 per SM per clock (132 SMs, 1.98 GHz)
// they alone need ~0.26 ms, so a kernel that takes one exp per (t, d, n)
// cannot reach the bytes term. And one thread per (batch row, channel)
// gives only B * di = 16,384 threads at that cell, a few warps per SM: too
// few to hide each timestep's latency. Splitting N or the time axis over
// more threads is later work.
//
// Design (right and simple first):
//   - one thread per channel d of one batch row, its N-wide f32 state and
//     its row of a in registers (N is a template parameter); d_block threads
//     per block, grid (ceil(di / d_block), B). The sequential chunk axis of
//     the TPU grid, which carried h in VMEM scratch, becomes a loop over time
//     inside the thread;
//   - neighbouring threads own neighbouring channels, so each timestep's
//     reads of dt and u and write of y coalesce; the next timestep's dt and
//     u are loaded before this one's arithmetic, so one load is in flight
//     while the thread computes;
//   - per chunk of `chunk` timesteps the block stages b_t and c_t, which all
//     its channels share, in shared memory as f32 (2 * chunk * N * 4 bytes,
//     above 48 KB through the dynamic shared-memory opt-in); every thread of
//     a warp reads the same word, a broadcast;
//   - the ragged last chunk and channels past di (d_block need not divide
//     di) are masked here; the wrapper pads nothing;
//   - products and sums are rounded one by one (__fmul_rn, __fadd_rn: no
//     fused multiply-add) and y sums over n in order, as the plain torch
//     version does, so the two agree to the rounding of exp.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py). Plain C entry
//        point, loaded with ctypes; returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

template <typename T, int N>
__global__ void __launch_bounds__(MAX_THREADS)
ssm_scan_kernel(const T* __restrict__ dt, const T* __restrict__ u,
                const T* __restrict__ bt, const T* __restrict__ ct,
                const T* __restrict__ a, T* __restrict__ y,
                int S, int di, int chunk) {
    extern __shared__ float smem[];
    float* bs = smem;              // chunk x N
    float* cs = smem + chunk * N;  // chunk x N

    const int b = blockIdx.y;
    const int d = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = d < di;

    float av[N], h[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
        av[n] = live ? to_f32(a[(long)d * N + n]) : 0.f;
        h[n] = 0.f;
    }
    const T* bt_b = bt + (long)b * S * N;
    const T* ct_b = ct + (long)b * S * N;
    const long row0 = (long)b * S * di + d;

    for (int t0 = 0; t0 < S; t0 += chunk) {
        const int len = min(chunk, S - t0);
        __syncthreads();  // every thread is done with the previous chunk
        for (int i = threadIdx.x; i < len * N; i += blockDim.x) {
            bs[i] = to_f32(bt_b[(long)t0 * N + i]);
            cs[i] = to_f32(ct_b[(long)t0 * N + i]);
        }
        __syncthreads();
        if (!live) continue;
        long off = row0 + (long)t0 * di;
        float dtv = to_f32(dt[off]);
        float uv = to_f32(u[off]);
        for (int j = 0; j < len; ++j) {
            float dt_next = 0.f, u_next = 0.f;
            if (j + 1 < len) {
                dt_next = to_f32(dt[off + di]);
                u_next = to_f32(u[off + di]);
            }
            const float du = __fmul_rn(dtv, uv);
            const float* bj = bs + j * N;
            const float* cj = cs + j * N;
#pragma unroll
            for (int n = 0; n < N; ++n) {
                const float da = expf(__fmul_rn(dtv, av[n]));
                h[n] = __fadd_rn(__fmul_rn(da, h[n]), __fmul_rn(du, bj[n]));
            }
            float acc = __fmul_rn(h[0], cj[0]);
#pragma unroll
            for (int n = 1; n < N; ++n) acc = __fadd_rn(acc, __fmul_rn(h[n], cj[n]));
            from_f32(acc, y + off);
            off += di;
            dtv = dt_next;
            uv = u_next;
        }
    }
}

template <typename T, int N>
cudaError_t launch(const void* dt, const void* u, const void* bt,
                   const void* ct, const void* a, void* y, int B, int S,
                   int di, int chunk, int d_block, cudaStream_t stream) {
    const size_t smem = 2 * (size_t)chunk * N * sizeof(float);
    auto kernel = ssm_scan_kernel<T, N>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    dim3 grid((di + d_block - 1) / d_block, B);
    kernel<<<grid, d_block, smem, stream>>>(
        static_cast<const T*>(dt), static_cast<const T*>(u),
        static_cast<const T*>(bt), static_cast<const T*>(ct),
        static_cast<const T*>(a), static_cast<T*>(y), S, di, chunk);
    return cudaGetLastError();
}

template <typename T>
cudaError_t by_state_dim(int n, const void* dt, const void* u, const void* bt,
                         const void* ct, const void* a, void* y, int B, int S,
                         int di, int chunk, int d_block, cudaStream_t st) {
    if (d_block < 1 || d_block > MAX_THREADS || chunk < 1) return cudaErrorInvalidValue;
    switch (n) {
        case 4: return launch<T, 4>(dt, u, bt, ct, a, y, B, S, di, chunk, d_block, st);
        case 8: return launch<T, 8>(dt, u, bt, ct, a, y, B, S, di, chunk, d_block, st);
        case 16: return launch<T, 16>(dt, u, bt, ct, a, y, B, S, di, chunk, d_block, st);
        case 32: return launch<T, 32>(dt, u, bt, ct, a, y, B, S, di, chunk, d_block, st);
        case 64: return launch<T, 64>(dt, u, bt, ct, a, y, B, S, di, chunk, d_block, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int ssm_scan(const void* dt, const void* u, const void* bt,
                        const void* ct, const void* a, void* y, int dtype,
                        int B, int S, int di, int n, int chunk, int d_block,
                        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return by_state_dim<float>(n, dt, u, bt, ct, a, y, B, S, di, chunk, d_block, st);
    if (dtype == 1)
        return by_state_dim<__nv_bfloat16>(n, dt, u, bt, ct, a, y, B, S, di, chunk, d_block, st);
    return cudaErrorInvalidValue;
}
