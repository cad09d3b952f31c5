// Fixed-iteration preconditioned CG in the eigenbasis of the ICAR precision.
//
// Replaces the Pallas kernel occuspytial_tpu/ops/pallas_cg.py:_cg_kernel
// (launched by _cg_batched via _make_fused / icar_cg_solve_fused). For each
// chain it solves (tau*Q + diag(omega)) X = RHS for the chain's R stacked
// right-hand-side rows, with Q = U S U':
//   operator        A v = tau*S*v + U'(omega o (U v))
//   preconditioner  M^-1 r = r / (tau*S + mean(omega))
//   warm start      x0 in the eigenbasis
// and returns the site solution U x, the eigenbasis solution x and the
// per-chain residual max_rows ||r_k|| / ||U' rhs||, the contract of
// ops/cg.py:icar_cg_solve_spectral(..., return_resid=True). The clamps
// max(denominator, 1e-30) are those of the JAX ops/cg.py:pcg, and every
// dot product accumulates in float32, so a stiff tau (1e4) stays stable.
//
// Design: one block per chain (the rows of one chain share omega and tau;
// rows of different chains share nothing but U). The chain's rows of
// r, x, p, A p and the site-basis scratch, plus omega, tau*S and the
// preconditioner, live in dynamic shared memory: (5 R + 3) n floats, 132 KB
// at R = 6, n = 1000. Each operator application reads U twice from global
// memory (U is 4 MB at n = 1000, so it stays in the 50 MB L2):
//   U v   : one warp per row i of U, lanes along the row, warp-shuffle sums;
//   w' U  : one thread per column j, looping over i (coalesced U reads,
//           broadcast shared reads of w).
// alpha, beta and the residual come from block-level reductions.
//
// What bounds it on the card: operations at the float32 CUDA-core rate
// (2 n^2 multiply-adds per row and iteration, 9 operator applications per
// solve at iters = 8) against ~13 MB of compulsory traffic; in practice the
// L2 reads of U bound this simple design, since each of the 64 blocks
// streams U 2 (iters + 1) + 2 times and only 64 of the 132 SMs are busy.
// Sharing U reads across chains (a tile of U in shared memory feeding many
// chains' rows) is the work of a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Sums each of the R per-thread values over the block; every thread gets
// the totals.
template <int R>
__device__ __forceinline__ void block_sum(float (&v)[R], float (*red)[R],
                                          float* tot) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = warp_sum(v[r]);
    if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) red[warp][r] = v[r];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            float s = lane < kWarps ? red[lane][r] : 0.0f;
            s = warp_sum(s);
            if (lane == 0) tot[r] = s;
        }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = tot[r];
}

// out[r, i] = scale[i] * sum_j U[i, j] v[r, j]   (v U', then omega o .)
template <int R>
__device__ __forceinline__ void to_site(const float* __restrict__ U,
                                        const float* v, float* out,
                                        const float* scale, int n) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = warp; i < n; i += kWarps) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;
        const float* urow = U + (size_t)i * n;
        for (int j = lane; j < n; j += 32) {
            const float u = __ldg(urow + j);
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] += u * v[r * n + j];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = warp_sum(acc[r]);
        if (lane == 0) {
            const float s = scale ? scale[i] : 1.0f;
#pragma unroll
            for (int r = 0; r < R; ++r) out[r * n + i] = acc[r] * s;
        }
    }
}

// out[r, j] = diag[j] * v[r, j] + sum_i w[r, i] U[i, j]   (diag may be null)
template <int R>
__device__ __forceinline__ void to_spec(const float* __restrict__ U,
                                        const float* w, const float* diag,
                                        const float* v, float* out, int n) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;
        const float* ucol = U + j;
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
            const float u = __ldg(ucol + (size_t)i * n);
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] += w[r * n + i] * u;
        }
        if (diag) {
#pragma unroll
            for (int r = 0; r < R; ++r)
                out[r * n + j] = diag[j] * v[r * n + j] + acc[r];
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) out[r * n + j] = acc[r];
        }
    }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
icar_cg_kernel(const float* __restrict__ U, const float* __restrict__ S,
               const float* __restrict__ rhs, const float* __restrict__ x0,
               const float* __restrict__ omega, const float* __restrict__ tau,
               float* __restrict__ x_site, float* __restrict__ x_spec,
               float* __restrict__ rel, int n, int iters) {
    extern __shared__ float sm[];
    __shared__ float red[kWarps][R];
    __shared__ float tot[R];
    float* r = sm;             // residual (first: the eigenbasis rhs)
    float* x = r + R * n;      // iterate
    float* p = x + R * n;      // search direction
    float* ap = p + R * n;     // operator applied to p
    float* w = ap + R * n;     // site-basis scratch
    float* om = w + R * n;     // omega
    float* tau_s = om + n;     // tau * S
    float* pinv = tau_s + n;   // 1 / (tau * S + mean(omega))

    const int c = blockIdx.x;
    const int t = threadIdx.x;
    const size_t base = (size_t)c * R * n;
    const float tc = tau[c];

    float acc[R];
    float sum1[1] = {0.0f};
    for (int j = t; j < n; j += kThreads) {
        om[j] = omega[(size_t)c * n + j];
        sum1[0] += om[j];
    }
    block_sum<1>(sum1, reinterpret_cast<float(*)[1]>(&red[0][0]), tot);
    const float cbar = sum1[0] / (float)n;
    for (int j = t; j < n; j += kThreads) {
        tau_s[j] = tc * S[j];
        pinv[j] = 1.0f / (tau_s[j] + cbar);
    }
    for (int idx = t; idx < R * n; idx += kThreads) {
        w[idx] = rhs[base + idx];
        x[idx] = x0[base + idx];
    }
    __syncthreads();

    // eigenbasis right-hand side b = rhs U, and ||b||^2 per row
    to_spec<R>(U, w, nullptr, nullptr, r, n);
    __syncthreads();
    float bb[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
        bb[q] = 0.0f;
        for (int j = t; j < n; j += kThreads) bb[q] += r[q * n + j] * r[q * n + j];
    }
    block_sum<R>(bb, red, tot);

    // r = b - A x0, p = z = M^-1 r, rz = r.z
    to_site<R>(U, x, w, om, n);
    __syncthreads();
    to_spec<R>(U, w, tau_s, x, ap, n);
    __syncthreads();
    float rz[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
        rz[q] = 0.0f;
        for (int j = t; j < n; j += kThreads) {
            const float rr = r[q * n + j] - ap[q * n + j];
            const float z = pinv[j] * rr;
            r[q * n + j] = rr;
            p[q * n + j] = z;
            rz[q] += rr * z;
        }
    }
    block_sum<R>(rz, red, tot);

    for (int it = 0; it < iters; ++it) {
        to_site<R>(U, p, w, om, n);
        __syncthreads();
        to_spec<R>(U, w, tau_s, p, ap, n);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < R; ++q) {
            acc[q] = 0.0f;
            for (int j = t; j < n; j += kThreads)
                acc[q] += p[q * n + j] * ap[q * n + j];
        }
        block_sum<R>(acc, red, tot);
        float rz_new[R];
#pragma unroll
        for (int q = 0; q < R; ++q) {
            const float alpha = rz[q] / fmaxf(acc[q], kTiny);
            rz_new[q] = 0.0f;
            for (int j = t; j < n; j += kThreads) {
                x[q * n + j] += alpha * p[q * n + j];
                const float rr = r[q * n + j] - alpha * ap[q * n + j];
                r[q * n + j] = rr;
                rz_new[q] += rr * (pinv[j] * rr);
            }
        }
        block_sum<R>(rz_new, red, tot);
#pragma unroll
        for (int q = 0; q < R; ++q) {
            const float beta = rz_new[q] / fmaxf(rz[q], kTiny);
            for (int j = t; j < n; j += kThreads)
                p[q * n + j] = pinv[j] * r[q * n + j] + beta * p[q * n + j];
            rz[q] = rz_new[q];
        }
        __syncthreads();
    }

    // final residual rows -> per-chain relative residual
#pragma unroll
    for (int q = 0; q < R; ++q) {
        acc[q] = 0.0f;
        for (int j = t; j < n; j += kThreads) acc[q] += r[q * n + j] * r[q * n + j];
    }
    block_sum<R>(acc, red, tot);
    if (t == 0) {
        float worst = 0.0f;
#pragma unroll
        for (int q = 0; q < R; ++q) worst = fmaxf(worst, acc[q] / fmaxf(bb[q], kTiny));
        rel[c] = sqrtf(worst);
    }
    for (int idx = t; idx < R * n; idx += kThreads) x_spec[base + idx] = x[idx];
    to_site<R>(U, x, w, nullptr, n);
    __syncthreads();
    for (int idx = t; idx < R * n; idx += kThreads) x_site[base + idx] = w[idx];
}

template <int R>
int launch(const void* U, const void* S, const void* rhs, const void* x0,
           const void* omega, const void* tau, void* x_site, void* x_spec,
           void* rel, int chains, int n, int iters, cudaStream_t stream) {
    const size_t smem = (size_t)(5 * R + 3) * n * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        icar_cg_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    icar_cg_kernel<R><<<chains, kThreads, smem, stream>>>(
        (const float*)U, (const float*)S, (const float*)rhs,
        (const float*)x0, (const float*)omega, (const float*)tau,
        (float*)x_site, (float*)x_spec, (float*)rel, n, iters);
    return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code (0 on success); rows must lie in [1, 8].
extern "C" int icar_cg_launch(const void* U, const void* S, const void* rhs,
                              const void* x0, const void* omega,
                              const void* tau, void* x_site, void* x_spec,
                              void* rel, int chains, int rows, int n,
                              int iters, void* stream) {
    if (chains == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (rows) {
        case 1: return launch<1>(U, S, rhs, x0, omega, tau, x_site, x_spec, rel, chains, n, iters, s);
        case 2: return launch<2>(U, S, rhs, x0, omega, tau, x_site, x_spec, rel, chains, n, iters, s);
        case 3: return launch<3>(U, S, rhs, x0, omega, tau, x_site, x_spec, rel, chains, n, iters, s);
        case 4: return launch<4>(U, S, rhs, x0, omega, tau, x_site, x_spec, rel, chains, n, iters, s);
        case 5: return launch<5>(U, S, rhs, x0, omega, tau, x_site, x_spec, rel, chains, n, iters, s);
        case 6: return launch<6>(U, S, rhs, x0, omega, tau, x_site, x_spec, rel, chains, n, iters, s);
        case 7: return launch<7>(U, S, rhs, x0, omega, tau, x_site, x_spec, rel, chains, n, iters, s);
        case 8: return launch<8>(U, S, rhs, x0, omega, tau, x_site, x_spec, rel, chains, n, iters, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* icar_cg_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
