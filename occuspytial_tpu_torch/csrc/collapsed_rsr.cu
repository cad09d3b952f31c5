// The q-space work of one collapsed probit RSR sweep, one chain a block:
// the Cholesky factor of A = tau Q_rsr + K'K / 2 (potrf), its triangular
// solves (trsm), the collapsed beta draw and the eta draw, in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves these draws
// (occuspytial_tpu/models/probit.py: ProbitRSRGibbs._update_beta_collapsed
// and _update_eta_collapsed) to XLA. On the card their torch form
// (occuspytial_tpu_torch/models/probit.py, the same methods, which the CPU
// and every case this kernel does not take still run) is cuSOLVER's
// batched potrf and cuBLAS's batched trsm, 14 launches, each a round trip
// of every chain's 128 x 128 factor through device memory, with the
// operand copies and the ~40 small ops of the p x p draw around them.
//
// Per chain, with ku = K'u and xu = X'u (the site contractions, torch
// products outside the kernel), p <= 6 and q <= 128:
//   A      = tau Q_rsr + K'K / 2 = L L'
//   [Sx su] = A^-1 [K'X ku]                     (through L, then L')
//   a_beta = XTX / 2 + b_prec - K'X' Sx / 4,  symmetrised
//   b_beta = xu / 2 - su' K'X / 4 + b_prec mu
//   beta   = a_beta^-1 b_beta + La'^-1 eps_beta  (La the p x p factor)
//   b_eta  = (ku - K'X beta) / 2                 (= K'(u - X beta) / 2)
//   eta    = A^-1 b_eta + L'^-1 eps_eta
//
// What bounds it on the card. Operations: q^3 / 3 multiply-adds for the
// factor and q^2 for each right-hand side through L and L': 404 MFLOP for
// 256 chains at q = 128, 6.0 us at 67 TFLOP/s float32. Bytes: the inputs
// and outputs are a few KB a chain, and the fixed matrices (Q_rsr, K'K:
// 128 KB) are read by every block from L2. L never leaves the SM. What
// bounds it in practice is latency: 256 chains are two blocks an SM, and
// each block walks the factor's 128 pivots and its solves' panels in
// order.
//
// Design. One block (256 threads) owns one chain for the whole sweep; no
// value crosses blocks, so a chain's bits depend on its own inputs alone
// (the same at every chain count). A lives in shared memory (66 KB at q =
// 128, row stride 129 so that a column of 32 rows falls in 32 banks), with
// the inverses of its four diagonal blocks (17 KB); the block's ~89 KB let
// two blocks share an SM, so 256 chains run in one wave on 132 SMs. q is
// padded to a multiple of 32 with identity rows and columns and zero
// right-hand sides, whose solutions stay zero.
//   load    the fixed matrices' lower triangles with 32 loads in flight a
//           thread.
//   factor  right-looking, by 32-wide panels: warp 0 factors the diagonal
//           block in registers (lane i holds row i, the pivots' columns
//           passed by shuffles, one reciprocal a pivot on the chain of
//           dependent steps: factor_diag); then the last warp inverts it
//           while one thread a row solves the panel below it; then the
//           block subtracts the panel's outer product from the trailing
//           lower tiles, 64 threads a 32 x 32 tile from 4 x 4 register
//           tiles. 1 / L_jj is kept.
//   solves  by panels: warp c applies the diagonal block's inverse to
//           right-hand side c (a 32-term dot product a lane, where
//           substitution would take 32 dependent steps), then the block
//           updates the rows below (L) or above (L'). The first pass takes
//           K'X and ku through L, then those and eps_eta through L'; the
//           second takes b_eta through L and L'.
//   draws   the p^2 + p dot products of a_beta and b_beta one warp each,
//           then thread 0 draws beta by the p x p Cholesky with the
//           rounding of ops/mvnorm.py's unrolled draw.
// Arithmetic is float32 (the configuration's precision, no TF32): FMAs in
// the factor, the solves and the dots; the elementwise steps round as the
// torch ops do (__fmul_rn, __fadd_rn: no contraction). A is well
// conditioned (tau Q_rsr + K'K / 2 with K'K = I on a Moran basis), so the
// 32 x 32 inverses cost no accuracy that matters against the cell's limit.
// A pivot that is not positive (or NaN) makes L_jj NaN, which reaches
// every later entry: the chain's beta and eta come out NaN, so a failed
// factor is seen.
//
// Launch count. Thread 0 of block 0 adds one to `launches` (a device
// counter owned by the wrapper), so a launch replayed from a captured CUDA
// graph is counted by the card, as an eager one is.
//
// Built without --use_fast_math: divisions, square roots and reciprocals
// are IEEE-rounded, but for the pivots' reciprocals inside the diagonal
// blocks' factor (rcp_newton).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 32;                // panel width: a warp's lanes
constexpr int kMaxQ = 128;             // basis dimension at most
constexpr int kMaxNB = kMaxQ / kNB;    // panels at most
constexpr int kLD = kMaxQ + 1;         // row stride of A
constexpr int kLI = kNB + 1;           // row stride of a diagonal inverse
constexpr int kMaxP = 6;               // covariates at most
constexpr int kCols = kMaxP + 2;       // K'X, ku, eps_eta
constexpr int kDots = kMaxP * kMaxP + kMaxP;
constexpr size_t kSmemFloats = (size_t)kMaxQ * kLD + kMaxQ
    + (size_t)kMaxNB * kNB * kLI + (size_t)(kCols + kMaxP) * kMaxQ + kDots
    + kMaxP;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMaxQ % kNB == 0, "whole panels");
static_assert(kCols <= kWarps, "a warp a right-hand side");
static_assert(kMaxQ - kNB <= (kWarps - 1) * 32,
              "the panel rows leave the last warp free");
static_assert(kSmemBytes <= 113 * 1024, "two blocks an SM");

struct Params {
    const float* tau;       // (chains)
    const float* ku;        // (chains, q)  K'u
    const float* xu;        // (chains, p)  X'u
    const float* eps_beta;  // (chains, p)
    const float* eps_eta;   // (chains, q)
    const float* q_rsr;     // (q, q)
    const float* ktk;       // (q, q)
    const float* ktx;       // (q, p)
    const float* xtx;       // (p, p)
    const float* b_prec;    // (p, p)
    const float* b_mu;      // (p)  b_prec @ b_mu
    float* beta;            // (chains, p)
    float* eta;             // (chains, q)
    unsigned long long* launches;
    int q, p;
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// 1 / x from the hardware's approximate reciprocal and one Newton step:
// within an ulp of the IEEE-rounded reciprocal for a normal x, without
// the IEEE routine's branch to its slow path (which, on the pivots'
// chain, took the diagonal block's factor from 7.0 to 13.5 thousand
// cycles on the H100).
__device__ __forceinline__ float rcp_newton(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// Factor the 32 x 32 diagonal block D (row stride kLD) in place, lower
// triangle, by one warp: lane i holds row i. The elimination runs as
// U diag(d) U' (U unit lower), so that a pivot's step holds one
// reciprocal on the chain of dependent steps: lane j's d_j broadcast,
// its reciprocal, each lane's multiplier u_ij = a_ij / d_j and its
// update a_ic -= u_ij a_cj, whose a_cj lanes c pass before the
// reciprocal is ready. The square roots follow, off that chain: L = U
// diag(sqrt d), and rinv[j] = 1 / L_jj (IEEE-rounded). A pivot that is
// not positive (or NaN) makes L_jj NaN.
__device__ __forceinline__ void factor_diag(float* D, float* rinv, int lane) {
    float a[kNB], d = 0.0f;
#pragma unroll
    for (int c = 0; c < kNB; ++c) a[c] = c <= lane ? D[lane * kLD + c] : 0.0f;
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
        if (lane == j) d = a[j];
        const float rd = rcp_newton(__shfl_sync(kFull, a[j], j));
        const float u = __fmul_rn(a[j], rd);
#pragma unroll
        for (int c = j + 1; c < kNB; ++c) {
            const float acj = __shfl_sync(kFull, a[j], c);
            if (lane >= c) a[c] = fmaf(-u, acj, a[c]);
        }
        if (lane > j) a[j] = u;
    }
    const float root = d > 0.0f ? __fsqrt_rn(d) : nan_f();
    rinv[lane] = __frcp_rn(root);
#pragma unroll
    for (int c = 0; c < kNB; ++c) {
        const float rc = __shfl_sync(kFull, root, c);
        if (c < lane) D[lane * kLD + c] = __fmul_rn(a[c], rc);
    }
    D[lane * kLD + lane] = root;
}

// Li = L11^-1 (lower, row stride kLI, zero above) for the diagonal block
// D, by one warp: lane c takes column c through L11 by substitution.
__device__ __forceinline__ void invert_diag(const float* D, const float* rinv,
                                            float* Li, int lane) {
    float x[kNB];
#pragma unroll
    for (int j = 0; j < kNB; ++j) x[j] = j == lane ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
        x[k] = __fmul_rn(x[k], rinv[k]);
#pragma unroll
        for (int j = k + 1; j < kNB; ++j) x[j] = fmaf(-D[j * kLD + k], x[k], x[j]);
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j) Li[j * kLI + lane] = x[j];
}

// Rows r of the panel below the diagonal block D: L[r, panel] = A[r,
// panel] L11^-T, a row a thread; `row` points at A[r][k0].
__device__ __forceinline__ void solve_panel_row(float* row, const float* D,
                                                const float* rinv) {
    float a[kNB];
#pragma unroll
    for (int c = 0; c < kNB; ++c) a[c] = row[c];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
        const float x = __fmul_rn(a[j], rinv[j]);
        a[j] = x;
#pragma unroll
        for (int c = j + 1; c < kNB; ++c) a[c] = fmaf(-x, D[c * kLD + j], a[c]);
    }
#pragma unroll
    for (int c = 0; c < kNB; ++c) row[c] = a[c];
}

// A[i][j] -= sum_k L[i][k0 + k] L[j][k0 + k] over the 32 x 32 tiles below
// and right of panel P (lower tiles only); 64 threads a tile, thread (ty,
// tx) owns rows ty + 8a and columns tx + 8b of it.
__device__ __forceinline__ void trailing_update(float* A, int P, int nb,
                                                int tid) {
    const int t = nb - P - 1;
    const int tiles = t * (t + 1) / 2;
    const int k0 = P * kNB, k1 = k0 + kNB;
    const int ty = (tid >> 3) & 7, tx = tid & 7;
    for (int T = tid >> 6; T < tiles; T += kThreads / 64) {
        int bi = 0, bj = T;
        while (bj > bi) { bj -= bi + 1; ++bi; }
        float* Ci = A + (k1 + kNB * bi + ty) * kLD + k1 + kNB * bj + tx;
        const float* Li = A + (k1 + kNB * bi + ty) * kLD + k0;
        const float* Lj = A + (k1 + kNB * bj + tx) * kLD + k0;
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = Ci[8 * a * kLD + 8 * b];
#pragma unroll 8
        for (int k = 0; k < kNB; ++k) {
            float li[4], lj[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) li[a] = Li[8 * a * kLD + k];
#pragma unroll
            for (int b = 0; b < 4; ++b) lj[b] = Lj[8 * b * kLD + k];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    acc[a][b] = fmaf(-li[a], lj[b], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) Ci[8 * a * kLD + 8 * b] = acc[a][b];
    }
}

// sum_k M(k) v[k] over k < 32 in four interleaved partial sums
template <typename F>
__device__ __forceinline__ float dot32(F m, const float* v) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kNB; ++k) s[k & 3] = fmaf(m(k), v[k], s[k & 3]);
    return __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
}

// L Y = B in place for the columns c < ncols of B (column c at B + c *
// kMaxQ), Qp = 32 nb rows: by panels, warp c applies the diagonal block's
// inverse to column c, then the block updates the rows below.
__device__ __forceinline__ void solve_lower(const float* A, const float* Li,
                                            float* B, int ncols, int nb,
                                            int tid) {
    const int warp = tid >> 5, lane = tid & 31, Qp = nb * kNB;
    for (int P = 0; P < nb; ++P) {
        const int k0 = P * kNB;
        if (warp < ncols) {
            const float* Lp = Li + P * kNB * kLI + lane * kLI;
            float* b = B + warp * kMaxQ + k0;
            const float y = dot32([&](int k) { return Lp[k]; }, b);
            __syncwarp();
            b[lane] = y;
        }
        __syncthreads();
        const int below = Qp - k0 - kNB;
        for (int e = tid; e < below * ncols; e += kThreads) {
            const int c = e / below, r = k0 + kNB + e % below;
            const float* lr = A + r * kLD + k0;
            float* x = B + c * kMaxQ;
            x[r] = __fsub_rn(x[r], dot32([&](int k) { return lr[k]; },
                                         x + k0));
        }
        __syncthreads();
    }
}

// L' X = B in place, as solve_lower from the last panel up.
__device__ __forceinline__ void solve_upper(const float* A, const float* Li,
                                            float* B, int ncols, int nb,
                                            int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int P = nb - 1; P >= 0; --P) {
        const int k0 = P * kNB;
        if (warp < ncols) {
            const float* Lp = Li + P * kNB * kLI + lane;
            float* b = B + warp * kMaxQ + k0;
            const float x = dot32([&](int k) { return Lp[k * kLI]; }, b);
            __syncwarp();
            b[lane] = x;
        }
        __syncthreads();
        for (int e = tid; e < k0 * ncols; e += kThreads) {
            const int c = e / k0, r = e % k0;
            const float* lc = A + k0 * kLD + r;
            float* x = B + c * kMaxQ;
            x[r] = __fsub_rn(x[r], dot32([&](int k) { return lc[k * kLD]; },
                                         x + k0));
        }
        __syncthreads();
    }
}

// beta ~ N(a^-1 b, a^-1) for the symmetric p x p `a` by ops/mvnorm.py's
// unrolled draw, each step rounded as its torch op: L = chol(a), mean =
// L'^-1 L^-1 b, fluctuation L'^-1 eps. Loops run to kMaxP (registers)
// and skip what p leaves out.
__device__ __forceinline__ void draw_small(const float (&a)[kMaxP][kMaxP],
                                           const float (&b)[kMaxP],
                                           const float (&eps)[kMaxP], int p,
                                           float (&out)[kMaxP]) {
    float low[kMaxP][kMaxP], y[kMaxP], m[kMaxP], f[kMaxP];
#pragma unroll
    for (int i = 0; i < kMaxP; ++i) {
        if (i >= p) break;
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float s = a[i][j];
#pragma unroll
            for (int k = 0; k < j; ++k)
                s = __fsub_rn(s, __fmul_rn(low[i][k], low[j][k]));
            low[i][j] = i == j ? __fsqrt_rn(s) : __fdiv_rn(s, low[j][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kMaxP; ++i) {
        if (i >= p) break;
        float s = b[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = __fsub_rn(s, __fmul_rn(low[i][k], y[k]));
        y[i] = __fdiv_rn(s, low[i][i]);
    }
#pragma unroll
    for (int i = kMaxP - 1; i >= 0; --i) {
        if (i < p) {
            float s = y[i], t = eps[i];
#pragma unroll
            for (int k = i + 1; k < kMaxP; ++k) {
                if (k < p) {
                    s = __fsub_rn(s, __fmul_rn(low[k][i], m[k]));
                    t = __fsub_rn(t, __fmul_rn(low[k][i], f[k]));
                }
            }
            m[i] = __fdiv_rn(s, low[i][i]);
            f[i] = __fdiv_rn(t, low[i][i]);
            out[i] = __fadd_rn(m[i], f[i]);
        }
    }
}

__global__ void __launch_bounds__(kThreads, 2)
collapsed_rsr_potrf_trsm_kernel(const Params P) {
    extern __shared__ float smem[];
    float* A = smem;                        // kMaxQ x kLD
    float* rinv = A + kMaxQ * kLD;          // kMaxQ
    float* Li = rinv + kMaxQ;               // kMaxNB blocks of kNB x kLI
    float* B = Li + kMaxNB * kNB * kLI;     // kCols columns of kMaxQ
    float* ktx = B + kCols * kMaxQ;         // kMaxP columns of kMaxQ
    float* red = ktx + kMaxP * kMaxQ;       // kDots
    float* beta_s = red + kDots;            // kMaxP

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int chain = blockIdx.x;
    const int q = P.q, p = P.p;
    const int nb = (q + kNB - 1) / kNB, Qp = nb * kNB;
    const float tau = P.tau[chain];
    if (chain == 0 && tid == 0) atomicAdd(P.launches, 1ULL);

    // A's lower triangle (identity in the padding), zero above: rows warp
    // + 8t and columns lane + 32c, 32 loads in flight a thread
    for (int t0 = 0; t0 < Qp; t0 += 4 * kWarps) {
        float qv[4][kMaxNB], kv[4][kMaxNB];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int i = t0 + warp + kWarps * t;
#pragma unroll
            for (int c = 0; c < kMaxNB; ++c) {
                const int j = lane + kNB * c;
                const bool in = i < q && j <= i;
                qv[t][c] = in ? __ldg(P.q_rsr + i * q + j) : 0.0f;
                kv[t][c] = in ? __ldg(P.ktk + i * q + j) : 0.0f;
            }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int i = t0 + warp + kWarps * t;
#pragma unroll
            for (int c = 0; c < kMaxNB; ++c) {
                const int j = lane + kNB * c;
                if (c < nb)
                    A[i * kLD + j] =
                        i < q && j <= i
                            ? __fadd_rn(__fmul_rn(tau, qv[t][c]),
                                        __fmul_rn(0.5f, kv[t][c]))
                            : (i == j ? 1.0f : 0.0f);
            }
        }
    }
    const float* ku = P.ku + (size_t)chain * q;
    const float* ee = P.eps_eta + (size_t)chain * q;
    for (int r = tid; r < Qp; r += kThreads) {
        for (int c = 0; c < p; ++c) {
            const float v = r < q ? P.ktx[r * p + c] : 0.0f;
            ktx[c * kMaxQ + r] = v;
            B[c * kMaxQ + r] = v;
        }
        B[p * kMaxQ + r] = r < q ? ku[r] : 0.0f;
        B[(p + 1) * kMaxQ + r] = r < q ? ee[r] : 0.0f;
    }
    if (tid < p) beta_s[tid] = P.eps_beta[(size_t)chain * p + tid];
    __syncthreads();

    // the factor, in place in A's lower triangle, and the inverses of its
    // diagonal blocks (the last warp, beside the panel rows)
    for (int b = 0; b < nb; ++b) {
        const int k0 = b * kNB;
        float* D = A + k0 * kLD + k0;
        if (warp == 0) factor_diag(D, rinv + k0, lane);
        __syncthreads();
        if (warp == kWarps - 1) invert_diag(D, rinv + k0, Li + b * kNB * kLI,
                                            lane);
        for (int r = k0 + kNB + tid; r < Qp; r += kThreads)
            solve_panel_row(A + r * kLD + k0, D, rinv + k0);
        __syncthreads();
        trailing_update(A, b, nb, tid);
        __syncthreads();
    }

    // [Sx su] = A^-1 [K'X ku] and L'^-1 eps_eta
    solve_lower(A, Li, B, p + 1, nb, tid);
    solve_upper(A, Li, B, p + 2, nb, tid);

    // a_beta = (XTX / 2 + b_prec) - K'X' Sx / 4 and b_beta = (xu / 2 -
    // su' K'X / 4) + b_prec mu, an entry a warp (its dot product over q)
    const int pp = p * p;
    for (int d = warp; d < pp + p; d += kWarps) {
        const int i = d < pp ? d / p : d - pp;
        const int col = d < pp ? d % p : p;
        float s = 0.0f;
        for (int r = lane; r < q; r += 32)
            s = fmaf(ktx[i * kMaxQ + r], B[col * kMaxQ + r], s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        if (lane == 0)
            red[d] = d < pp
                ? __fsub_rn(__fadd_rn(__fmul_rn(0.5f, P.xtx[d]), P.b_prec[d]),
                            __fmul_rn(0.25f, s))
                : __fadd_rn(__fsub_rn(__fmul_rn(0.5f, P.xu[(size_t)chain * p + i]),
                                      __fmul_rn(0.25f, s)),
                            P.b_mu[i]);
    }
    __syncthreads();

    // beta by thread 0, with a_beta symmetrised: (a + a') / 2
    if (tid == 0) {
        float s[kMaxP][kMaxP], bb[kMaxP], eb[kMaxP], out[kMaxP];
#pragma unroll
        for (int i = 0; i < kMaxP; ++i) {
#pragma unroll
            for (int j = 0; j < kMaxP; ++j)
                if (i < p && j < p)
                    s[i][j] = __fmul_rn(0.5f, __fadd_rn(red[i * p + j],
                                                        red[j * p + i]));
            if (i < p) {
                bb[i] = red[pp + i];
                eb[i] = beta_s[i];
            }
        }
        draw_small(s, bb, eb, p, out);
#pragma unroll
        for (int i = 0; i < kMaxP; ++i) {
            if (i < p) {
                beta_s[i] = out[i];
                P.beta[(size_t)chain * p + i] = out[i];
            }
        }
    }
    __syncthreads();

    // b_eta = (ku - K'X beta) / 2 in column 0, through L and L'
    for (int r = tid; r < Qp; r += kThreads) {
        float v = 0.0f;
        if (r < q) {
            float s = ku[r];
            for (int c = 0; c < p; ++c) s = fmaf(-ktx[c * kMaxQ + r], beta_s[c], s);
            v = __fmul_rn(0.5f, s);
        }
        B[r] = v;
    }
    __syncthreads();
    solve_lower(A, Li, B, 1, nb, tid);
    solve_upper(A, Li, B, 1, nb, tid);

    float* eta = P.eta + (size_t)chain * q;
    for (int r = tid; r < q; r += kThreads)
        eta[r] = __fadd_rn(B[r], B[(p + 1) * kMaxQ + r]);
}

}  // namespace

// Returns a CUDA error code (0 on success). All pointers are device
// pointers to contiguous float32 but for `launches`, one uint64 the launch
// adds 1 to. tau (chains), ku and eps_eta (chains, q), xu and eps_beta
// (chains, p), q_rsr and ktk (q, q), ktx (q, p), xtx and b_prec (p, p),
// b_mu (p); writes beta (chains, p) and eta (chains, q). 1 <= q <= 128,
// 1 <= p <= 6.
extern "C" int collapsed_rsr_launch(
    const void* tau, const void* ku, const void* xu, const void* eps_beta,
    const void* eps_eta, const void* q_rsr, const void* ktk, const void* ktx,
    const void* xtx, const void* b_prec, const void* b_mu, void* beta,
    void* eta, void* launches, int chains, int q, int p, void* stream) {
    if (chains == 0) return 0;
    if (chains < 0 || q < 1 || q > kMaxQ || p < 1 || p > kMaxP)
        return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    // the shared-memory opt-in and carve-out, once a device (outside any
    // capture: the wrapper's launch counter makes the first launch on a
    // device eager)
    static bool opted[64] = {};
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
        err = cudaFuncSetAttribute(collapsed_rsr_potrf_trsm_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemBytes);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute(
            collapsed_rsr_potrf_trsm_kernel,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
        opted[dev] = true;
    }
    Params P;
    P.tau = (const float*)tau;
    P.ku = (const float*)ku;
    P.xu = (const float*)xu;
    P.eps_beta = (const float*)eps_beta;
    P.eps_eta = (const float*)eps_eta;
    P.q_rsr = (const float*)q_rsr;
    P.ktk = (const float*)ktk;
    P.ktx = (const float*)ktx;
    P.xtx = (const float*)xtx;
    P.b_prec = (const float*)b_prec;
    P.b_mu = (const float*)b_mu;
    P.beta = (float*)beta;
    P.eta = (float*)eta;
    P.launches = (unsigned long long*)launches;
    P.q = q;
    P.p = p;
    collapsed_rsr_potrf_trsm_kernel<<<chains, kThreads, kSmemBytes,
                                      (cudaStream_t)stream>>>(P);
    return (int)cudaGetLastError();
}

// Blocks of the kernel that fit one SM at once (the occupancy query, after
// the opt-in of a first launch); negative: a CUDA error code, negated.
extern "C" int collapsed_rsr_blocks_per_sm() {
    int blocks = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, collapsed_rsr_potrf_trsm_kernel, kThreads, kSmemBytes);
    return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* collapsed_rsr_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
