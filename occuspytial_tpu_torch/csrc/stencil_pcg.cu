// Fixed-iteration DCT-preconditioned CG on the lattice ICAR operator, one
// (chain, row) field a block, every iteration in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves its lattice solve
// (occuspytial_tpu/ops/stencil.py:cg_solve) to XLA. On the card the torch
// form of that solve (ops/stencil.py:cg_solve_plain through ops/cg.py:pcg)
// costs ~35 kernels an iteration: shifted-slice adds over padded views for
// the matvec, four batched cuBLAS products and their reshapes for the
// preconditioner, the dots and the axpys, each a round trip of every field
// through device memory. This kernel runs the same algorithm,
//   operator        A v = tau * (deg o v - rho * (neighbour sum of v))
//                         + omega o v
//   preconditioner  M^-1 r = Cr' [(Cr R Cc') / (tau * sym + cbar)] Cc,
//                   R the field of r on the (rows, cols) grid, cbar =
//                   sum(omega) / n
//   iteration       exactly `iters` PCG steps from the warm start x0,
//                   denominators clamped at 1e-30
// and returns x and, when asked, sqrt(||r||^2 / max(||b||^2, 1e-30)) per
// field (the wrapper takes the per-chain maximum over rows).
//
// What bounds it on the card. Operations: four 100 x 100 x 100 products a
// preconditioner apply, 16 applies a solve (the start's and one an
// iteration), 128 MFLOP a field, 24.6 GFLOP for 32 chains x 6 rows: 0.37
// ms at the 67 TFLOP/s float32 rate. Its bytes are the inputs and x, ~24 MB
// at that shape. The products run as float32 FMAs: the configuration is
// float32 with TF32 off, and split-TF32 products read ~4x the rounding of
// float32 against a limit that leaves 1.9x room.
//
// Design. A field is independent of every other, dot products included, so
// one block owns one field for the whole solve and needs no grid barrier;
// the grid is chains x rows blocks, one block an SM (two waves of 132 at
// 192 fields). 250 of its 256 threads work, on a 25 x 10 thread grid:
// thread (ty, tx) owns the elements (ty + 25a, tx + 10b), a < 4, b < 10, of
// every field-shaped quantity, so 100 x 100 is covered with no padding.
// x, r and p stay in the owner's registers; in shared memory (223 KB):
//   cr, cc   the DCT bases, rows x rows and cols x cols
//   oms      the chain's omega
//   dinv     1 / (tau * sym + cbar), made once
//   W        a (rows + 2) x (cols + 2) tile with a zero border: p for the
//            matvec's nine points, then the preconditioner's work field
//   deg      the degree grid as bytes (neighbour counts, 0-8, exact)
// so the iterations read nothing from device memory. Each product gives a
// thread its 4 x 10 tile from one A value a row and one B value a column
// per k (14 shared loads, 40 FMAs; the compiler merges loads along k where
// they are contiguous). Two warps an SM sub-partition and a k loop
// unrolled 20 deep keep loads in flight behind the FMAs (on the H100 the
// solve took 8% longer unrolled 4 deep, 23% at 2 deep). Every buffer's row stride is 106 = 10 (mod 32): the 32 threads
// of a warp are 32 consecutive (ty, tx), so their own elements, and the
// nine points of the matvec, fall in 32 banks; a column read of 4 rows (10
// rows for cc') falls in 4 (10) banks. Every element is computed whether
// or not it lies in a smaller lattice's field (on addresses inside the
// buffers), and only stores and sums look: no branch splits the element
// loops, so the 40 elements' latency chains overlap.
//
// The four products of an apply, in the order of ops/stencil.py:
//   P1  W = cr @ W (W = r)     P2  W = (W @ cc') * dinv
//   P3  W = cr' @ W            P4  z = W @ cc   (kept in registers)
// each summed over k in order with one FMA a term, and written back in
// place after a barrier. The elementwise steps round as the torch ops do
// (separate products and sums, no contraction: __fmul_rn, __fadd_rn), but
// for P2's scaling, a product with the reciprocal rounded once where torch
// divides (one unit in the last place apart at most: an IEEE division a
// element would cost a call to its slow path's check on every one). The
// matvec adds its neighbours in the order of ops/stencil.py:matvec.
// Dot products: each thread sums its elements in a fixed order, then a
// fixed shuffle tree and the warps in order, so a field's bits do not
// depend on the other fields, the chain count or the launch.
//
// Launch count. Thread 0 of block 0 adds one to `launches` (a device
// counter owned by the wrapper), so a launch replayed from a captured CUDA
// graph is counted by the card, as an eager one is.
//
// Built without --use_fast_math: divisions, reciprocals and sqrtf are
// IEEE-rounded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTY = 25;                // thread rows
constexpr int kTX = 10;                // thread columns
constexpr int kWorkers = kTY * kTX;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMY = 4;                 // rows a thread owns: ty + 25a
constexpr int kMX = 10;                // columns a thread owns: tx + 10b
constexpr int kMaxSide = 100;          // lattice rows and columns at most
constexpr int kLD = 106;               // row stride of every buffer
constexpr int kSquare = kMaxSide * kLD;
constexpr int kTile = (kMaxSide + 2) * kLD;
constexpr size_t kSmemBytes =
    sizeof(float) * (4 * kSquare + kTile + kWarps) + kSquare;  // + deg bytes
constexpr float kTiny = 1e-30f;

static_assert(kTY * kMY == kMaxSide && kTX * kMX == kMaxSide,
              "the thread tiles cover the largest field");
static_assert(kWorkers <= kThreads && kThreads % 32 == 0, "whole warps");
static_assert(kLD >= kMaxSide + 2 && kLD % 32 == kTX, "conflict-free rows");
static_assert(kSmemBytes <= 232448, "one block fits an SM");

struct Params {
    const float* rhs;     // (fields, n)
    const float* x0;      // (fields, n)
    const float* omega;   // (chains, n)
    const float* tau;     // (chains)
    const float* deg;     // (R, C)
    const float* cr;      // (R, R)
    const float* cc;      // (C, C)
    const float* sym;     // (R, C)
    float* x;             // (fields, n)
    float* rel;           // (fields) or null
    unsigned long long* launches;
    int rows;             // right-hand sides a chain
    int R, C;             // lattice rows and columns
    int iters;
    int queen;            // 8 neighbours (else 4)
    float rho;
};

typedef float Tile[kMY][kMX];

// Sum of v over the block, the same bits in every thread: a fixed shuffle
// tree in each warp, then the warps in order. Its first barrier also ends
// every shared read made before the call.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w];
    return s;
}

// acc[a][b] = sum_k A(i_a, k) B(k, j_b) over k < K, with A(i, k) at
// A[i * AI + k * AK] and B(k, j) at B[k * BK + j * BJ], i_a = ty + 25a and
// j_b = tx + 10b; A and B point at (ty, 0) and (0, tx).
template <int AI, int AK, int BK, int BJ>
__device__ __forceinline__ void product(const float* A, const float* B,
                                        int K, Tile& acc) {
#pragma unroll
    for (int a = 0; a < kMY; ++a)
#pragma unroll
        for (int b = 0; b < kMX; ++b) acc[a][b] = 0.0f;
#pragma unroll 20
    for (int k = 0; k < K; ++k) {
        float av[kMY], bv[kMX];
#pragma unroll
        for (int a = 0; a < kMY; ++a) av[a] = A[a * kTY * AI + k * AK];
#pragma unroll
        for (int b = 0; b < kMX; ++b) bv[b] = B[k * BK + b * kTX * BJ];
#pragma unroll
        for (int a = 0; a < kMY; ++a)
#pragma unroll
            for (int b = 0; b < kMX; ++b)
                acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
}

__device__ __forceinline__ float clamp_tiny(float d) {
    return d < kTiny ? kTiny : d;  // NaN stays NaN, as torch.clamp
}

// The thread's own elements: (a, b) -> (i, j), whether (i, j) lies in the
// field (`ok`), and its index in a global (R, C) array (0 outside it).
#define OWN                                                \
    _Pragma("unroll") for (int a = 0; a < kMY; ++a)       \
    _Pragma("unroll") for (int b = 0; b < kMX; ++b)        \
    if (const int i = ty + kTY * a, j = tx + kTX * b,      \
        ok = i < rmax && j < C, s = ok ? i * C + j : 0;    \
        true)

__global__ void __launch_bounds__(kThreads, 1)
stencil_pcg_kernel(const Params P) {
    extern __shared__ float smem[];
    float* cr = smem;
    float* cc = cr + kSquare;
    float* oms = cc + kSquare;
    float* dinv = oms + kSquare;
    float* tile = dinv + kSquare;
    float* red = tile + kTile;
    uint8_t* deg = (uint8_t*)(red + kWarps);
    float* W = tile + kLD + 1;  // W[i * kLD + j] is field element (i, j)

    const int tid = threadIdx.x;
    const bool worker = tid < kWorkers;
    const int ty = worker ? tid / kTX : 0, tx = worker ? tid % kTX : 0;
    const int field = blockIdx.x;
    const int chain = field / P.rows;
    const int R = P.R, C = P.C, n = R * C;
    const int rmax = worker ? R : 0;  // an idle thread owns nothing
    const bool queen = P.queen != 0;
    const float rho = P.rho;
    const float tau = P.tau[chain];
    if (field == 0 && tid == 0) atomicAdd(P.launches, 1ULL);

    for (int e = tid; e < R * R; e += kThreads)
        cr[(e / R) * kLD + e % R] = P.cr[e];
    for (int e = tid; e < C * C; e += kThreads)
        cc[(e / C) * kLD + e % C] = P.cc[e];
    for (int e = tid; e < kTile; e += kThreads) tile[e] = 0.0f;
    for (int e = tid; e < kSquare; e += kThreads) dinv[e] = 0.0f;
    const float* __restrict__ om = P.omega + (size_t)chain * n;
    float part = 0.0f;
    for (int e = tid; e < n; e += kThreads) {
        const int at = (e / C) * kLD + e % C;
        oms[at] = om[e];
        deg[at] = (uint8_t)P.deg[e];  // a neighbour count, 0-8
        part += om[e];
    }
    // block_sum's barriers also publish the staged and zeroed buffers
    const float cbar = __fdiv_rn(block_sum(part, red), (float)n);

    // A v at element (i, j) from W: tau * (deg * g - rho * nbrs) + om * g,
    // the neighbours in the order of ops/stencil.py:matvec
    auto apply_a = [&](int i, int j) {
        const float* c = W + i * kLD + j;
        float acc = c[-1] + c[1];
        acc += c[-kLD];
        acc += c[kLD];
        if (queen) {
            acc += c[-kLD - 1];
            acc += c[kLD + 1];
            acc += c[-kLD + 1];
            acc += c[kLD - 1];
        }
        const float g = c[0];
        const float d = (float)deg[i * kLD + j];
        const float q = __fsub_rn(__fmul_rn(d, g), __fmul_rn(rho, acc));
        return __fadd_rn(__fmul_rn(tau, q), __fmul_rn(oms[i * kLD + j], g));
    };

    Tile r, p, x, acc;
    const float* __restrict__ x0 = P.x0 + (size_t)field * n;
    OWN {
        x[a][b] = x0[s];
        if (ok) {
            dinv[i * kLD + j] =
                __frcp_rn(__fadd_rn(__fmul_rn(tau, P.sym[s]), cbar));
            W[i * kLD + j] = x[a][b];
        }
    }
    __syncthreads();
    const float* __restrict__ b_in = P.rhs + (size_t)field * n;
    float bb = 0.0f;
    OWN {
        const float bv = b_in[s];
        bb = __fadd_rn(bb, ok ? __fmul_rn(bv, bv) : 0.0f);
        r[a][b] = __fsub_rn(bv, apply_a(i, j));
    }
    bb = block_sum(bb, red);

    // z = M^-1 r into acc, from W = r; every earlier read of W is done
    auto precond = [&]() {
        OWN {
            if (ok) W[i * kLD + j] = r[a][b];
        }
        __syncthreads();
        product<kLD, 1, kLD, 1>(cr + ty * kLD, W + tx, R, acc);
        __syncthreads();
        OWN {
            if (ok) W[i * kLD + j] = acc[a][b];
        }
        __syncthreads();
        product<kLD, 1, 1, kLD>(W + ty * kLD, cc + tx * kLD, C, acc);
        __syncthreads();
        OWN {
            if (ok) W[i * kLD + j] = __fmul_rn(acc[a][b], dinv[i * kLD + j]);
        }
        __syncthreads();
        product<1, kLD, kLD, 1>(cr + ty, W + tx, R, acc);
        __syncthreads();
        OWN {
            if (ok) W[i * kLD + j] = acc[a][b];
        }
        __syncthreads();
        product<kLD, 1, kLD, 1>(W + ty * kLD, cc + tx, C, acc);
    };
    // r . z, then p = z + beta * p onto W (p = z at the start); the sum's
    // first barrier ends P4's reads of W
    auto next_p = [&](bool start, float& rz) {
        float sum = 0.0f;
        OWN {
            sum = __fadd_rn(sum, ok ? __fmul_rn(r[a][b], acc[a][b]) : 0.0f);
        }
        const float rz_new = block_sum(sum, red);
        const float beta = start ? 0.0f : __fdiv_rn(rz_new, clamp_tiny(rz));
        OWN {
            p[a][b] = start ? acc[a][b]
                            : __fadd_rn(acc[a][b], __fmul_rn(beta, p[a][b]));
            if (ok) W[i * kLD + j] = p[a][b];
        }
        rz = rz_new;
        __syncthreads();
    };

    float rz = 0.0f;
    precond();
    next_p(true, rz);

    for (int it = 0; it < P.iters; ++it) {
        float pap = 0.0f;
        OWN {
            acc[a][b] = apply_a(i, j);
            pap = __fadd_rn(pap, ok ? __fmul_rn(p[a][b], acc[a][b]) : 0.0f);
        }
        const float alpha = __fdiv_rn(rz, clamp_tiny(block_sum(pap, red)));
        OWN {
            x[a][b] = __fadd_rn(x[a][b], __fmul_rn(alpha, p[a][b]));
            r[a][b] = __fsub_rn(r[a][b], __fmul_rn(alpha, acc[a][b]));
        }
        precond();
        next_p(false, rz);
    }

    float* x_out = P.x + (size_t)field * n;
    float rr = 0.0f;
    OWN {
        if (ok) x_out[s] = x[a][b];
        rr = __fadd_rn(rr, ok ? __fmul_rn(r[a][b], r[a][b]) : 0.0f);
    }
    if (P.rel != nullptr) {
        rr = block_sum(rr, red);
        if (tid == 0) P.rel[field] = sqrtf(__fdiv_rn(rr, clamp_tiny(bb)));
    }
}

#undef OWN

}  // namespace

// Returns a CUDA error code (0 on success). All pointers are device
// pointers to contiguous float32 but for `launches`, one uint64 the launch
// adds 1 to; `rel` may be null (no residual). rhs, x0 and x are (chains *
// rows, R * C), omega (chains, R * C), tau (chains), deg and sym (R, C), cr
// (R, R), cc (C, C). 1 <= R, C <= 100; chains * rows below 2^31.
extern "C" int stencil_pcg_launch(const void* rhs, const void* x0,
                                  const void* omega, const void* tau,
                                  const void* deg, const void* cr,
                                  const void* cc, const void* sym, void* x,
                                  void* rel, void* launches, int chains,
                                  int rows, int R, int C, int iters,
                                  int queen, float rho, void* stream) {
    if (chains == 0 || rows == 0) return 0;
    if (chains < 0 || rows < 0 || iters < 0 || R < 1 || C < 1
        || R > kMaxSide || C > kMaxSide
        || (long long)chains * rows >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    // the shared-memory opt-in, once a device (outside any capture: the
    // wrapper's launch counter makes the first launch on a device eager)
    static bool opted[64] = {};
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
        err = cudaFuncSetAttribute(stencil_pcg_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemBytes);
        if (err != cudaSuccess) return (int)err;
        opted[dev] = true;
    }
    Params P;
    P.rhs = (const float*)rhs;
    P.x0 = (const float*)x0;
    P.omega = (const float*)omega;
    P.tau = (const float*)tau;
    P.deg = (const float*)deg;
    P.cr = (const float*)cr;
    P.cc = (const float*)cc;
    P.sym = (const float*)sym;
    P.x = (float*)x;
    P.rel = (float*)rel;
    P.launches = (unsigned long long*)launches;
    P.rows = rows;
    P.R = R;
    P.C = C;
    P.iters = iters;
    P.queen = queen;
    P.rho = rho;
    stencil_pcg_kernel<<<chains * rows, kThreads, kSmemBytes,
                         (cudaStream_t)stream>>>(P);
    return (int)cudaGetLastError();
}

extern "C" const char* stencil_pcg_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
