// Fixed-iteration preconditioned CG in the eigenbasis of the ICAR precision.
//
// Replaces the Pallas kernel occuspytial_tpu/ops/pallas_cg.py:_cg_kernel
// (launched by _cg_batched via _make_fused / icar_cg_solve_fused). For each
// chain it solves (tau*Q + diag(omega)) X = RHS for the chain's stacked
// right-hand-side rows, with Q = U S U':
//   operator        A v = tau*S*v + U'(omega o (U v))
//   preconditioner  M^-1 r = r / (tau*S + mean(omega))
//   warm start      x0 in the eigenbasis
// and returns the site solution U x, the eigenbasis solution x and the
// per-chain residual max_rows ||r_k|| / ||U' rhs||, the contract of
// ops/cg.py:icar_cg_solve_spectral(..., return_resid=True). The clamps
// max(denominator, 1e-30) are those of the JAX ops/cg.py:pcg, tau*S stays an
// exact elementwise term and every sum accumulates in float32, so a stiff
// tau (1e4) stays stable.
//
// Design. Like the TPU kernel, the solve is one (chains * rows, n) row batch
// against one U: every matrix product of the iteration is a tiled float32
// product of that batch with U or U', and the whole solve is ONE cooperative
// launch whose phases are separated by grid-wide barriers:
//   start   b = rhs U (and ||b||^2), w = omega o (x0 U'), mean(omega)
//           r = b - (tau*S*x0 + w U), p = M^-1 r, r.z
//   each iteration
//     S1    w  = omega o (p U')                        [tiles]
//     S2    Ap = tau*S*p + w U, and p.Ap               [tiles]
//     S3    alpha, x, r, r.z, beta, p                  [one warp per row]
//   end     x_site = x U', per-chain residual
// A tile is 48 rows x 64 columns of the output; the grid is persistent and
// walks the tiles (128 of them at 64 chains x 6 rows x n = 1000, one per SM).
// Each k-slice of 32 is staged in shared memory by cp.async through a
// 4-stage ring, so one staged tile of U feeds 48 rows, which belong to
// several chains. The vectors r, p, Ap, w and x live in global memory, where
// they stay in the L2 cache.
//
// The products run on the tensor cores at float32 accuracy ("3xTF32"): each
// operand is split into a TF32 head and a TF32 remainder, a = hi + lo, and
// lo*hi + hi*lo + hi*hi is accumulated in float32 by mma.sync m16n8k8, small
// terms first; what is dropped is ~2^-21 of a product, the size of float32
// rounding. The 8 warps of a block form 4 k-groups (each takes 8 of
// a slice's 32 k) of 2 warps (each takes all 48 rows and 32 of the 64
// columns: 3 x 4 mma tiles, 48 accumulators a thread). Fragments are read
// from shared memory by conflict-free 4-byte loads in which every lane gets
// its own element. The four groups' sums are added in a fixed order through
// shared memory, from which all 256 threads run the epilogue on 4
// consecutive columns each.
//
// Order of sums. Every output element is summed over k in one fixed order
// that depends on n alone. Row dot products are reduced per (row, column
// tile) in a fixed order inside the tile's epilogue, written to global
// memory and summed in tile order after the barrier; the row pass uses one
// warp per row. There are no floating-point atomics. A row's results
// therefore depend on that row's chain alone: they are bit-identical from
// launch to launch, whatever the other chains hold and whatever the chain
// count (and so the tiling of rows, and the grid) is.
//
// What bounds it on the card: operations (2 n^2 multiply-adds per row and
// product, 2 (iters + 1) + 2 products per solve; three tensor-core
// operations for each) against ~10 MB of compulsory traffic. Shapes off the
// tile grid are zero-filled in shared memory (cp.async with a short source),
// never read past a row. When n is not a multiple of 4, or a tensor is not
// 16-byte aligned, the tiles are staged by 4-byte copies instead of 16-byte
// ones.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 48;       // output rows per tile
constexpr int kBN = 64;       // output columns per tile
constexpr int kBK = 32;       // k-slice per pipeline stage
constexpr int kStages = 4;    // depth of the cp.async ring
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 4;    // k-groups a block's warps form
constexpr int kLd = kBK + 4;   // row stride of k-contiguous shared tiles
constexpr int kLdB = kBN + 8;  // row stride of the n-contiguous U tile
constexpr int kLdC = kBN + 8;  // row stride of the staged partial sums
constexpr int kAFloats = kBM * kLd;
constexpr int kBFloats = kBN * kLd;
constexpr int kStageFloats = kAFloats + kBFloats;
constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);
constexpr int kBlocksPerSM = 1;
constexpr float kTiny = 1e-30f;

static_assert(kBK * kLdB <= kBFloats, "the n-contiguous tile fits its slot");
static_assert(kGroups * kBM * kLdC <= kStages * kStageFloats,
              "the partial sums fit the ring");
static_assert(kBM == 48 && kBN == 64 && kBK == 32 && kThreads == 256,
              "the thread layouts below are written for these sizes");

struct Params {
    const float* U;
    const float* S;
    const float* rhs;
    const float* x0;
    const float* omega;
    const float* tau;
    float* x_site;
    float* x_spec;
    float* rel;
    // scratch, written and read inside the launch
    float* r;         // residual (first: the eigenbasis rhs b)
    float* p;         // search direction
    float* ap;        // operator applied to p
    float* w;         // site-basis scratch
    float* part_bb;   // per (row, column tile) partial ||b||^2
    float* part_rz;   // ... partial r.z of the start
    float* part_pap;  // ... partial p.Ap
    float* rz;        // per row r.z
    float* ratio;     // per row ||r||^2 / ||b||^2
    float* cbar;      // per chain mean(omega)
    unsigned long long* launches;  // the launch adds 1 (block 0, thread 0)
    int chains, rows, n, iters, M, tiles_m, tiles_n;
};

enum Epilogue { kSiteScale, kSitePlain, kRhs, kInit, kAp };

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const size_t s = __cvta_generic_to_global(src);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(s), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const size_t s = __cvta_generic_to_global(src);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(s), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages 4 floats at dst: the first `valid` from src, the rest zero. With
// valid == 0 nothing is read; `safe` is then the (unused) source address.
template <bool VEC>
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       const float* safe, int valid) {
    if (VEC) {
        cp_async16(dst, valid > 0 ? src : safe, 4 * valid);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            cp_async4(dst + e, e < valid ? src + e : safe, e < valid ? 4 : 0);
    }
}

__device__ __forceinline__ int valid4(int limit, int at) {
    return min(4, max(0, limit - at));
}

// Runs `compute(stage, prefetch)` on every k-slice of the product of rows
// m0.. of A (M, n) with the column tile n0.. of U (TRANS: of U'), the slices
// staged through the cp.async ring; on return every thread is past its last
// read of the ring. A stage holds the A tile as [row][k] (row stride kLd) and
// the U tile as [col][k] (TRANS, row stride kLd) or [k][col] (row stride
// kLdB). Every thread copies the same (at most 4) 4-float pieces of every
// slice, so their addresses are worked out once, before the loop.
template <bool TRANS, bool VEC, typename Compute>
__device__ __forceinline__ void pipeline(const float* A, const float* U,
                                         int M, int n, int m0, int n0,
                                         float* sm, Compute compute) {
    const int nk = (n + kBK - 1) / kBK;
    const int tid = threadIdx.x;
    // k-contiguous pieces: 8 to a row; A has 48 rows (1.5 pieces a thread),
    // the U' tile 64 (2 a thread). limit: k from which a piece is cut
    // short, or 0 when its row is outside the matrix.
    const float* ka_src[4];
    int ka_dst[4], ka_lim[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const bool is_a = i < 2;
        const int id = tid + (i & 1) * kThreads;
        const int row = id >> 3, kc = (id & 7) * 4;
        const int g_row = (is_a ? m0 : n0) + row;
        const bool ok = is_a ? (row < kBM && g_row < M) : g_row < n;
        const float* base = is_a ? A : U;
        ka_src[i] = ok ? base + (size_t)g_row * n + kc : base;
        ka_dst[i] = (is_a ? 0 : kAFloats) + row * kLd + kc;
        ka_lim[i] = ok ? n - kc : 0;
    }
    // n-contiguous pieces of the U tile: 16 to a row of 64, 2 a thread
    const float* nb_src[2];
    int nb_dst[2], nb_cols[2], nb_row[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int id = tid + i * kThreads;
        const int krow = id >> 4, nc = (id & 15) * 4;
        nb_cols[i] = valid4(n, n0 + nc);
        nb_src[i] = nb_cols[i] > 0 ? U + (size_t)krow * n + n0 + nc : U;
        nb_dst[i] = kAFloats + krow * kLdB + nc;
        nb_row[i] = krow;
    }
    auto load_stage = [&](int kt) {
        float* st = sm + (kt % kStages) * kStageFloats;
        const int k0 = kt * kBK;
#pragma unroll
        for (int i = 0; i < (TRANS ? 4 : 2); ++i) {
            if (i == 1 && tid >= kBM * 8 - kThreads) continue;
            const int valid = valid4(ka_lim[i], k0);
            stage4<VEC>(st + ka_dst[i], ka_src[i] + (valid > 0 ? k0 : 0),
                        ka_src[i], valid);
        }
        if (!TRANS) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int valid = k0 + nb_row[i] < n ? nb_cols[i] : 0;
                stage4<VEC>(st + nb_dst[i],
                            nb_src[i] + (valid > 0 ? (size_t)k0 * n : 0),
                            nb_src[i], valid);
            }
        }
    };
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) load_stage(s);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // slice kt has landed; slice kt - 1 is consumed
        // compute calls this once, after its own shared-memory loads: the
        // copies of a slice keep the load pipe busy for about as long as
        // its arithmetic takes, and loads queued behind them would wait
        auto prefetch = [&]() {
            if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1);
            cp_async_commit();
        };
        compute(sm + (kt % kStages) * kStageFloats, prefetch);
    }
    cp_async_wait<0>();
    __syncthreads();
}

// x ~ hi + lo, both TF32 numbers (float32 bits with the low 13 mantissa
// bits clear): hi is x rounded to nearest at 10 mantissa bits, lo the exact
// float32 remainder cut to 10 bits, so |x - hi - lo| <= 2^-21 |x|. Integer
// arithmetic on the bits; cvt.rna.tf32.f32 computes the same hi but runs
// at a fraction of the rate.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tile's product on the tensor cores; leaves each k-group's partial
// sums in sm[group][row][col] (row stride kLdC).
//   TRANS:  B[k, col] = U[n0 + col, k]   (A U')
//   else :  B[k, col] = U[k, n0 + col]   (A U)
template <bool TRANS, bool VEC>
__device__ __forceinline__ void product(const float* A, const float* U,
                                        int M, int n, int m0, int n0,
                                        float* sm) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
    const int kg = (warp >> 1) * 8;          // this k-group's 8 of the slice
    const int nh = (warp & 1) * 32;          // this warp's half of the columns
    float acc[3][4][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    pipeline<TRANS, VEC>(A, U, M, n, m0, n0, sm, [&](const float* as,
                                                     auto prefetch) {
        const float* bs = as + kAFloats;
        float af[3][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const float* a0 = as + (16 * i + g) * kLd + kg + t;
            af[i][0] = a0[0];
            af[i][1] = a0[8 * kLd];
            af[i][2] = a0[4];
            af[i][3] = a0[8 * kLd + 4];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = nh + 8 * j + g;
            const float* b0 = TRANS ? bs + col * kLd + kg + t
                                    : bs + (kg + t) * kLdB + col;
            bf[j][0] = b0[0];
            bf[j][1] = b0[TRANS ? 4 : 4 * kLdB];
        }
        prefetch();
        uint32_t ah[3][4], al[3][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                split_tf32(af[i][e], ah[i][e], al[i][e]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                split_tf32(bf[j][e], bh[j][e], bl[j][e]);
        // small terms first; consecutive mma write different accumulators
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    });

    float* mine = sm + (warp >> 1) * kBM * kLdC;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float* at = mine + (16 * i + g) * kLdC + nh + 8 * j + 2 * t;
            *reinterpret_cast<float2*>(at) =
                make_float2(acc[i][j][0], acc[i][j][1]);
            *reinterpret_cast<float2*>(at + 8 * kLdC) =
                make_float2(acc[i][j][2], acc[i][j][3]);
        }
    __syncthreads();
}

// Sum over the 16 threads that share a tile row (half a warp), fixed order.
__device__ __forceinline__ float row_threads_sum(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// v[0 .. cnt) = src[0 .. cnt), the rest 0; with VEC, cnt is 0 or 4 and src
// is 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void load4(const float* src, int cnt,
                                      float (&v)[4]) {
    if (VEC) {
        const float4 q = cnt > 0 ? *reinterpret_cast<const float4*>(src)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = e < cnt ? src[e] : 0.0f;
    }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* dst, int cnt,
                                       const float (&v)[4]) {
    if (VEC) {
        if (cnt > 0)
            *reinterpret_cast<float4*>(dst) =
                make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (e < cnt) dst[e] = v[e];
    }
}

// One output tile: the product, then the phase's elementwise work and,
// where the phase needs a row dot product, the tile's partial of it. In the
// epilogue thread (ty, tx) owns rows ty, ty + 16, ty + 32 and the 4 columns
// from 4 tx.
template <int EPI, bool VEC>
__device__ __noinline__ void tile(const Params& P, const float* A, float* sm,
                                  int job) {
    constexpr bool kTrans = EPI == kSiteScale || EPI == kSitePlain;
    constexpr bool kDot = EPI == kRhs || EPI == kInit || EPI == kAp;
    const int tm = job / P.tiles_n, tn = job - tm * P.tiles_n;
    const int m0 = tm * kBM, n0 = tn * kBN, n = P.n;
    product<kTrans, VEC>(A, P.U, P.M, n, m0, n0, sm);

    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int j = n0 + 4 * tx;
    const int cols = valid4(n, j);
#pragma unroll
    for (int rr = 0; rr < 3; ++rr) {
        const int row = ty + 16 * rr, m = m0 + row;
        const bool row_ok = m < P.M;
        const int cnt = row_ok ? cols : 0;
        const int chain = row_ok ? m / P.rows : 0;
        const size_t at = (size_t)m * n + j;
        // the k-groups' partial sums, in group order
        float v[4];
        {
            const float* part = sm + row * kLdC + 4 * tx;
            float4 q = *reinterpret_cast<const float4*>(part);
#pragma unroll
            for (int grp = 1; grp < kGroups; ++grp) {
                const float4 o = *reinterpret_cast<const float4*>(
                    part + grp * kBM * kLdC);
                q.x += o.x, q.y += o.y, q.z += o.z, q.w += o.w;
            }
            v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
        }
        float dot = 0.0f;
        if (cnt > 0) {
            if (EPI == kSiteScale) {
                float om[4];
                load4<VEC>(P.omega + (size_t)chain * n + j, cnt, om);
#pragma unroll
                for (int e = 0; e < 4; ++e) v[e] *= om[e];
                store4<VEC>(P.w + at, cnt, v);
            } else if (EPI == kSitePlain) {
                store4<VEC>(P.x_site + at, cnt, v);
            } else if (EPI == kRhs) {
                store4<VEC>(P.r + at, cnt, v);
#pragma unroll
                for (int e = 0; e < 4; ++e) dot += v[e] * v[e];
            } else if (EPI == kInit) {
                const float tc = P.tau[chain], cb = P.cbar[chain];
                float sv[4], xv[4], rv[4], zv[4];
                load4<VEC>(P.S + j, cnt, sv);
                load4<VEC>(P.x0 + at, cnt, xv);
                load4<VEC>(P.r + at, cnt, rv);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float ts = tc * sv[e];
                    rv[e] = rv[e] - (ts * xv[e] + v[e]);
                    zv[e] = (1.0f / (ts + cb)) * rv[e];
                    if (e < cnt) dot += rv[e] * zv[e];
                }
                store4<VEC>(P.r + at, cnt, rv);
                store4<VEC>(P.p + at, cnt, zv);
            } else {
                const float tc = P.tau[chain];
                float sv[4], pv[4];
                load4<VEC>(P.S + j, cnt, sv);
                load4<VEC>(P.p + at, cnt, pv);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    v[e] = tc * sv[e] * pv[e] + v[e];
                    dot += pv[e] * v[e];
                }
                store4<VEC>(P.ap + at, cnt, v);
            }
        }
        if (kDot) {
            dot = row_threads_sum(dot);
            float* parts = EPI == kRhs    ? P.part_bb
                           : EPI == kInit ? P.part_rz
                                          : P.part_pap;
            if (tx == 0 && row_ok) parts[(size_t)m * P.tiles_n + tn] = dot;
        }
    }
    __syncthreads();  // the next tile reuses the shared memory
}

template <int EPI, bool VEC>
__device__ __forceinline__ void tiles(const Params& P, const float* A,
                                      float* sm) {
    const int total = P.tiles_m * P.tiles_n;
    for (int job = blockIdx.x; job < total; job += gridDim.x)
        tile<EPI, VEC>(P, A, sm, job);
}

__device__ __forceinline__ float sum_parts(const float* parts, int m,
                                           int tiles_n) {
    float s = 0.0f;
    for (int tn = 0; tn < tiles_n; ++tn) s += parts[(size_t)m * tiles_n + tn];
    return s;
}

// The vector part of iteration `it`, one warp per row: alpha from p.Ap,
// x and r, the new r.z, beta and p. `update` false (iters == 0) only copies
// x0. On the last pass the row's ||r||^2 / ||b||^2 is left in P.ratio. A
// lane takes every 32nd element, kBatch of them at a time: all of a batch's
// loads come before its first store, so that they overlap.
constexpr int kBatch = 8;

__device__ __forceinline__ void row_pass(const Params& P, int it, bool update,
                                         bool last) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n = P.n;
    for (int m = blockIdx.x + gridDim.x * warp; m < P.M;
         m += gridDim.x * kWarps) {
        const int chain = m / P.rows;
        const float tc = P.tau[chain], cb = P.cbar[chain];
        const size_t base = (size_t)m * n;
        const float* xin = (it == 0 ? P.x0 : P.x_spec) + base;
        float* x = P.x_spec + base;
        float* r = P.r + base;
        float* p = P.p + base;
        const float* ap = P.ap + base;
        float rz = 0.0f, alpha = 0.0f, rz_new = 0.0f, rr2 = 0.0f;
        if (update) {
            rz = it == 0 ? sum_parts(P.part_rz, m, P.tiles_n) : P.rz[m];
            alpha = rz / fmaxf(sum_parts(P.part_pap, m, P.tiles_n), kTiny);
        }
        for (int j0 = lane; j0 < n; j0 += 32 * kBatch) {
            float pv[kBatch], xv[kBatch], rv[kBatch], av[kBatch], sv[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int j = j0 + 32 * u;
                const bool ok = j < n;
                xv[u] = ok ? xin[j] : 0.0f;
                rv[u] = ok ? r[j] : 0.0f;
                pv[u] = ok && update ? p[j] : 0.0f;
                av[u] = ok && update ? ap[j] : 0.0f;
                sv[u] = ok && update ? P.S[j] : 1.0f;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int j = j0 + 32 * u;
                if (j >= n) continue;
                const float rr = update ? rv[u] - alpha * av[u] : rv[u];
                x[j] = update ? xv[u] + alpha * pv[u] : xv[u];
                if (update) {
                    r[j] = rr;
                    rz_new += rr * ((1.0f / (tc * sv[u] + cb)) * rr);
                }
                rr2 += rr * rr;
            }
        }
        if (update && !last) {
            rz_new = warp_sum(rz_new);
            const float beta = rz_new / fmaxf(rz, kTiny);
            for (int j0 = lane; j0 < n; j0 += 32 * kBatch) {
                float pv[kBatch], rv[kBatch], sv[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int j = j0 + 32 * u;
                    const bool ok = j < n;
                    rv[u] = ok ? r[j] : 0.0f;
                    pv[u] = ok ? p[j] : 0.0f;
                    sv[u] = ok ? P.S[j] : 1.0f;
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int j = j0 + 32 * u;
                    if (j < n)
                        p[j] = (1.0f / (tc * sv[u] + cb)) * rv[u]
                               + beta * pv[u];
                }
            }
            if (lane == 0) P.rz[m] = rz_new;
        }
        if (last) {
            rr2 = warp_sum(rr2);
            const float bb = sum_parts(P.part_bb, m, P.tiles_n);
            if (lane == 0) P.ratio[m] = rr2 / fmaxf(bb, kTiny);
        }
    }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
icar_cg_kernel(const __grid_constant__ Params P) {
    extern __shared__ __align__(16) float sm[];
    cg::grid_group grid = cg::this_grid();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int total = P.tiles_m * P.tiles_n;
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(P.launches, 1ULL);

    // b = rhs U with ||b||^2, w = omega o (x0 U'), and mean(omega)
    for (int job = blockIdx.x; job < 2 * total; job += gridDim.x) {
        if (job < total)
            tile<kRhs, VEC>(P, P.rhs, sm, job);
        else
            tile<kSiteScale, VEC>(P, P.x0, sm, job - total);
    }
    for (int c = blockIdx.x * kWarps + warp; c < P.chains;
         c += gridDim.x * kWarps) {
        float s = 0.0f;
        for (int j = lane; j < P.n; j += 32) s += P.omega[(size_t)c * P.n + j];
        s = warp_sum(s);
        if (lane == 0) P.cbar[c] = s / (float)P.n;
    }
    grid.sync();
    // r = b - A x0, p = z = M^-1 r, r.z
    tiles<kInit, VEC>(P, P.w, sm);
    grid.sync();

    for (int it = 0; it < P.iters; ++it) {
        tiles<kSiteScale, VEC>(P, P.p, sm);
        grid.sync();
        tiles<kAp, VEC>(P, P.w, sm);
        grid.sync();
        row_pass(P, it, true, it == P.iters - 1);
        grid.sync();
    }
    if (P.iters == 0) {
        row_pass(P, 0, false, true);
        grid.sync();
    }

    tiles<kSitePlain, VEC>(P, P.x_spec, sm);
    for (int c = blockIdx.x * kThreads + threadIdx.x; c < P.chains;
         c += gridDim.x * kThreads) {
        float worst = 0.0f;
        for (int q = 0; q < P.rows; ++q)
            worst = fmaxf(worst, P.ratio[(size_t)c * P.rows + q]);
        P.rel[c] = sqrtf(worst);
    }
}

size_t round4(size_t v) { return (v + 3) / 4 * 4; }

int tiles_of(int v, int tile) { return (v + tile - 1) / tile; }

// Blocks a cooperative launch of `kernel` may hold per SM times the SM
// count, from the occupancy query (cached per device); 0 with *err set when
// the device cannot run it.
template <bool VEC>
int max_grid(cudaError_t* err) {
    static int cached[64] = {0};
    int dev = 0;
    *err = cudaGetDevice(&dev);
    if (*err != cudaSuccess) return 0;
    if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
    *err = cudaFuncSetAttribute(icar_cg_kernel<VEC>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes);
    if (*err != cudaSuccess) return 0;
    int coop = 0, sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (*err != cudaSuccess) return 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, icar_cg_kernel<VEC>, kThreads, kSmemBytes);
    if (*err != cudaSuccess) return 0;
    if (!coop) {
        *err = cudaErrorNotSupported;
        return 0;
    }
    if (per_sm < 1) {
        *err = cudaErrorLaunchOutOfResources;
        return 0;
    }
    const int grid = sms * std::min(per_sm, kBlocksPerSM);
    if (dev >= 0 && dev < 64) cached[dev] = grid;
    return grid;
}

template <bool VEC>
int launch(Params P, cudaStream_t stream) {
    cudaError_t err = cudaSuccess;
    const int limit = max_grid<VEC>(&err);
    if (err != cudaSuccess) return (int)err;
    // the start phase has the most jobs: two products' tiles
    const long long jobs = 2LL * P.tiles_m * P.tiles_n;
    const int grid = (int)(jobs < limit ? jobs : limit);
    void* args[] = {&P};
    err = cudaLaunchCooperativeKernel((void*)icar_cg_kernel<VEC>, dim3(grid),
                                      dim3(kThreads), args, kSmemBytes,
                                      stream);
    return (int)err;
}

}  // namespace

// Floats of scratch a solve of `chains` x `rows` rows of length n needs.
extern "C" long long icar_cg_scratch_floats(int chains, int rows, int n) {
    const size_t M = (size_t)chains * rows;
    const size_t tn = tiles_of(n, kBN);
    return (long long)(4 * round4(M * n) + 3 * round4(M * tn)
                       + 2 * round4(M) + round4(chains));
}

// Returns a CUDA error code (0 on success). All pointers are device
// pointers, to contiguous float32 but for `launches`, one uint64 the
// launch adds 1 to; `scratch` holds icar_cg_scratch_floats floats and is
// 16-byte aligned. chains * rows * n must stay below 2^31.
extern "C" int icar_cg_launch(const void* U, const void* S, const void* rhs,
                              const void* x0, const void* omega,
                              const void* tau, void* x_site, void* x_spec,
                              void* rel, void* scratch, void* launches,
                              int chains, int rows, int n, int iters,
                              void* stream) {
    if (chains == 0 || rows == 0 || n == 0) return 0;
    if (chains < 0 || rows < 0 || n < 0 || iters < 0
        || (long long)chains * rows * n >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    Params P;
    P.U = (const float*)U;
    P.S = (const float*)S;
    P.rhs = (const float*)rhs;
    P.x0 = (const float*)x0;
    P.omega = (const float*)omega;
    P.tau = (const float*)tau;
    P.x_site = (float*)x_site;
    P.x_spec = (float*)x_spec;
    P.rel = (float*)rel;
    P.launches = (unsigned long long*)launches;
    P.chains = chains;
    P.rows = rows;
    P.n = n;
    P.iters = iters;
    P.M = chains * rows;
    P.tiles_m = tiles_of(P.M, kBM);
    P.tiles_n = tiles_of(n, kBN);
    const size_t vec = round4((size_t)P.M * n);
    const size_t parts = round4((size_t)P.M * P.tiles_n);
    float* s = (float*)scratch;
    P.r = s;
    P.p = s + vec;
    P.ap = s + 2 * vec;
    P.w = s + 3 * vec;
    s += 4 * vec;
    P.part_bb = s;
    P.part_rz = s + parts;
    P.part_pap = s + 2 * parts;
    s += 3 * parts;
    P.rz = s;
    P.ratio = s + round4(P.M);
    P.cbar = s + 2 * round4(P.M);
    const uintptr_t bits = (uintptr_t)U | (uintptr_t)S | (uintptr_t)rhs
                           | (uintptr_t)x0 | (uintptr_t)omega
                           | (uintptr_t)x_site | (uintptr_t)x_spec
                           | (uintptr_t)scratch;
    const bool vec16 = n % 4 == 0 && bits % 16 == 0;
    cudaStream_t st = (cudaStream_t)stream;
    return vec16 ? launch<true>(P, st) : launch<false>(P, st);
}

extern "C" const char* icar_cg_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
