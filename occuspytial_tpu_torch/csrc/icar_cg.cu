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
// What bounds it on the card. Its bound is operations: a solve makes
// 2 (iters + 1) + 2 products of the (chains * rows, n) row batch with U or
// U' (n^2 multiply-adds a row each, three tensor-core operations for each
// of them, below) against ~10 MB of compulsory traffic. What binds it is
// the L2 cache and fixed costs: every 64-row tile reads both halves of its
// eigenbasis' column tile again, so a product at 64 chains x 6 rows x n =
// 1000 reads ~80 MB from L2 (20 KB a k-slice and block), and each phase
// pays its pipeline fill, its epilogue and a grid-wide barrier
// (scripts/torch_k3_anatomy.py takes a solve apart on the card).
//
// Design. Like the TPU kernel, the solve is one (chains * rows, n) row batch
// against one U, and the whole solve is ONE cooperative launch whose phases
// are separated by grid-wide barriers:
//   start   b = rhs U (and ||b||^2), w = omega o (x0 U'), mean(omega)
//           r = b - (tau*S*x0 + w U), p = M^-1 r, r.z
//   each iteration
//     S1    w  = omega o (p U')                        [tiles]
//     S2    Ap = tau*S*p + w U, and p.Ap               [tiles]
//     S3    alpha, x, r, r.z, beta, p                  [two warps a row]
//   end     x_site = x U', per-chain residual
// A tile is 64 rows (one wgmma) x 48 columns of a product's output; the
// grid is persistent and walks the tiles (126 of them at 64 chains x 6 rows
// x n = 1000, one wave on 132 SMs).
//
// Every product runs on wgmma.mma_async with TF32 operands, fed by TMA.
// wgmma takes TF32 only K-major, so both products read an eigenbasis stored
// with k contiguous: A U reads U' row-major, A U' reads U. The wrapper
// prepares them once (ops/cuda_cg.py:k3_operands): one (4, n, ld) tensor
// holding the TF32 head and remainder of U and of U', rows padded to ld =
// n rounded up to 4 floats (TMA's 16-byte row stride). Every other array
// the kernel reads or writes (rhs, x0, omega, S, the outputs and the
// scratch r, p, Ap, w, x) takes the same stride. Block roles: one producer
// warp whose lane 0 keeps k-slices of 32 floats (128 bytes, the 128-byte
// swizzle) of both operands in flight through an 8-stage ring of shared
// memory, each stage guarded by a full and an empty mbarrier; the A slice
// (64 x 32 of the vector batch) and the head and remainder of the B slice
// (2 x 48 x 32, one after the other) arrive by two cp.async.bulk.tensor
// copies, and the tensor maps' bounds are (n, rows) and (n, n), so the
// ragged edge is zero-filled by the copy and the row padding is never read.
// Two consumer warpgroups take alternate k-slices (warpgroup c the slices
// kt % 2 == c): each reads its slice of A from shared memory into
// registers (conflict-free 4-byte loads on the swizzled layout) and splits
// it into head and remainder there. Per 8 k it issues two wgmma with A in
// registers and B from shared memory: m64n48k8 for the A remainder times
// the B head, and m64n96k8 for the A head times the B head and remainder
// at once. The three sums meet at the end, small terms first: (lo*hi +
// hi*lo) + hi*hi ("3xTF32", float32 accuracy: what is dropped is ~2^-21 of
// a product). The two warpgroups' sums meet in shared memory, even slices
// + odd slices, and 256 consumer threads run the phase's epilogue, 4
// threads a row of the tile.
//
// Order of sums. Every output element is summed over k in one fixed order
// that depends on n alone: the k-slices, their split between the two
// warpgroups and the order of the products are the same for every row, and
// a wgmma's arithmetic for an output element does not depend on the row's
// place in the 64-row tile. Row dot products are reduced per (row, column
// tile) in a fixed order inside the tile's epilogue, written to global
// memory and summed in a fixed order after the barrier; the row pass sums a
// row over a fixed pair of warps. There are no floating-point atomics. A
// row's results therefore depend on that row's chain alone: they are
// bit-identical from launch to launch, whatever the other chains hold and
// whatever the chain count (and so the tiling of rows, and the grid) is.
//
// Writes made by ordinary stores that a later phase reads through TMA (w,
// p, x) are ordered by a proxy fence on both sides of the grid barrier. A
// wait on the ring that lasts 20 s traps instead of holding the card.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only; no driver library link
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 64;        // output rows per tile: one wgmma
constexpr int kBN = 48;        // output columns per tile: the wgmma's N
constexpr int kBK = 32;        // k per stage: 128 bytes of float
constexpr int kStages = 8;     // depth of the TMA ring
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kWarps = kThreads / 32;
constexpr int kABytes = kBM * kBK * 4;
constexpr int kBHalfBytes = kBN * kBK * 4;
constexpr int kStageBytes = kABytes + 2 * kBHalfBytes;
constexpr int kEpilogueThreads = 4 * kBM;  // 4 a row of the tile
constexpr int kLdC = kBN + 4;  // row stride of the staged sums
constexpr int kCFloats = kBM * kLdC;
constexpr int kSmemBytes = 1024 /* alignment slack */ + kStages * kStageBytes
                           + kConsumers * kCFloats * 4 + 2 * kStages * 8;
constexpr int kBlocksPerSM = 1;
constexpr float kTiny = 1e-30f;

static_assert(kABytes % 1024 == 0 && kBHalfBytes % 1024 == 0,
              "every operand tile starts on a 1024-byte swizzle period");
static_assert(kBK * 4 == 128, "a k-slice is one 128-byte swizzle row");
static_assert(kBN % 8 == 0 && kBN == 48 && kBM == 64,
              "the wgmma and epilogue layouts below are written for 64 x 48");
static_assert(kSmemBytes <= 232448, "fits one block's shared memory");

struct Params {
    // A operands: (M, n) at row stride ld; box 32 x 64
    CUtensorMap map_rhs, map_x0, map_p, map_w, map_x;
    // B operands: (4, n, n) at row stride ld (U head, U remainder, U'
    // head, U' remainder); box 32 x 48 x 2
    CUtensorMap map_u;
    // every array below at row stride ld and 16-byte aligned
    const float* S;      // (ld,)
    const float* x0;     // (M, ld)
    const float* omega;  // (chains, ld)
    const float* tau;
    float* x_site;  // (M, ld)
    float* x_spec;  // (M, ld)
    float* rel;
    // scratch, written and read inside the launch; vectors (M, ld)
    float* r;         // residual (first: the eigenbasis rhs b)
    float* p;         // search direction
    float* ap;        // operator applied to p
    float* w;         // site-basis scratch
    float* xs;        // the iterate x
    float* part_bb;   // per (row, column tile) partial ||b||^2
    float* part_rz;   // ... partial r.z of the start
    float* part_pap;  // ... partial p.Ap
    float* rz;        // per row r.z
    float* ratio;     // per row ||r||^2 / ||b||^2
    float* cbar;      // per chain mean(omega)
    unsigned long long* launches;  // the launch adds 1 (block 0, thread 0)
    int chains, rows, n, ld, iters, M, tiles_m, tiles_n;
};

enum Epilogue { kSiteScale, kSitePlain, kRhs, kInit, kAp };

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// Waits for the phase of `bar` with this parity to complete. A wait that
// lasts 20 s traps, so that a fault in the ring ends the launch with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_addr(bar);
    uint64_t since = 0;
    for (uint32_t polls = 1;; ++polls) {
        uint32_t done;
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
        if (done) return;
        if (polls % 4096 == 0) {
            const uint64_t now = global_ns();
            if (since == 0)
                since = now;
            else if (now - since > 20000000000ull)
                __trap();
        }
    }
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
        "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2,
                                       uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
        "r"(c1), "r"(c2)
        : "memory");
}

// orders this thread's ordinary global accesses with later (or earlier)
// accesses of the async proxy (TMA)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ float lds(uint32_t addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), the leading offset unused
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
    const uint64_t a = smem_addr(tile);
    return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A (64 x 8, in registers: the m16n8k8 layout, one 16-row slab a
// warp) x B (8 x 48, K-major in shared memory at `desc`), TF32 in, float32
// sums
__device__ __forceinline__ void wgmma_tf32(float (&d)[24],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += A (64 x 8, in registers) x B (8 x 96: rows 0-47 the head, 48-95 the
// remainder of a B slice, K-major in shared memory at `desc`)
__device__ __forceinline__ void wgmma_tf32_n96(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
          "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
          "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// x ~ hi + lo, both TF32 numbers (float32 bits with the low 13 mantissa
// bits clear): hi is x rounded to nearest at 10 mantissa bits, lo the exact
// float32 remainder cut to 10 bits, so |x - hi - lo| <= 2^-22 |x|. Integer
// arithmetic on the bits, the same as ops/cuda_cg.py:tf32_split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// ------------------------------------------------------------ the ring --

struct Ring {
    char* stages;     // kStages x kStageBytes, 1024-byte aligned
    uint64_t* full;   // TMA bytes landed (1 arrival + the transaction)
    uint64_t* empty;  // the consuming warpgroup's 4 warps are done
    float* sums;      // kConsumers x (kBM x kLdC) staged sums
};

__host__ __device__ __forceinline__ int tiles_of(int v, int tile) {
    return (v + tile - 1) / tile;
}

// The producer's part of one tile: every k-slice of the A rows m0.. and
// of the B rows n0.. (sel 0: U, for A U'; sel 2: U', for A U). `q` counts
// the slices this block has put through the ring, in every role alike.
__device__ __forceinline__ void produce(const Params& P, const Ring& R,
                                        const CUtensorMap* amap, int sel,
                                        int m0, int n0, uint32_t& q) {
    const int nk = tiles_of(P.n, kBK);
    for (int kt = 0; kt < nk; ++kt, ++q) {
        const int stage = q % kStages;
        const uint32_t parity = (q / kStages) & 1;
        mbar_wait(&R.empty[stage], parity ^ 1);
        char* st = R.stages + stage * kStageBytes;
        mbar_expect_tx(&R.full[stage], kStageBytes);
        tma_2d(st, amap, kt * kBK, m0, &R.full[stage]);
        tma_3d(st + kABytes, &P.map_u, kt * kBK, n0, sel, &R.full[stage]);
    }
}

// A consumer warpgroup's part of one tile's product: the sum over its
// k-slices (kt % kConsumers == wg), left in sums[wg] as [row][col].
// Per 8 k, one wgmma multiplies the A remainder by the B head (48
// columns) and one the A head by the B head and remainder together (96
// columns: the two halves of the slice lie one after the other); the
// three sums meet at the end, small terms first: (lo*hi + hi*lo) + hi*hi.
__device__ __forceinline__ void consume(const Params& P, const Ring& R,
                                        int wg, uint32_t& q) {
    const int nk = tiles_of(P.n, kBK);
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 16 * warp + g;  // rows r0 and r0 + 8 of the A slice
    float lh[24], hh[48];
#pragma unroll
    for (int i = 0; i < 24; ++i) lh[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 48; ++i) hh[i] = 0.0f;

    for (int kt = wg; kt < nk; kt += kConsumers) {
        const uint32_t at = q + kt;
        const int stage = at % kStages;
        mbar_wait(&R.full[stage], (at / kStages) & 1);
        const char* st = R.stages + stage * kStageBytes;
        // the A fragments of the slice's four 8-k steps: element (row, k)
        // of the swizzled tile sits at row * 128 + ((k / 4) ^ (row % 8))
        // * 16 + (k % 4) * 4; rows r0 and r0 + 8 share row % 8 == g, so
        // the 32 lanes of a load hit 32 banks
        const uint32_t a_row = smem_addr(st) + r0 * 128 + t * 4;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const uint32_t c_lo = a_row + ((2 * s) ^ g) * 16;
            const uint32_t c_hi = a_row + ((2 * s + 1) ^ g) * 16;
            split_tf32(lds(c_lo), ah[s][0], al[s][0]);
            split_tf32(lds(c_lo + 8 * 128), ah[s][1], al[s][1]);
            split_tf32(lds(c_hi), ah[s][2], al[s][2]);
            split_tf32(lds(c_hi + 8 * 128), ah[s][3], al[s][3]);
        }
        const char* b = st + kABytes;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            // 8 k are 32 bytes along the swizzled 128-byte row
            wgmma_tf32(lh, al[s], sw128_desc(b + 32 * s));
            wgmma_tf32_n96(hh, ah[s], sw128_desc(b + 32 * s));
        }
        wgmma_commit();
        wgmma_wait_all();
        __syncwarp();
        if (lane == 0) mbar_arrive(&R.empty[stage]);
    }
    q += nk;

    // accumulator layout: rows 16 warp + g (+ 8), columns 8 j + 2 t (+ 1);
    // hh's columns 48.. are the A head times the B remainder
    float* mine = R.sums + wg * kCFloats;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            v[e] = (lh[4 * j + e] + hh[24 + 4 * j + e]) + hh[4 * j + e];
        float* at0 = mine + r0 * kLdC + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(at0) = make_float2(v[0], v[1]);
        *reinterpret_cast<float2*>(at0 + 8 * kLdC) = make_float2(v[2], v[3]);
    }
}

// ------------------------------------------------------------ epilogue --

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

// The phase's elementwise work on one tile and, where the phase needs a row
// dot product, the tile's partial of it. Thread (row, quarter) owns the 12
// columns from 12 quarter, as 3 runs of 4; the two warpgroups' sums are
// added even + odd. Every array is at row stride ld and 16-byte aligned, so
// a run is one 16-byte access; in a run that reaches past n the columns
// from n on are padding, written but never read, and left out of the dot.
template <int EPI>
__device__ __forceinline__ void epilogue(const Params& P, const Ring& R,
                                         int m0, int n0, int tn) {
    constexpr bool kDot = EPI == kRhs || EPI == kInit || EPI == kAp;
    const int ct = threadIdx.x;
    const int row = ct >> 2, quarter = ct & 3;
    const int m = m0 + row, n = P.n;
    const bool row_ok = m < P.M;
    const int chain = row_ok ? m / P.rows : 0;
    const size_t at = (size_t)m * P.ld;
    float dot = 0.0f;
#pragma unroll
    for (int e4 = 0; e4 < 3; ++e4) {
        const int c = 12 * quarter + 4 * e4, j = n0 + c;
        const int cnt = row_ok ? min(4, max(0, n - j)) : 0;
        if (cnt == 0) continue;
        float4 a = ld4(R.sums + row * kLdC + c);
#pragma unroll
        for (int w = 1; w < kConsumers; ++w) {
            const float4 b = ld4(R.sums + w * kCFloats + row * kLdC + c);
            a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
        }
        float v[4] = {a.x, a.y, a.z, a.w};
        if (EPI == kSiteScale) {
            const float4 om = ld4(P.omega + (size_t)chain * P.ld + j);
            st4(P.w + at + j,
                make_float4(v[0] * om.x, v[1] * om.y, v[2] * om.z,
                            v[3] * om.w));
        } else if (EPI == kSitePlain) {
            st4(P.x_site + at + j, make_float4(v[0], v[1], v[2], v[3]));
        } else if (EPI == kRhs) {
            st4(P.r + at + j, make_float4(v[0], v[1], v[2], v[3]));
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (e < cnt) dot += v[e] * v[e];
        } else if (EPI == kInit) {
            const float tc = P.tau[chain], cb = P.cbar[chain];
            const float4 s4 = ld4(P.S + j), x4 = ld4(P.x0 + at + j),
                         r4 = ld4(P.r + at + j);
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
            float rv[4] = {r4.x, r4.y, r4.z, r4.w}, zv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float ts = tc * sv[e];
                rv[e] = rv[e] - (ts * xv[e] + v[e]);
                zv[e] = (1.0f / (ts + cb)) * rv[e];
                if (e < cnt) dot += rv[e] * zv[e];
            }
            st4(P.r + at + j, make_float4(rv[0], rv[1], rv[2], rv[3]));
            st4(P.p + at + j, make_float4(zv[0], zv[1], zv[2], zv[3]));
        } else {
            const float tc = P.tau[chain];
            const float4 s4 = ld4(P.S + j), p4 = ld4(P.p + at + j);
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
            const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                v[e] = tc * sv[e] * pv[e] + v[e];
                if (e < cnt) dot += pv[e] * v[e];
            }
            st4(P.ap + at + j, make_float4(v[0], v[1], v[2], v[3]));
        }
    }
    if (kDot) {
        // the 4 threads of a row are 4 consecutive lanes
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        float* parts = EPI == kRhs    ? P.part_bb
                       : EPI == kInit ? P.part_rz
                                      : P.part_pap;
        if (quarter == 0 && row_ok) parts[(size_t)m * P.tiles_n + tn] = dot;
    }
}

// ------------------------------------------------------------- phases --

// One product phase: the tiles job = blockIdx.x, + gridDim.x, ... of
// `jobs`; a job below `split` multiplies amap0 (epilogue EPI0), one above
// amap1 (EPI1) at job - split. The producer warp feeds the ring; the
// consumers multiply and run the epilogue.
template <int EPI0, int EPI1>
__device__ __forceinline__ uint32_t product_phase(
    const Params& P, const Ring& R, const CUtensorMap* amap0,
    const CUtensorMap* amap1, int split, int jobs, uint32_t q) {
    constexpr bool kTrans0 = EPI0 == kSiteScale || EPI0 == kSitePlain;
    constexpr bool kTrans1 = EPI1 == kSiteScale || EPI1 == kSitePlain;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == kConsumerThreads / 32) {
        if (lane == 0) {
            for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
                const bool second = job >= split;
                const int jb = second ? job - split : job;
                const int tm = jb / P.tiles_n, tn = jb - tm * P.tiles_n;
                produce(P, R, second ? amap1 : amap0,
                        (second ? kTrans1 : kTrans0) ? 0 : 2, tm * kBM,
                        tn * kBN, q);
            }
        }
        __syncwarp();
        return q;
    }
    const int wg = threadIdx.x >> 7;
    for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
        const bool second = job >= split;
        const int jb = second ? job - split : job;
        const int tm = jb / P.tiles_n, tn = jb - tm * P.tiles_n;
        consume(P, R, wg, q);
        consumers_sync();  // the warpgroups' sums are staged
        if (threadIdx.x < kEpilogueThreads) {
            if (second)
                epilogue<EPI1>(P, R, tm * kBM, tn * kBN, tn);
            else
                epilogue<EPI0>(P, R, tm * kBM, tn * kBN, tn);
        }
        consumers_sync();  // the staged sums are read
    }
    fence_proxy_async();
    return q;
}

// A phase of one product over all tiles.
template <int EPI>
__device__ __forceinline__ uint32_t phase(const Params& P, const Ring& R,
                                          const CUtensorMap* amap,
                                          uint32_t q) {
    const int total = P.tiles_m * P.tiles_n;
    return product_phase<EPI, EPI>(P, R, amap, amap, total, total, q);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// A lane's share of a row's per-tile partials: the tiles lane, lane + 32,
// ... in order (warp_sum then adds the lanes in a fixed tree).
__device__ __forceinline__ float lane_parts(const float* parts, int m,
                                            int tiles_n, int lane) {
    float s = 0.0f;
    for (int tn = lane; tn < tiles_n; tn += 32)
        s += parts[(size_t)m * tiles_n + tn];
    return s;
}

// The sum of v over the 64 lanes of a warp pair: each warp in a fixed
// tree, then warp 0's + warp 1's through shared memory.
__device__ __forceinline__ float pair_sum(float v, float* red, int pair,
                                          int half, int lane) {
    v = warp_sum(v);
    if (lane == 0) red[2 * pair + half] = v;
    asm volatile("bar.sync %0, 64;\n" ::"r"(2 + pair) : "memory");
    const float s = red[2 * pair] + red[2 * pair + 1];
    asm volatile("bar.sync %0, 64;\n" ::"r"(2 + pair) : "memory");
    return s;
}

// The vector part of iteration `it`, two warps per row (the consumer warps
// in pairs): alpha from p.Ap, r and the new r.z, beta, then x and p.
// `update` false (iters == 0) only copies x0 to x. On the last pass x is
// also written to x_spec and the row's ||r||^2 / ||b||^2 is left in
// P.ratio, and p is not needed. The row's 16-byte runs go to the pair's 64
// lanes in turn (run c to lane c % 64), kBatch of them a lane at a time:
// all of a batch's loads come before its first store, so that they
// overlap. A lane's sums run over its elements in order, then over the
// lanes in a fixed tree.
constexpr int kBatch = 4;
constexpr int kPairs = kConsumerThreads / 64;

__device__ __forceinline__ void row_pass(const Params& P, int it, bool update,
                                         bool last) {
    __shared__ float red[2 * kPairs];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp >= 2 * kPairs) return;
    const int pair = warp >> 1, half = warp & 1;
    const int n = P.n, runs = P.ld / 4;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int m = blockIdx.x + gridDim.x * pair; m < P.M;
         m += gridDim.x * kPairs) {
        const int chain = m / P.rows;
        const float tc = P.tau[chain], cb = P.cbar[chain];
        const size_t base = (size_t)m * P.ld;
        const float4* xin =
            reinterpret_cast<const float4*>((it == 0 ? P.x0 : P.xs) + base);
        float4* x = reinterpret_cast<float4*>(P.xs + base);
        float4* xo = reinterpret_cast<float4*>(P.x_spec + base);
        float4* r = reinterpret_cast<float4*>(P.r + base);
        float4* p = reinterpret_cast<float4*>(P.p + base);
        const float4* ap = reinterpret_cast<const float4*>(P.ap + base);
        const float4* S = reinterpret_cast<const float4*>(P.S);
        // the partials' loads are issued with the first batch's
        float rz = 0.0f, pap = 0.0f;
        if (update) {
            rz = it == 0 ? lane_parts(P.part_rz, m, P.tiles_n, lane)
                         : P.rz[m];
            pap = lane_parts(P.part_pap, m, P.tiles_n, lane);
        }
        bool have_alpha = !update;
        float alpha = 0.0f, rz_part = 0.0f, rr_part = 0.0f;
        // pass 1: r -= alpha Ap, and the sums of the new r
        for (int s0 = 32 * half; s0 < runs || !have_alpha;
             s0 += 64 * kBatch) {
            float4 rv[kBatch], av[kBatch], sv[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int c = s0 + lane + 64 * u;
                const bool ok = c < runs;
                rv[u] = ok ? r[c] : zero;
                av[u] = ok && update ? ap[c] : zero;
                sv[u] = ok && update ? S[c] : zero;
            }
            if (!have_alpha) {
                if (it == 0) rz = warp_sum(rz);
                alpha = rz / fmaxf(warp_sum(pap), kTiny);
                have_alpha = true;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int c = s0 + lane + 64 * u;
                if (c >= runs) continue;
                const float re[4] = {rv[u].x, rv[u].y, rv[u].z, rv[u].w};
                const float ae[4] = {av[u].x, av[u].y, av[u].z, av[u].w};
                const float se[4] = {sv[u].x, sv[u].y, sv[u].z, sv[u].w};
                float rn[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    rn[e] = update ? re[e] - alpha * ae[e] : re[e];
                    if (4 * c + e < n) {
                        if (update)
                            rz_part +=
                                rn[e] * ((1.0f / (tc * se[e] + cb)) * rn[e]);
                        rr_part += rn[e] * rn[e];
                    }
                }
                if (update) r[c] = make_float4(rn[0], rn[1], rn[2], rn[3]);
            }
        }
        float beta = 0.0f;
        const bool new_p = update && !last;
        if (new_p) {
            const float rz_new = pair_sum(rz_part, red, pair, half, lane);
            beta = rz_new / fmaxf(rz, kTiny);
            if (half == 0 && lane == 0) P.rz[m] = rz_new;
        }
        if (last) {
            const float rr2 = pair_sum(rr_part, red, pair, half, lane);
            const float bb = warp_sum(lane_parts(P.part_bb, m, P.tiles_n,
                                                 lane));
            if (half == 0 && lane == 0) P.ratio[m] = rr2 / fmaxf(bb, kTiny);
        }
        // pass 2: x += alpha p and p = M^-1 r + beta p
        for (int s0 = 32 * half; s0 < runs; s0 += 64 * kBatch) {
            float4 xv[kBatch], pv[kBatch], rv[kBatch], sv[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int c = s0 + lane + 64 * u;
                const bool ok = c < runs;
                xv[u] = ok ? xin[c] : zero;
                pv[u] = ok && update ? p[c] : zero;
                rv[u] = ok && new_p ? r[c] : zero;
                sv[u] = ok && new_p ? S[c] : zero;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int c = s0 + lane + 64 * u;
                if (c >= runs) continue;
                const float xe[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
                const float pe[4] = {pv[u].x, pv[u].y, pv[u].z, pv[u].w};
                const float re[4] = {rv[u].x, rv[u].y, rv[u].z, rv[u].w};
                const float se[4] = {sv[u].x, sv[u].y, sv[u].z, sv[u].w};
                float xn[4], pn[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    xn[e] = update ? xe[e] + alpha * pe[e] : xe[e];
                    pn[e] = (1.0f / (tc * se[e] + cb)) * re[e] + beta * pe[e];
                }
                const float4 x4 = make_float4(xn[0], xn[1], xn[2], xn[3]);
                x[c] = x4;
                if (last) xo[c] = x4;
                if (new_p) p[c] = make_float4(pn[0], pn[1], pn[2], pn[3]);
            }
        }
    }
    fence_proxy_async();
}

// every thread of the grid; the proxy fences order the ordinary stores
// before it with the TMA reads after it
__device__ __forceinline__ void grid_barrier(cg::grid_group& grid) {
    grid.sync();
    fence_proxy_async();
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
icar_cg_kernel(const __grid_constant__ Params P) {
    extern __shared__ __align__(16) char smem_raw[];
    cg::grid_group grid = cg::this_grid();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int total = P.tiles_m * P.tiles_n;
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(P.launches, 1ULL);

    Ring R;
    {
        const uintptr_t base = reinterpret_cast<uintptr_t>(smem_raw);
        R.stages = smem_raw + ((1024 - base % 1024) % 1024);
        R.sums = reinterpret_cast<float*>(R.stages + kStages * kStageBytes);
        R.full = reinterpret_cast<uint64_t*>(R.sums + kConsumers * kCFloats);
        R.empty = R.full + kStages;
    }
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&R.full[s], 1);
            mbar_init(&R.empty[s], 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    uint32_t q = 0;  // k-slices through the ring, the same in every role

    // b = rhs U with ||b||^2, w = omega o (x0 U'), and mean(omega)
    q = product_phase<kRhs, kSiteScale>(P, R, &P.map_rhs, &P.map_x0, total,
                                        2 * total, q);
    for (int c = blockIdx.x * kWarps + warp; c < P.chains;
         c += gridDim.x * kWarps) {
        float s = 0.0f;
        for (int j = lane; j < P.n; j += 32)
            s += P.omega[(size_t)c * P.ld + j];
        s = warp_sum(s);
        if (lane == 0) P.cbar[c] = s / (float)P.n;
    }
    grid_barrier(grid);
    // r = b - A x0, p = z = M^-1 r, r.z
    q = phase<kInit>(P, R, &P.map_w, q);
    grid_barrier(grid);

    for (int it = 0; it < P.iters; ++it) {
        q = phase<kSiteScale>(P, R, &P.map_p, q);
        grid_barrier(grid);
        q = phase<kAp>(P, R, &P.map_w, q);
        grid_barrier(grid);
        row_pass(P, it, true, it == P.iters - 1);
        grid_barrier(grid);
    }
    if (P.iters == 0) {
        row_pass(P, 0, false, true);
        grid_barrier(grid);
    }

    (void)phase<kSitePlain>(P, R, &P.map_x, q);
    for (int c = blockIdx.x * kThreads + threadIdx.x; c < P.chains;
         c += gridDim.x * kThreads) {
        float worst = 0.0f;
        for (int k = 0; k < P.rows; ++k)
            worst = fmaxf(worst, P.ratio[(size_t)c * P.rows + k]);
        P.rel[c] = sqrtf(worst);
    }
}

// Blocks a cooperative launch of the kernel may hold per SM times the SM
// count, from the occupancy query (cached per device); 0 with *err set when
// the device cannot run it.
int max_grid(cudaError_t* err) {
    static int cached[64] = {0};
    int dev = 0;
    *err = cudaGetDevice(&dev);
    if (*err != cudaSuccess) return 0;
    if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
    *err = cudaFuncSetAttribute(icar_cg_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes);
    if (*err != cudaSuccess) return 0;
    int coop = 0, sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (*err != cudaSuccess) return 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, icar_cg_kernel, kThreads, kSmemBytes);
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

// ------------------------------------------------------- tensor maps --

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A tensor map's encoding failed: the error code returned is this plus the
// driver's CUresult.
constexpr int kEncodeError = 100000;

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library links no driver library of its own
EncodeTiled encode_fn(cudaError_t* err) {
    static EncodeTiled fn = nullptr;
    if (fn != nullptr) return fn;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    *err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                            12000, cudaEnableDefault, &found);
#else
    *err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &found);
#endif
    if (*err == cudaSuccess
        && (found != cudaDriverEntryPointSuccess || p == nullptr))
        *err = cudaErrorSymbolNotFound;
    if (*err != cudaSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
    return fn;
}

// rank 2: (rows, n) at row stride ld, box 32 x box_rows; rank 3: (4, n, n)
// at row stride ld, box 32 x box_rows x 2. Float32, the 128-byte swizzle,
// zeros outside the bounds.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rank,
                int n, int rows, int ld, int box_rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)rows, 4};
    const cuuint64_t strides[2] = {(cuuint64_t)ld * 4,
                                   (cuuint64_t)ld * 4 * (cuuint64_t)rows};
    const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)box_rows, 2};
    const cuuint32_t unit[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
              const_cast<void*>(base), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// Floats of scratch a solve of `chains` x `rows` rows of length n needs:
// five vectors at row stride ld = n rounded up to 4, the partial sums and
// the per-row and per-chain scalars.
extern "C" long long icar_cg_scratch_floats(int chains, int rows, int n) {
    const size_t M = (size_t)chains * rows;
    const size_t ld = ((size_t)n + 3) / 4 * 4;
    const size_t tn = tiles_of(n, kBN);
    const size_t parts = (M * tn + 3) / 4 * 4;
    const size_t per_row = (M + 3) / 4 * 4;
    return (long long)(5 * M * ld + 3 * parts + 2 * per_row
                       + ((size_t)chains + 3) / 4 * 4);
}

// Returns a CUDA error code (0 on success), or kEncodeError + a CUresult
// when a tensor map cannot be encoded. All pointers are device pointers,
// to contiguous float32 but for `launches`, one uint64 the launch adds 1
// to, and all are 16-byte aligned. With ld = n rounded up to 4, rhs, x0,
// x_site and x_spec are (chains * rows, ld), omega (chains, ld), S (ld),
// operands (4, n, ld) from k3_operands and `scratch`
// icar_cg_scratch_floats floats; only the first n of each ld are read.
// chains * rows * n must stay below 2^31.
extern "C" int icar_cg_launch(const void* operands, const void* S,
                              const void* rhs, const void* x0,
                              const void* omega, const void* tau,
                              void* x_site, void* x_spec, void* rel,
                              void* scratch, void* launches, int chains,
                              int rows, int n, int iters, void* stream) {
    if (chains == 0 || rows == 0 || n == 0) return 0;
    if (chains < 0 || rows < 0 || n < 0 || iters < 0
        || (long long)chains * rows * n >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const uintptr_t bits = (uintptr_t)operands | (uintptr_t)S
                           | (uintptr_t)rhs | (uintptr_t)x0
                           | (uintptr_t)omega | (uintptr_t)x_site
                           | (uintptr_t)x_spec | (uintptr_t)scratch;
    if (bits % 16 != 0) return (int)cudaErrorMisalignedAddress;
    cudaError_t err = cudaSuccess;
    EncodeTiled fn = encode_fn(&err);
    if (fn == nullptr) return (int)err;
    Params P;
    P.S = (const float*)S;
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
    P.ld = (n + 3) / 4 * 4;
    P.iters = iters;
    P.M = chains * rows;
    P.tiles_m = tiles_of(P.M, kBM);
    P.tiles_n = tiles_of(n, kBN);
    const size_t vec = (size_t)P.M * P.ld;
    const size_t parts = ((size_t)P.M * P.tiles_n + 3) / 4 * 4;
    const size_t per_row = ((size_t)P.M + 3) / 4 * 4;
    float* s = (float*)scratch;
    P.r = s;
    P.p = s + vec;
    P.ap = s + 2 * vec;
    P.w = s + 3 * vec;
    P.xs = s + 4 * vec;
    s += 5 * vec;
    P.part_bb = s;
    P.part_rz = s + parts;
    P.part_pap = s + 2 * parts;
    s += 3 * parts;
    P.rz = s;
    P.ratio = s + per_row;
    P.cbar = s + 2 * per_row;
    const struct {
        CUtensorMap* map;
        const void* base;
    } vectors[] = {{&P.map_rhs, rhs}, {&P.map_x0, x0},  {&P.map_p, P.p},
                   {&P.map_w, P.w},   {&P.map_x, P.xs}};
    for (const auto& v : vectors) {
        const CUresult res = encode(fn, v.map, v.base, 2, n, P.M, P.ld, kBM);
        if (res != CUDA_SUCCESS) return kEncodeError + (int)res;
    }
    const CUresult res = encode(fn, &P.map_u, operands, 3, n, n, P.ld, kBN);
    if (res != CUDA_SUCCESS) return kEncodeError + (int)res;
    const int limit = max_grid(&err);
    if (err != cudaSuccess) return (int)err;
    // the start phase has the most jobs: two products' tiles
    const long long jobs = 2LL * P.tiles_m * P.tiles_n;
    const int grid = (int)(jobs < limit ? jobs : limit);
    void* args[] = {&P};
    return (int)cudaLaunchCooperativeKernel(
        (void*)icar_cg_kernel, dim3(grid), dim3(kThreads), args, kSmemBytes,
        (cudaStream_t)stream);
}

extern "C" const char* icar_cg_error_string(int err) {
    if (err >= kEncodeError) {
        static char text[96];
        snprintf(text, sizeof text,
                 "cuTensorMapEncodeTiled failed with CUresult %d",
                 err - kEncodeError);
        return text;
    }
    return cudaGetErrorString((cudaError_t)err);
}
