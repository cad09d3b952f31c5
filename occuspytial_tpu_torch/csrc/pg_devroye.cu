// Exact Polya-Gamma PG(1, z) draws by Devroye rejection, from z alone; and
// the Threefry word plane of a step's draw plan (threefry_plan_kernel, at
// the end of the file), which shares this file's Threefry function.
//
// Replaces the Pallas kernels of occuspytial_tpu/ops/pallas_pg.py:
// _pg_kernel_grouped (the packed TPU default, launched by
// _pg_packed_grouped) and _pg_kernel (launched by _pg_rows), both running
// the rejection loop _run_rejection on the mixture inputs of _pg_inputs. On
// the TPU a block of lanes runs its rounds in lockstep and reseeds its core
// generator per (chain, round); here round k of lane l of chain b draws its
// 9 uniforms from Threefry-2x32 on (the chain's subkey, counter
// (k, 5 l + j)), j < 5, where l is the column of z or, given a lane
// table, its entry for that column. That counter-based stream gives both TPU contracts
// at once: a chain's draws depend on its own key alone, and a lane's value
// is its first accepted proposal whatever the other lanes do. The bits are
// those of occuspytial_tpu_torch/rng.py, so the plain torch sampler
// (ops/polyagamma.py:pg_devroye) and this kernel agree draw for draw up to
// the rounding of the transcendental functions.
//
// Design. One launch takes z and the int64 key words and does everything:
//  1. Inputs in the kernel. c = |z| / 2, k_exp = pi^2/8 + c^2/2 and the
//     mixture mass `ratio` are computed here, so a lane reads 4 bytes and
//     writes 4. log Phi(x) at the strongly negative argument of the mass is
//     log(erfcx(-x / sqrt 2) / 2) - x^2 / 2, which does not underflow.
//  2. Lanes are not tied to threads. A warp owns a chunk of 128 lanes;
//     it first computes the chunk's c and ratio into shared memory (all
//     threads busy), then runs rejection rounds in which a thread whose lane
//     accepted takes the chunk's next pending lane (__ballot_sync and a
//     warp-uniform counter). The warp stays full until the chunk is nearly
//     done, instead of idling until the slowest of 32 lanes accepts. Any
//     thread can compute any (lane, round), so the values do not change.
//  3. A round generates only what the lane's path uses: Threefry blocks 0
//     and 4 always (branch choice and tail proposal, series test), blocks
//     1-2 for the squeeze body, 2-3 for the inverse-Gaussian body.
//
// Launch count. Thread 0 of block 0 adds one to `launches` (a device
// counter owned by the wrapper), so a launch replayed from a captured CUDA
// graph is counted by the card, as an eager one is.
//
// What bounds it on the card: operations (integer Threefry rounds and
// transcendental calls); bytes are 8 per lane.
//
// Built without --use_fast_math: logf, expf, sqrtf, cosf and erfcxf are the
// IEEE-accurate CUDA math library versions (no __logf/__expf intrinsics),
// and divisions are IEEE-rounded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;  // lanes a warp owns
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kT = 0.64f;
constexpr int kMaxRounds = 64;
constexpr int kSeries = 4;
constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = (float)kPiD;
// products of pi rounded once from double, as the torch version's
// Python-float constants are
constexpr float kPiSq = (float)(kPiD * kPiD);
constexpr float kPiSq8 = (float)(kPiD * kPiD / 8.0);
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kLog2 = 0.69314718055994530942f;

static_assert(kChunk >= 32 && kChunk % 32 == 0, "a chunk is whole warps");

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (the same function as rng.threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = rotl(x1, rot[i % 2][j]);
            x1 ^= x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
    }
}

// Uniform in (0, 1]: 1 - (bits >> 9) * 2^-23, as rng.uniform.
__device__ __forceinline__ float bits_to_uniform(uint32_t b) {
    return 1.0f - (float)(b >> 9) * 1.1920928955078125e-7f;
}

// log of the standard normal distribution function.
__device__ __forceinline__ float log_ndtr(float x) {
    if (x < 0.0f)
        return logf(0.5f * erfcxf(-x * kInvSqrt2)) - 0.5f * x * x;
    return log1pf(-0.5f * erfcf(x * kInvSqrt2));
}

__device__ __forceinline__ float logaddexp(float a, float b) {
    return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// P(choose the truncated-exponential branch) for |z|/2 = c
// (ops/polyagamma.py:_mass_texpon).
__device__ __forceinline__ float mass_texpon(float c) {
    const float k = kPiSq8 + 0.5f * c * c;
    const float log_p = logf(kPi / (2.0f * k)) - k * kT;
    const float rt = 1.25f;  // 1 / sqrt(t)
    const float a1 = rt * (kT * c - 1.0f);
    const float a2 = -rt * (kT * c + 1.0f);
    const float log_q =
        kLog2 + logaddexp(-c + log_ndtr(a1), c + log_ndtr(a2));
    return expf(log_p - logaddexp(log_p, log_q));
}

__device__ __forceinline__ bool series_accept(float x, float v) {
    const bool small = x <= kT;
    const float log_small_base = 1.5f * logf(2.0f / (kPi * x));
    const float a0 = (0.5f * kPi) * expf(
        small ? log_small_base - 0.5f / x : -kPiSq8 * x);
    const float q = expf(small ? -4.0f / x : -kPiSq * x);
    float s = a0, term = a0, qp = 1.0f;
    const float y = v * a0;
    bool accepted = false, rejected = false;
#pragma unroll
    for (int n = 1; n <= kSeries; ++n) {
        qp = qp * q;
        term = term * (float)((2.0 * n + 1.0) / (2.0 * n - 1.0)) * qp;
        if (n % 2 == 1) {
            s = s - term;
            accepted = accepted || (!rejected && y <= s);
        } else {
            s = s + term;
            rejected = rejected || (!accepted && y > s);
        }
    }
    return accepted || !(accepted || rejected);
}

// One lane's sampler state, held by whichever thread runs it now.
struct Lane {
    uint32_t k0, k1, lane;
    float c, ratio, k_exp, x;
    int k;
    bool committed, is_exp;

    __device__ __forceinline__ void start(const long long* subkeys,
                                          long long key_stride,
                                          const long long* lanes,
                                          long long idx, int m, float c_in,
                                          float ratio_in) {
        const long long chain = idx / m;
        const long long col = idx - chain * m;
        // column j draws as lane j, or as global lane lanes[j]
        lane = lanes ? (uint32_t)lanes[col] : (uint32_t)col;
        // the key words are uint32 values held in int64
        k0 = (uint32_t)subkeys[key_stride * chain];
        k1 = (uint32_t)subkeys[key_stride * chain + 1];
        c = c_in;
        ratio = ratio_in;
        // rounded as the plain version's separate multiply and add
        k_exp = __fadd_rn(kPiSq8, __fmul_rn(__fmul_rn(0.5f, c), c));
        x = kT;
        k = 0;
        committed = false;
        is_exp = false;
    }

    __device__ __forceinline__ void block(int j, float& ua, float& ub) const {
        uint32_t x0 = (uint32_t)k, x1 = lane * 5u + (uint32_t)j;
        threefry2x32(k0, k1, x0, x1);
        ua = bits_to_uniform(x0);
        ub = bits_to_uniform(x1);
    }

    // branch B1: squeeze sampler for the truncated IG body (c < 1/t)
    __device__ __forceinline__ bool squeeze(float u2, float u3, float u4,
                                            float& x_new) const {
        const float half_csq = 0.5f * c * c;
        const float e1 = -logf(u2);
        const float e2 = -logf(u3);
        const bool ok = e1 * e1 <= 2.0f * e2 / kT;
        const float t1 = 1.0f + kT * e1;
        x_new = kT / (t1 * t1);
        return ok && (u4 < expf(-x_new * half_csq));
    }

    // branch B2: Michael-Schucany-Haas IG transform (c >= 1/t)
    __device__ __forceinline__ bool inverse_gaussian(float u5, float u6,
                                                     float u7,
                                                     float& x_new) const {
        const float mu = 1.0f / fmaxf(c, 1e-30f);
        const float nrm = sqrtf(-2.0f * logf(u5)) * cosf((2.0f * kPi) * u6);
        const float y0 = nrm * nrm;
        const float mu_y = mu * y0;
        float x_ig =
            mu + 0.5f * mu * (mu_y - sqrtf(4.0f * mu_y + mu_y * mu_y));
        if (u7 > mu / (mu + x_ig)) x_ig = mu * mu / x_ig;
        x_new = x_ig;
        return x_ig <= kT;
    }

    // Runs round k; true when the lane is finished (accepted, or out of
    // rounds with x left at t).
    __device__ __forceinline__ bool round() {
        const bool use_squeeze = c < (1.0f / kT);
        float u0, u1, u2, u3, u4, u5, u6, u7, u8, u9;
        float x_new;
        bool valid;
        if (!committed || is_exp) {
            block(0, u0, u1);
            if (!committed) is_exp = u0 < ratio;
        }
        if (is_exp) {
            // branch A: exponential tail on (t, inf)
            x_new = kT + (-logf(u1)) / k_exp;
            valid = true;
        } else {
            block(2, u4, u5);
            if (use_squeeze) {
                block(1, u2, u3);
                valid = squeeze(u2, u3, u4, x_new);
            } else {
                block(3, u6, u7);
                valid = inverse_gaussian(u5, u6, u7, x_new);
            }
        }
        block(4, u8, u9);
        if (valid && series_accept(x_new, u8)) {
            x = x_new;
            return true;
        }
        committed = !valid;
        return ++k >= kMaxRounds;
    }
};

__global__ void __launch_bounds__(kThreads)
pg_devroye_kernel(const long long* __restrict__ subkeys,
                  long long key_stride, const long long* __restrict__ lanes,
                  const float* __restrict__ z,
                  float* __restrict__ out, int chains, int m,
                  unsigned long long* __restrict__ launches) {
    __shared__ float s_c[kWarps][kChunk];
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ULL);
    __shared__ float s_ratio[kWarps][kChunk];
    const unsigned full = 0xffffffffu;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long total = (long long)chains * m;
    const long long base = ((long long)blockIdx.x * kWarps + warp) * kChunk;
    if (base >= total) return;  // the whole warp leaves
    const int count = (int)(total - base < kChunk ? total - base : kChunk);

    // the chunk's mixture inputs, every thread busy
    for (int i = lane; i < count; i += 32) {
        const float c = 0.5f * fabsf(z[base + i]);
        s_c[warp][i] = c;
        s_ratio[warp][i] = mass_texpon(c);
    }
    __syncwarp();

    // rejection rounds; a thread whose lane finished takes the next one
    int next = 32;
    int item = lane < count ? lane : -1;
    Lane st;
    if (item >= 0)
        st.start(subkeys, key_stride, lanes, base + item, m,
                 s_c[warp][item], s_ratio[warp][item]);
    while (__any_sync(full, item >= 0)) {
        bool finished = false;
        if (item >= 0) {
            finished = st.round();
            if (finished) out[base + item] = 0.25f * st.x;
        }
        const unsigned need = __ballot_sync(full, finished);
        if (finished) {
            item = next + __popc(need & ((1u << lane) - 1u));
            if (item < count)
                st.start(subkeys, key_stride, lanes, base + item, m,
                         s_c[warp][item], s_ratio[warp][item]);
            else
                item = -1;
        }
        next += __popc(need);
    }
}

// The Threefry draw plan: the word plane of one rng.DrawPlan call.
//
// Replaces no TPU kernel: the JAX package leaves jax.random to XLA, which
// fuses it. It was added because the plan in int64 torch ops
// (rng.threefry2x32 over the whole (chains, counters) plane, then a stack)
// is about 172 kernels a Gibbs step, each reading and writing the plane.
//
// Thread (chain, j) computes threefry(key of the chain, (step, x1[j])) in
// registers and stores its two words as one 16-byte longlong2 at columns
// 2j and 2j + 1 of the chain's row: neighbouring threads write neighbouring
// 16 bytes, and the plane is the (chains, 2 * counters) int64 layout of
// torch.stack([y0, y1], -1). Block row y of the grid is chain y (at most
// 65,535 chains, which the wrapper checks), so a chain's key words are one
// broadcast load a block.
//
// The step word comes from a device pointer when given (a captured CUDA
// graph advances the 0-d step tensor in place; a host value would be
// frozen into the graph at capture), else from the host argument; its low
// 32 bits are the first counter word, as (step + k0) & MASK in rng.py.
//
// What bounds it: the bytes written, 16 a counter, and ~80 32-bit integer
// operations a counter (20 rounds of add, funnel shift, xor; 5 key
// injections). At icar1k's plan (6,660 counters x 64 chains) that is
// 6.8 MB (2.0 us at 3.35 TB/s) and ~34 M operations (~2 us at ~16.7 T
// integer operations/s); at lattice10k's (54,459 x 32) 27.9 MB (8.3 us)
// and ~139 M operations (~8.3 us).
constexpr int kPlanThreads = 256;

__global__ void __launch_bounds__(kPlanThreads)
threefry_plan_kernel(const long long* __restrict__ keys, long long key_stride,
                     const long long* __restrict__ x1, int n_ctr,
                     const long long* __restrict__ step_ptr,
                     long long step_host, longlong2* __restrict__ out,
                     unsigned long long* __restrict__ launches) {
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
        atomicAdd(launches, 1ULL);
    const int j = blockIdx.x * kPlanThreads + threadIdx.x;
    if (j >= n_ctr) return;
    const int chain = blockIdx.y;
    // the key words are uint32 values held in int64
    const uint32_t k0 = (uint32_t)keys[key_stride * chain];
    const uint32_t k1 = (uint32_t)keys[key_stride * chain + 1];
    uint32_t y0 = (uint32_t)(step_ptr ? *step_ptr : step_host);
    uint32_t y1 = (uint32_t)x1[j];
    threefry2x32(k0, k1, y0, y1);
    out[(long long)chain * n_ctr + j] =
        make_longlong2((long long)y0, (long long)y1);
}

}  // namespace

// `subkeys` (chains, 2) int64 key words, chain b's pair at
// subkeys[b * key_stride]; `lanes` null, or (m,) int64 global lane
// indices (column j of z draws lane lanes[j]'s uniforms: a band of sites
// draws what the whole field gives those lanes); `z` and `out` (chains,
// m) contiguous float32; `launches` one uint64 the launch adds 1 to; all
// device pointers. Returns a CUDA error code (0 on success).
extern "C" int pg_devroye_launch(const void* subkeys, long long key_stride,
                                 const void* lanes, const void* z, void* out,
                                 int chains, int m, void* launches,
                                 void* stream) {
    const long long total = (long long)chains * m;
    if (total == 0) return 0;
    const long long per_block = (long long)kWarps * kChunk;
    const long long blocks = (total + per_block - 1) / per_block;
    pg_devroye_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const long long*)subkeys, key_stride, (const long long*)lanes,
        (const float*)z, (float*)out, chains, m,
        (unsigned long long*)launches);
    return (int)cudaGetLastError();
}

extern "C" const char* pg_devroye_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// `keys` (chains, 2) int64 key words, chain b's pair at keys[b *
// key_stride], at most 65,535 chains; `x1` (n_ctr,) int64 counters; `step`
// null, or one int64 on the device whose low 32 bits are the step word
// (else `step_host`'s are);
// `out` (chains, 2 * n_ctr) int64, 16-byte aligned; `launches` one uint64
// the launch adds 1 to; all device pointers. Returns a CUDA error code.
extern "C" int threefry_plan_launch(const void* keys, long long key_stride,
                                    const void* x1, int n_ctr, int chains,
                                    const void* step, long long step_host,
                                    void* out, void* launches,
                                    void* stream) {
    if (n_ctr == 0 || chains == 0) return 0;
    const dim3 grid((n_ctr + kPlanThreads - 1) / kPlanThreads, chains);
    threefry_plan_kernel<<<grid, kPlanThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, key_stride, (const long long*)x1, n_ctr,
        (const long long*)step, step_host, (longlong2*)out,
        (unsigned long long*)launches);
    return (int)cudaGetLastError();
}
