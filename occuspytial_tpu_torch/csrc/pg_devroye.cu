// Exact Polya-Gamma PG(1, z) draws by Devroye rejection, one thread per lane.
//
// Replaces the Pallas kernels of occuspytial_tpu/ops/pallas_pg.py:
// _pg_kernel_grouped (the packed TPU default, launched by
// _pg_packed_grouped) and _pg_kernel (launched by _pg_rows), both running
// the rejection loop _run_rejection. On the TPU a block of lanes runs its
// rounds in lockstep and reseeds its core generator per (chain, round); here
// each thread loops over its own rounds until it accepts or reaches 64, and
// draws round k's 9 uniforms from Threefry-2x32 on (its chain's subkey,
// counter (k, 5 * lane + j)), j < 5. That counter-based stream gives both
// TPU contracts at once: a chain's draws depend on its own key alone, and a
// lane's value is its first accepted proposal whatever the other lanes do.
// The bits are those of occuspytial_tpu_torch/rng.py, so the plain torch
// sampler (ops/polyagamma.py:pg_devroye) and this kernel agree draw for draw
// up to the rounding of the transcendental functions.
//
// What bounds it on the card: operations. Each round costs ~5 Threefry
// blocks (~200 integer ops) and ~10 transcendental calls per lane, against
// 16 bytes read and 4 written per lane; a lane takes ~2 rounds on average.
// The design keeps every intermediate in registers and reads each input
// once. Pitfall left for a later change: warp divergence in the rejection
// tail (a warp runs until its slowest lane accepts, and the two proposal
// branches diverge inside a round).
//
// Built without --use_fast_math: logf, expf, sqrtf and cosf are the
// IEEE-accurate CUDA math library versions (no __logf/__expf intrinsics),
// and divisions are IEEE-rounded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kT = 0.64f;
constexpr int kMaxRounds = 64;
constexpr int kSeries = 4;
constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = (float)kPiD;
// products of pi rounded once from double, as the torch version's
// Python-float constants are
constexpr float kPiSq = (float)(kPiD * kPiD);
constexpr float kPiSq8 = (float)(kPiD * kPiD / 8.0);

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

__global__ void pg_devroye_kernel(const uint32_t* __restrict__ subkeys,
                                  const float* __restrict__ c_in,
                                  const float* __restrict__ ratio_in,
                                  const float* __restrict__ kexp_in,
                                  float* __restrict__ out,
                                  int chains, int m) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)chains * m) return;
    const int chain = (int)(idx / m);
    const uint32_t lane = (uint32_t)(idx - (long long)chain * m);
    const uint32_t k0 = subkeys[2 * chain], k1 = subkeys[2 * chain + 1];
    const float c = c_in[idx], ratio = ratio_in[idx], k_exp = kexp_in[idx];

    const bool use_squeeze = c < (1.0f / kT);
    const float mu = 1.0f / fmaxf(c, 1e-30f);
    const float half_csq = 0.5f * c * c;

    float x = kT;
    bool committed = false, is_exp = false;
    for (int k = 0; k < kMaxRounds; ++k) {
        float u[10];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
            uint32_t x0 = (uint32_t)k, x1 = lane * 5u + (uint32_t)j;
            threefry2x32(k0, k1, x0, x1);
            u[2 * j] = bits_to_uniform(x0);
            u[2 * j + 1] = bits_to_uniform(x1);
        }
        if (!committed) is_exp = u[0] < ratio;

        // branch A: exponential tail on (t, inf)
        const float x_exp = kT + (-logf(u[1])) / k_exp;

        // branch B1: squeeze sampler for the truncated IG body (c < 1/t)
        const float e1 = -logf(u[2]);
        const float e2 = -logf(u[3]);
        bool ok_sq = e1 * e1 <= 2.0f * e2 / kT;
        const float t1 = 1.0f + kT * e1;
        const float x_sq = kT / (t1 * t1);
        ok_sq = ok_sq && (u[4] < expf(-x_sq * half_csq));

        // branch B2: Michael-Schucany-Haas IG transform (c >= 1/t)
        const float nrm = sqrtf(-2.0f * logf(u[5])) * cosf((2.0f * kPi) * u[6]);
        const float y0 = nrm * nrm;
        const float mu_y = mu * y0;
        float x_ig = mu + 0.5f * mu * (mu_y - sqrtf(4.0f * mu_y + mu_y * mu_y));
        if (u[7] > mu / (mu + x_ig)) x_ig = mu * mu / x_ig;
        const bool ok_ig = x_ig <= kT;

        const float x_body = use_squeeze ? x_sq : x_ig;
        const bool ok_body = use_squeeze ? ok_sq : ok_ig;
        const float x_new = is_exp ? x_exp : x_body;
        const bool valid = is_exp || ok_body;
        if (valid && series_accept(x_new, u[8])) {
            x = x_new;
            break;
        }
        committed = !valid;
    }
    out[idx] = 0.25f * x;
}

}  // namespace

extern "C" int pg_devroye_launch(const void* subkeys, const void* c,
                                 const void* ratio, const void* k_exp,
                                 void* out, int chains, int m,
                                 void* stream) {
    const long long total = (long long)chains * m;
    if (total == 0) return 0;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    pg_devroye_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)subkeys, (const float*)c, (const float*)ratio,
        (const float*)k_exp, (float*)out, chains, m);
    return (int)cudaGetLastError();
}

extern "C" const char* pg_devroye_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
