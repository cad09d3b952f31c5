"""Counter-based random words of the sampler's documented stream.

A frozen, plain rewrite: Threefry-2x32 with 20 rounds (Salmon et al.
2011) in int64 torch ops with 32-bit masks, and the stream layout the
samplers document:

- chain c's key is ``threefry(root, (purpose, c))``, ``root = (seed >>
  32, seed & 0xFFFFFFFF)``, purpose 1 for the initial state and 2 for the
  run;
- word pair i of update u at step t is ``threefry(key, (t, u << 24 |
  i))``;
- the Polya-Gamma draw's subkey is update 0's word pair; round k of lane
  l reads its 9 uniforms from ``threefry(subkey, (k, 5 l + j))``, j < 5;
- a uniform is ``1 - (w >> 9) 2^-23``, a normal is Box-Muller over two
  words, a gamma draw is Marsaglia-Tsang over 16 candidates of 4 words.

The floating-point parts run in the dtype asked for (float64 for the
reference).
"""

import math

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
INIT, RUN = 1, 2
LANE_BITS = 24
GAMMA_CANDIDATES = 16
GAMMA_WORDS = 4 * GAMMA_CANDIDATES


def threefry2x32(k0, k1, x0, x1):
    """The two output words of Threefry-2x32 (20 rounds)."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def chain_keys(seed, chains, purpose, device):
    """(chains, 2) int64 key words of the chains of ``seed``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    r0, r1 = seed >> 32, seed & MASK
    c = torch.arange(chains, dtype=torch.int64, device=device)
    return torch.stack(threefry2x32(r0, r1, purpose, c), dim=1)


def words(keys, step, update, count):
    """(chains, count) words of update ``update`` at step ``step``."""
    n_ctr = (count + 1) // 2
    ctr = (update << LANE_BITS) | torch.arange(
        n_ctr, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], int(step), ctr[None])
    return torch.stack([y0, y1], dim=-1).reshape(keys.shape[0], -1)[
        :, :count]


def uniform(w, dtype):
    """Uniforms in (0, 1], exact in float32 and wider types."""
    return 1.0 - (w >> 9).to(dtype) * (2.0 ** -23)


def normal(w, dtype):
    """Box-Muller normals, one per pair of words along the last axis."""
    u = uniform(w, dtype).reshape(*w.shape[:-1], -1, 2)
    return torch.sqrt(-2.0 * torch.log(u[..., 0])) * torch.cos(
        (2.0 * math.pi) * u[..., 1])


def gamma(shape, w, dtype):
    """Gamma(shape, 1) from ``w`` (..., GAMMA_WORDS): the first accepted
    Marsaglia-Tsang candidate (the candidate mean if none is); a shape
    below 1 draws shape + 1 and scales by U^(1 / shape)."""
    cand = w.reshape(*w.shape[:-1], GAMMA_CANDIDATES, 4)
    x = normal(cand[..., :2], dtype)[..., 0]
    u = uniform(cand[..., 2], dtype)
    a = shape + 1.0 if shape < 1.0 else shape
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    v = (1.0 + c * x) ** 3
    pos = v > 0
    vs = torch.where(pos, v, torch.ones_like(v))
    ok = pos & (torch.log(u) < 0.5 * x * x + d - d * vs + d * torch.log(vs))
    first = ok.to(torch.int32).argmax(dim=-1, keepdim=True)
    g = torch.where(ok.any(dim=-1),
                    (d * torch.gather(vs, -1, first))[..., 0],
                    torch.full_like(x[..., 0], d))
    if shape < 1.0:
        g = g * uniform(cand[..., 0, 3], dtype) ** (1.0 / shape)
    return g


def pg_uniforms(subkeys, k, lanes, m, dtype):
    """(9, len(lanes)) uniforms of rejection round ``k`` for the flat
    (chain * m + column) lane indices ``lanes``."""
    chain, lane = lanes // m, lanes % m
    x1 = lane[:, None] * 5 + torch.arange(5, device=lanes.device)
    y0, y1 = threefry2x32(subkeys[chain, 0][:, None],
                          subkeys[chain, 1][:, None], int(k), x1)
    w = torch.stack([y0, y1], dim=-1).reshape(-1, 10)[:, :9]
    return uniform(w, dtype).T
