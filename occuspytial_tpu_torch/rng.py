"""Counter-based random numbers, identical in torch ops and in the kernels.

The generator is Threefry-2x32 with 20 rounds (Salmon et al. 2011), the
function behind ``jax.random``'s default keys. It is written here in
int64 torch ops with explicit 32-bit masks: additions, rotations and xors
are then exact on any device, and nothing needs a 64-bit multiply-high.
``csrc/pg_devroye.cu`` carries the same function as a ``__device__``
inline, used by two kernels: the Pólya-Gamma kernel K1 draws its
uniforms with it, and ``threefry_plan_kernel`` computes a
:class:`DrawPlan`'s whole word plane in one launch on CUDA keys (the
torch ops above run on CPU keys). Both give the torch ops' bits.

Keys and streams:

- a chain's key is two 32-bit words (held in int64 tensors), a function
  of ``random_state`` and the chain index alone: ``threefry(root,
  (purpose, chain))`` with ``purpose`` :data:`INIT` or :data:`RUN` and
  ``root = (seed >> 32, seed & 0xFFFFFFFF)``, the key data of
  ``jax.random.key(seed)``. Chain c's stream is therefore the same
  whatever the chain count;
- every draw is a pure function of (chain key, step, update, lane): word
  pair ``i`` of update ``u`` at step ``t`` is ``threefry(key, (t, u <<
  24 | i))``. A carry that stores the key words and the step counter
  therefore resumes bit for bit;
- update 0 of a step is the Pólya-Gamma subkey ``threefry(key, (t, 0))``;
  round ``k`` of lane ``l`` draws its 9 uniforms from ``threefry(subkey,
  (k, 5 l + j))``, j < 5 (see :func:`pg_uniforms`).

Uniforms lie in (0, 1], from the top 23 bits as the TPU kernel's
``_bits_to_uniform`` makes them, so ``-log(u)`` is finite. Normals use
Box-Muller (two words each). Gamma draws use Marsaglia-Tsang over
:data:`GAMMA_CANDIDATES` candidates with no host synchronisation.
"""

import math

import torch

from .ops.cuda_rng import threefry_plan

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: purpose words of the two per-chain key families (the analog of
#: ``fold_in(root, 1 | 2)`` in the JAX package, models/base.py:416-418)
INIT, RUN = 1, 2

#: counter bits left for the lane index within one update
_LANE_BITS = 24

#: Marsaglia-Tsang candidates per gamma draw. Each is accepted with
#: probability above 0.95 for the boosted shape (>= 1), so all 16 fail
#: with probability below 0.05**16 ~ 1.5e-21 per draw; the draw then
#: falls back to the candidate mean ``d``.
GAMMA_CANDIDATES = 16

#: words one gamma draw consumes: per candidate a normal (2 words), an
#: acceptance uniform and a spare whose first copy is the U^(1/a) boost
GAMMA_WORDS = 4 * GAMMA_CANDIDATES


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counters ``(x0, x1)`` under key
    ``(k0, k1)``. Arguments are int64 tensors or Python ints holding
    uint32 values and broadcast together; returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def root_key(seed):
    """The two key words of ``jax.random.key(seed)`` for 0 <= seed <
    2**32; a larger seed keeps its high word, as in JAX's 64-bit mode."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed >> 32, seed & MASK


def _step_word(step, keys):
    """The step counter as Threefry's first counter word: a Python int, or
    a 0-d int64 tensor on the keys' device. A captured CUDA graph holds
    the step in such a tensor and advances it in place, where a Python
    int would be frozen into the kernels' arguments at capture; both
    forms give the same words."""
    if isinstance(step, torch.Tensor):
        if (step.dtype != torch.int64 or step.dim() != 0
                or step.device != keys.device):
            raise ValueError(
                'a tensor step must be a 0-d int64 tensor on the keys\' '
                f'device, got {step.dtype} {tuple(step.shape)} on '
                f'{step.device}'
            )
        return step
    return int(step)


def chain_keys(seed, chains, purpose, device='cpu'):
    """(chains, 2) int64 key words: chain c's are ``threefry(root,
    (purpose, c))``, so they do not depend on the chain count."""
    r0, r1 = root_key(seed)
    c = torch.arange(chains, dtype=torch.int64, device=device)
    return torch.stack(threefry2x32(r0, r1, purpose, c), dim=1)


def plan_words(keys, x1, step):
    """(chains, 2 * counters) int64 words in int64 torch ops, on any
    device: columns 2j and 2j + 1 of row b are the two words of
    ``threefry(keys[b], (step, x1[j]))``. The plain version of the CUDA
    kernel ``ops/cuda_rng.py:threefry_plan``; ``step`` an int or a 0-d
    int64 tensor on the keys' device."""
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], step, x1[None])
    return torch.stack([y0, y1], dim=-1).reshape(keys.shape[0], -1)


class DrawPlan:
    """All of one step's draws in one Threefry call.

    ``counts`` maps update index -> number of 32-bit words. Calling the
    plan with (chain keys, step) returns update index -> (chains, words)
    int64 tensor, the same words :func:`words` gives for each update
    alone: on CUDA keys the step's draws are one kernel launch
    (``ops/cuda_rng.py``), on CPU keys one pass of int64 torch ops.

    ``tables`` (optional) maps an update index to a 1-D int64 array of
    word indices below its count: that update then returns only those
    words of its full draw, in the table's order (a band of sites draws
    the words the whole field would give its sites). Normal i reads words
    2i and 2i + 1 and uniform i reads word i, so a table is word-level:
    it may start or end at either half of a counter. Only the counters
    the table touches are computed, each once.
    """

    def __init__(self, counts, device='cpu', tables=None):
        tables = tables or {}
        self.counts = dict(counts)
        ctrs, self.slices, self.gathers, off = [], {}, {}, 0
        for uid, n in counts.items():
            n_ctr = (int(n) + 1) // 2
            if n_ctr > (1 << _LANE_BITS) or uid >= (1 << 8):
                raise ValueError('draw too large for the counter layout')
            if uid in tables:
                idx = torch.as_tensor(tables[uid], dtype=torch.int64)
                if idx.numel() and (idx.min() < 0 or idx.max() >= int(n)):
                    raise ValueError(
                        f'word table of update {uid} leaves [0, {n})'
                    )
                used, pos = torch.unique(idx >> 1, return_inverse=True)
                ctrs.append(((uid << _LANE_BITS) | used).to(device))
                self.gathers[uid] = (2 * (off + pos) + (idx & 1)).to(device)
                off += used.numel()
                continue
            # made on the device: a plan built inside a captured step
            # (rng.words) copies nothing from the host
            ctrs.append(
                (uid << _LANE_BITS)
                | torch.arange(n_ctr, dtype=torch.int64, device=device)
            )
            self.slices[uid] = (2 * off, 2 * off + int(n))
            off += n_ctr
        self.x1 = torch.cat(ctrs)

    def __call__(self, keys, step):
        step = _step_word(step, keys)
        plane = threefry_plan if keys.is_cuda else plan_words
        w = plane(keys, self.x1, step)
        out = {uid: w[:, a:b] for uid, (a, b) in self.slices.items()}
        out.update({uid: w[:, g] for uid, g in self.gathers.items()})
        return out


def normal_words(idx):
    """Word indices (2i, 2i + 1 for each i) of the normals ``idx`` of an
    update: a :class:`DrawPlan` table that draws those normals alone."""
    idx = torch.as_tensor(idx, dtype=torch.int64)
    return torch.stack([2 * idx, 2 * idx + 1], dim=-1).reshape(-1)


def words(keys, step, update, count):
    """(chains, count) words of update ``update`` at step ``step`` (an int
    or a tensor, as for :class:`DrawPlan`)."""
    return DrawPlan({update: count}, keys.device)(keys, step)[update]


def lane_words(keys, step, update, lanes, per_lane):
    """(chains, len(lanes) * per_lane) words of update ``update`` at step
    ``step``: column j's ``per_lane`` words are words ``lanes[j] *
    per_lane + t`` (t < per_lane) of the update's full draw
    (:func:`words`), so a band of a 2-D run draws the words the whole
    field gives its lanes. ``lanes`` (m,) int64 on the keys' device;
    ``step`` as for :class:`DrawPlan`."""
    idx = (lanes[:, None] * per_lane
           + torch.arange(per_lane, device=lanes.device)).reshape(-1)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], _step_word(step, keys),
                          (update << _LANE_BITS) | (idx >> 1))
    return torch.where((idx & 1).bool(), y1, y0)


def uniform(w, dtype=torch.float32):
    """One uniform in (0, 1] per 32-bit word: ``1 - (w >> 9) * 2^-23``,
    bit for bit the TPU kernel's mantissa trick (ops/pallas_pg.py)."""
    f = (w >> 9).to(torch.float32) * (2.0 ** -23)
    return (1.0 - f).to(dtype)


def normal(w, dtype=torch.float32):
    """Standard normals by Box-Muller, one per pair of words along the
    last axis (which must be even)."""
    u = uniform(w, dtype).reshape(*w.shape[:-1], -1, 2)
    return torch.sqrt(-2.0 * torch.log(u[..., 0])) * torch.cos(
        (2.0 * math.pi) * u[..., 1]
    )


def gamma(shape, w, dtype=torch.float32):
    """Gamma(shape, 1) draws from ``w`` (..., GAMMA_WORDS).

    Marsaglia-Tsang (2000) over :data:`GAMMA_CANDIDATES` candidates; the
    first accepted one is the draw. ``shape`` < 1 draws Gamma(shape + 1)
    and scales by U^(1/shape) (the init tau draw has shape 0.5).
    """
    if isinstance(shape, torch.Tensor):
        shape = shape.to(dtype)
    else:
        # filled on the device: a host scalar copied there would
        # synchronise the stream
        shape = torch.full((), float(shape), dtype=dtype, device=w.device)
    cand = w.reshape(*w.shape[:-1], GAMMA_CANDIDATES, 4)
    x = normal(cand[..., :2], dtype)[..., 0]
    u = uniform(cand[..., 2], dtype)
    boost = shape < 1.0
    a = torch.where(boost, shape + 1.0, shape)
    d = (a - 1.0 / 3.0)[..., None]
    c = 1.0 / torch.sqrt(9.0 * d)
    v = (1.0 + c * x) ** 3
    pos = v > 0
    v_safe = torch.where(pos, v, torch.ones_like(v))
    ok = pos & (
        torch.log(u) < 0.5 * x * x + d - d * v_safe + d * torch.log(v_safe)
    )
    first = ok.to(torch.int32).argmax(dim=-1, keepdim=True)
    g = torch.where(
        ok.any(dim=-1),
        (d * torch.gather(v_safe, -1, first))[..., 0],
        d[..., 0],
    )
    u_boost = uniform(cand[..., 0, 3], dtype)
    return torch.where(
        boost, g * u_boost ** (1.0 / shape), g
    )


def pg_uniforms(subkeys, k, m, dtype=torch.float32, lanes=None,
                table=None):
    """Uniforms of Pólya-Gamma rejection round ``k``: lane l of chain b
    uses counters ``(k, 5 l + j)``, j < 5, under ``subkeys[b]``, with the
    word pairs in order (the 10th word is unused). Returns (9, chains, m),
    or (9, len(lanes)) for the flat (chain * m + column) indices
    ``lanes``. Column j draws as lane j, or as global lane ``table[j]``
    when a lane table (m,) int64 is given: a band of a 2-D run draws the
    uniforms the whole field gives its lanes.
    """
    dev = subkeys.device
    if lanes is None:
        flat = torch.arange(subkeys.shape[0] * m, dtype=torch.int64,
                            device=dev)
    else:
        flat = lanes
    chain, lane = flat // m, flat % m
    if table is not None:
        lane = table[lane]
    x1 = lane[:, None] * 5 + torch.arange(5, device=dev)
    y0, y1 = threefry2x32(
        subkeys[chain, 0][:, None], subkeys[chain, 1][:, None], int(k), x1
    )
    w = torch.stack([y0, y1], dim=-1).reshape(-1, 10)[:, :9]
    u = uniform(w, dtype).T
    return u if lanes is not None else u.reshape(9, subkeys.shape[0], m)
