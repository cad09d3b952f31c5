"""The port's counter-based generator (occuspytial_tpu_torch/rng.py).

Threefry-2x32 must be the function behind jax.random's default keys, bit
for bit; the derived uniforms, normals and gamma draws must have the
right distributions; and the per-chain key derivation must not depend on
the chain count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32
from scipy import stats

from occuspytial_tpu_torch import rng

# the tensors here are small: one intra-op thread is faster than many,
# and the suite already runs in parallel worker processes
torch.set_num_threads(1)


def _u32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.uint32).astype(np.int64))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_threefry_matches_jax_bit_for_bit(seed):
    gen = np.random.default_rng(seed)
    key = gen.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    ctr = gen.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64).astype(
        np.uint32
    )
    want = np.asarray(threefry_2x32(jnp.asarray(key),
                                    jnp.asarray(ctr.reshape(-1))))
    y0, y1 = rng.threefry2x32(
        int(key[0]), int(key[1]), _u32(ctr[0]), _u32(ctr[1])
    )
    got = np.concatenate([y0.numpy(), y1.numpy()]).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_threefry_broadcasts_per_lane_keys():
    """Per-lane key tensors give what one call per key gives."""
    gen = np.random.default_rng(5)
    keys = gen.integers(0, 2 ** 32, (3, 2), dtype=np.uint64)
    ctr = gen.integers(0, 2 ** 32, (2, 50), dtype=np.uint64)
    k = _u32(keys)
    y0, y1 = rng.threefry2x32(k[:, :1], k[:, 1:], _u32(ctr[0])[None],
                              _u32(ctr[1])[None])
    for b in range(3):
        want = np.asarray(threefry_2x32(
            jnp.asarray(keys[b].astype(np.uint32)),
            jnp.asarray(ctr.astype(np.uint32).reshape(-1)),
        ))
        np.testing.assert_array_equal(y0[b].numpy(), want[:50])
        np.testing.assert_array_equal(y1[b].numpy(), want[50:])


@pytest.mark.parametrize('seed', [0, 7, 2 ** 32 - 1])
def test_root_key_is_jax_key_data(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    assert rng.root_key(seed) == tuple(int(v) for v in want)


def test_uniform_range_is_open_at_zero_closed_at_one():
    edge = torch.tensor([0, 1, 511, 512, 2 ** 32 - 1], dtype=torch.int64)
    u = rng.uniform(edge)
    assert float(u[0]) == 1.0
    assert float(u[-1]) == 2.0 ** -23
    keys = rng.chain_keys(3, 4, rng.RUN)
    u = rng.uniform(rng.words(keys, 0, 1, 100_000))
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    assert bool(torch.isfinite(-torch.log(u)).all())
    # uniform on (0, 1]: KS against U(0, 1)
    assert stats.kstest(u.reshape(-1).numpy(), 'uniform').pvalue > 1e-3


def test_normal_moments_and_ks():
    keys = rng.chain_keys(11, 4, rng.RUN)
    x = rng.normal(rng.words(keys, 3, 2, 2 * 50_000)).reshape(-1).numpy()
    assert abs(x.mean()) < 5 / np.sqrt(x.size)
    assert abs(x.var() - 1.0) < 5 * np.sqrt(2.0 / x.size)
    assert stats.kstest(x, 'norm').pvalue > 1e-3


@pytest.mark.parametrize('shape', [0.5, 1.0, 500.0])
def test_gamma_moments_against_scipy(shape):
    keys = rng.chain_keys(5, 4, rng.RUN)
    m = 25_000
    w = rng.words(keys, 0, 1, rng.GAMMA_WORDS * m).reshape(4, m, -1)
    g = rng.gamma(shape, w).reshape(-1).double().numpy()
    ref = stats.gamma(shape)
    n = g.size
    assert abs(g.mean() - ref.mean()) < 5 * ref.std() / np.sqrt(n)
    # sd of the sample variance: sqrt((mu4 - sigma^4) / n), gamma
    # excess kurtosis 6/shape
    var_sd = ref.var() * np.sqrt((2.0 + 6.0 / shape) / n)
    assert abs(g.var() - ref.var()) < 5 * var_sd
    assert stats.kstest(g, ref.cdf).pvalue > 1e-3


def test_gamma_tensor_shape_per_chain():
    keys = rng.chain_keys(2, 3, rng.RUN)
    w = rng.words(keys, 0, 1, rng.GAMMA_WORDS)
    shapes = torch.tensor([0.5, 2.0, 300.0])
    g = rng.gamma(shapes, w)
    for b in range(3):
        assert float(g[b]) == float(rng.gamma(float(shapes[b]), w[b:b + 1]))


def test_chain_keys_are_prefix_stable():
    for purpose in (rng.INIT, rng.RUN):
        a = rng.chain_keys(9, 2, purpose)
        b = rng.chain_keys(9, 5, purpose)
        assert torch.equal(a, b[:2])
    assert not torch.equal(rng.chain_keys(9, 2, rng.INIT),
                           rng.chain_keys(9, 2, rng.RUN))


def test_draw_plan_matches_per_update_words():
    keys = rng.chain_keys(4, 3, rng.RUN)
    counts = {0: 2, 1: 65, 2: 300, 7: 9}
    plan = rng.DrawPlan(counts)
    got = plan(keys, 12)
    for uid, n in counts.items():
        assert got[uid].shape == (3, n)
        assert torch.equal(got[uid], rng.words(keys, 12, uid, n))
    # a longer draw of the same update extends the shorter one
    assert torch.equal(rng.words(keys, 12, 2, 301)[:, :300], got[2])
    # another step gives other words
    assert not torch.equal(rng.words(keys, 13, 2, 300), got[2])


def test_pg_uniforms_lane_subset_matches_full_plane():
    sub = rng.words(rng.chain_keys(1, 3, rng.RUN), 0, 0, 2)
    full = rng.pg_uniforms(sub, 4, 37)
    assert full.shape == (9, 3, 37)
    idx = torch.tensor([0, 5, 40, 110])
    part = rng.pg_uniforms(sub, 4, 37, lanes=idx)
    assert torch.equal(part, full.reshape(9, -1)[:, idx])
