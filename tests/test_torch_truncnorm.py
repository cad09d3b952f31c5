"""The port's truncated-normal draws against the JAX package's.

The JAX functions draw their uniforms from a key; the port takes them as
an argument, so the test makes them with jax.random on the same key and
passes them on. Both compute in float32 through log_ndtr and ndtri of
their own libraries: draws agree to 1e-4 of the largest entry, tails
(|loc| up to 30) included, where every draw must be finite. The two ends
of the uniforms' supports, u = 0 (jax.random.uniform's [0, 1)) and u = 1
(the port's (0, 1]), are held against the JAX formulas evaluated there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import log_ndtr as jlog_ndtr
from scipy import stats

from occuspytial_tpu.ops import truncnorm as jtn
from occuspytial_tpu_torch import rng
from occuspytial_tpu_torch.ops import truncnorm as ttn

torch.set_num_threads(1)

LOC = np.concatenate([
    np.linspace(-30.0, 30.0, 241),
    [-10.0, -6.0, -5.3, -2.0, -0.5, 0.0, 0.5, 2.0, 5.3, 6.0, 10.0],
]).astype(np.float32)


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _uniforms(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_one_sided_draws_match_jax(seed):
    key = jax.random.key(seed)
    loc = np.tile(LOC, 4)
    u = torch.tensor(_uniforms(key, loc.shape))
    for jfn, tfn in ((jtn.truncnorm_positive, ttn.truncnorm_positive),
                     (jtn.truncnorm_negative, ttn.truncnorm_negative)):
        want = jfn(key, jnp.asarray(loc))
        got = tfn(torch.tensor(loc), u)
        _close(got.numpy(), want)


@pytest.mark.parametrize('seed', [3, 4])
def test_sign_draw_matches_jax(seed):
    key = jax.random.key(seed)
    loc = np.tile(LOC, 4)
    positive = np.random.default_rng(seed).random(loc.shape) < 0.5
    want = jtn.truncnorm_sign(key, jnp.asarray(loc), jnp.asarray(positive))
    u = torch.tensor(_uniforms(key, loc.shape))
    got = ttn.truncnorm_sign(torch.tensor(loc), torch.tensor(positive), u)
    _close(got.numpy(), want)
    # away from the far tails, where the clamp truncates, the signs hold
    mid = np.abs(loc) < 4.0
    g = got.numpy()
    assert (g[mid & positive] >= 0).all() and (g[mid & ~positive] <= 0).all()


@pytest.mark.parametrize('end', [0.0, 1.0])
def test_support_ends_are_finite_and_match_the_jax_formula(end):
    """u = 0 can come from jax.random.uniform, u = 1 from the port's
    rng.uniform: at both the port gives the JAX formula's value, finite
    (at u = 1 the positive branch's log1p(-u) is -inf, which the clamp
    turns into a draw at the clamp's ~5.3 sigma)."""
    loc = jnp.asarray(LOC)
    p = jnp.full(loc.shape, end, jnp.float32)
    tiny = jnp.finfo(jnp.float32).tiny
    want_pos = loc - jtn._safe_ndtri_exp(jlog_ndtr(loc) + jnp.log1p(-p))
    want_neg = loc + jtn._safe_ndtri_exp(jlog_ndtr(-loc) + jnp.log(p))
    want_sign_neg = loc + jtn._safe_ndtri_exp(
        jlog_ndtr(-loc) + jnp.log(jnp.maximum(p, tiny))
    )
    tl, tu = torch.tensor(LOC), torch.full((LOC.size,), end)
    _close(ttn.truncnorm_positive(tl, tu).numpy(), want_pos)
    _close(ttn.truncnorm_negative(tl, tu).numpy(), want_neg)
    pos = torch.arange(LOC.size) % 2 == 0
    got = ttn.truncnorm_sign(tl, pos, tu).numpy()
    _close(got, np.where(pos.numpy(), want_pos, want_sign_neg))


@pytest.mark.parametrize('loc', [-3.0, 0.0, 1.0, 3.0])
def test_port_draws_have_the_truncated_moments(loc):
    """The draws from the port's own uniforms ((0, 1]) against
    scipy.stats.truncnorm, both tails."""
    n = 100_000
    keys = rng.chain_keys(int(10 * loc) % 97, 1, rng.RUN)
    u = rng.uniform(rng.words(keys, 0, 0, n), torch.float32)[0]
    locs = torch.full((n,), loc)
    for positive in (True, False):
        draws = ttn.truncnorm_sign(
            locs, torch.full((n,), positive), u
        ).double().numpy()
        if positive:
            assert draws.min() >= 0.0
            ref = stats.truncnorm(-loc, np.inf, loc=loc)
        else:
            assert draws.max() <= 0.0
            ref = stats.truncnorm(-np.inf, -loc, loc=loc)
        assert abs(draws.mean() - ref.mean()) < 6 * ref.std() / np.sqrt(n)
        assert abs(draws.std() - ref.std()) < 0.03 * ref.std() + 1e-3


def test_float64_draws_match_the_float32_ones():
    loc = torch.tensor(LOC[np.abs(LOC) < 5.0])
    u = torch.linspace(0.01, 0.99, loc.numel())
    pos = torch.arange(loc.numel()) % 3 == 0
    a = ttn.truncnorm_sign(loc, pos, u)
    b = ttn.truncnorm_sign(loc.double(), pos, u.double())
    assert b.dtype == torch.float64
    _close(a.numpy(), b.numpy())
