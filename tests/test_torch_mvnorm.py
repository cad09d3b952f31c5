"""The port's Gaussian draws and ASIS moves against the JAX package's.

Each JAX function draws its noise from a key; the port takes the noise
as arguments, so the test makes it with jax.random on the same keys the
JAX function uses and passes it to the port. Both compute in float32
with sums in different orders: results agree to 1e-4 of their largest
entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuspytial_tpu.models import interweave as jiw
from occuspytial_tpu.ops import mvnorm as jmv
from occuspytial_tpu_torch.models import interweave as tiw
from occuspytial_tpu_torch.ops import mvnorm as tmv
from occuspytial_tpu_torch.ops.icar import icar_spectral, lattice_precision

# the tensors here are small: one intra-op thread is faster than many,
# and the suite already runs in parallel worker processes
torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _spd(d, seed):
    gen = np.random.default_rng(seed)
    a = gen.normal(size=(d, d))
    return (a @ a.T + d * np.eye(d)).astype(np.float32)


@pytest.mark.parametrize('d', [3, 6, 9])
def test_precision_mvnorm_matches_jax(d):
    keys = jax.random.split(jax.random.key(d), 3)
    precs = np.stack([_spd(d, s) for s in range(3)])
    bs = np.random.default_rng(1).normal(size=(3, d)).astype(np.float32)
    want = np.stack([
        np.asarray(jmv.precision_mvnorm(k, jnp.asarray(b), jnp.asarray(p)))
        for k, b, p in zip(keys, bs, precs)
    ])
    eps = np.stack([np.asarray(jax.random.normal(k, (d,), jnp.float32))
                    for k in keys])
    got = tmv.precision_mvnorm(_t(bs), _t(precs), _t(eps))
    _close(got.numpy(), want)


def test_precision_mvnorm_draws_without_given_noise():
    prec = _t(_spd(3, 0))
    gen = torch.Generator().manual_seed(0)
    draws = tmv.precision_mvnorm(
        torch.zeros(20000, 3), prec.expand(20000, 3, 3), generator=gen
    )
    cov = np.cov(draws.numpy().T)
    np.testing.assert_allclose(cov, np.linalg.inv(prec.numpy()), atol=0.01)


def test_sum_to_zero_and_constrained_draw_match_jax():
    q = lattice_precision(10, 15).toarray().astype(np.float64)
    _, _, sf = icar_spectral(q)
    n = q.shape[0]
    gen = np.random.default_rng(2)
    b = gen.normal(size=n).astype(np.float32)
    omega = gen.uniform(0.05, 0.3, n).astype(np.float32)
    tau = np.float32(2.5)
    key = jax.random.key(5)
    want = jmv.constrained_icar_mvnorm(
        key, jnp.asarray(b), jnp.asarray(omega), tau,
        jnp.asarray(q, jnp.float32), jnp.asarray(sf, jnp.float32),
    )
    k1, k2 = jax.random.split(key)
    eps1 = jax.random.normal(k1, (n,), jnp.float32)
    eps2 = jax.random.normal(k2, (sf.shape[1],), jnp.float32)
    got = tmv.constrained_icar_mvnorm(
        _t(b)[None], _t(omega)[None], torch.tensor([tau]),
        _t(q.astype(np.float32)), _t(sf.astype(np.float32)),
        _t(eps1)[None], _t(eps2)[None],
    )
    _close(got[0].numpy(), want)
    assert abs(float(got.sum())) < 1e-3
    x, z = gen.normal(size=(2, n)).astype(np.float32)
    _close(tmv.sum_to_zero(_t(x), _t(z)).numpy(),
           jmv.sum_to_zero(jnp.asarray(x), jnp.asarray(z)))


def test_constrained_draw_cg_matches_jax():
    """The warm-started CG form of the constrained draw against the JAX
    ``constrained_icar_mvnorm_cg`` on its own key's noise: the same eta
    and the same new warm start (the solutions of [y, 1])."""
    q = lattice_precision(10, 15).toarray().astype(np.float64)
    s_eig, u_eig, sf = icar_spectral(q)
    n = q.shape[0]
    gen = np.random.default_rng(4)
    b = gen.normal(size=n).astype(np.float32)
    omega = gen.uniform(0.05, 0.3, n).astype(np.float32)
    tau = np.float32(1.7)
    warm = 0.1 * gen.normal(size=(2, n)).astype(np.float32)
    arrays = [a.astype(np.float32) for a in (q, sf, u_eig, s_eig)]
    key = jax.random.key(6)
    want_eta, want_warm = jmv.constrained_icar_mvnorm_cg(
        key, jnp.asarray(b), jnp.asarray(omega), tau,
        *(jnp.asarray(a) for a in arrays), jnp.asarray(warm), 12,
    )
    k1, k2 = jax.random.split(key)
    eps1 = jax.random.normal(k1, (n,), jnp.float32)
    eps2 = jax.random.normal(k2, (sf.shape[1],), jnp.float32)
    eta, new_warm = tmv.constrained_icar_mvnorm_cg(
        _t(b)[None], _t(omega)[None], torch.tensor([tau]),
        *(_t(a) for a in arrays), _t(warm)[None], 12,
        _t(eps1)[None], _t(eps2)[None],
    )
    _close(eta[0].numpy(), want_eta)
    _close(new_warm[0].numpy(), want_warm)
    assert abs(float(eta.sum())) < 1e-3
    # the draw is a function of the given noise: without it, torch draws
    gen_t = torch.Generator().manual_seed(0)
    again = tmv.constrained_icar_mvnorm_cg(
        _t(b)[None], _t(omega)[None], torch.tensor([tau]),
        *(_t(a) for a in arrays), _t(warm)[None], 12, generator=gen_t,
    )[0]
    assert again.shape == (1, n) and not torch.equal(again, eta)


def _logf(a0, b0, a_lin, c_quad):
    def jf(lt):
        t = jnp.exp(lt)
        return a0 * lt - b0 * t + a_lin * jax.lax.rsqrt(t) - c_quad / t

    def tf(lt):
        t = torch.exp(lt)
        return a0 * lt - b0 * t + a_lin * torch.rsqrt(t) - c_quad / t

    return jf, tf


@pytest.mark.parametrize('method', ['mh', 'slice'])
def test_log_tau_moves_match_jax(method):
    jf, tf = _logf(5.0, 0.005, 30.0, 80.0)
    steps, sd = 12, 1.2
    key = jax.random.key(3)
    lt0 = np.float32(1.0)
    want = jiw.log_tau_move(key, jnp.float32(lt0), jf, method, sd, steps,
                            jnp.float32)
    if method == 'mh':
        k1, k2 = jax.random.split(key)
        noise = (_t(jax.random.normal(k1, (steps,), jnp.float32))[None],
                 _t(jax.random.uniform(k2, (steps,), jnp.float32))[None])
    else:
        k_y, k_place, k_j, k_shrink = jax.random.split(key, 4)
        noise = (
            _t(jax.random.exponential(k_y, dtype=jnp.float32))[None],
            _t(jax.random.uniform(k_place, (), jnp.float32))[None],
            _t(jax.random.uniform(k_j, (), jnp.float32))[None],
            _t(jax.random.uniform(k_shrink, (steps,), jnp.float32))[None],
        )
    got = tiw.log_tau_move(torch.tensor([lt0]), tf, method, sd, steps, noise)
    _close(got.numpy(), np.asarray(want)[None])
    assert float(got[0]) != float(lt0)


def test_noise_from_words_shapes():
    w = torch.arange(2 * 40, dtype=torch.int64).reshape(2, 40) * 7919
    normals, uniforms = tiw.noise_from_words(w[:, :36], 'mh', 12,
                                             torch.float32)
    assert normals.shape == uniforms.shape == (2, 12)
    e, up, uj, us = tiw.noise_from_words(w[:, :15], 'slice', 12,
                                         torch.float32)
    assert e.shape == up.shape == uj.shape == (2,) and us.shape == (2, 12)
    assert tiw.noise_words('mh', 12) == 36
    assert tiw.noise_words('slice', 12) == 15
