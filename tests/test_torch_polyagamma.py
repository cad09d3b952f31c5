"""The port's Pólya-Gamma samplers against the JAX package.

The plain torch rejection sampler is the CPU version of the CUDA kernel
(csrc/pg_devroye.cu); here it is held against the JAX package's TPU
rejection loop (ops/pallas_pg.py:_run_rejection, plain jnp/lax code that
runs on the CPU) fed the same uniform planes. float32 transcendental
functions round differently in XLA and torch, so a lane whose proposal
sits within rounding of an accept/reject boundary may take another
round: the tolerance is 99.9% of lanes equal to 1e-5 relative.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuspytial_tpu.ops import pallas_pg as jpallas
from occuspytial_tpu.ops import polyagamma as jpg
from occuspytial_tpu_torch import rng
from occuspytial_tpu_torch.ops import polyagamma as tpg
from occuspytial_tpu_torch.ops.cuda_pg import pg_devroye_cuda

# the tensors here are small: one intra-op thread is faster than many,
# and the suite already runs in parallel worker processes
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_mass_texpon_mean_var_match_jax():
    c = np.concatenate([
        np.linspace(0.0, 3.0, 301), np.geomspace(3.0, 60.0, 100)
    ]).astype(np.float32)
    # for c above ~17 the weight underflows into float32's subnormal
    # range, where the two libraries' roundings differ in every digit:
    # below the smallest normal number only the absolute error counts
    np.testing.assert_allclose(
        tpg._mass_texpon(_t(c)).numpy(),
        np.asarray(jpg._mass_texpon(jnp.asarray(c))), rtol=1e-5,
        atol=np.finfo(np.float32).tiny,
    )
    z = np.concatenate([
        np.linspace(-8.0, 8.0, 321), [1e-7, -1e-7, 5e-4, 40.0]
    ]).astype(np.float32)
    np.testing.assert_allclose(
        tpg.pg_mean(_t(z)).numpy(), np.asarray(jpg.pg_mean(jnp.asarray(z))),
        rtol=1e-5,
    )
    # pg_var's sinh(z) - z cancels in float32 for 1e-3 <= |z| < 0.5,
    # where XLA and torch lose different digits (up to 5e-4 relative
    # apart at z = 0.05): there the port is held against float64
    var = tpg.pg_var(_t(z)).numpy()
    far = (np.abs(z) >= 0.5) | (np.abs(z) < 1e-3)
    np.testing.assert_allclose(
        var[far], np.asarray(jpg.pg_var(jnp.asarray(z)))[far], rtol=1e-5,
    )
    exact = tpg.pg_var(_t(z.astype(np.float64))).numpy()
    np.testing.assert_allclose(var[~far], exact[~far], rtol=1e-4)


@pytest.mark.parametrize('reference', ['jax', 'port'])
def test_kernel_input_arithmetic_matches_reference(reference):
    """The CUDA kernel computes c, k_exp and the mixture mass itself, the
    mass with log Phi written in erfcx (csrc/pg_devroye.cu:mass_texpon).
    Its torch transcription agrees with the JAX _pg_inputs and with the
    port's pg_inputs over c in [0, 40]: c and k_exp are the same
    operations (1e-6 relative), and the mass, which goes through other
    library functions (erfcx and log1p against log_ndtr and logaddexp),
    to 2e-6 absolute on a quantity in (0, 1)."""
    c = np.concatenate([
        np.linspace(0.0, 40.0, 4001), np.geomspace(1e-6, 40.0, 500)
    ]).astype(np.float32)
    gen = np.random.default_rng(5)
    z = (2.0 * c * gen.choice([-1.0, 1.0], c.size)).astype(np.float32)
    if reference == 'jax':
        want = [np.asarray(a) for a in jpallas._pg_inputs(jnp.asarray(z))]
    else:
        want = [a.numpy() for a in tpg.pg_inputs(_t(z))]
    tc = 0.5 * torch.abs(_t(z))
    ratio = tpg.mass_texpon_erfcx(tc).numpy()
    k_exp = (math.pi * math.pi / 8.0 + 0.5 * tc * tc).numpy()
    np.testing.assert_allclose(tc.numpy(), want[0], rtol=1e-6)
    np.testing.assert_allclose(k_exp, want[2], rtol=1e-6)
    assert np.isfinite(ratio).all()
    assert np.abs(ratio - want[1]).max() <= 2e-6


def test_log_ndtr_erfcx_keeps_its_digits_in_the_tail():
    """At the mass's strongly negative arguments (down to -33 at c = 40)
    Phi(x) underflows in float32 but the erfcx form of log Phi(x) stays
    within 1e-6 relative of scipy's float64 log_ndtr."""
    from scipy.special import log_ndtr

    x = np.linspace(-33.0, 5.0, 2000).astype(np.float32)
    got = tpg._log_ndtr_erfcx(_t(x)).numpy()
    want = log_ndtr(x.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _partial_sums(x, v):
    """float64 partial sums S_1..S_4 of the alternating series and the
    test statistic y = v * a_0(x)."""
    x = x.astype(np.float64)
    small = x <= 0.64
    a0 = 0.5 * np.pi * np.exp(np.where(
        small, 1.5 * np.log(2.0 / (np.pi * x)) - 0.5 / x,
        -(np.pi ** 2 / 8.0) * x,
    ))
    q = np.exp(np.where(small, -4.0 / x, -(np.pi ** 2) * x))
    s, term, qp, sums = a0.copy(), a0.copy(), np.ones_like(x), []
    for n in range(1, 5):
        qp = qp * q
        term = term * ((2.0 * n + 1.0) / (2.0 * n - 1.0)) * qp
        s = s - term if n % 2 else s + term
        sums.append(s.copy())
    return v * a0, np.stack(sums)


def test_series_accept_matches_jax():
    gen = np.random.default_rng(1)
    x = gen.uniform(0.05, 3.0, 100_000).astype(np.float32)
    v = gen.uniform(0.0, 1.0, 100_000).astype(np.float32)
    got = tpg._series_accept(_t(x), _t(v)).numpy()
    want = np.asarray(jpg._series_accept(jnp.asarray(x), jnp.asarray(v)))
    assert (got == want).mean() >= 0.999
    bad = got != want
    if bad.any():
        y, sums = _partial_sums(x[bad], v[bad].astype(np.float64))
        near = np.min(np.abs(y - sums) / np.abs(sums), axis=0)
        assert (near < 1e-5).all()


class _Out:
    """A stand-in for a Pallas output ref: keeps what is stored."""

    def __setitem__(self, key, value):
        self.value = value


@pytest.mark.parametrize('seed', [0, 1])
def test_plain_rejection_matches_jax_run_rejection(seed):
    gen = np.random.default_rng(seed)
    rows = 8
    z = np.concatenate([
        gen.normal(0.0, 3.0, (rows - 2) * 128),
        gen.uniform(-40.0, 40.0, 2 * 128),
    ]).astype(np.float32).reshape(rows, 128)
    planes = (1.0 - gen.uniform(size=(64, 9, rows, 128))).astype(np.float32)
    c, ratio, k_exp = jpallas._pg_inputs(jnp.asarray(z))
    out = _Out()
    jplanes = jnp.asarray(planes)
    jpallas._run_rejection(
        c, ratio, k_exp, lambda k: (lambda idx: jplanes[k, idx]), out
    )
    want = np.asarray(out.value)
    tc, tr, tk = tpg.pg_inputs(_t(z))
    flat = torch.as_tensor(planes).reshape(64, 9, -1)
    got = tpg._rejection(tc, tr, tk, lambda k, idx: flat[k][:, idx]).numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert (rel <= 1e-5).mean() >= 0.999


@pytest.mark.parametrize('zv', [0.0, 1.0, 4.0, 16.0])
def test_pg_devroye_moments(zv):
    sub = rng.words(rng.chain_keys(7, 4, rng.RUN), 3, 0, 2)
    z = torch.full((4, 16384), zv)
    d = tpg.pg_devroye(sub, z).double()
    m = float(tpg.pg_mean(torch.tensor(zv, dtype=torch.float64)))
    v = float(tpg.pg_var(torch.tensor(zv, dtype=torch.float64)))
    assert abs(float(d.mean()) - m) < 5 * math.sqrt(v / d.numel())
    assert abs(float(d.var()) - v) < 0.05 * v + 5e-5


def test_pg_devroye_per_chain_key_contract():
    keys = rng.chain_keys(2, 4, rng.RUN)
    sub = rng.words(keys, 0, 0, 2)
    z = torch.linspace(-3.0, 3.0, 300).expand(4, 300).contiguous()
    a = tpg.pg_devroye(sub, z)
    sub2 = sub.clone()
    sub2[2] = torch.tensor([77, 78])
    b = tpg.pg_devroye(sub2, z)
    assert torch.equal(a[[0, 1, 3]], b[[0, 1, 3]])
    assert not torch.equal(a[2], b[2])
    # a chain's draws do not depend on the batch around it
    assert torch.equal(tpg.pg_devroye(sub[1:2], z[1:2]), a[1:2])


def test_pg_devroye_float64_lane():
    sub = rng.words(rng.chain_keys(3, 2, rng.RUN), 0, 0, 2)
    z = torch.linspace(-5.0, 5.0, 500, dtype=torch.float64).expand(2, 500)
    d = tpg.pg_devroye(sub, z)
    assert d.dtype == torch.float64 and bool(torch.isfinite(d).all())
    assert bool((d > 0).all())


def test_pg_gamma_mean():
    sub = rng.words(rng.chain_keys(8, 4, rng.RUN), 0, 0, 2)
    for zv in (0.0, 2.0, 10.0):
        z = torch.full((4, 4096), zv)
        d = tpg.pg_gamma(sub, z).double()
        m = float(tpg.pg_mean(torch.tensor(zv, dtype=torch.float64)))
        v = float(tpg.pg_var(torch.tensor(zv, dtype=torch.float64)))
        assert abs(float(d.mean()) - m) < 5 * math.sqrt(v / d.numel())


def test_kernel_wrapper_on_cpu_is_the_plain_sampler():
    sub = rng.words(rng.chain_keys(4, 3, rng.RUN), 0, 0, 2)
    z = torch.linspace(-6.0, 6.0, 777).expand(3, 777).contiguous()
    before = pg_devroye_cuda.counter.launches
    assert torch.equal(pg_devroye_cuda(sub, z), tpg.pg_devroye(sub, z))
    assert pg_devroye_cuda.counter.launches == before


def test_lane_table_draws_the_full_width_lanes():
    """A lane table makes column j draw as global lane lanes[j]: a band of
    lanes drawn alone is the full-width draw gathered at those lanes, bit
    for bit, through the plain sampler and the wrapper's CPU path."""
    sub = rng.words(rng.chain_keys(3, 3, rng.RUN), 0, 0, 2)
    gen = np.random.default_rng(7)
    z_full = torch.tensor(gen.normal(0.0, 5.0, (3, 300)), dtype=torch.float32)
    full = tpg.pg_devroye(sub, z_full)
    for lanes in (torch.arange(101, 171),
                  torch.tensor(gen.permutation(300)[:64])):
        z = z_full[:, lanes].contiguous()
        got = tpg.pg_devroye(sub, z, lanes)
        assert torch.equal(got, full[:, lanes])
        assert torch.equal(pg_devroye_cuda(sub, z, lanes), got)
    # without a table, column j is lane j
    assert torch.equal(tpg.pg_devroye(sub, z_full[:, :50]), full[:, :50])


def test_random_polyagamma_dispatches_as_jax():
    """The JAX entry point's dispatch: 'devroye' is the exact sampler,
    'gamma' the truncated series with its ``trunc``, and any other method
    raises the JAX error."""
    sub = rng.words(rng.chain_keys(5, 2, rng.RUN), 0, 0, 2)
    z = torch.linspace(-4.0, 4.0, 200).expand(2, 200).contiguous()
    assert torch.equal(tpg.random_polyagamma(sub, z),
                       tpg.pg_devroye(sub, z))
    assert torch.equal(tpg.random_polyagamma(sub, z, 'gamma', trunc=16),
                       tpg.pg_gamma(sub, z, trunc=16))
    import jax

    for mod, key, zz in ((tpg, sub, z),
                         (jpg, jax.random.key(0), jnp.asarray(z.numpy()))):
        with pytest.raises(ValueError) as err:
            mod.random_polyagamma(key, zz, method='nope')
        assert str(err.value) == "unknown PG sampling method: 'nope'"
    # and the draws have the JAX function's moments
    zz = torch.full((4, 4096), 2.0)
    keys = rng.words(rng.chain_keys(6, 4, rng.RUN), 0, 0, 2)
    jd = np.asarray(jpg.random_polyagamma(jax.random.key(1),
                                          jnp.full((16384,), 2.0)))
    d = tpg.random_polyagamma(keys, zz).double().numpy().ravel()
    sd = math.sqrt(float(tpg.pg_var(torch.tensor(2.0, dtype=torch.float64)))
                   * (1 / d.size + 1 / jd.size))
    assert abs(d.mean() - jd.mean()) < 5 * sd
