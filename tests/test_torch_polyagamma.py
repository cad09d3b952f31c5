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
    before = pg_devroye_cuda.launches
    assert torch.equal(pg_devroye_cuda(sub, z), tpg.pg_devroye(sub, z))
    assert pg_devroye_cuda.launches == before
