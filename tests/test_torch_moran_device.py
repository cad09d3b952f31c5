"""The RSR samplers' ``basis='device'`` route (``ops/icar.py:
moran_basis_device``, ``models/field.py: RSRField``) on the CPU in
float64, at 150 sites: its columns are the host route's dense ``eigh``
basis signed by the same convention; it spans the JAX package's Lanczos
subspace; the ``'host'`` route is what it was, bit for bit; and the
default route resolves by device and site count."""

import numpy as np
import pytest
import torch

from occuspytial_tpu.ops import icar as jicar
from occuspytial_tpu_torch import LogitRSRGibbs, ProbitRSRGibbs
from occuspytial_tpu_torch.models.field import resolve_basis
from occuspytial_tpu_torch.ops import icar
from occuspytial_tpu_torch.utils import make_data

torch.set_num_threads(1)

KWS = [dict(r=0.5), dict(r=0.2), dict(num_eigs=15), dict(num_eigs=40)]


@pytest.fixture(scope='module')
def data():
    return make_data(n=150, ns=100, p=3, q=2, random_state=10)


def _signed_np(k):
    """The host basis under the device route's convention: each column's
    inner product with the fixed vector g positive."""
    g = icar.sign_vector(k.shape[0])
    return k * np.where(g @ k < 0, -1.0, 1.0)


@pytest.mark.parametrize('kw', KWS)
def test_columns_are_the_dense_basis_under_the_convention(data, kw):
    """Both are float64 eigh of the same operator: only rounding (orders
    below 1e-8 at these gaps) parts them once the signs are fixed."""
    Q, X = data[0], data[2]
    k_host, _ = icar.moran_basis(X, Q.toarray(), **kw)
    k, q_rsr, info = icar.moran_basis_device(X, Q, device='cpu', **kw)
    assert k.dtype == q_rsr.dtype == torch.float64
    want = _signed_np(k_host)
    np.testing.assert_allclose(k.numpy(), want, rtol=0, atol=1e-8)
    np.testing.assert_allclose(q_rsr.numpy(), want.T @ Q.toarray() @ want,
                               rtol=0, atol=1e-8)
    assert torch.equal(q_rsr, q_rsr.T)
    g = torch.as_tensor(icar.sign_vector(k.shape[0]))
    assert bool(torch.all(g @ k > 0))
    assert info['margin'] == pytest.approx(
        float(torch.min(g @ k) / torch.norm(g)))
    assert info['eigvals'].shape == (X.shape[0],)


@pytest.mark.parametrize('kw', [dict(r=0.5), dict(num_eigs=12)])
def test_spans_the_jax_lanczos_subspace(data, kw, monkeypatch):
    """The JAX package's sparse route (Lanczos from a random start, the
    threshold lowered to this problem) keeps the same subspace; its
    basis has arbitrary signs, so the projectors are compared."""
    Q, X = data[0], data[2]
    monkeypatch.setattr(jicar, '_MORAN_LANCZOS_THRESHOLD', X.shape[0])
    k_j, q_j = jicar.moran_basis(X, Q, **kw)
    k, q_rsr, _ = icar.moran_basis_device(X, Q, device='cpu', **kw)
    k = k.numpy()
    assert k.shape == k_j.shape and k.shape[1] > 0
    np.testing.assert_allclose(k @ (k.T @ k_j), k_j, atol=1e-6)
    np.testing.assert_allclose(np.linalg.eigvalsh(q_rsr.numpy()),
                               np.linalg.eigvalsh(q_j), rtol=1e-6,
                               atol=1e-8)


@pytest.mark.parametrize('cls', [LogitRSRGibbs, ProbitRSRGibbs])
def test_host_route_is_unchanged(data, cls):
    """``'host'``, and the CPU's default, keep the host functions' arrays
    bit for bit (and so the JAX package's, tests/test_torch_rsr.py)."""
    Q, W, X, y = data[:4]
    k, q_rsr = icar.moran_basis(X, Q, r=0.5)
    for basis in ('host', None):
        s = cls(Q, W, X, y, random_state=3, basis=basis,
                dtype=torch.float64, device='cpu')
        assert s.basis == 'host' and s.basis_seconds > 0
        assert torch.equal(s.fixed['K'], torch.as_tensor(k))
        assert torch.equal(s.fixed['Q_rsr'], torch.as_tensor(q_rsr))
        if cls is LogitRSRGibbs:
            assert torch.equal(s.fixed['sqrt_factor'], torch.as_tensor(
                icar.psd_sqrt_factor(q_rsr)))


def test_default_route():
    """``'device'`` on a CUDA card from 2,048 sites, ``'host'`` below it
    and on the CPU; a route named is kept; an unknown one raises."""
    assert icar._MORAN_LANCZOS_THRESHOLD == 2048
    assert resolve_basis(None, 2048, 'cuda') == 'device'
    assert resolve_basis(None, 10000, torch.device('cuda', 0)) == 'device'
    assert resolve_basis(None, 2047, 'cuda') == 'host'
    assert resolve_basis(None, 10000, 'cpu') == 'host'
    assert resolve_basis('host', 10000, 'cuda') == 'host'
    assert resolve_basis('device', 150, 'cpu') == 'device'
    with pytest.raises(ValueError, match='basis route'):
        resolve_basis('gpu', 150, 'cpu')


@pytest.mark.parametrize('cls', [LogitRSRGibbs, ProbitRSRGibbs])
def test_samplers_take_the_device_route(data, cls):
    """A sampler given ``basis='device'`` holds the device route's K and
    Q_rsr; the logit sampler's E (E E' = Q_rsr) has its eigenvectors
    signed the same way; both draw."""
    Q, W, X, y = data[:4]
    s = cls(Q, W, X, y, random_state=3, r=0.5, basis='device',
            dtype=torch.float64, device='cpu')
    k, q_rsr, _ = icar.moran_basis_device(X, Q, r=0.5, device='cpu')
    assert s.basis == 'device' and s.basis_seconds > 0
    assert torch.equal(s.fixed['K'], k)
    assert torch.equal(s.fixed['Q_rsr'], q_rsr)
    if cls is LogitRSRGibbs:
        e = s.fixed['sqrt_factor']
        np.testing.assert_allclose((e @ e.T).numpy(), q_rsr.numpy(),
                                   atol=1e-10)
        s_e, u_e = torch.linalg.eigh(q_rsr)
        g = torch.as_tensor(icar.sign_vector(q_rsr.shape[0]))
        assert bool(torch.all(g @ (e / torch.sqrt(s_e)) > 0))
    else:
        np.testing.assert_allclose(s.fixed['KTX'].numpy(),
                                   (k.T @ torch.as_tensor(X)).numpy())
    post = s.sample(4, chains=2, progressbar=False)
    assert np.all(np.isfinite(post['tau']))
