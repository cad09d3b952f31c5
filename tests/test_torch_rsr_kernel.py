"""The collapsed probit RSR sweep kernel's plain side on the CPU.

``ProbitRSRGibbs`` takes the CUDA kernel of ``ops/cuda_rsr.py`` only for
the collapsed ladder in float32 on a CUDA device with q and p within the
kernel's budget; everywhere else its draws are the torch ops of
``models/probit.py``. Here: the dispatch predicate case by case, the
kernel's q-space order written in torch against the torch path in
float64 at the benchmark cell's shapes, and the kernel's name against the
reader of its layer's metric. The kernel itself is held against the torch
path on the card (``tests/test_torch_cuda.py``).
"""

import importlib.util
import json
import re
from pathlib import Path

import pytest
import torch

from chip_smoke import make_lattice_dataset
from h100bench.generators import make_data as generator
from occuspytial_tpu_torch import LogitRSRGibbs, ProbitRSRGibbs, _build
from occuspytial_tpu_torch.ops import cuda_rsr
from occuspytial_tpu_torch.ops.mvnorm import cholesky_solve, precision_mvnorm

ROOT = Path(__file__).resolve().parents[1]


def kernel_order(tau, ku, xu, eps_beta, eps_eta, fixed):
    """The kernel's q-space order in torch ops: one factor of A = tau
    Q_rsr + K'K/2; [K'X, ku] through L and L' together; a_beta, b_beta
    and the p x p draw from those solves; b_eta = (ku - K'X beta)/2 (the
    torch path contracts u - X beta with K); eta's mean through L and L',
    its noise through L'^-1."""
    low = torch.linalg.cholesky(
        tau[:, None, None] * fixed['Q_rsr'] + 0.5 * fixed['KTK'])
    ktx = fixed['KTX']
    q, p = ktx.shape
    rhs = torch.cat([ktx.expand(tau.shape[0], q, p), ku[..., None]], dim=-1)
    sol = cholesky_solve(rhs, low)
    a_beta = (0.5 * fixed['XTX'] + fixed['b_prec']
              - 0.25 * (ktx.T @ sol[..., :p]))
    b_beta = (0.5 * xu - 0.25 * (sol[..., p] @ ktx)
              + fixed['b_prec_by_mu'])
    beta = precision_mvnorm(b_beta, 0.5 * (a_beta + a_beta.mT), eps_beta)
    b_eta = 0.5 * (ku - beta @ ktx.T)
    mean = cholesky_solve(b_eta[..., None], low)[..., 0]
    fluct = torch.linalg.solve_triangular(
        low.mT, eps_eta[..., None], upper=True)[..., 0]
    return beta, mean + fluct


# (q, p, device, dtype) -> whether the sweep is the CUDA kernel
_DISPATCH = [
    (128, 3, 'cuda', torch.float32, True),
    (1, 1, 'cuda:0', torch.float32, True),
    (100, 6, 'cuda', torch.float32, True),
    (128, 3, 'cpu', torch.float32, False),
    (128, 3, 'cuda', torch.float64, False),
    (129, 3, 'cuda', torch.float32, False),
    (512, 3, 'cuda', torch.float32, False),
    (128, 7, 'cuda', torch.float32, False),
]


@pytest.mark.parametrize('q, p, device, dtype, want', _DISPATCH)
def test_predicate_by_device_dtype_and_size(q, p, device, dtype, want):
    """The kernel takes float32 on a CUDA device with q <= MAX_Q (128)
    and p within the unrolled draw's bound (6); the CPU, float64 and
    larger sizes stay in torch."""
    assert cuda_rsr.MAX_Q == 128 and cuda_rsr.MAX_P == 6
    assert cuda_rsr.takes_kernel(q, p, torch.device(device), dtype) is want


@pytest.fixture(scope='module')
def lattice():
    return make_lattice_dataset(10, 10, ns=50, seed=3)[:4]


def _make(case, data):
    Q, W, X, y = data
    if case == 'logit':
        return LogitRSRGibbs(Q, W, X, y, random_state=4, device='cpu')
    kw = {'float64': dict(dtype=torch.float64),
          'uncollapsed': dict(collapsed=False)}.get(case, {})
    if case == 'wide_q':
        Q, W, X, y, *_ = make_lattice_dataset(12, 12, ns=60, seed=3)
        kw = dict(q=cuda_rsr.MAX_Q + 2)
    return ProbitRSRGibbs(Q, W, X, y, random_state=4, device='cpu', **kw)


@pytest.mark.parametrize('case, calls', [
    ('collapsed', 2), ('cpu', 0), ('float64', 0), ('wide_q', 0),
    ('uncollapsed', 0), ('logit', 0),
])
def test_sweeps_take_the_kernel_only_where_the_predicate_holds(
        monkeypatch, lattice, case, calls):
    """Two steps with the kernel replaced by :func:`kernel_order`, the
    predicate's device test passed (but in the ``'cpu'`` case): only the
    collapsed float32 ProbitRSRGibbs within the kernel's sizes calls it,
    once a sweep, and loads it when made; CPU, float64, q > MAX_Q,
    ``collapsed=False`` and ``LogitRSRGibbs`` draw what they draw without
    it, bit for bit."""
    plain = _make(case, lattice).sample(2, chains=2, progressbar=False)
    got = []

    def fake(*args):
        got.append(args[0].shape)
        return kernel_order(*args)

    monkeypatch.setattr(cuda_rsr, 'collapsed_rsr_cuda', fake)
    loaded = []
    monkeypatch.setattr(cuda_rsr, 'load', lambda: loaded.append(1))
    if case != 'cpu':
        takes = cuda_rsr.takes_kernel
        monkeypatch.setattr(
            cuda_rsr, 'takes_kernel',
            lambda q, p, device, dtype: takes(q, p, 'cuda', dtype))
    s = _make(case, lattice)
    post = s.sample(2, chains=2, progressbar=False)
    assert len(got) == calls * getattr(s, 'spatial_sweeps', 1)
    # a sampler that takes the kernel builds it when it is made
    assert len(loaded) == (calls > 0)
    for name in ('alpha', 'beta', 'tau'):
        assert torch.isfinite(torch.as_tensor(post[name])).all()
        if not calls:
            assert (post[name] == plain[name]).all(), name


@pytest.fixture(scope='module')
def cell():
    """The benchmark cell's sampler in float64 on the CPU: 1,000 sites,
    p = 3, q = 128."""
    cfg = json.loads((ROOT / 'h100bench/configs/probit_rsr1k.json')
                     .read_text())
    d = generator.generate(cfg['data'], cfg['data_seed'])
    s = ProbitRSRGibbs(d['Q'], d['W'], d['X'], d['y'], random_state=4,
                       dtype=torch.float64, device='cpu',
                       **cfg['sampler_args'])
    assert (s.q_dim, s.n_beta) == (128, 3)
    return s


@pytest.mark.parametrize('seed', [0, 1])
def test_kernel_order_is_the_torch_path_in_float64(cell, seed):
    """The kernel's order (:func:`kernel_order`) and the torch path
    (``_collapsed_factor``, ``_update_beta_collapsed``,
    ``_update_eta_collapsed``) on the same inputs and noise, 4 chains at
    the cell's shapes: the same draws to 1e-10 in float64, so the
    reordering is the same mathematics."""
    s, f = cell, cell.fixed
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    tau = 0.2 + 40.0 * torch.rand(4, generator=gen, dtype=torch.float64)
    u = 1.5 * normal(4, s.n)
    eps_beta, eps_eta = normal(4, 3), normal(4, 128)
    chol = s._collapsed_factor(tau, f)
    beta = s._update_beta_collapsed({}, u, tau, f, eps_beta, chol)
    eta, spatial = s._update_eta_collapsed({'beta': beta}, u, tau, f,
                                           eps_eta, chol)
    got_beta, got_eta = kernel_order(tau, u @ f['K'], u @ f['X'], eps_beta,
                                     eps_eta, f)
    torch.testing.assert_close(got_beta, beta, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got_eta, eta, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got_eta @ f['K'].T, spatial, rtol=1e-10,
                               atol=1e-10)


def test_kernel_name_is_read_by_its_layer_metric():
    """Every ``__global__`` function of ``csrc/collapsed_rsr.cu`` matches
    the pattern by which ``rsr_factor.us_per_step`` (and with it
    ``rsr_factor.roofline``) finds the layer's kernels in a trace."""
    path = ROOT / 'h100bench/metrics/rsr_factor.us_per_step.py'
    spec = importlib.util.spec_from_file_location('_rsr_us', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (_build.SOURCE_DIR / 'collapsed_rsr.cu').read_text()
    names = re.findall(
        r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)', src)
    assert names == ['collapsed_rsr_potrf_trsm_kernel']
    assert all(mod.PATTERN.search(n) for n in names)


def test_wrapper_refuses_cpu_tensors(lattice):
    """On the CPU the wrapper raises (the sampler never calls it there)."""
    s = _make('collapsed', lattice)
    q, p = s.q_dim, s.n_beta
    zeros = torch.zeros
    with pytest.raises(ValueError, match='runs on CUDA'):
        cuda_rsr.collapsed_rsr_cuda(zeros(2), zeros(2, q), zeros(2, p),
                                    zeros(2, p), zeros(2, q), s.fixed)
    assert not s._takes_kernel
