"""The port's CUDA kernels and main path on the card (marked ``cuda``).

Each kernel is held against its plain torch version on the same CUDA
tensors. Every test skips without a card, so on a CPU-only machine this
file counts no passes. The file imports no JAX (the card machine has
none); run it there with

    python -m pytest tests/test_torch_cuda.py -q -o addopts='' \
        --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from occuspytial_tpu_torch import LogitICARGibbs, rng
from occuspytial_tpu_torch.ops import cg as tcg
from occuspytial_tpu_torch.ops import polyagamma as tpg
from occuspytial_tpu_torch.ops.cuda_cg import icar_cg_solve_cuda
from occuspytial_tpu_torch.ops.cuda_pg import pg_devroye_cuda
from occuspytial_tpu_torch.ops.icar import icar_spectral, lattice_precision
from occuspytial_tpu_torch.utils import make_data

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card; the CPU run holds the plain version')
    return torch.device('cuda')


def test_pg_kernel_matches_plain(dev):
    sub = rng.words(rng.chain_keys(4, 8, rng.RUN, dev), 0, 0, 2)
    z = torch.linspace(-20.0, 20.0, 4034, device=dev).expand(8, 4034)
    z = z.contiguous()
    before = pg_devroye_cuda.launches
    got = pg_devroye_cuda(sub, z)
    torch.cuda.synchronize()
    assert pg_devroye_cuda.launches == before + 1
    want = tpg.pg_devroye(sub, z)
    rel = ((got - want).abs() / want.abs()).cpu().numpy()
    # transcendental functions may round differently in the kernel and in
    # torch's CUDA ops, which can move a lane across an accept boundary
    assert (rel <= 1e-5).mean() >= 0.999
    with pytest.raises(TypeError):
        pg_devroye_cuda(sub, z.double())


@pytest.mark.parametrize('tau', [1.0, 1e4])
def test_cg_kernel_matches_plain(dev, tau):
    q = lattice_precision(10, 20).toarray().astype(np.float64)
    s, u, _ = icar_spectral(q)
    gen = torch.Generator(device=dev).manual_seed(0)
    chains, rows, n = 4, 6, q.shape[0]
    args = (
        torch.randn((chains, rows, n), device=dev, generator=gen),
        0.1 * torch.randn((chains, rows, n), device=dev, generator=gen),
        0.05 + 0.25 * torch.rand((chains, n), device=dev, generator=gen),
        torch.full((chains,), tau, device=dev),
        torch.as_tensor(u, dtype=torch.float32, device=dev),
        torch.as_tensor(s, dtype=torch.float32, device=dev),
        8,
    )
    before = icar_cg_solve_cuda.launches
    got = icar_cg_solve_cuda(*args, return_resid=True)
    torch.cuda.synchronize()
    assert icar_cg_solve_cuda.launches == before + 1
    want = tcg.icar_cg_solve_spectral(*args, return_resid=True)
    # float32 sums in another order: 1e-4 of the largest entry; relative
    # residuals below 1e-6 are rounding and compare absolutely (the
    # starved solves below compare them relatively)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert float(((got[2] - want[2]).abs()
                  / (want[2].abs() + 1e-3)).max()) <= 1e-3


@pytest.mark.parametrize('tau, iters', [(1.0, 1), (1.0, 2), (1e4, 1)])
def test_cg_kernel_starved_residual_matches_plain(dev, tau, iters):
    """From a zero start, one or two iterations leave relative residuals
    of 1e-3 to 1e-1: the kernel's agree with the plain solve's to 1e-3 of
    themselves, with no absolute floor."""
    q = lattice_precision(10, 20).toarray().astype(np.float64)
    s, u, _ = icar_spectral(q)
    gen = torch.Generator(device=dev).manual_seed(1)
    chains, rows, n = 4, 6, q.shape[0]
    args = (
        torch.randn((chains, rows, n), device=dev, generator=gen),
        torch.zeros((chains, rows, n), device=dev),
        0.05 + 0.25 * torch.rand((chains, n), device=dev, generator=gen),
        torch.full((chains,), tau, device=dev),
        torch.as_tensor(u, dtype=torch.float32, device=dev),
        torch.as_tensor(s, dtype=torch.float32, device=dev),
        iters,
    )
    got = icar_cg_solve_cuda(*args, return_resid=True)
    want = tcg.icar_cg_solve_spectral(*args, return_resid=True)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert float(want[2].min()) >= 1e-3
    assert bool(((got[2] - want[2]).abs() <= 1e-3 * want[2]).all())


def test_main_path_runs_and_is_reproducible(dev):
    Q, W, X, y, *_ = make_data(n=150, ns=100, p=3, q=2, random_state=10)
    draws = []
    for _ in range(2):
        s = LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                           cg_iters=15)
        assert s.pg_method == 'pallas_packed'
        before = pg_devroye_cuda.launches
        post = s.sample(20, chains=4, progressbar=False)
        assert pg_devroye_cuda.launches == before + 21  # + cold check
        draws.append(post)
    for name in ('alpha', 'beta', 'tau'):
        assert np.isfinite(draws[0][name]).all()
        # deterministic segment sums: one seed gives one run on the card
        np.testing.assert_array_equal(draws[0][name], draws[1][name])
    with pytest.raises(TypeError):
        LogitICARGibbs(Q, W, X, y, dtype='float64', solver='cg').sample(
            2, progressbar=False)
