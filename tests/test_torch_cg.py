"""The port's eigenbasis CG against the JAX package's ops/cg.py.

Same right-hand sides, warm starts, omega, tau, U and S go through the
JAX solve (vmapped over chains) and the port's batched solve. Both run
float32 sums in different orders (XLA's and torch's reductions and
matrix products), so solutions and residuals agree to 1e-4 of their
largest entry, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuspytial_tpu.ops import cg as jcg
from occuspytial_tpu_torch.ops import cg as tcg
from occuspytial_tpu_torch.ops.cuda_cg import icar_cg_solve_cuda
from occuspytial_tpu_torch.ops.icar import icar_spectral, lattice_precision

# the tensors here are small: one intra-op thread is faster than many,
# and the suite already runs in parallel worker processes
torch.set_num_threads(1)

N, CHAINS, ROWS = 200, 4, 6


@pytest.fixture(scope='module')
def system():
    q = lattice_precision(10, 20).toarray().astype(np.float64)
    s, u, _ = icar_spectral(q)
    gen = np.random.default_rng(0)
    return dict(
        q=q.astype(np.float32), u=u.astype(np.float32),
        s=s.astype(np.float32),
        rhs=gen.normal(size=(CHAINS, ROWS, N)).astype(np.float32),
        warm=0.1 * gen.normal(size=(CHAINS, ROWS, N)).astype(np.float32),
        omega=gen.uniform(0.05, 0.3, (CHAINS, N)).astype(np.float32),
    )


def _close(got, want, tol=1e-4, floor=1e-30):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), floor)
    assert np.abs(got - want).max() <= tol * scale


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize('iters', [8, 15])
@pytest.mark.parametrize('tau', [1.0, 1e4])
def test_spectral_cg_matches_jax(system, iters, tau):
    taus = np.full(CHAINS, tau, np.float32)
    want = jax.vmap(
        lambda r, w, o, t: jcg.icar_cg_solve_spectral(
            r, w, o, t, jnp.asarray(system['u']), jnp.asarray(system['s']),
            iters, return_resid=True,
        )
    )(jnp.asarray(system['rhs']), jnp.asarray(system['warm']),
      jnp.asarray(system['omega']), jnp.asarray(taus))
    got = tcg.icar_cg_solve_spectral(
        _t(system['rhs']), _t(system['warm']), _t(system['omega']),
        _t(taus), _t(system['u']), _t(system['s']), iters,
        return_resid=True,
    )
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    # relative residuals below 1e-6 are float32 rounding of the
    # recursive residual (at tau=1e4 both solves read ~1e-17)
    _close(got[2].numpy(), want[2], floor=1e-2)
    # the K3 wrapper on CPU tensors is the plain solve
    before = icar_cg_solve_cuda.counter.launches
    wrapped = icar_cg_solve_cuda(
        _t(system['rhs']), _t(system['warm']), _t(system['omega']),
        _t(taus), _t(system['u']), _t(system['s']), iters,
        return_resid=True,
    )
    assert icar_cg_solve_cuda.counter.launches == before
    for g, w in zip(wrapped, got):
        assert torch.equal(g, w)


# from a zero start, one or two iterations leave relative residuals of
# 1e-3 to 1e-1, where a wrong residual shows. (From the random warm start
# at tau = 1e4 the first residual is ~1e4 |b| and cancels to ~0.05 |b| in
# one iteration, which leaves only float32 rounding to compare.)
STARVED = [(1.0, 1), (1.0, 2), (1e4, 1)]


@pytest.mark.parametrize('tau, iters', STARVED)
def test_starved_cg_residual_matches_jax(system, tau, iters):
    taus = np.full(CHAINS, tau, np.float32)
    zero = np.zeros_like(system['warm'])
    want = jax.vmap(
        lambda r, w, o, t: jcg.icar_cg_solve_spectral(
            r, w, o, t, jnp.asarray(system['u']), jnp.asarray(system['s']),
            iters, return_resid=True,
        )
    )(jnp.asarray(system['rhs']), jnp.asarray(zero),
      jnp.asarray(system['omega']), jnp.asarray(taus))
    got = tcg.icar_cg_solve_spectral(
        _t(system['rhs']), _t(zero), _t(system['omega']), _t(taus),
        _t(system['u']), _t(system['s']), iters, return_resid=True,
    )
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    rel_want = np.asarray(want[2])
    assert rel_want.min() >= 1e-3
    # each chain's residual to 1e-3 of itself, no absolute floor
    assert np.all(np.abs(got[2].numpy() - rel_want) <= 1e-3 * rel_want)


@pytest.mark.parametrize('rows', [2, 6, 8])
def test_plain_cg_chain_independence(system, rows):
    """A chain's solution, eigenbasis solution and residual depend on
    that chain alone. Among the same number of chains they are bit for
    bit the same whatever the other chains hold. At another chain count
    the plain solve's matrix products (all chains' rows folded into one
    matrix) may block their sums differently, so there it agrees to 1e-5
    of the largest entry; the CUDA kernel, which fixes its order of sums,
    is held to bit-identity in both cases on the card
    (tests/test_torch_cuda.py)."""
    gen = np.random.default_rng(11)
    chains = 7
    rhs = gen.normal(size=(chains, rows, N)).astype(np.float32)
    warm = 0.1 * gen.normal(size=(chains, rows, N)).astype(np.float32)
    omega = gen.uniform(0.05, 0.3, (chains, N)).astype(np.float32)
    tau = gen.uniform(0.5, 1.5, chains).astype(np.float32)
    u, s = _t(system['u']), _t(system['s'])

    def solve(sel, scramble=False):
        a = [rhs[sel].copy(), warm[sel].copy(), omega[sel].copy(),
             tau[sel].copy()]
        if scramble:  # every chain but the first of the selection
            for arr in a:
                arr[1:] = gen.uniform(0.05, 1.0, arr[1:].shape)
        return tcg.icar_cg_solve_spectral(
            *(_t(x) for x in a), u, s, 8, return_resid=True)

    among = solve(slice(2, 7))
    mixed = solve(slice(2, 7), scramble=True)
    alone = solve(slice(2, 3))
    full = solve(slice(0, 7))
    for k in range(3):
        assert torch.equal(among[k][0], mixed[k][0])
        # converged residuals (1e-7 and less) are float32 rounding and
        # compare above an absolute floor, as in the tests above
        floor = 1e-2 if k == 2 else 1e-30
        _close(alone[k][0].numpy(), among[k][0].numpy(), tol=1e-5,
               floor=floor)
        _close(full[k][2].numpy(), among[k][0].numpy(), tol=1e-5,
               floor=floor)
    assert not torch.equal(among[0][1], mixed[0][1])


def test_spectral_cg_solves_the_system(system):
    """15 iterations solve tau*Q + diag(omega) to float32 accuracy."""
    tau = torch.full((CHAINS,), 3.0)
    x, _, rel = tcg.icar_cg_solve_spectral(
        _t(system['rhs']), torch.zeros(CHAINS, ROWS, N), _t(system['omega']),
        tau, _t(system['u']), _t(system['s']), 15, return_resid=True,
    )
    q, om = _t(system['q']), _t(system['omega'])
    resid = 3.0 * (x @ q) + om[:, None, :] * x - _t(system['rhs'])
    true_rel = resid.norm(dim=-1) / _t(system['rhs']).norm(dim=-1)
    assert float(true_rel.max()) < 1e-4
    assert float(rel.max()) < 1e-4


def test_pcg_matches_jax():
    gen = np.random.default_rng(3)
    a = gen.normal(size=(30, 30))
    a = (a @ a.T + 30 * np.eye(30)).astype(np.float32)
    b = gen.normal(size=(3, 30)).astype(np.float32)
    d = np.diag(a).copy()
    want = jcg.pcg(
        lambda v: v @ jnp.asarray(a), lambda r: r / jnp.asarray(d),
        jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)), 12,
        return_resid=True,
    )
    got = tcg.pcg(
        lambda v: v @ _t(a), lambda r: r / _t(d), _t(b),
        torch.zeros(3, 30), 12, return_resid=True,
    )
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])


def test_site_basis_cg_matches_jax(system):
    tau = 2.0
    want = jcg.icar_cg_solve(
        jnp.asarray(system['rhs'][0]), jnp.asarray(system['warm'][0]),
        jnp.asarray(system['omega'][0]), tau, jnp.asarray(system['q']),
        jnp.asarray(system['u']), jnp.asarray(system['s']), 10,
    )
    got = tcg.icar_cg_solve(
        _t(system['rhs'][0]), _t(system['warm'][0]), _t(system['omega'][0]),
        tau, _t(system['q']), _t(system['u']), _t(system['s']), 10,
    )
    _close(got.numpy(), want)
