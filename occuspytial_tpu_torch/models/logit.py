"""Logit-link Gibbs samplers with the ICAR or RSR spatial random effect.

Port of ``LogitICARGibbs`` and ``LogitRSRGibbs`` from the JAX package's
``models/logit.py`` (reference gibbs/logit.py, Pólya-Gamma augmentation).
One step, per chain (chains are the leading dimension of every state
tensor):

1. one PG(1, z) draw for both linear predictors, the sites' and the
   visits' (the CUDA kernel on the card, :mod:`..ops.cuda_pg`);
2. ``spatial_sweeps`` times: tau | eta (gamma), the collapsed beta / eta
   update (one multi-row solve against tau*Q + diag(omega), by the
   eigenbasis CG or by Cholesky; RSR: eta in the q-dimensional Moran
   basis, then beta), and the ASIS log-tau move;
3. alpha | z, omega_a and z | rest.

Each update takes its noise as arguments (the step makes it from the
chain's counter-based stream, see :mod:`..rng`), so a test can feed the
port and the JAX package the same draws.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import rng
from .._device import resolve_dtype
from ..ops import icar
from ..ops.cg import icar_cg_solve_spectral
from ..ops.cuda_cg import icar_cg_solve_cuda
from ..ops.cuda_pg import pg_devroye_cuda
from ..ops.mvnorm import (
    lambda_cholesky_solve,
    precision_mvnorm,
    rsr_mvnorm,
    sum_to_zero,
)
from ..ops.polyagamma import pg_devroye, pg_gamma
from .base import INIT_ETA_BASIS, GibbsBase
from .interweave import ancillary_tau_move, noise_from_words, noise_words

#: below this site count the dense Cholesky eta draw is the default
_CG_AUTO_THRESHOLD = 512

#: from this site count a sparse Q selects the matrix-free graph path
_GRAPH_AUTO_THRESHOLD = 4096

_NOT_PORTED = {
    'stencil': "solver='stencil' (the lattice path, ROADMAP.md module "
               "queue item 12: ops/stencil.py) is not ported yet",
    'graph': "solver='graph' (the arbitrary-graph path, ROADMAP.md module "
             "queue item 13: ops/graph.py) is not ported yet",
}

#: update indices of a step's draws (see _plan); per sweep i the block
#: starts at 1 + _SWEEP_UPDATES * i
_SWEEP_UPDATES = 5
_TAU, _BETA, _EPS1, _NOISE, _ASIS = range(5)


class LogitICARGibbs(GibbsBase):
    """Gibbs sampler using the logit link and the ICAR spatial model.

    Same constructor as the JAX package's ``LogitICARGibbs`` plus
    ``device`` (default ``'cuda'``; pass ``'cpu'`` for the CPU).

    ``pg_method``: ``'pallas_packed'`` and ``'pallas'`` (the names of the
    JAX package's two TPU kernels) both draw through the CUDA kernel
    (``ops/cuda_pg.py``; plain sampler on the CPU); ``'devroye'`` is the
    plain torch rejection sampler; ``'gamma'`` the truncated series.
    Default: ``'pallas_packed'`` on CUDA, ``'devroye'`` on the CPU.

    ``solver``: ``'chol'`` (dense Cholesky) or ``'cg'`` (fixed-budget
    eigenbasis CG, ``cg_iters`` iterations); ``None`` picks ``'cg'`` from
    512 sites. ``cg_impl``: ``'xla'`` (default: the torch-op CG of
    ``ops/cg.py``) or ``'pallas'`` (the CUDA kernel, ``ops/cuda_cg.py``).
    ``eig_dtype``: storage dtype of the CG eigenbasis (default ``dtype``).
    The lattice (``'stencil'``) and graph solvers are not ported yet and
    raise ``NotImplementedError``.
    """

    def __init__(
        self, Q, W, X, y, hparams=None, random_state=None,
        dtype=torch.float32, pg_method=None, solver=None, cg_iters=None,
        lattice=None, blocked=True, cg_impl=None, asis=True,
        asis_sd=1.2, asis_steps=12, asis_method='mh',
        solver_check_tol=0.2, graph_rank=None, graph_block='auto',
        spatial_sweeps=None, eig_dtype=None, device=None,
    ):
        if asis_method not in ('mh', 'slice'):
            raise ValueError(f'unknown asis_method: {asis_method!r}')
        self.asis_method = asis_method
        if spatial_sweeps is not None:
            spatial_sweeps = int(spatial_sweeps)
            if spatial_sweeps < 1:
                raise ValueError('spatial_sweeps must be >= 1')
        self.spatial_sweeps = spatial_sweeps
        self.blocked = bool(blocked)
        self.solver_check_tol = (
            None if solver_check_tol is None else float(solver_check_tol)
        )
        self._solver_checked = False
        self.asis = bool(asis)
        self.asis_sd = float(asis_sd)
        self.asis_steps = int(asis_steps)
        if cg_impl is None:
            cg_impl = 'xla'
        if cg_impl not in ('xla', 'pallas'):
            raise ValueError(f'unknown cg_impl: {cg_impl!r}')
        self.cg_impl = cg_impl
        if pg_method not in (
            None, 'devroye', 'gamma', 'pallas', 'pallas_packed'
        ):
            raise ValueError(f'unknown PG sampling method: {pg_method!r}')
        if solver not in (None, 'chol', 'cg', 'stencil', 'graph'):
            raise ValueError(f'unknown eta solver: {solver!r}')
        if lattice is not None and solver in (None, 'stencil'):
            solver = 'stencil'
        n_sites = np.asarray(X).shape[0]
        if solver is None:
            import scipy.sparse as sps

            if sps.issparse(Q) and n_sites >= _GRAPH_AUTO_THRESHOLD:
                solver = 'graph'
            else:
                solver = 'cg' if n_sites >= _CG_AUTO_THRESHOLD else 'chol'
        if solver in _NOT_PORTED and self._solves_lambda:
            raise NotImplementedError(_NOT_PORTED[solver])
        self.solver = solver
        if cg_iters is None:
            # the JAX package's measured per-regime budget: 8 for the
            # spectral CG (cold residual at the float32 floor by 6)
            cg_iters = {'cg': 8}.get(self.solver, 15)
        self.cg_iters = int(cg_iters)
        if self.spatial_sweeps is None:
            # the JAX package's per-regime policy: cg 3, chol 2
            self.spatial_sweeps = {'cg': 3, 'chol': 2}[self.solver]
        super().__init__(
            Q, W, X, y, hparams, random_state, dtype=dtype, device=device,
        )
        # storage dtype of the CG eigenbasis; the JAX package's bf16
        # default is a TPU rule, so the default here is the model dtype
        self.eig_dtype = (
            self.dtype if eig_dtype is None else resolve_dtype(eig_dtype)
        )
        if 'q_eigvecs' in self.fixed:
            self.fixed['q_eigvecs'] = self.fixed['q_eigvecs'].to(
                self.eig_dtype
            )
        if pg_method is None:
            pg_method = (
                'pallas_packed' if self.device.type == 'cuda' else 'devroye'
            )
        self.pg_method = pg_method
        counts = {0: 2}
        for i in range(self.spatial_sweeps):
            base = 1 + _SWEEP_UPDATES * i
            counts[base + _TAU] = rng.GAMMA_WORDS
            counts[base + _BETA] = 2 * self.n_beta
            counts[base + _EPS1] = 2 * self.n
            # the field noise: B eps with B B' = Q (n - 1 columns), or
            # E eps with E E' = Q_rsr (q columns)
            counts[base + _NOISE] = 2 * self.fixed['sqrt_factor'].shape[1]
            counts[base + _ASIS] = noise_words(
                self.asis_method, self.asis_steps
            )
        self._alpha_update = 1 + _SWEEP_UPDATES * self.spatial_sweeps
        self._z_update = self._alpha_update + 1
        counts[self._alpha_update] = 2 * self.n_alpha
        counts[self._z_update] = self.n
        self._plan = rng.DrawPlan(counts, self.device)

    def _configure(self, Q, x_np, hparams):
        super()._configure(Q, x_np, hparams)
        s_eig, u_eig, sqrt_factor = icar.icar_spectral(self.fixed['Q'])
        self.fixed['sqrt_factor'] = sqrt_factor
        if self.solver == 'cg':
            self.fixed['q_eigvals'] = s_eig
            self.fixed['q_eigvecs'] = u_eig

    @property
    def _solves_lambda(self):
        """Whether eta is drawn on the full site field through solves
        against tau*Q + diag(omega); a subclass that overrides the eta
        conditional (RSR: a dense q-dimensional draw) never is."""
        return type(self)._update_eta is LogitICARGibbs._update_eta

    def _pg(self, subkeys, z):
        if self.pg_method == 'gamma':
            return pg_gamma(subkeys, z)
        if self.pg_method in ('pallas', 'pallas_packed'):
            return pg_devroye_cuda(subkeys, z)
        return pg_devroye(subkeys, z)

    def _init_state(self, keys, fixed):
        state = self._init_common(keys, fixed)
        if self.solver == 'cg':
            # warm starts of the blocked solve's rows [Omega X, k, 1,
            # pert] (unblocked: [y, 1]), in Q's eigenbasis
            rows = (self.n_beta + 3) if self.blocked else 2
            chains = keys.shape[0]
            state['eta_warm'] = torch.zeros(
                (chains, rows, self.n), dtype=self.dtype, device=self.device
            )
            state['solver_resid'] = torch.zeros(
                chains, dtype=self.dtype, device=self.device
            )
        return state

    # ----------------- shared Lambda = tau*Q + diag(omega) ------------- #

    def _lambda_solve(self, rhs, warm, omega, tau, fixed,
                      return_resid=False):
        """Solve Lambda X = rhs for (chains, rows, n) stacked rows.

        Returns ``(sol, warm_next[, rel])``: the site-basis solutions, the
        carry for the next solve's warm start (eigenbasis for the CG) and
        the per-chain relative residual (0 for the exact Cholesky)."""
        if self.solver == 'cg':
            solve = (
                icar_cg_solve_cuda if self.cg_impl == 'pallas'
                else icar_cg_solve_spectral
            )
            return solve(
                rhs, warm, omega, tau, fixed['q_eigvecs'],
                fixed['q_eigvals'], self.cg_iters, return_resid=return_resid,
            )
        sol = lambda_cholesky_solve(rhs, omega, tau, fixed['Q'])
        if return_resid:
            return sol, sol, torch.zeros_like(tau)
        return sol, sol

    def _lambda_noise(self, eps, tau, fixed):
        """sqrt(tau) * B eps with B B' = Q; ``eps`` (chains, n - 1)."""
        return torch.sqrt(tau)[:, None] * (eps @ fixed['sqrt_factor'].T)

    def solver_residual(self, carry=None):
        """Max relative residual of the configured eta solver, run cold
        on the blocked update's right-hand sides at chain 0 of ``carry``
        (default: a fresh one-chain carry). A converged CG reports well
        under 1e-3 in float32, a starved one orders of magnitude more.
        omega is drawn through the configured PG path with fixed zero key
        words: the check only needs a representative omega."""
        if carry is None:
            carry = self.init_carry(chains=1)
        state = {k: v[:1] for k, v in carry.states.items()}
        fixed = self.fixed
        x = fixed['X']
        lin_b = state['beta'] @ x.T + state['spatial']
        subkeys = torch.zeros((1, 2), dtype=torch.int64, device=self.device)
        omega = self._pg(subkeys, lin_b)
        tau = state['tau']
        rhs = torch.cat(
            [
                omega[:, None, :] * x.T,
                (state['z'] - 0.5)[:, None, :],
                torch.ones_like(omega)[:, None, :],
            ],
            dim=1,
        )
        sol = self._lambda_solve(
            rhs, torch.zeros_like(rhs), omega, tau, fixed
        )[0]
        resid = (
            tau[:, None, None] * (sol @ fixed['Q'].T)
            + omega[:, None, :] * sol - rhs
        )
        rel = torch.linalg.norm(resid, dim=-1) / torch.linalg.norm(
            rhs, dim=-1
        )
        return float(rel.max())

    def init_carry(self, chains=2, start=None):
        """Build the resumable carry, then run the one-time solver
        accuracy check (see :meth:`_check_solver_accuracy`)."""
        carry = super().init_carry(chains, start)
        self._check_solver_accuracy(carry)
        return carry

    def _check_solver_accuracy(self, carry):
        """Once per instance, raise if the cold-start residual of the
        fixed-budget CG exceeds ``solver_check_tol`` (None skips)."""
        if (
            self.solver != 'cg'
            or self.solver_check_tol is None
            or self._solver_checked
            or not self._solves_lambda
        ):
            return
        self._solver_checked = True
        resid = self.solver_residual(carry)
        if resid > self.solver_check_tol:
            raise RuntimeError(
                f'eta solver ({self.solver!r}, cg_iters={self.cg_iters}) '
                f'did not converge: cold-start relative residual '
                f'{resid:.2e} exceeds solver_check_tol='
                f'{self.solver_check_tol:.0e}. Increase cg_iters (or '
                f'pass solver_check_tol=None to bypass this check).'
            )

    # -------------------------- update segments ----------------------- #

    def _eta_quad(self, eta, fixed):
        """eta' Q eta per chain."""
        return torch.sum(eta * (eta @ fixed['Q']), dim=-1)

    def _update_tau(self, eta, fixed, g):
        """tau ~ Gamma(shape, 0.5 eta'Q eta + rate) given ``g`` ~
        Gamma(shape, 1) per chain (reference gibbs/logit.py:206-209)."""
        quad = self._eta_quad(eta, fixed)
        # clamp: float32 cancellation can push the PSD form below 0
        rate = 0.5 * torch.clamp(quad, min=0.0) + fixed['tau_rate']
        return g / rate

    def _update_beta_eta_blocked(self, state, omega_b, tau, fixed,
                                 eps_beta, eps1, eps_noise):
        """Collapsed beta draw plus the conditional eta draw.

        beta is drawn with eta integrated out, from p + 3 solves against
        Lambda = tau*Q + diag(omega) in one batched call: the rows
        [Omega X, k, 1, pert] give every piece of the Schur complement and
        of eta | beta by linearity (see the JAX ``_update_beta_eta_blocked``
        for the derivation). ``eps_beta`` (chains, p), ``eps1`` (chains,
        n) and ``eps_noise`` (chains, n - 1) are standard normals.
        """
        x = fixed['X']
        p = self.n_beta
        k_vec = state['k']
        a_t = omega_b[:, None, :] * x.T  # (chains, p, n)
        pert = torch.sqrt(omega_b) * eps1 + self._lambda_noise(
            eps_noise, tau, fixed
        )
        rhs = torch.cat(
            [a_t, k_vec[:, None], torch.ones_like(k_vec)[:, None],
             pert[:, None]],
            dim=1,
        )
        warm = state.get('eta_warm')
        if warm is None:
            warm = torch.zeros_like(rhs)
        sol, warm_next, rel = self._lambda_solve(
            rhs, warm, omega_b, tau, fixed, return_resid=True
        )
        self._track_resid(state, rel)
        g, gk, h, gp = sol[:, :p], sol[:, p], sol[:, p + 1], sol[:, p + 2]
        hsum = torch.sum(h, dim=-1, keepdim=True)
        ca = g - (torch.sum(g, dim=-1, keepdim=True) / hsum[:, None]) * \
            h[:, None, :]
        ck = gk - (torch.sum(gk, dim=-1, keepdim=True) / hsum) * h
        s_mat = (
            (x.T * omega_b[:, None, :]) @ x
            + fixed['b_prec']
            - a_t @ ca.transpose(-1, -2)
        )
        s_mat = 0.5 * (s_mat + s_mat.transpose(-1, -2))
        l_vec = (
            k_vec @ x + fixed['b_prec_by_mu']
            - (a_t @ ck[:, :, None])[..., 0]
        )
        beta = precision_mvnorm(l_vec, s_mat, eps_beta)
        eta = sum_to_zero(gk - (beta[:, None, :] @ g)[:, 0] + gp, h)
        if 'eta_warm' in state:
            state['eta_warm'] = warm_next
        return beta, eta

    @property
    def _eta_scale_dim(self):
        return self.n - 1

    def _asis_tau(self, s, omega_b, fixed, noise):
        """Sufficient/ancillary tau interweave (Yu & Meng 2011): a move on
        log tau under the ancillary field sqrt(tau) * eta, then eta and
        spatial rescaled (see the JAX ``_asis_tau``). ``noise`` is the
        move's noise (:func:`.interweave.noise_from_words`)."""
        spatial_a = torch.sqrt(s['tau'])[:, None] * s['spatial']
        xb = s['beta'] @ fixed['X'].T
        a_lin = torch.sum((s['k'] - omega_b * xb) * spatial_a, dim=-1)
        c_quad = 0.5 * torch.sum(omega_b * spatial_a * spatial_a, dim=-1)
        return ancillary_tau_move(
            s, spatial_a, a_lin, c_quad,
            fixed['tau_shape'] - 0.5 * self._eta_scale_dim,
            fixed['tau_rate'], self.asis_method, self.asis_sd,
            self.asis_steps, noise,
        )

    def _update_eta(self, state, omega_b, tau, fixed, eps1, eps_noise):
        """Constrained ICAR draw (reference gibbs/logit.py:211-217),
        unblocked path: solve Lambda [x, z] = [y, 1] with y ~ N(b,
        Lambda) and kriging-project."""
        xb = state['beta'] @ fixed['X'].T
        b = state['k'] - omega_b * xb
        y = b + torch.sqrt(omega_b) * eps1 + self._lambda_noise(
            eps_noise, tau, fixed
        )
        rhs = torch.stack([y, torch.ones_like(y)], dim=1)
        warm = state.get('eta_warm')
        if warm is None:
            warm = torch.zeros_like(rhs)
        sol, warm_next, rel = self._lambda_solve(
            rhs, warm, omega_b, tau, fixed, return_resid=True
        )
        if 'eta_warm' in state:
            state['eta_warm'] = warm_next
        self._track_resid(state, rel)
        eta = sum_to_zero(sol[:, 0], sol[:, 1])
        return eta, eta

    def _update_beta(self, state, omega_b, spatial, fixed, eps):
        """beta ~ precision MVN (reference gibbs/logit.py:226-232)."""
        x = fixed['X']
        a = (x.T * omega_b[:, None, :]) @ x + fixed['b_prec']
        b = (state['k'] - omega_b * spatial) @ x + fixed['b_prec_by_mu']
        return precision_mvnorm(b, a, eps)

    def _update_alpha(self, state, omega_a, fixed, eps):
        """alpha over the currently-occupied surveyed sites, on the flat
        (total_visits,) layout (reference gibbs/logit.py:180-193,
        219-224); ``eps`` (chains, n_alpha) standard normals."""
        w = fixed['W_flat']
        wt = state['z'][:, self._visit_site]
        a = w.T @ ((wt * omega_a)[..., None] * w) + fixed['a_prec']
        b = (wt * (fixed['y_flat'] - 0.5)) @ w + fixed['a_prec_by_mu']
        return precision_mvnorm(b, a, eps)

    def _update_z(self, state, alpha, beta, spatial, fixed, u):
        """Occupancy update (reference gibbs/logit.py:234-252) given
        uniforms ``u`` (chains, n): z = 1 where detected, else
        Bernoulli(sigmoid(logit psi + sum_v log(1 - d_v))), the sum over
        visits in a fixed order (:meth:`~.base.GibbsBase._site_sum`)."""
        logit_psi = beta @ fixed['X'].T + spatial
        log_prod = self._site_sum(-F.softplus(alpha @ fixed['W_flat'].T))
        p = torch.sigmoid(logit_psi + log_prod)
        draw = (u < p).to(self.dtype)
        z = torch.where(
            fixed['obs'] > 0, torch.ones((), dtype=self.dtype,
                                         device=self.device), draw,
        )
        return z, z - 0.5

    # ----------------------------- transition ------------------------- #

    def _step(self, keys, step, state, fixed):
        """One Gibbs iteration for all chains (the JAX ``_step``: both
        PG fields in one draw, ``spatial_sweeps`` x (tau, beta/eta, ASIS),
        then alpha and z)."""
        w = self._plan(keys, step)
        dt = self.dtype
        s = dict(state)
        lin_b = s['beta'] @ fixed['X'].T + s['spatial']
        lin_a = s['alpha'] @ fixed['W_flat'].T
        omega = self._pg(w[0], torch.cat([lin_b, lin_a], dim=-1))
        omega_b, omega_a = omega[:, :self.n], omega[:, self.n:]

        for i in range(self.spatial_sweeps):
            base = 1 + _SWEEP_UPDATES * i
            tau = self._update_tau(
                s['eta'], fixed,
                rng.gamma(fixed['tau_shape'], w[base + _TAU], dt),
            )
            eps1 = rng.normal(w[base + _EPS1], dt)
            eps_noise = rng.normal(w[base + _NOISE], dt)
            if self.blocked and self._solves_lambda:
                beta, eta = self._update_beta_eta_blocked(
                    s, omega_b, tau, fixed, rng.normal(w[base + _BETA], dt),
                    eps1, eps_noise,
                )
                s['tau'], s['eta'], s['spatial'] = tau, eta, eta
                s['beta'] = beta
            else:
                eta, spatial = self._update_eta(
                    s, omega_b, tau, fixed, eps1, eps_noise
                )
                s['tau'], s['eta'], s['spatial'] = tau, eta, spatial
                s['beta'] = self._update_beta(
                    s, omega_b, spatial, fixed,
                    rng.normal(w[base + _BETA], dt),
                )
            if self.asis:
                s = self._asis_tau(
                    s, omega_b, fixed,
                    noise_from_words(
                        w[base + _ASIS], self.asis_method,
                        self.asis_steps, dt,
                    ),
                )

        s['alpha'] = self._update_alpha(
            s, omega_a, fixed, rng.normal(w[self._alpha_update], dt)
        )
        # z conditions on the post-ASIS spatial field (the move rescales
        # tau, eta and spatial jointly)
        s['z'], s['k'] = self._update_z(
            s, s['alpha'], s['beta'], s['spatial'], fixed,
            rng.uniform(w[self._z_update], dt),
        )
        return s


class LogitRSRGibbs(LogitICARGibbs):
    """Logit sampler with Reduced Spatial Regression (Moran basis).

    Port of the JAX package's ``LogitRSRGibbs`` (reference
    gibbs/logit.py:340-485); same constructor plus ``device``. The Moran
    basis K (n, q) is built once on the host (:func:`..ops.icar.
    moran_basis`, threshold ``r`` or ``q`` columns); eta lives in that
    basis and ``spatial = K eta``. A step draws both PG fields in one
    launch of the CUDA kernel (on the card), then ``spatial_sweeps``
    (default 2) times tau, eta (:func:`..ops.mvnorm.rsr_mvnorm`), beta and
    the ASIS move. ``solver`` and ``blocked`` are accepted and unused, as
    in the JAX package: no solve against tau*Q + diag(omega) is made.
    """

    # K and Q_rsr = K'QK are the only spatial operators downstream
    _needs_dense_q = False

    def __init__(
        self, Q, W, X, y, hparams=None, random_state=None, r=0.5, q=None,
        dtype=torch.float32, pg_method=None, **kwargs,
    ):
        self._rsr_r = r
        self._rsr_q = q
        # the JAX package's measured default: a third sweep does not pay
        # in the reduced basis (tau does not bind there)
        kwargs.setdefault('spatial_sweeps', 2)
        super().__init__(
            Q, W, X, y, hparams, random_state, dtype=dtype,
            pg_method=pg_method, **kwargs,
        )

    def _configure(self, Q, x_np, hparams):
        GibbsBase._configure(self, Q, x_np, hparams)
        k_basis, q_rsr = icar.moran_basis(
            x_np, Q, r=self._rsr_r, num_eigs=self._rsr_q
        )
        self.q_dim = q_rsr.shape[0]
        self.fixed['K'] = k_basis
        self.fixed['Q_rsr'] = q_rsr
        self.fixed['sqrt_factor'] = icar.psd_sqrt_factor(q_rsr)
        if not self.hparams_given:
            # reference gibbs/logit.py:454-457
            self.fixed['tau_shape'] = 0.5 + 0.5 * self.q_dim

    def _init_state(self, keys, fixed):
        """The common start, then eta ~ N(0, 5^2) in the basis (reference
        gibbs/logit.py:462-466)."""
        state = self._init_common(keys, fixed)
        w = rng.words(keys, 0, INIT_ETA_BASIS, 2 * self.q_dim)
        state['eta'] = 5.0 * rng.normal(w, self.dtype)
        state['spatial'] = self._spatial_from_eta(state['eta'])
        return state

    def _spatial_from_eta(self, eta):
        return eta @ self.fixed['K'].T

    @property
    def _eta_scale_dim(self):
        return self.q_dim

    def _eta_quad(self, eta, fixed):
        return torch.sum(eta * (eta @ fixed['Q_rsr']), dim=-1)

    def _update_eta(self, state, omega_b, tau, fixed, eps1, eps2):
        """Reduced-basis eta draw (reference gibbs/logit.py:478-485);
        ``eps1`` (chains, n) and ``eps2`` (chains, q) standard normals."""
        xb = state['beta'] @ fixed['X'].T
        b = (state['k'] - omega_b * xb) @ fixed['K']
        eta = rsr_mvnorm(
            b, omega_b, tau, fixed['Q_rsr'], fixed['K'],
            fixed['sqrt_factor'], eps1, eps2,
        )
        return eta, eta @ fixed['K'].T
