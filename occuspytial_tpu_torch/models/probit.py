"""Probit-link Gibbs samplers (Albert-Chib truncated-normal augmentation).

Port of the JAX package's ``models/probit.py``: ``_ProbitBase``,
``ProbitRSRGibbs`` and ``ProbitICARGibbs`` with the spectral eta solver
(reference gibbs/probit.py:27-270). The model adds a site random effect
``eps`` on top of the spatial term; the latent utilities are one-sided
truncated normals (:mod:`..ops.truncnorm`). One step, per chain:

1. the site utilities omega_b | z (with eps integrated out under the
   collapsed ladder), then the PX scale move;
2. ``spatial_sweeps`` times: tau | eta (gamma); the (beta, eta, eps)
   block, either collapsed (beta with eta and eps integrated out, eta
   with eps out, then eps) or in the reference's order (eps, eta,
   beta); the PX scale move; the ASIS log-tau move;
3. the visit utilities omega_a, alpha and z.

As in :mod:`.logit`, every update takes its noise as arguments and the
step makes it from the chain's counter-based stream, so a test can feed
the port and the JAX package the same draws. The probit paths run no
hand-written kernel: their work is elementwise draws and small dense
products, plain torch ops here as they are plain ``jnp`` in the JAX
package.
"""

import math

import numpy as np
import torch
from torch.special import log_ndtr

from .. import rng
from ..ops import icar
from ..ops.mvnorm import (
    cholesky_solve,
    constrained_icar_mvnorm_unit,
    precision_mvnorm,
)
from ..ops.truncnorm import truncnorm_sign
from .base import INIT_EPS, INIT_ETA_BASIS, GibbsBase
from .interweave import ancillary_tau_move, noise_from_words, noise_words
from .logit import _GRAPH_AUTO_THRESHOLD, _NOT_PORTED

#: update indices of a step's draws: 0 the site utilities, 1 the PX move
#: before the sweeps; per sweep i the block starts at 2 + _SWEEP_UPDATES *
#: i; the visit utilities, alpha and z follow the last sweep
_OMEGA_B, _PX_FIRST = 0, 1
_SWEEP_UPDATES = 6
_TAU, _BETA, _ETA, _EPS, _PX, _ASIS = range(_SWEEP_UPDATES)

#: words of the PX move's Metropolis noise: a normal (2) and a uniform
_PX_MH_WORDS = 3


class _ProbitBase(GibbsBase):
    """Shared probit machinery (utilities, eps, alpha, beta, z, PX, ASIS).

    Same constructor as the JAX package's ``_ProbitBase`` plus
    ``device`` (default ``'cuda'``). ``collapsed=True`` (default) draws
    the (beta, eta, eps) block by the partially collapsed ladder;
    ``collapsed=False`` follows the reference's order (gibbs/probit.py:
    262-270). ``px`` adds the scale move over (u, beta, eta, eps): an
    exact chi draw on the orbit when the beta prior mean is zero,
    otherwise a Metropolis step with ``log g ~ N(0, px_sd^2)``.
    """

    def __init__(
        self, Q, W, X, y, hparams=None, random_state=None,
        dtype=torch.float32, collapsed=True, px=True, px_sd=0.3,
        asis=True, asis_sd=1.0, asis_steps=12, asis_method='mh',
        spatial_sweeps=None, device=None,
    ):
        if asis_method not in ('mh', 'slice'):
            raise ValueError(f'unknown asis_method: {asis_method!r}')
        self.asis_method = asis_method
        # None: 1, the JAX package's measured policy (ProbitICARGibbs
        # resolves its small-n spectral case to 6 before reaching here)
        self.spatial_sweeps = 1 if spatial_sweeps is None else int(
            spatial_sweeps
        )
        if self.spatial_sweeps < 1:
            raise ValueError('spatial_sweeps must be >= 1')
        self.collapsed = bool(collapsed)
        self.px = bool(px)
        self.px_sd = float(px_sd)
        self.asis = bool(asis)
        self.asis_sd = float(asis_sd)
        self.asis_steps = int(asis_steps)
        super().__init__(
            Q, W, X, y, hparams, random_state, dtype=dtype, device=device,
        )
        # the exact orbit draw needs a zero-mean beta prior (else MH)
        self._px_exact = bool(
            np.allclose(self.fixed['b_mu'].cpu().numpy(), 0.0)
        )
        px_words = rng.GAMMA_WORDS if self._px_exact else _PX_MH_WORDS
        counts = {_OMEGA_B: self.n}
        if self.px:
            counts[_PX_FIRST] = px_words
        for i in range(self.spatial_sweeps):
            base = 2 + _SWEEP_UPDATES * i
            counts[base + _TAU] = rng.GAMMA_WORDS
            counts[base + _BETA] = 2 * self.n_beta
            counts[base + _ETA] = 2 * self._eta_noise_dim
            counts[base + _EPS] = 2 * self.n
            if self.px:
                counts[base + _PX] = px_words
            if self.asis:
                counts[base + _ASIS] = noise_words(
                    self.asis_method, self.asis_steps
                )
        self._omega_a_update = 2 + _SWEEP_UPDATES * self.spatial_sweeps
        self._alpha_update = self._omega_a_update + 1
        self._z_update = self._omega_a_update + 2
        counts[self._omega_a_update] = self.total_visits
        counts[self._alpha_update] = 2 * self.n_alpha
        counts[self._z_update] = self.n
        self._plan = rng.DrawPlan(counts, self.device)

    #: dimension of eta under scaling (subspace dimension for ICAR)
    _eta_dim = None
    #: standard normals one eta draw takes
    _eta_noise_dim = None
    _start_names = GibbsBase._start_names + ('eps',)

    def _eta_quad(self, eta, fixed):
        raise NotImplementedError

    def _init_state(self, keys, fixed):
        """The common start plus eps ~ N(0, 1) and zero utilities."""
        state = self._init_common(keys, fixed)
        w = rng.words(keys, 0, INIT_EPS, 2 * self.n)
        state['eps'] = rng.normal(w, self.dtype)
        state['omega_b'] = torch.zeros_like(state['eps'])
        return state

    # ----------------------------- PX and ASIS ------------------------ #

    def _px_dim(self, marginal):
        """Jacobian dimension of the orbit: dim(u) + dim(beta) +
        dim_eff(eta), plus dim(eps) unless eps is integrated out."""
        d = self.n + self.n_beta + self._eta_dim
        return d if marginal else d + self.n

    def _px_noise(self, w, marginal):
        """The PX move's noise from its words: a Gamma(d/2, 1) draw per
        chain for the exact move, else (normal, uniform)."""
        if self._px_exact:
            return rng.gamma(0.5 * self._px_dim(marginal), w, self.dtype)
        normal = rng.normal(w[:, :2], self.dtype)[:, 0]
        return normal, rng.uniform(w[:, 2], self.dtype)

    def _px_scale_move(self, s, fixed, noise, marginal=False):
        """Group scale move ``(u, beta, eta, eps) -> g * (...)`` (Liu &
        Wu 1999; see the JAX ``_px_scale_move`` for the derivation).

        With a zero-mean beta prior the orbit density is a chi
        distribution and ``g^2 = 2 G / S`` with ``G`` ~ Gamma(d/2, 1)
        (``noise``); otherwise ``g = exp(px_sd * normal)`` is accepted
        by Metropolis with ``noise = (normal, uniform)``. ``marginal``
        runs the move on the eps-marginal density (u ~ N(X beta +
        spatial, 2I)), where eps is neither conditioned on nor moved."""
        beta, eta, eps = s['beta'], s['eta'], s['eps']
        u = s['omega_b']
        b_prec = fixed['b_prec']
        xb = beta @ fixed['X'].T
        quad = s['tau'] * self._eta_quad(eta, fixed)
        if marginal:
            r = u - xb - s['spatial']
            rss = 0.5 * torch.sum(r * r, dim=-1) + quad
        else:
            r = u - xb - s['spatial'] - eps
            rss = torch.sum(r * r, dim=-1) + torch.sum(eps * eps, dim=-1) \
                + quad
        d = self._px_dim(marginal)
        if self._px_exact:
            s_tot = rss + torch.sum(beta * (beta @ b_prec.T), dim=-1)
            gg = torch.sqrt(2.0 * noise / s_tot)
        else:
            normal, uniform = noise
            g = torch.exp(self.px_sd * normal)
            bmu = beta - fixed['b_mu']
            gbmu = g[:, None] * beta - fixed['b_mu']
            prior_diff = torch.sum(gbmu * (gbmu @ b_prec.T), dim=-1) \
                - torch.sum(bmu * (bmu @ b_prec.T), dim=-1)
            log_a = (
                -0.5 * (g * g - 1.0) * rss - 0.5 * prior_diff
                + d * torch.log(g)
            )
            accept = torch.log(uniform) < log_a
            gg = torch.where(accept, g, torch.ones_like(g))
        gc = gg[:, None]
        s['omega_b'] = gc * u
        s['beta'] = gc * beta
        s['eta'] = gc * eta
        if not marginal:
            s['eps'] = gc * eps
        s['spatial'] = gc * s['spatial']
        return s

    def _asis_tau(self, s, fixed, noise):
        """The ASIS tau interweave with the Gaussian utility likelihood
        u ~ N(X beta + spatial + eps, 1): A = (u - X beta - eps)'
        spatial_a, C = 0.5 ||spatial_a||^2 (the JAX ``_asis_tau``)."""
        spatial_a = torch.sqrt(s['tau'])[:, None] * s['spatial']
        d = s['omega_b'] - s['beta'] @ fixed['X'].T - s['eps']
        a_lin = torch.sum(d * spatial_a, dim=-1)
        c_quad = 0.5 * torch.sum(spatial_a * spatial_a, dim=-1)
        return ancillary_tau_move(
            s, spatial_a, a_lin, c_quad,
            fixed['tau_shape'] - 0.5 * self._eta_dim, fixed['tau_rate'],
            self.asis_method, self.asis_sd, self.asis_steps, noise,
        )

    # ---------------------------- conditionals ------------------------ #

    def _update_omega_b(self, state, fixed, u):
        """Site utilities truncated by z (reference gibbs/probit.py:
        196-209) given uniforms ``u`` (chains, n). Under the collapsed
        ladder eps is integrated out: u ~ N(X beta + spatial, 2)."""
        loc = state['beta'] @ fixed['X'].T + state['spatial']
        positive = state['z'] > 0.5
        if self.collapsed:
            root2 = math.sqrt(2.0)
            return root2 * truncnorm_sign(loc / root2, positive, u)
        return truncnorm_sign(loc + state['eps'], positive, u)

    def _update_eps(self, state, omega_b, fixed, eps):
        """eps | rest ~ N(0.5 (omega_b - X beta - spatial), 1/2)
        (reference gibbs/probit.py:216-221); ``eps`` standard normals."""
        mean = 0.5 * (
            omega_b - state['beta'] @ fixed['X'].T - state['spatial']
        )
        return mean + eps / math.sqrt(2.0)

    def _update_beta(self, state, omega_b, fixed, eps):
        """beta with precision X'X + b_prec (reference gibbs/probit.py:
        237-243)."""
        b = fixed['b_prec_by_mu'] + (
            omega_b - state['spatial'] - state['eps']
        ) @ fixed['X']
        return precision_mvnorm(b, fixed['XTX_plus_bprec'], eps)

    def _update_omega_a(self, state, fixed, u):
        """Visit utilities truncated by the detections (reference
        gibbs/probit.py:173-194), flat visit layout."""
        loc = state['alpha'] @ fixed['W_flat'].T
        return truncnorm_sign(loc, fixed['y_flat'] > 0.5, u)

    def _update_alpha(self, state, omega_a, fixed, eps):
        """alpha with precision W'W + a_prec over the occupied sites'
        visits (reference gibbs/probit.py:231-235)."""
        w = fixed['W_flat']
        wt = state['z'][:, self._visit_site]
        a = w.T @ (wt[..., None] * w) + fixed['a_prec']
        b = fixed['a_prec_by_mu'] + (wt * omega_a) @ w
        return precision_mvnorm(b, a, eps)

    def _update_z(self, state, fixed, u):
        """Occupancy (reference gibbs/probit.py:245-260) in log-odds form,
        ``sigmoid(log Phi(lin) + sum_v log Phi(-w_v alpha) - log
        Phi(-lin))``, the sum over visits in a fixed order."""
        lin = (
            state['beta'] @ fixed['X'].T + state['spatial'] + state['eps']
        )
        log_prod = self._site_sum(log_ndtr(-(state['alpha']
                                             @ fixed['W_flat'].T)))
        p = torch.sigmoid(log_ndtr(lin) + log_prod - log_ndtr(-lin))
        draw = (u < p).to(self.dtype)
        return torch.where(
            fixed['obs'] > 0,
            torch.ones((), dtype=self.dtype, device=self.device), draw,
        )

    def _update_tau(self, eta, fixed, g):
        """tau ~ Gamma(shape, 0.5 eta'Q eta + rate) given ``g`` ~
        Gamma(shape, 1) per chain."""
        return g / (0.5 * self._eta_quad(eta, fixed) + fixed['tau_rate'])

    def _collapsed_factor(self, tau, fixed):
        """A factorization both collapsed draws of a sweep share (RSR: the
        q x q Cholesky); None where they need none."""
        return None

    # ----------------------------- transition ------------------------- #

    def _step(self, keys, step, state, fixed):
        """One Gibbs iteration (the JAX ``_step``)."""
        w = self._plan(keys, step)
        dt = self.dtype
        s = dict(state)
        omega_b = self._update_omega_b(s, fixed, rng.uniform(w[_OMEGA_B], dt))
        s['omega_b'] = omega_b
        if self.px:
            # the collapsed block integrates eps out of this window, so
            # the move runs on the eps-marginal density
            s = self._px_scale_move(
                s, fixed, self._px_noise(w[_PX_FIRST], self.collapsed),
                marginal=self.collapsed,
            )
            omega_b = s['omega_b']
        for i in range(self.spatial_sweeps):
            base = 2 + _SWEEP_UPDATES * i
            s['tau'] = self._update_tau(
                s['eta'], fixed,
                rng.gamma(fixed['tau_shape'], w[base + _TAU], dt),
            )
            eps_beta = rng.normal(w[base + _BETA], dt)
            eps_eta = rng.normal(w[base + _ETA], dt)
            eps_eps = rng.normal(w[base + _EPS], dt)
            if self.collapsed:
                factor = self._collapsed_factor(s['tau'], fixed)
                s['beta'] = self._update_beta_collapsed(
                    s, omega_b, s['tau'], fixed, eps_beta, factor
                )
                s['eta'], s['spatial'] = self._update_eta_collapsed(
                    s, omega_b, s['tau'], fixed, eps_eta, factor
                )
                s['eps'] = self._update_eps(s, omega_b, fixed, eps_eps)
            else:
                s['eps'] = self._update_eps(s, omega_b, fixed, eps_eps)
                s['eta'], s['spatial'] = self._update_eta(
                    s, omega_b, s['tau'], fixed, eps_eta
                )
                s['beta'] = self._update_beta(s, omega_b, fixed, eps_beta)
            if self.px:
                s = self._px_scale_move(
                    s, fixed, self._px_noise(w[base + _PX], False)
                )
                omega_b = s['omega_b']
            if self.asis:
                s = self._asis_tau(
                    s, fixed,
                    noise_from_words(w[base + _ASIS], self.asis_method,
                                     self.asis_steps, dt),
                )
        omega_a = self._update_omega_a(
            s, fixed, rng.uniform(w[self._omega_a_update], dt)
        )
        s['alpha'] = self._update_alpha(
            s, omega_a, fixed, rng.normal(w[self._alpha_update], dt)
        )
        s['z'] = self._update_z(s, fixed, rng.uniform(w[self._z_update], dt))
        s['k'] = s['z'] - 0.5
        return s


class ProbitRSRGibbs(_ProbitBase):
    """Probit sampler with Reduced Spatial Regression spatial effects.

    Port of the JAX package's ``ProbitRSRGibbs`` (reference
    gibbs/probit.py:27-270): the Moran basis K (n, q) of
    :func:`..ops.icar.moran_basis`, ``spatial = K eta``. The collapsed
    beta draw uses Woodbury through A = tau Q_rsr + K'K/2, whose one
    Cholesky per chain and sweep also serves the collapsed eta draw.
    """

    _needs_dense_q = False

    def __init__(
        self, Q, W, X, y, hparams=None, random_state=None, r=0.5, q=None,
        dtype=torch.float32, collapsed=True, **kwargs,
    ):
        self._rsr_r = r
        self._rsr_q = q
        super().__init__(
            Q, W, X, y, hparams, random_state, dtype=dtype,
            collapsed=collapsed, **kwargs,
        )

    def _configure(self, Q, x_np, hparams):
        super()._configure(Q, x_np, hparams)
        f = self.fixed
        f['XTX_plus_bprec'] = x_np.T @ x_np + f['b_prec']
        k_basis, q_rsr = icar.moran_basis(
            x_np, Q, r=self._rsr_r, num_eigs=self._rsr_q
        )
        self.q_dim = q_rsr.shape[0]
        f['K'] = k_basis
        f['Q_rsr'] = q_rsr
        f['KTK'] = k_basis.T @ k_basis
        f['KTX'] = k_basis.T @ x_np
        f['XTX'] = x_np.T @ x_np
        if not self.hparams_given:
            f['tau_shape'] = 0.5 + 0.5 * self.q_dim

    def _init_state(self, keys, fixed):
        state = super()._init_state(keys, fixed)
        w = rng.words(keys, 0, INIT_ETA_BASIS, 2 * self.q_dim)
        state['eta'] = 5.0 * rng.normal(w, self.dtype)
        state['spatial'] = self._spatial_from_eta(state['eta'])
        return state

    def _spatial_from_eta(self, eta):
        return eta @ self.fixed['K'].T

    @property
    def _eta_dim(self):
        return self.q_dim

    _eta_noise_dim = _eta_dim

    def _eta_quad(self, eta, fixed):
        # clamp: float32 cancellation can push the PSD form below 0
        return torch.clamp(
            torch.sum(eta * (eta @ fixed['Q_rsr']), dim=-1), min=0.0
        )

    def _update_eta(self, state, omega_b, tau, fixed, eps):
        """eta with precision K'K + tau Q_rsr (reference
        gibbs/probit.py:223-229)."""
        a = fixed['KTK'] + tau[:, None, None] * fixed['Q_rsr']
        b = (
            omega_b - state['beta'] @ fixed['X'].T - state['eps']
        ) @ fixed['K']
        eta = precision_mvnorm(b, a, eps)
        return eta, eta @ fixed['K'].T

    # With eps integrated out the utility noise has variance 2, so u has
    # covariance 2I + K (tau Q_rsr)^{-1} K' given beta, and by Woodbury
    # its inverse is I/2 - K A^{-1} K'/4 with A = tau Q_rsr + K'K/2, the
    # precision of the collapsed eta draw.

    def _collapsed_factor(self, tau, fixed):
        a_eta = tau[:, None, None] * fixed['Q_rsr'] + 0.5 * fixed['KTK']
        return torch.linalg.cholesky_ex(a_eta).L

    def _update_beta_collapsed(self, state, omega_b, tau, fixed, eps,
                               chol=None):
        """beta with eta and eps integrated out; ``chol`` the factor of
        A (:meth:`_collapsed_factor`), computed when not given."""
        if chol is None:
            chol = self._collapsed_factor(tau, fixed)
        ktx = fixed['KTX']  # (q, p)
        sol_x = cholesky_solve(ktx, chol)
        sol_u = cholesky_solve((omega_b @ fixed['K'])[..., None], chol)[
            ..., 0
        ]
        a_beta = (
            0.5 * fixed['XTX'] + fixed['b_prec'] - 0.25 * (ktx.T @ sol_x)
        )
        b_beta = (
            0.5 * (omega_b @ fixed['X']) - 0.25 * (sol_u @ ktx)
            + fixed['b_prec_by_mu']
        )
        return precision_mvnorm(
            b_beta, 0.5 * (a_beta + a_beta.transpose(-1, -2)), eps
        )

    def _update_eta_collapsed(self, state, omega_b, tau, fixed, eps,
                              chol=None):
        """eta | u, beta with eps integrated out: precision A."""
        if chol is None:
            chol = self._collapsed_factor(tau, fixed)
        b = 0.5 * (
            (omega_b - state['beta'] @ fixed['X'].T) @ fixed['K']
        )
        eta = precision_mvnorm(b, None, eps, chol=chol)
        return eta, eta @ fixed['K'].T


class ProbitICARGibbs(_ProbitBase):
    """Probit sampler with the full-rank ICAR spatial model.

    Port of the JAX package's ``ProbitICARGibbs`` with
    ``solver='spectral'``: the eta conditional has precision tau*Q + I on
    the sum-to-zero hyperplane, diagonal in Q's eigenbasis, so every eta
    draw and the collapsed beta draw are closed-form spectral transforms
    of one host ``eigh``. With ``solver=None`` and n <= 256 sites,
    ``spatial_sweeps`` defaults to 6. ``'stencil'`` (or ``lattice=``)
    and ``'graph'`` (also the automatic choice for a sparse Q from 4096
    sites) are not ported yet and raise ``NotImplementedError``;
    ``cg_iters``, ``graph_rank``, ``graph_block`` and
    ``solver_check_tol`` belong to them: accepted, unused.
    """

    def __init__(
        self, Q, W, X, y, hparams=None, random_state=None,
        dtype=torch.float32, solver=None, cg_iters=None, lattice=None,
        graph_rank=None, graph_block='auto', solver_check_tol=0.2,
        **kwargs,
    ):
        if solver not in (None, 'spectral', 'stencil', 'graph'):
            raise ValueError(f'unknown eta solver: {solver!r}')
        n_sites = int(np.asarray(X).shape[0])
        if lattice is not None and solver is None:
            solver = 'stencil'
        if solver is None:
            import scipy.sparse as sps

            solver = (
                'graph'
                if sps.issparse(Q) and n_sites >= _GRAPH_AUTO_THRESHOLD
                else 'spectral'
            )
        if solver in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[solver])
        self.solver = solver
        if kwargs.get('spatial_sweeps') is None and n_sites <= 256:
            # the JAX package's measured policy: at small n the block is
            # cheap next to the step's fixed cost and tau binds
            kwargs['spatial_sweeps'] = 6
        super().__init__(
            Q, W, X, y, hparams, random_state, dtype=dtype, **kwargs
        )

    def _configure(self, Q, x_np, hparams):
        super()._configure(Q, x_np, hparams)
        f = self.fixed
        f['XTX_plus_bprec'] = x_np.T @ x_np + f['b_prec']
        s_eig, u_eig, _ = icar.icar_spectral(f['Q'])
        f['q_eigvals'] = s_eig
        f['q_eigvecs'] = u_eig
        f['UX'] = u_eig.T @ x_np  # X in Q's eigenbasis (collapsed beta)
        # boolean: kept out of the float cast onto the device
        f['eig_mask'] = s_eig > (1e-8 * float(np.max(s_eig)))

    @property
    def _eta_dim(self):
        return self.n - 1  # eta lives on the sum-to-zero subspace

    @property
    def _eta_noise_dim(self):
        return self.n

    def _eta_quad(self, eta, fixed):
        return torch.clamp(
            torch.sum(eta * (eta @ fixed['Q']), dim=-1), min=0.0
        )

    def _update_eta(self, state, omega_b, tau, fixed, eps):
        """The constrained draw with unit noise (closed form in Q's
        eigenbasis, :func:`..ops.mvnorm.constrained_icar_mvnorm_unit`)."""
        b = omega_b - state['beta'] @ fixed['X'].T - state['eps']
        eta = constrained_icar_mvnorm_unit(
            b, tau, fixed['q_eigvecs'], fixed['q_eigvals'], eps
        )
        return eta, eta

    # In Q's eigenbasis, with eps and eta out, Cov(U'u) = diag(2 + 1/(tau
    # s_i)) on the spatial subspace and 2 on the null direction, so the
    # collapsed beta draw is a p x p problem after one (n, p) rescale.

    def _update_beta_collapsed(self, state, omega_b, tau, fixed, eps,
                               factor=None):
        s_eig = fixed['q_eigvals']
        var_u = torch.where(
            fixed['eig_mask'],
            2.0 + 1.0 / (tau[:, None] * torch.clamp(s_eig, min=1e-30)),
            2.0,
        )
        w = 1.0 / var_u
        ux = fixed['UX']  # (n, p)
        uu = omega_b @ fixed['q_eigvecs']  # U'u
        a = ux.T @ (w[..., None] * ux) + fixed['b_prec']
        b = (w * uu) @ ux + fixed['b_prec_by_mu']
        return precision_mvnorm(b, a, eps)

    def _update_eta_collapsed(self, state, omega_b, tau, fixed, eps,
                              factor=None):
        """eta | u, beta with eps out: precision tau*Q + I/2 on the
        sum-to-zero subspace, drawn exactly in the eigenbasis with the
        null coordinate zeroed."""
        b = 0.5 * (omega_b - state['beta'] @ fixed['X'].T)
        d = tau[:, None] * fixed['q_eigvals'] + 0.5
        coef = (b @ fixed['q_eigvecs']) / d + eps / torch.sqrt(d)
        coef = torch.where(fixed['eig_mask'], coef, torch.zeros_like(coef))
        eta = coef @ fixed['q_eigvecs'].T
        return eta, eta
