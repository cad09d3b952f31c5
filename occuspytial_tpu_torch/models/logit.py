"""Logit-link Gibbs samplers with the ICAR or RSR spatial random effect.

Port of ``LogitICARGibbs`` and ``LogitRSRGibbs`` from the JAX package's
``models/logit.py`` (reference gibbs/logit.py, Pólya-Gamma augmentation).
One step, per chain (chains are the leading dimension of every state
tensor):

1. one PG(1, z) draw for both linear predictors, the sites' and the
   visits' (the CUDA kernel on the card, :mod:`..ops.cuda_pg`);
2. ``spatial_sweeps`` times: tau | eta (gamma), the collapsed beta / eta
   update (one multi-row solve against tau*Q + diag(omega), by the
   eigenbasis CG, by Cholesky, or by the matrix-free PCG of the lattice
   stencil or the graph panels; RSR: eta in the q-dimensional Moran
   basis, then beta), and the ASIS log-tau move;
3. alpha | z, omega_a and z | rest.

Each update takes its noise as arguments (the step makes it from the
chain's counter-based stream, see :mod:`..rng`), so a test can feed the
port and the JAX package the same draws.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import rng, tracing
from .._device import resolve_dtype
from ..ops import icar
from ..ops.cuda_cg import k3_operands
from ..ops.cuda_pg import pg_devroye_cuda
from ..ops.mvnorm import precision_mvnorm, rsr_mvnorm, sum_to_zero
from ..ops.polyagamma import pg_devroye, pg_gamma
from ..ops.sites import lincomb
from . import field
from .base import GibbsBase
from .field import ICARField, RSRField
from .interweave import ancillary_tau_move, noise_from_words, noise_words

#: below this site count the dense Cholesky eta draw is the default
_CG_AUTO_THRESHOLD = 512

#: update indices of a step's draws (see _plan); per sweep i the block
#: starts at 1 + _SWEEP_UPDATES * i
_SWEEP_UPDATES = 5
_TAU, _BETA, _EPS1, _NOISE, _ASIS = range(5)


class LogitICARGibbs(ICARField, GibbsBase):
    """Gibbs sampler using the logit link and the ICAR spatial model.

    Same constructor as the JAX package's ``LogitICARGibbs`` plus
    ``device`` (default ``'cuda'``; pass ``'cpu'`` for the CPU).

    ``pg_method``: ``'pallas_packed'`` and ``'pallas'`` (the names of the
    JAX package's two TPU kernels) both draw through the CUDA kernel
    (``ops/cuda_pg.py``; plain sampler on the CPU); ``'devroye'`` is the
    plain torch rejection sampler; ``'gamma'`` the truncated series.
    Default: ``'pallas_packed'`` on CUDA, ``'devroye'`` on the CPU.

    ``solver``: ``'chol'`` (dense Cholesky), ``'cg'`` (fixed-budget
    eigenbasis CG, ``cg_iters`` iterations), ``'stencil'`` (the O(n)
    matrix-free lattice path, :mod:`..ops.stencil`; ``lattice=(rows, cols,
    max_neighbors[, rho])`` selects it) or ``'graph'`` (matrix-free panels
    for any sparse adjacency, :mod:`..ops.graph`, with a deflation basis
    of ``graph_rank`` bottom eigenvectors and the block-tridiagonal layout
    per ``graph_block``). ``None`` picks ``'graph'`` for a sparse Q from
    4096 sites, else ``'cg'`` from 512 sites, else ``'chol'``.
    ``cg_impl``: ``'xla'`` (default: the torch-op CG of ``ops/cg.py``) or
    ``'pallas'`` (the CUDA kernel, ``ops/cuda_cg.py``) for ``'cg'``.
    ``eig_dtype``: storage dtype of the CG eigenbasis and of the graph
    deflation basis (default ``dtype``).
    """

    _STEP_SETTINGS = GibbsBase._STEP_SETTINGS + field.SETTINGS + (
        'pg_method', 'blocked', 'cg_impl', 'eig_dtype',
    )
    #: the dense arrays whose rows are the sites (see :mod:`..parallel`)
    _site_rows = ('sqrt_factor',)

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
        n_sites = np.asarray(X).shape[0]
        self._resolve_field(
            Q, n_sites, solver, lattice, cg_iters, graph_rank, graph_block,
            solver_check_tol,
            'cg' if n_sites >= _CG_AUTO_THRESHOLD else 'chol',
        )
        if self.spatial_sweeps is None:
            # the JAX package's per-regime policy: cg 3, chol 2, and 1
            # for the matrix-free regimes (the eta solve dominates there)
            self.spatial_sweeps = {'cg': 3, 'chol': 2}.get(self.solver, 1)
        super().__init__(
            Q, W, X, y, hparams, random_state, dtype=dtype, device=device,
        )
        # storage dtype of the CG eigenbasis; the JAX package's bf16
        # default is a TPU rule, so the default here is the model dtype
        self.eig_dtype = (
            self.dtype if eig_dtype is None else resolve_dtype(eig_dtype)
        )
        for key in ('q_eigvecs', 'gr_defl_vecs', 'gr_defl_vecs_p'):
            if key in self.fixed:
                self.fixed[key] = self.fixed[key].to(self.eig_dtype)
        if (self.solver == 'cg' and self.cg_impl == 'pallas'
                and self.device.type == 'cuda'):
            # K3's K-major eigenbases, split once here rather than at
            # every solve; the whole field's, also on a 2-D band
            self.fixed['k3_operands'] = k3_operands(self.fixed['q_eigvecs'])
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
            counts[base + _NOISE] = 2 * self._field_noise_dim
            counts[base + _ASIS] = noise_words(
                self.asis_method, self.asis_steps
            )
        self._alpha_update = 1 + _SWEEP_UPDATES * self.spatial_sweeps
        self._z_update = self._alpha_update + 1
        counts[self._alpha_update] = 2 * self.n_alpha
        counts[self._z_update] = self.n
        self._plan = rng.DrawPlan(counts, self.device)

    def _dense_field(self, x_np, s_eig, u_eig, sqrt_factor):
        """The dense regimes' arrays: the noise factor B, and the
        eigenbasis the CG solves in."""
        arrays = {'sqrt_factor': sqrt_factor}
        if self.solver == 'cg':
            arrays.update(q_eigvals=s_eig, q_eigvecs=u_eig)
        return arrays

    @property
    def _warm_rows(self):
        # the blocked solve's rows [Omega X, k, 1, pert] (unblocked: [y, 1])
        return (self.n_beta + 3) if self.blocked else 2

    @property
    def _step_reads_back(self):
        # the plain rejection sampler reads its active set back every round
        return self.pg_method == 'devroye'

    def _pg(self, subkeys, z):
        if self.pg_method == 'gamma':
            return pg_gamma(subkeys, z, lanes=self._pg_lanes)
        if self.pg_method in ('pallas', 'pallas_packed'):
            return pg_devroye_cuda(subkeys, z, self._pg_lanes)
        return pg_devroye(subkeys, z, self._pg_lanes)

    def _lambda_noise(self, eps, tau, fixed):
        """sqrt(tau) * B eps with B B' = Q; ``eps`` (chains, n - 1), or
        for a matrix-free regime (chains, noise_dim) in its op module's
        layout. A band of a 2-D run holds its sites' rows of B."""
        if self._ops is not None:
            return torch.sqrt(tau)[:, None] * self._ops.noise(
                self._spec, fixed, eps
            )
        return torch.sqrt(tau)[:, None] * (eps @ fixed['sqrt_factor'].T)

    def _residual_system(self, state, fixed):
        """The blocked update's right-hand sides [Omega X, k, 1] and
        omega for :meth:`~.field.ICARField.solver_residual`, omega drawn
        through the configured PG path with fixed zero key words: the
        check only needs a representative omega."""
        x = fixed['X']
        lin_b = lincomb(state['beta'], x.T) + state['spatial']
        subkeys = torch.zeros((1, 2), dtype=torch.int64, device=self.device)
        omega = self._pg(subkeys, lin_b)
        rhs = torch.cat(
            [
                omega[:, None, :] * x.T,
                (state['z'] - 0.5)[:, None, :],
                torch.ones_like(omega)[:, None, :],
            ],
            dim=1,
        )
        return rhs, omega

    def _band_tables(self, band):
        """:class:`..rng.DrawPlan` word tables of a band of a 2-D run
        (:class:`..parallel.sharded_stencil.Band` on a lattice,
        :class:`..parallel.sharded_graph.GraphBand` on a graph,
        :class:`..parallel.sharded_dense.SiteBand` otherwise): the
        field's draws at the band's sites and at the field noise's
        normals its sites need (the edges that touch them, then any
        site normals), so the band draws the words the whole field gives
        them; the per-chain draws stay whole, and so does a field noise
        that no site indexes (the dense regimes' n - 1 normals of B eps,
        RSR's q normals)."""
        sites = torch.arange(band.site0, band.site1)
        noise = band.noise_index(self._spec)
        tables = {self._z_update: sites}
        for i in range(self.spatial_sweeps):
            base = 1 + _SWEEP_UPDATES * i
            tables[base + _EPS1] = rng.normal_words(sites)
            if noise is not None:
                tables[base + _NOISE] = rng.normal_words(noise)
        return tables

    # -------------------------- update segments ----------------------- #

    def _update_beta_eta_blocked(self, state, omega_b, tau, fixed,
                                 eps_beta, eps1, eps_noise):
        """Collapsed beta draw plus the conditional eta draw.

        beta is drawn with eta integrated out, from p + 3 solves against
        Lambda = tau*Q + diag(omega) in one batched call: the rows
        [Omega X, k, 1, pert] give every piece of the Schur complement and
        of eta | beta by linearity (see the JAX ``_update_beta_eta_blocked``
        for the derivation). ``eps_beta`` (chains, p), ``eps1`` (chains,
        n) and ``eps_noise`` (the field noise of :meth:`_lambda_noise`) are
        standard normals.
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
        sol = self._warm_solve(state, rhs, omega_b, tau, fixed)
        g, gk, h, gp = sol[:, :p], sol[:, p], sol[:, p + 1], sol[:, p + 2]
        sites = self._sites
        hsum = sites.sum(h, dim=-1, keepdim=True)
        ca = g - (sites.sum(g, dim=-1, keepdim=True) / hsum[:, None]) * \
            h[:, None, :]
        ck = gk - (sites.sum(gk, dim=-1, keepdim=True) / hsum) * h
        s_mat = (
            sites.contract(x.T * omega_b[:, None, :], x)
            + fixed['b_prec']
            - sites.contract(a_t, ca.transpose(-1, -2))
        )
        s_mat = 0.5 * (s_mat + s_mat.transpose(-1, -2))
        l_vec = (
            sites.contract(k_vec, x) + fixed['b_prec_by_mu']
            - sites.contract(a_t, ck[:, :, None])[..., 0]
        )
        beta = precision_mvnorm(l_vec, s_mat, eps_beta)
        eta = sum_to_zero(gk - lincomb(beta, g) + gp, h, sites)
        return beta, eta

    def _asis_tau(self, s, omega_b, fixed, noise):
        """Sufficient/ancillary tau interweave (Yu & Meng 2011): a move on
        log tau under the ancillary field sqrt(tau) * eta, then eta and
        spatial rescaled (see the JAX ``_asis_tau``). ``noise`` is the
        move's noise (:func:`.interweave.noise_from_words`)."""
        spatial_a = torch.sqrt(s['tau'])[:, None] * s['spatial']
        xb = lincomb(s['beta'], fixed['X'].T)
        a_lin = self._sites.sum((s['k'] - omega_b * xb) * spatial_a, dim=-1)
        c_quad = 0.5 * self._sites.sum(omega_b * spatial_a * spatial_a,
                                       dim=-1)
        return ancillary_tau_move(
            s, spatial_a, a_lin, c_quad,
            fixed['tau_shape'] - 0.5 * self._eta_dim,
            fixed['tau_rate'], self.asis_method, self.asis_sd,
            self.asis_steps, noise,
        )

    def _update_eta(self, state, omega_b, tau, fixed, eps1, eps_noise):
        """Constrained ICAR draw (reference gibbs/logit.py:211-217),
        unblocked path: solve Lambda [x, z] = [y, 1] with y ~ N(b,
        Lambda) and kriging-project."""
        xb = lincomb(state['beta'], fixed['X'].T)
        b = state['k'] - omega_b * xb
        y = b + torch.sqrt(omega_b) * eps1 + self._lambda_noise(
            eps_noise, tau, fixed
        )
        rhs = torch.stack([y, torch.ones_like(y)], dim=1)
        sol = self._warm_solve(state, rhs, omega_b, tau, fixed)
        eta = sum_to_zero(sol[:, 0], sol[:, 1], self._sites)
        return eta, eta

    def _update_beta(self, state, omega_b, spatial, fixed, eps):
        """beta ~ precision MVN (reference gibbs/logit.py:226-232)."""
        x = fixed['X']
        a = self._sites.contract(x.T * omega_b[:, None, :], x) \
            + fixed['b_prec']
        b = self._sites.contract(state['k'] - omega_b * spatial, x) \
            + fixed['b_prec_by_mu']
        return precision_mvnorm(b, a, eps)

    def _update_alpha(self, state, omega_a, fixed, eps):
        """alpha over the currently-occupied surveyed sites, on the flat
        (total_visits,) layout (reference gibbs/logit.py:180-193,
        219-224); ``eps`` (chains, n_alpha) standard normals."""
        w = fixed['W_flat']
        wt = state['z'][:, self._visit_site]
        # sums over the visits of the sites (a band's visits in a 2-D run)
        a = self._sites.contract(w.T, (wt * omega_a)[..., None] * w) \
            + fixed['a_prec']
        b = self._sites.contract(wt * (fixed['y_flat'] - 0.5), w) \
            + fixed['a_prec_by_mu']
        return precision_mvnorm(b, a, eps)

    def _update_z(self, state, alpha, beta, spatial, fixed, u):
        """Occupancy update (reference gibbs/logit.py:234-252) given
        uniforms ``u`` (chains, n): z = 1 where detected, else
        Bernoulli(sigmoid(logit psi + sum_v log(1 - d_v))), the sum over
        visits in a fixed order (:meth:`~.base.GibbsBase._site_sum`)."""
        logit_psi = lincomb(beta, fixed['X'].T) + spatial
        log_prod = self._site_sum(
            -F.softplus(lincomb(alpha, fixed['W_flat'].T))
        )
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
        then alpha and z), marked in the phases of :mod:`..tracing`."""
        with tracing.phase('draws'):
            w = self._plan(keys, step)
        dt = self.dtype
        s = dict(state)
        with tracing.phase('pg'):
            lin_b = lincomb(s['beta'], fixed['X'].T) + s['spatial']
            lin_a = lincomb(s['alpha'], fixed['W_flat'].T)
            omega = self._pg(w[0], torch.cat([lin_b, lin_a], dim=-1))
            omega_b, omega_a = omega[:, :self.n], omega[:, self.n:]

        for i in range(self.spatial_sweeps):
            base = 1 + _SWEEP_UPDATES * i
            with tracing.phase('tau'):
                tau = self._update_tau(
                    s['eta'], fixed,
                    rng.gamma(fixed['tau_shape'], w[base + _TAU], dt),
                )
            with tracing.phase('beta_eta'):
                eps1 = rng.normal(w[base + _EPS1], dt)
                eps_noise = rng.normal(w[base + _NOISE], dt)
                if self.blocked and self._solves_lambda:
                    beta, eta = self._update_beta_eta_blocked(
                        s, omega_b, tau, fixed,
                        rng.normal(w[base + _BETA], dt), eps1, eps_noise,
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
                with tracing.phase('asis'):
                    s = self._asis_tau(
                        s, omega_b, fixed,
                        noise_from_words(
                            w[base + _ASIS], self.asis_method,
                            self.asis_steps, dt,
                        ),
                    )

        with tracing.phase('alpha'):
            s['alpha'] = self._update_alpha(
                s, omega_a, fixed, rng.normal(w[self._alpha_update], dt)
            )
        # z conditions on the post-ASIS spatial field (the move rescales
        # tau, eta and spatial jointly)
        with tracing.phase('z'):
            s['z'], s['k'] = self._update_z(
                s, s['alpha'], s['beta'], s['spatial'], fixed,
                rng.uniform(w[self._z_update], dt),
            )
        return s


class LogitRSRGibbs(RSRField, LogitICARGibbs):
    """Logit sampler with Reduced Spatial Regression (Moran basis).

    Port of the JAX package's ``LogitRSRGibbs`` (reference
    gibbs/logit.py:340-485); same constructor plus ``device`` and
    ``basis``. The Moran basis K (n, q) is built once (threshold ``r`` or
    ``q`` columns) by the route ``basis`` (:class:`.field.RSRField`:
    ``'host'``, ``'device'``, or None for ``'device'`` on a CUDA card from
    2,048 sites and ``'host'`` otherwise); eta lives in that basis and
    ``spatial = K eta``. A step draws both PG fields in one launch of the
    CUDA kernel (on the card), then ``spatial_sweeps`` (default 2) times
    tau, eta (:func:`..ops.mvnorm.rsr_mvnorm`), beta and the ASIS move.
    ``solver`` and ``blocked`` are accepted and unused, as in the JAX
    package: no solve against tau*Q + diag(omega) is made.
    """

    def __init__(
        self, Q, W, X, y, hparams=None, random_state=None, r=0.5, q=None,
        dtype=torch.float32, pg_method=None, basis=None, **kwargs,
    ):
        self._rsr_r = r
        self._rsr_q = q
        self._rsr_basis = basis
        # the JAX package's measured default: a third sweep does not pay
        # in the reduced basis (tau does not bind there)
        kwargs.setdefault('spatial_sweeps', 2)
        super().__init__(
            Q, W, X, y, hparams, random_state, dtype=dtype,
            pg_method=pg_method, **kwargs,
        )

    def _configure_field(self, Q, x_np):
        """The basis, then E with E E' = Q_rsr, the noise factor of the
        eta draw: on the device route in float64 on the device, each
        eigenvector signed as K's columns are."""
        super()._configure_field(Q, x_np)
        if self.basis == 'device':
            self.fixed['sqrt_factor'], _ = icar.psd_sqrt_factor_device(
                self.fixed['Q_rsr'])
        else:
            self.fixed['sqrt_factor'] = icar.psd_sqrt_factor(
                self.fixed['Q_rsr'])

    def _update_eta(self, state, omega_b, tau, fixed, eps1, eps2):
        """Reduced-basis eta draw (reference gibbs/logit.py:478-485);
        ``eps1`` (chains, n) and ``eps2`` (chains, q) standard normals.
        :func:`..ops.mvnorm.rsr_mvnorm` marks its precision
        (``rsr_precision``) and its factor and solves (``rsr_factor``)."""
        xb = lincomb(state['beta'], fixed['X'].T)
        b = self._sites.contract(state['k'] - omega_b * xb, fixed['K'])
        eta = rsr_mvnorm(
            b, omega_b, tau, fixed['Q_rsr'], fixed['K'],
            fixed['sqrt_factor'], eps1, eps2, sites=self._sites,
        )
        return eta, eta @ fixed['K'].T
