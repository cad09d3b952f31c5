"""The spatial field of the samplers: what eta is, and how it is drawn.

Two mixins hold it, each written once for both links and put first in a
sampler's bases: :class:`ICARField`, the full-rank ICAR field of
``LogitICARGibbs`` and ``ProbitICARGibbs`` with its eta regimes (dense
``'chol'``, ``'cg'`` or ``'spectral'``, matrix-free ``'stencil'`` or
``'graph'``), and :class:`RSRField`, the Moran basis of ``LogitRSRGibbs``
and ``ProbitRSRGibbs``. A link passes in only what differs (its dense
default and arrays, its warm start's rows, its residual check's
right-hand sides); the runner and :mod:`..parallel` ask the field
(``_ops``, ``_spec``, ``_band_layout``, ``_site_rows``,
``_eta_on_sites``) and never read a regime's name. A new regime goes
into :class:`ICARField`: its set-up in :meth:`ICARField._configure_field`,
its op module in :data:`OPS`. Port of the JAX package's
``models/etasetup.py`` and of its samplers' field code.
"""

import time

import numpy as np
import scipy.sparse as sps
import torch

from .. import rng, tracing
from ..ops import cuda_stencil, icar, stencil
from ..ops import graph as graph_ops
from ..ops.cg import icar_cg_solve_spectral
from ..ops.cuda_cg import icar_cg_solve_cuda
from ..ops.mvnorm import lambda_cholesky_solve
from .base import INIT_ETA_BASIS

#: from this site count a sparse Q selects the matrix-free graph path (a
#: dense eigendecomposition of Q stops being a sane default)
GRAPH_AUTO_THRESHOLD = 4096

#: the matrix-free regimes and the op module that serves each
OPS = {'stencil': stencil, 'graph': graph_ops}

#: the attributes of either field a step reads (see
#: :attr:`.base.GibbsBase._STEP_SETTINGS`); both families name them all
SETTINGS = ('solver', 'lattice', 'graph', 'graph_rank', 'graph_block',
            'cg_iters', 'q_dim')


def auto_graph_rank(n_sites):
    """Default deflation rank of the graph solver: ~5% of the site
    count rounded up to a multiple of 64, floored at 64, capped at 512
    (the JAX package's policy, measured there: the thin deflation
    products cost little while each step up in rank cuts the fixed-budget
    residual severalfold)."""
    raw = max(64, int(n_sites) // 20)
    return min(512, ((raw + 63) // 64) * 64)


def setup_stencil(lattice, Q, n):
    """Validate ``Q`` against the declared lattice; return the fixed
    arrays. The lattice is trusted only after a random matvec against Q
    (numpy, float64) matches the stencil's (float32, CPU tensors)."""
    if lattice.n != n:
        raise ValueError(
            f'lattice {lattice.rows}x{lattice.cols} does not match '
            f'{n} sites'
        )
    v = np.random.default_rng(0).standard_normal(n)
    qv = (sps.csr_matrix(Q) @ v) if sps.issparse(Q) else (np.asarray(Q) @ v)
    deg = torch.as_tensor(stencil.degree_grid(lattice), dtype=torch.float32)
    sv = stencil.matvec(
        lattice, {'lat_deg': deg}, torch.as_tensor(v, dtype=torch.float32)
    ).numpy()
    if not np.allclose(qv, sv, atol=1e-3 * max(1.0, np.abs(qv).max())):
        raise ValueError('Q does not match the declared lattice structure')
    return stencil.setup(lattice)


def setup_graph(Q, n, rank, block):
    """Flatten a sparse or dense precision into graph panels; return
    ``(spec, arrays)`` with the index panels as int64. Structural checks
    (symmetry, CAR sign pattern, diagonal dominance) happen in
    :func:`..ops.graph.build`."""
    spec, arrays = graph_ops.build(Q, deflate=rank, block=block)
    if spec.n != n:
        raise ValueError(f'Q is {spec.n}x{spec.n} but X has {n} sites')
    for key in graph_ops.INDEX_KEYS:
        if key in arrays:
            arrays[key] = arrays[key].astype(np.int64)
    return spec, arrays


class ICARField:
    """The full-rank ICAR field on the sites, eta on the sum-to-zero
    hyperplane, drawn through solves against tau*Q + diag(omega)."""

    #: eta is drawn on the whole site field through solves against tau*Q
    #: + diag(omega) (not so for a reduced basis)
    _solves_lambda = True
    #: eta is laid out (chains, n sites), as a 2-D run cuts it
    _eta_on_sites = True

    def _resolve_field(self, Q, n_sites, solver, lattice, cg_iters,
                       graph_rank, graph_block, solver_check_tol, dense):
        """Resolve the regime as both links do: a ``lattice`` (a
        :class:`~..ops.stencil.LatticeSpec` or its fields) selects
        ``'stencil'`` unless another solver is named; ``'stencil'`` needs
        a lattice; with no solver named, a sparse Q from
        :data:`GRAPH_AUTO_THRESHOLD` sites selects ``'graph'``, else
        ``dense`` (the link's dense choice for this site count). Then the
        deflation rank (:func:`auto_graph_rank`), the iteration budget and
        the guardrail's tolerance."""
        if lattice is not None:
            if not isinstance(lattice, stencil.LatticeSpec):
                lattice = stencil.LatticeSpec(*lattice)
            if solver in (None, 'stencil'):
                solver = 'stencil'
        if solver == 'stencil' and lattice is None:
            raise ValueError("solver='stencil' requires the `lattice` argument")
        if solver is None:
            solver = (
                'graph' if sps.issparse(Q) and n_sites >= GRAPH_AUTO_THRESHOLD
                else dense
            )
        self.solver, self.lattice, self.graph = solver, lattice, None
        self.graph_rank = int(
            auto_graph_rank(n_sites) if graph_rank is None else graph_rank
        )
        self.graph_block = graph_block
        if cg_iters is None:
            # the JAX package's measured budgets: 8 for the eigenbasis CG
            # (cold residual at the float32 floor by 6), for the graph 7
            # from deflation rank 512, 10 from 256, else 24; 15 otherwise
            # (the stencil's: its DCT preconditioner is near exact; the
            # other dense regimes do not iterate)
            rank = self.graph_rank
            cg_iters = (
                8 if solver == 'cg' else 15 if solver != 'graph'
                else 7 if rank >= 512 else 10 if rank >= 256 else 24
            )
        self.cg_iters = int(cg_iters)
        self.solver_check_tol = (
            None if solver_check_tol is None else float(solver_check_tol)
        )
        self._solver_checked = False

    @property
    def _ops(self):
        """The op module of a matrix-free regime (:data:`OPS`), a band's
        operators in a 2-D run, else None."""
        if self._band_ops is not None:
            return self._band_ops
        return OPS.get(self.solver)

    @property
    def _spec(self):
        """The static spec those ops take: the lattice or the graph."""
        return self.lattice if self.solver == 'stencil' else self.graph

    @property
    def _band_layout(self):
        """How a 2-D run bands the sites: ``'stencil'`` (lattice rows),
        ``'graph'`` (a run of sites and a run of blocks), else ``'dense'``
        (a run of sites)."""
        return self.solver if self.solver in OPS else 'dense'

    @property
    def _iterates(self):
        """Whether eta is drawn by fixed-budget iterative solves: they
        carry a warm start and a running residual, and the cold-start
        check watches them."""
        return (self.solver in ('cg', 'stencil', 'graph')
                and self._solves_lambda)

    @property
    def _eta_dim(self):
        """Dimension of eta under scaling: the sum-to-zero subspace's."""
        return self._field_n - 1

    @property
    def _field_noise_dim(self):
        """Standard normals of one draw's field noise: the matrix-free
        factor's (one per edge, plus one per site where Q has a diagonal
        surplus), the n - 1 columns of B with B B' = Q, or none where the
        link's dense draw is closed-form in the eigenbasis."""
        if self._ops is not None:
            return self._ops.noise_dim(self._spec)
        factor = self.fixed.get('sqrt_factor')
        return 0 if factor is None else factor.shape[1]

    def _configure_field(self, Q, x_np):
        """Check Q and build the regime's fixed arrays. The stencil checks
        zero row sums when rho = 1 (instead of a shift-invert ``eigsh``,
        slow at 10k+ sites) and Q against its lattice, and builds its
        kernel here, in set-up, not at the first step; the graph allows a
        proper CAR surplus (``ops/graph.build`` checks the CAR structure);
        a dense regime checks singularity (reference gibbs/base.py:
        166-170) and keeps the dense Q and the link's arrays from its
        eigenbasis (a matrix-free regime builds neither)."""
        if self.solver == 'stencil':
            rowsum = (
                np.abs(np.asarray(Q.sum(axis=1))).max()
                if sps.issparse(Q) else np.abs(np.asarray(Q).sum(1)).max()
            )
            if self.lattice.rho == 1.0 and rowsum > 1e-8:
                raise ValueError(
                    'Spatial precision matrix Q must be singular.'
                )
            self.fixed.update(setup_stencil(self.lattice, Q, self.n))
            if stencil.takes_kernel(self.lattice, self.device, self.dtype):
                cuda_stencil.load()
        elif self.solver == 'graph':
            # the banded panels stay in the model dtype (float32): rounding
            # Q's entries breaks the ICAR zero row sums, and the JAX
            # package measured a cold residual of 2.3 with bfloat16 panels
            # against 8.7e-4 in float32
            self.graph, arrays = setup_graph(
                Q, self.n, self.graph_rank, self.graph_block
            )
            self.fixed.update(arrays)
        else:
            icar.verify_spatial_precision(Q)
            self.fixed['Q'] = icar.to_dense(Q)
            self.fixed.update(self._dense_field(
                x_np, *icar.icar_spectral(self.fixed['Q'])
            ))

    def _init_state(self, keys, fixed):
        """The link's start, plus the iterative solves' warm start
        (``_warm_rows`` rows: in Q's eigenbasis for the CG, the site-basis
        solutions for the matrix-free regimes) and residual maximum."""
        state = super()._init_state(keys, fixed)
        if self._iterates:
            chains = keys.shape[0]
            state['eta_warm'] = torch.zeros(
                (chains, self._warm_rows, self.n), dtype=self.dtype,
                device=self.device,
            )
            state['solver_resid'] = torch.zeros(
                chains, dtype=self.dtype, device=self.device
            )
        return state

    def _lambda_solve(self, rhs, warm, omega, tau, fixed,
                      return_resid=False):
        """Solve Lambda X = rhs for (chains, rows, n) stacked rows.

        Returns ``(sol, warm_next[, rel])``: the site-basis solutions, the
        carry for the next solve's warm start (eigenbasis for the CG) and
        the per-chain relative residual (0 for the exact Cholesky).

        A band of a 2-D run in a dense regime gathers its chain row's
        operands (:meth:`..ops.sites.Sites.gather`), makes the unchanged
        solve on the whole field and keeps its band of the solutions and
        of the warm start (a band of eigen-coefficients for the CG)."""
        if self._ops is not None:
            out = self._ops.cg_solve(
                self._spec, fixed, rhs, warm, omega, tau, self.cg_iters,
                return_resid=return_resid,
            )
            if return_resid:
                return out[0], out[0], out[1]
            return out, out
        sites = self._sites
        if self.solver == 'cg':
            rhs, warm, omega = sites.gather(rhs, warm, omega, label='field')
            args = (rhs, warm, omega, tau, fixed['q_eigvecs'],
                    fixed['q_eigvals'], self.cg_iters)
            if self.cg_impl == 'pallas':
                out = icar_cg_solve_cuda(
                    *args, return_resid=return_resid,
                    operands=fixed.get('k3_operands'),
                )
            else:
                out = icar_cg_solve_spectral(*args,
                                             return_resid=return_resid)
            return (sites.band(out[0]), sites.band(out[1])) + out[2:]
        rhs, omega = sites.gather(rhs, omega, label='field')
        sol = sites.band(lambda_cholesky_solve(rhs, omega, tau, fixed['Q']))
        if return_resid:
            return sol, sol, torch.zeros_like(tau)
        return sol, sol

    def _warm_solve(self, state, rhs, omega, tau, fixed):
        """:meth:`_lambda_solve` from ``state``'s warm start (zeros where
        it carries none), which it updates with the next one and with the
        residual maximum; returns the solutions."""
        warm = state.get('eta_warm')
        if warm is None:
            warm = torch.zeros_like(rhs)
        with tracing.phase('eta_solve'):
            sol, warm_next, rel = self._lambda_solve(
                rhs, warm, omega, tau, fixed, return_resid=True
            )
        if 'eta_warm' in state:
            state['eta_warm'] = warm_next
        self._track_resid(state, rel)
        return sol

    def _track_resid(self, state, rel):
        """Fold one eta solve's per-chain relative residual into the
        running max ``state['solver_resid']`` (kept on the device and
        checked when :meth:`sample` returns)."""
        if 'solver_resid' in state:
            state['solver_resid'] = torch.maximum(
                state['solver_resid'], rel.to(self.dtype)
            )

    def _eta_quad(self, eta, fixed):
        """eta' Q eta per chain (a band of a 2-D run in a dense regime:
        its sites' terms of the gathered field's product, summed)."""
        if self._ops is not None:
            quad = self._ops.quad_form(self._spec, fixed, eta)
        else:
            sites = self._sites
            [field] = sites.gather(eta, label='field')
            quad = sites.sum(eta * sites.band(field @ fixed['Q']), dim=-1)
        # clamp: float32 cancellation can push the PSD form below 0
        return torch.clamp(quad, min=0.0)

    # ------------- iterative-solver accuracy guardrail ---------------- #

    def solver_residual(self, carry=None):
        """Max relative residual ``||(tau*Q + diag(omega)) x - rhs|| /
        ||rhs||`` of the configured eta solver, run cold on the link's
        right-hand sides (``_residual_system``) at chain 0 of ``carry``
        (default: a fresh one-chain carry). A converged CG reports well
        under 1e-3 in float32, a starved one orders of magnitude more."""
        if carry is None:
            carry = self.init_carry(chains=1)
        state = {k: v[:1] for k, v in carry.states.items()}
        fixed = self.fixed
        rhs, omega = self._residual_system(state, fixed)
        tau = state['tau']
        sol = self._lambda_solve(
            rhs, torch.zeros_like(rhs), omega, tau, fixed
        )[0]
        qsol = (
            self._ops.matvec(self._spec, fixed, sol) if self._ops is not None
            else sol @ fixed['Q'].T
        )
        resid = tau[:, None, None] * qsol + omega[:, None, :] * sol - rhs
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
        fixed-budget iterative solver exceeds ``solver_check_tol`` (None
        skips)."""
        if (
            not self._iterates
            or self.solver_check_tol is None
            or self._solver_checked
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


    def _check_run_solver_health(self, carry):
        """Raise if any chain's in-run solver residual max exceeded
        ``solver_check_tol``; the max is kept on ``self.last_solver_resid``
        either way."""
        states = carry.states
        if 'solver_resid' not in states:
            return
        resid = float(torch.max(states['solver_resid']))
        self.last_solver_resid = resid
        tol = self.solver_check_tol
        if tol is not None and resid > tol:
            raise RuntimeError(
                f'eta solver ({self.solver!r}, cg_iters={self.cg_iters}) '
                f'failed to converge during the run: worst per-draw '
                f'relative residual {resid:.2e} exceeds solver_check_tol='
                f'{tol:.0e}. The sampled draws may be biased — increase '
                f'cg_iters (or pass solver_check_tol=None to bypass). '
                f'The run is resumable from `self.final_carry`.'
            )


def resolve_basis(basis, n_sites, device):
    """The RSR basis route: ``'host'`` (numpy ``eigh``, from
    :data:`..ops.icar._MORAN_LANCZOS_THRESHOLD` sites a scipy Lanczos for
    a sparse Q) or ``'device'`` (float64 on the sampler's device,
    :func:`..ops.icar.moran_basis_device`). ``None`` picks ``'device'`` on
    a CUDA card from that many sites, else ``'host'``."""
    if basis is None:
        return ('device' if torch.device(device).type == 'cuda'
                and n_sites >= icar._MORAN_LANCZOS_THRESHOLD else 'host')
    if basis not in ('host', 'device'):
        raise ValueError(f'unknown basis route: {basis!r}')
    return basis


class RSRField:
    """Reduced Spatial Regression: the Moran basis K (n, q) is built once,
    at construction (threshold ``r`` or ``q`` columns, kept by the link's
    constructor as ``_rsr_r`` and ``_rsr_q``), by the route ``basis``
    (:func:`resolve_basis`): on the host (:func:`..ops.icar.moran_basis`)
    or in float64 on the device (:func:`..ops.icar.moran_basis_device`,
    each eigenvector's sign fixed by :func:`..ops.icar.signed_columns`);
    its host-clock seconds are ``basis_seconds``. eta lives in that basis,
    ``spatial = K eta``, with precision tau * Q_rsr, Q_rsr = K'QK. Put
    first in the bases: it overrides the ICAR field that ``LogitRSRGibbs``
    inherits."""

    _solves_lambda = False
    _eta_on_sites = False
    _band_layout = 'dense'
    #: the dense arrays whose rows are the sites (see :mod:`..parallel`)
    _site_rows = ('K',)
    _ops = _spec = None

    def _configure_field(self, Q, x_np):
        icar.verify_spatial_precision(Q)
        self.basis = resolve_basis(self._rsr_basis, self.n, self.device)
        t = time.perf_counter()
        if self.basis == 'device':
            k_basis, q_rsr, _ = icar.moran_basis_device(
                x_np, Q, r=self._rsr_r, num_eigs=self._rsr_q,
                device=self.device,
            )
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
        else:
            k_basis, q_rsr = icar.moran_basis(
                x_np, Q, r=self._rsr_r, num_eigs=self._rsr_q
            )
        self.basis_seconds = time.perf_counter() - t
        self.q_dim = q_rsr.shape[0]
        self.fixed['K'] = k_basis
        self.fixed['Q_rsr'] = q_rsr
        if not self.hparams_given:
            # reference gibbs/logit.py:454-457
            self.fixed['tau_shape'] = 0.5 + 0.5 * self.q_dim

    def _init_state(self, keys, fixed):
        """The link's start, then eta ~ N(0, 5^2) in the basis (reference
        gibbs/logit.py:462-466)."""
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

    _field_noise_dim = _eta_dim

    def _eta_quad(self, eta, fixed):
        # clamp: float32 cancellation can push the PSD form below 0
        return torch.clamp(
            torch.sum(eta * (eta @ fixed['Q_rsr']), dim=-1), min=0.0
        )
