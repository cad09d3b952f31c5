"""Sampler framework: batched Gibbs transitions driven by a Python loop.

Port of the JAX package's ``models/base.py``. There, a pure transition
is ``vmap``-ped over chains and ``lax.scan``-ned over iterations inside
one compiled program. Here every state entry carries the chains as an
explicit leading dimension, and :meth:`GibbsBase.sample` calls
``_step`` once per iteration from Python; the posterior draws are written
into preallocated device tensors and copied to the host once at the end.
Nothing inside a step reads a value back to the host, so on the card the
loop only enqueues work; the solver's running residual maximum stays on
the device and is read after the run.

Randomness: each chain has two key words (see :mod:`..rng`), a function of
``random_state`` and the chain index alone; every draw is a pure function
of (chain key, step, update, lane). The carry holds the key words and the
step counter, so resuming from it is bit for bit one longer run.
"""

import copy
import dataclasses
import typing

import numpy as np
import torch

from .. import rng
from .._device import resolve_device, resolve_dtype
from ..data import as_occupancy_data
from ..ops import icar
from ..ops.sites import LOCAL
from ..posterior import PosteriorParameter
from . import etasetup


#: update indices of the init draws (step 0 of the init keys) beyond the
#: common start's 1-4: a reduced-basis eta and the probit site effect
INIT_ETA_BASIS, INIT_EPS = 5, 6


class Carry(typing.NamedTuple):
    """Resumable sampling state: per-chain run keys (chains, 2) int64
    words, the state dict of batched tensors, and the next step index."""

    keys: torch.Tensor
    states: dict
    step: int


def _moved(obj, device):
    """``obj`` with every tensor it holds on ``device``: tensors, dicts,
    lists, tuples (named ones too), dataclasses and plain objects of this
    package are walked; containers and objects holding no tensor come
    back as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _moved(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        items = [_moved(v, device) for v in obj]
        if hasattr(obj, '_fields'):
            return type(obj)(*items)
        return type(obj)(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changed = {}
        for f in dataclasses.fields(obj):
            if f.init:
                val = getattr(obj, f.name)
                new = _moved(val, device)
                if new is not val:
                    changed[f.name] = new
        return dataclasses.replace(obj, **changed) if changed else obj
    if (
        type(obj).__module__.split('.')[0] == __name__.split('.')[0]
        and hasattr(obj, '__dict__')
    ):
        attrs = {k: _moved(v, device) for k, v in vars(obj).items()}
        if all(attrs[k] is v for k, v in vars(obj).items()):
            return obj
        out = copy.copy(obj)
        out.__dict__.update(attrs)
        return out
    return obj


class GibbsBase:
    """Shared machinery for the occupancy-model Gibbs samplers.

    Parameters mirror reference gibbs/base.py:30-88: ``Q`` the spatial
    precision (scipy sparse or dense), ``W``/``y`` dict-of-ragged survey
    data (or a prebuilt :class:`~occuspytial_tpu_torch.data.OccupancyData`),
    ``X`` the (n, p) occupancy design matrix, ``hparams`` the six
    documented hyperparameters, ``random_state`` an integer seed.
    ``dtype`` is float32 by default (float64 runs on the CPU); ``device``
    defaults to ``'cuda'`` and must be given as ``'cpu'`` to run there.
    """

    #: names of parameters retained in the posterior chain
    posterior_names = ('alpha', 'beta', 'tau')

    #: extra state entries to record per draw, e.g. ``('z',)``; set on the
    #: instance before :meth:`sample`. The recorded arrays are
    #: (chains, draws, n)-sized.
    track = ()

    #: every sum or contraction over the sites goes through this hook
    #: (:mod:`..ops.sites`): the torch op itself here; a band of a 2-D
    #: (chains x sites) run sums over its ranks
    _sites = LOCAL
    #: a band of a 2-D run: its lattice operators
    #: (:class:`..parallel.sharded_stencil.BandOps`) and the global lane
    #: of each column of its Pólya-Gamma draw; None for the whole field
    _band_ops = None
    _pg_lanes = None

    def __init__(
        self, Q, W, X, y, hparams=None, random_state=None,
        dtype=torch.float32, device=None,
    ):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        x_np = np.asarray(X, dtype=np.float64)
        self.n = x_np.shape[0]
        # sites of the whole field: a band of a 2-D run keeps it while its
        # ``n`` counts the band's sites
        self._field_n = self.n
        self.n_beta = x_np.shape[1]
        self.data = as_occupancy_data(W, y, self.n, dtype=np_dtype)
        self.n_alpha = self.data.n_alpha
        self.max_visits = self.data.max_visits
        self.total_visits = self.data.total_visits
        self._seed = 0 if random_state is None else int(random_state)

        self.fixed = {}
        self._configure(Q, x_np, hparams)
        # every fixed array moves to the device once, floats in self.dtype
        # (the JAX package's fixed pytree, array for array)
        self.fixed = {k: self._to_device(v) for k, v in self.fixed.items()}
        # index layouts of the visit grid (not model arrays)
        self._visit_site = torch.as_tensor(
            np.asarray(self.data.visit_site, dtype=np.int64),
            device=self.device,
        )
        self._site_idx = torch.as_tensor(
            np.asarray(self.data.site_idx, dtype=np.int64),
            device=self.device,
        )
        self._pad_idx = torch.as_tensor(
            self.data.flat_index(), device=self.device
        )
        self._pad_mask = torch.as_tensor(
            np.asarray(self.data.visit_mask), device=self.device
        )

    def _moved(self, device):
        """A shallow copy of this sampler with every tensor on ``device``
        (the fixed arrays and eigenbasis, the visit index layouts, the
        draw plan, the solver setup and any carry), for another process or
        card; nothing is rebuilt. ``device`` goes through
        :func:`.._device.resolve_device`, so a fresh process gets its TF32
        flags."""
        dev = resolve_device(device)
        out = copy.copy(self)
        out.__dict__.update(_moved(self.__dict__, dev))
        out.device = dev
        return out

    def _to_device(self, v):
        arr = np.asarray(v)
        if arr.dtype.kind == 'f':
            return torch.as_tensor(arr, device=self.device).to(self.dtype)
        return torch.as_tensor(arr, device=self.device)

    # ------------------------------------------------------------------ #
    # configuration (host side, runs once)
    # ------------------------------------------------------------------ #

    #: subclasses set False when they never need the dense precision
    _needs_dense_q = True

    @property
    def _ops(self):
        """The op module of the ICAR samplers' matrix-free eta regime
        (``ops.stencil`` or ``ops.graph``), a band's operators in a 2-D
        run, else None."""
        if self._band_ops is not None:
            return self._band_ops
        return etasetup.OPS.get(getattr(self, 'solver', None))

    @property
    def _spec(self):
        """The static spec those ops take: the lattice or the graph (None
        for a sampler with neither)."""
        if getattr(self, 'solver', None) == 'stencil':
            return self.lattice
        return getattr(self, 'graph', None)

    def _verify_spatial_precision(self, Q):
        """Singularity check (reference gibbs/base.py:166-170). The graph
        regime skips it (a proper CAR surplus is allowed there, and
        ``ops/graph.build`` checks the CAR structure); the stencil regime
        checks zero row sums when rho = 1 instead of a shift-invert
        ``eigsh``, which is slow at 10k+ sites."""
        solver = getattr(self, 'solver', None)
        if solver == 'graph':
            return
        if solver == 'stencil':
            import scipy.sparse as sps

            rowsum = (
                np.abs(np.asarray(Q.sum(axis=1))).max()
                if sps.issparse(Q) else np.abs(np.asarray(Q).sum(1)).max()
            )
            if self.lattice.rho == 1.0 and rowsum > 1e-8:
                raise ValueError(
                    'Spatial precision matrix Q must be singular.'
                )
            return
        icar.verify_spatial_precision(Q)

    def _configure(self, Q, x_np, hparams):
        """Build the ``fixed`` dict (reference gibbs/base.py:107-164)."""
        self._verify_spatial_precision(Q)
        f = self.fixed
        f['X'] = x_np
        if self._needs_dense_q:
            f['Q'] = icar.to_dense(Q)
        f['W_flat'] = self.data.W_flat
        f['y_flat'] = self.data.y_flat
        f['visit_site'] = np.asarray(self.data.visit_site)
        f['surveyed'] = np.asarray(self.data.surveyed)
        f['obs'] = np.asarray(self.data.obs, dtype=np.float64)
        self._set_hyperparams(hparams)

    def _set_hyperparams(self, hparams):
        """Hyperparameter defaults (reference gibbs/base.py:177-186)."""
        hp = dict(hparams) if hparams else {}
        self.hparams_given = bool(hparams)
        f = self.fixed
        f['tau_rate'] = float(hp.get('tau_rate', 0.005))
        f['tau_shape'] = float(
            hp.get('tau_shape', 0.5 + 0.5 * (self.n - 1))
        )
        f['a_mu'] = np.asarray(
            hp.get('a_mu', np.zeros(self.n_alpha)), dtype=np.float64
        )
        f['a_prec'] = np.asarray(
            hp.get('a_prec', np.eye(self.n_alpha) / 10), dtype=np.float64
        )
        f['b_mu'] = np.asarray(
            hp.get('b_mu', np.zeros(self.n_beta)), dtype=np.float64
        )
        f['b_prec'] = np.asarray(
            hp.get('b_prec', np.eye(self.n_beta) / 10), dtype=np.float64
        )
        f['a_prec_by_mu'] = f['a_prec'] @ f['a_mu']
        f['b_prec_by_mu'] = f['b_prec'] @ f['b_mu']

    # ------------------------------------------------------------------ #
    # state initialization
    # ------------------------------------------------------------------ #

    def _initial_z(self, fixed, chains):
        """Observed -> 1, unsurveyed -> 1, surveyed unobserved -> 0
        (reference gibbs/base.py:113-119)."""
        z = torch.where(
            fixed['surveyed'], fixed['obs'],
            torch.ones((), dtype=self.dtype, device=self.device),
        )
        return z.expand(chains, self.n).clone()

    def _init_plan(self):
        return rng.DrawPlan(
            {1: rng.GAMMA_WORDS, 2: 2 * self.n, 3: 2 * self.n_alpha,
             4: 2 * self.n_beta},
            self.device,
        )

    def _init_common(self, keys, fixed):
        """Default random start (reference gibbs/base.py:199-212, with
        the regression starts moderated to N(mu, I) as in the JAX
        package: the reference's MVN(mu, 100 * prec) start saturates
        the linear predictor in ~1 chain of 7, a metastable region for
        PG-Gibbs; see the JAX ``models/base.py:_init_common``)."""
        chains = keys.shape[0]
        w = self._init_plan()(keys, 0)
        state = {}
        state['z'] = self._initial_z(fixed, chains)
        state['k'] = state['z'] - 0.5
        state['tau'] = rng.gamma(0.5, w[1], self.dtype) / fixed['tau_rate']
        eta = rng.normal(w[2], self.dtype)
        state['eta'] = eta - eta.mean(dim=-1, keepdim=True)
        state['spatial'] = state['eta']
        state['alpha'] = fixed['a_mu'] + rng.normal(w[3], self.dtype)
        state['beta'] = fixed['b_mu'] + rng.normal(w[4], self.dtype)
        return state

    def _init_state(self, keys, fixed):
        """Subclasses may extend."""
        return self._init_common(keys, fixed)

    #: state entries a user ``start`` dict may set
    _start_names = ('alpha', 'beta', 'tau', 'eta')

    def _apply_start(self, state, start):
        """Override state entries from a user ``start`` dict
        (reference gibbs/base.py:188-197)."""
        out = dict(state)
        chains = state['tau'].shape[0]
        for name in self._start_names:
            if name in start:
                val = torch.as_tensor(
                    np.asarray(start[name]), device=self.device
                ).to(self.dtype)
                out[name] = val.expand(
                    (chains,) + tuple(state[name].shape[1:])
                ).clone()
        out['spatial'] = self._spatial_from_eta(out['eta'])
        return out

    def _spatial_from_eta(self, eta):
        return eta

    def _site_sum(self, per_visit):
        """Per-site sums (chains, n) of per-visit values (chains,
        total_visits), 0 at unsurveyed sites.

        The sum runs over the padded (n_surveyed, v_max) visit grid in a
        fixed order. The JAX package's scatter-add (``.at[visit_site].
        add``) would become ``index_add_``, which on CUDA sums with atomics
        in an order that changes from run to run, so one ``random_state``
        would no longer give identical draws."""
        grid = torch.where(
            self._pad_mask, per_visit[:, self._pad_idx],
            torch.zeros((), dtype=per_visit.dtype, device=per_visit.device),
        )
        out = per_visit.new_zeros((per_visit.shape[0], self.n))
        out[:, self._site_idx] = grid.sum(dim=-1)
        return out

    # ------------------------------------------------------------------ #
    # transition kernel
    # ------------------------------------------------------------------ #

    def _step(self, keys, step, state, fixed):
        raise NotImplementedError(
            f'{self.__class__.__name__} must implement a `_step` method.'
        )

    def _track_resid(self, state, rel):
        """Fold one eta solve's per-chain relative residual into the
        running max ``state['solver_resid']`` (kept on the device and
        checked when :meth:`sample` returns)."""
        if 'solver_resid' in state:
            state['solver_resid'] = torch.maximum(
                state['solver_resid'], rel.to(self.dtype)
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
        tol = getattr(self, 'solver_check_tol', None)
        if tol is not None and resid > tol:
            raise RuntimeError(
                f'eta solver ({getattr(self, "solver", "?")!r}, '
                f'cg_iters={getattr(self, "cg_iters", "?")}) failed to '
                f'converge during the run: worst per-draw relative '
                f'residual {resid:.2e} exceeds solver_check_tol='
                f'{tol:.0e}. The sampled draws may be biased — increase '
                f'cg_iters (or pass solver_check_tol=None to bypass). '
                f'The run is resumable from `self.final_carry`.'
            )

    # ------------------------------------------------------------------ #
    # sampling loop
    # ------------------------------------------------------------------ #

    def init_carry(self, chains=2, start=None):
        """Build the resumable carry: per-chain run keys, initial states
        and step 0. Chain c's init and run keys depend on
        ``random_state`` and c alone."""
        init_keys = rng.chain_keys(self._seed, chains, rng.INIT, self.device)
        run_keys = rng.chain_keys(self._seed, chains, rng.RUN, self.device)
        state0 = self._init_state(init_keys, self.fixed)
        unknown = [t for t in self.track if t not in state0]
        if unknown:
            raise ValueError(
                f'track names {unknown} are not state entries; this '
                f'model carries {sorted(state0)}'
            )
        if start is not None:
            state0 = self._apply_start(state0, start)
        return Carry(run_keys, state0, 0)

    def save_carry(self, path, carry):
        """Serialize a carry to ``path`` (.npz): ``__keys__`` (chains, 2)
        uint32 and one array per state entry, the layout of the JAX
        package's ``save_carry``, plus ``__step__``."""
        payload = {
            '__keys__': carry.keys.cpu().numpy().astype(np.uint32),
            '__step__': np.asarray(carry.step, dtype=np.int64),
        }
        for name, val in carry.states.items():
            payload[name] = val.cpu().numpy()
        np.savez(path, **payload)

    def load_carry(self, path):
        """Load a carry saved by :meth:`save_carry` or by the JAX
        package's ``save_carry`` (whose files have no ``__step__``: the
        run continues from step 0 of the saved keys)."""
        from ..convert import carry_from_jax

        with np.load(path) as data:
            states = {
                name: data[name] for name in data.files
                if name not in ('__keys__', '__step__')
            }
            step = int(data['__step__']) if '__step__' in data.files else 0
            return carry_from_jax(
                data['__keys__'], states, device=self.device,
                dtype=self.dtype, step=step,
            )

    def _run(self, carry, size, bars=()):
        """``size`` steps from ``carry``: returns the next carry and the
        recorded draws, name -> (size, chains, ...) device tensor."""
        keys, states, step = carry
        names = tuple(self.posterior_names) + tuple(self.track)
        out = {
            name: torch.empty(
                (size,) + tuple(states[name].shape),
                dtype=states[name].dtype, device=self.device,
            )
            for name in names
        }
        for t in range(size):
            states = self._step(keys, step + t, states, self.fixed)
            for name in names:
                out[name][t].copy_(states[name])
            for bar in bars:
                bar.update(1)
        return Carry(keys, states, step + size), out

    def _progress_bars(self, progressbar, size, chains):
        if not progressbar:
            return []
        try:
            from tqdm.auto import tqdm
        except ImportError:  # tqdm is an optional extra
            import warnings

            warnings.warn(
                'tqdm is not installed; sampling without a progress bar',
                stacklevel=3,
            )
            return []
        if progressbar == 'per-chain' and chains > 1:
            return [
                tqdm(total=size, position=i, desc=f'chain {i}')
                for i in range(chains)
            ]
        return [tqdm(total=size)]

    def sample(
        self, size, burnin=0, start=None, chains=2, progressbar=True,
        resume_from=None,
    ):
        """Draw posterior samples (API of reference gibbs/base.py:243-291).

        Returns a :class:`~occuspytial_tpu_torch.posterior.PosteriorParameter`
        over ('alpha', 'beta', 'tau') with per-chain arrays of shape
        (chains, size - burnin[, dim]). ``self.final_carry`` then holds
        the resumable carry; pass it back via ``resume_from`` (or through
        :meth:`save_carry`/:meth:`load_carry`) to continue the run
        exactly where it stopped. The progress bar counts enqueued steps.
        """
        if burnin >= size:
            raise ValueError('burnin value cannot be larger than sample size')
        if chains < 1:
            raise ValueError('chains must a positive integer.')
        if type(self)._step is GibbsBase._step:
            self._step(None, 0, None, None)
        carry = (
            resume_from if resume_from is not None
            else self.init_carry(chains, start)
        )
        bars = self._progress_bars(progressbar, size, carry.keys.shape[0])
        try:
            carry, out = self._run(carry, size, bars)
        finally:
            for bar in bars:
                bar.close()
        self.final_carry = carry
        self._check_run_solver_health(carry)
        merged = {
            name: np.moveaxis(val.cpu().numpy(), 0, 1)[:, burnin:]
            for name, val in out.items()
        }
        return PosteriorParameter(merged)

    def sample_until(
        self, rhat_tol=1.01, min_ess=400.0, chains=4, check_every=512,
        max_size=32768, start=None, discard_frac=0.5, progressbar=False,
    ):
        """Sample adaptively until convergence (rebuild addition).

        Extends the run in ``check_every``-draw blocks (each resumed from
        the previous carry, so bit for bit one long run) until, over the
        retained last ``1 - discard_frac`` of draws, every recorded
        scalar has rank-normalized split-R-hat <= ``rhat_tol`` and pooled
        bulk ESS >= ``min_ess`` (``None`` disables either criterion).
        Raises ``RuntimeError`` naming the worst parameter if ``max_size``
        draws do not converge.
        """
        from .. import diagnostics as dg

        if check_every < 8:
            raise ValueError('check_every must be at least 8')
        acc = {}
        carry = None
        total = 0
        while True:
            post = self.sample(
                check_every, chains=chains, start=start,
                progressbar=progressbar, resume_from=carry,
            )
            carry, start = self.final_carry, None
            total += check_every
            for name in post.data:
                arr = np.asarray(post[name])
                acc[name] = (
                    arr if name not in acc
                    else np.concatenate([acc[name], arr], axis=1)
                )
            keep = max(int(total * (1.0 - discard_frac)), 4)
            window = {k: v[:, -keep:] for k, v in acc.items()}
            worst_name, worst_rhat = None, 0.0
            worst_ess_name, worst_ess = None, np.inf
            for name, arr in window.items():
                scalar = arr.ndim == 2
                cols = arr[..., None] if scalar else arr
                for j in range(cols.shape[2]):
                    label = name if scalar else f'{name}[{j}]'
                    r = float(dg.rhat(cols[:, :, j]))
                    e = float(dg.ess_bulk(cols[:, :, j]))
                    if r > worst_rhat:
                        worst_name, worst_rhat = label, r
                    if e < worst_ess:
                        worst_ess_name, worst_ess = label, e
            ok_rhat = rhat_tol is None or worst_rhat <= rhat_tol
            ok_ess = min_ess is None or worst_ess >= min_ess
            if ok_rhat and ok_ess:
                return PosteriorParameter(window)
            if total >= max_size:
                raise RuntimeError(
                    f'no convergence after {total} draws: worst r_hat '
                    f'{worst_rhat:.4f} on {worst_name} (tol {rhat_tol}), '
                    f'min pooled ess_bulk {worst_ess:.0f} on '
                    f'{worst_ess_name} (need {min_ess})'
                )

    def copy(self):
        """Same-model sampler with an independent random stream (API
        parity with reference gibbs/base.py:293-306): the seed comes
        from (parent seed, spawn counter) through
        ``SeedSequence.spawn``, so successive copies never share a
        stream and never collide with ``random_state=seed+1``."""
        out = self.__class__.__new__(self.__class__)
        out.__dict__.update(self.__dict__)
        self._n_spawned = getattr(self, '_n_spawned', 0) + 1
        children = np.random.SeedSequence(self._seed).spawn(self._n_spawned)
        out._seed = int(children[-1].generate_state(1)[0])
        out._n_spawned = 0
        return out
