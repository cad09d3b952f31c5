"""The logit RSR Gibbs step (Polya-Gamma augmentation, a reduced Moran
basis), in plain torch.

A plain rewrite of the documented sampler (upstream OccuSpytial
``LogitRSRGibbs``, gibbs/logit.py:340-485), for one configuration's data
and settings: the same draws from the same stream (:mod:`.threefry`) and
the same updates, each chain independent, in the arithmetic of
:class:`.operators.Arith`. The spatial term is K eta, K the (n, q) top
eigenvectors of the Moran operator, built here in float64 on the
reference's device by upstream's construction (:func:`moran_basis`), with
the ICAR precision reduced to Q_rsr = K'QK. One step, per chain (update
indices of the step's words in brackets):

1. omega ~ PG(1, [X beta + K eta, W alpha]) over the sites' and the
   visits' lanes (0);
2. per sweep i, base 1 + 5 i, in the unblocked order: tau | eta ~
   Gamma(shape, 0.5 eta'Q_rsr eta + rate) (base); eta | omega, beta, tau
   (base + 2 and base + 3): with Lambda = tau Q_rsr + K' Omega K and E E'
   = Q_rsr, y = K'(k - omega X beta) + K'(sqrt(omega) eps1) + sqrt(tau) E
   eps2 ~ N(K'(k - omega X beta), Lambda), eta = Lambda^-1 y by one
   Cholesky factor; beta | omega, eta (base + 1): precision X' Omega X +
   B, linear term X'(k - omega K eta); the ASIS random-walk MH move of log
   tau (base + 4) under the ancillary field sqrt(tau) K eta, 12 sub-steps
   of sd 1.2;
3. alpha | z, omega_a, then z | rest from uniforms.

k = z - 1/2. Priors: tau ~ Gamma(0.5 + 0.5 q, 0.005), alpha, beta ~ N(0,
10 I) (B = I / 10). The initial state: z from the data, tau ~ Gamma(0.5)
/ 0.005, alpha and beta standard normals, eta 5 times standard normals
(updates 1, 3, 4 and 5 of step 0 under the init keys).

The signs of K's columns and of the eigenvectors that make E are fixed by
one convention, so that eta's coordinates are the program's: each is
signed so that its inner product with g is positive, g the first m
standard normals of ``numpy.random.default_rng(0)`` (m its length).
"""

import numpy as np
import scipy.sparse as sps
import torch

from . import threefry as tf
from .logit_icar import _pack
from .operators import Arith
from .polyagamma import pg_draw

_SWEEP = 5
_TAU, _BETA, _EPS1, _NOISE, _ASIS = range(_SWEEP)
#: init update of the reduced-basis eta
_INIT_ETA = 5


def _signed(v):
    """``v`` (m, k) with each column signed so that g'v_j > 0."""
    g = torch.as_tensor(np.random.default_rng(0).standard_normal(
        v.shape[0]), dtype=v.dtype, device=v.device)
    return v * torch.where(g @ v < 0, -1.0, 1.0).to(v.dtype)


def moran_basis(X, Q, r=0.5, q=None, device='cpu'):
    """Upstream's reduced basis, in float64 torch on ``device``: P = I - X
    (X'X)^-1 X' by a Cholesky factor of X'X and a triangular solve, the
    Moran operator M = n P'AP / sum(A) with A = -offdiag(Q), its
    eigenvectors by ``torch.linalg.eigh``, and the top ``q`` of them
    (those with eigenvalue at least ``r`` when ``q`` is None), each
    signed by the module's convention. Returns (K (n, q), Q_rsr = K'QK,
    M's eigenvalues in ascending order), tensors on ``device``."""
    dt = torch.float64
    x = torch.as_tensor(np.asarray(X, np.float64), device=device)
    n = x.shape[0]
    low = torch.linalg.cholesky(x.T @ x)
    half = torch.linalg.solve_triangular(low, x.T, upper=False)
    proj = torch.eye(n, dtype=dt, device=device) - half.T @ half
    coo = sps.coo_matrix(Q)
    qd = torch.sparse_coo_tensor(
        torch.as_tensor(np.vstack([coo.row, coo.col]).astype(np.int64)),
        torch.as_tensor(coo.data, dtype=dt), coo.shape,
        check_invariants=True).to(device).to_dense()
    adj = -qd
    adj.fill_diagonal_(0.0)
    moran = n * (proj.T @ adj @ proj) / torch.sum(adj)
    del proj, adj
    w, v = torch.linalg.eigh(moran)
    del moran
    q_dim = int(q) if q else int((w >= r).sum())
    k = _signed(v[:, -q_dim:])
    q_rsr = k.T @ qd @ k
    return k, 0.5 * (q_rsr + q_rsr.T), w


class LogitRSR:
    """The sampler of one dataset and one set of sampler arguments (``r``
    or ``q`` of the basis, ``spatial_sweeps``, default 2; ASIS MH with sd
    1.2 over 12 sub-steps, the defaults)."""

    def __init__(self, data, args, ar):
        for key, want in (('asis', True), ('asis_method', 'mh')):
            if args.get(key, want) != want:
                raise ValueError(f'no reference for {key}={args[key]!r}')
        Q, W, X, y = data['Q'], data['W'], data['X'], data['y']
        self.ar = ar
        dev, dt = ar.device, ar.dtype
        x = np.asarray(X, np.float64)
        n, p = x.shape
        self.n, self.p = n, p
        k, q_rsr, _ = moran_basis(x, Q, args.get('r', 0.5), args.get('q'),
                                  dev)
        self.q = k.shape[1]
        s, u = torch.linalg.eigh(q_rsr)
        e = _signed(u) * torch.sqrt(torch.clamp(s, min=0.0))
        self.K, self.Q_rsr, self.E = k.to(dt), q_rsr.to(dt), e.to(dt)
        self.sweeps = int(args.get('spatial_sweeps') or 2)
        self.asis_sd, self.asis_steps = 1.2, 12
        w_flat, y_flat, vs, surveyed, obs = _pack(W, y, n)
        self.X = ar.tensor(x)
        self.Wf = ar.tensor(w_flat)
        self.yf = ar.tensor(y_flat)
        self.vs = torch.as_tensor(vs, device=dev)
        self.surveyed = torch.as_tensor(surveyed, device=dev)
        self.obs = torch.as_tensor(obs, device=dev)
        self.qa = self.Wf.shape[1]
        self.tau_rate = 0.005
        self.tau_shape = 0.5 + 0.5 * self.q
        self.b_prec = torch.eye(p, dtype=dt, device=dev) / 10
        self.a_prec = torch.eye(self.qa, dtype=dt, device=dev) / 10
        self.alpha_update = 1 + _SWEEP * self.sweeps
        self.z_update = self.alpha_update + 1

    # ---------------------------------------------------------------- #

    def state_from(self, states):
        """The reference's state from a carry's state dict (any device or
        float type)."""
        keep = ('z', 'tau', 'eta', 'spatial', 'alpha', 'beta')
        return {k: states[k].to(self.ar.device).to(self.ar.dtype)
                for k in keep}

    def init_state(self, seed, chains):
        ar, dt = self.ar, self.ar.dtype
        keys = tf.chain_keys(seed, chains, tf.INIT, ar.device)
        z0 = torch.where(self.surveyed, self.obs.to(dt),
                         torch.ones((), dtype=dt, device=ar.device))
        tau = tf.gamma(0.5, tf.words(keys, 0, 1, tf.GAMMA_WORDS), dt) \
            / self.tau_rate
        eta = 5.0 * tf.normal(tf.words(keys, 0, _INIT_ETA, 2 * self.q), dt)
        return {
            'z': z0.expand(chains, self.n).clone(),
            'tau': tau,
            'eta': eta,
            'spatial': ar.mm(eta, self.K.T),
            'alpha': tf.normal(tf.words(keys, 0, 3, 2 * self.qa), dt),
            'beta': tf.normal(tf.words(keys, 0, 4, 2 * self.p), dt),
        }

    def run_keys(self, seed, chains):
        return tf.chain_keys(seed, chains, tf.RUN, self.ar.device)

    # ---------------------------------------------------------------- #

    @staticmethod
    def _mvn(b, prec, eps):
        """N(prec^-1 b, prec^-1) from standard normals ``eps``."""
        low = torch.linalg.cholesky(prec)
        mean = torch.cholesky_solve(b[..., None], low)[..., 0]
        fluct = torch.linalg.solve_triangular(
            low.transpose(-1, -2), eps[..., None], upper=True)[..., 0]
        return mean + fluct

    def _quad(self, eta):
        """eta'Q_rsr eta per chain, at least 0."""
        return torch.clamp(torch.sum(eta * self.ar.mm(eta, self.Q_rsr),
                                     dim=-1), min=0.0)

    def _eta(self, s, k, omega, tau, eps1, eps2):
        """eta ~ N(Lambda^-1 b, Lambda^-1), Lambda = tau Q_rsr + K'
        Omega K, b = K'(k - omega X beta): y ~ N(b, Lambda), then one
        Cholesky solve."""
        ar, K = self.ar, self.K
        b = ar.mm(k - omega * (s['beta'] @ self.X.T), K)
        y = (b + ar.mm(torch.sqrt(omega) * eps1, K)
             + torch.sqrt(tau)[:, None] * ar.mm(eps2, self.E.T))
        lam = tau[:, None, None] * self.Q_rsr + ar.mm(
            K.T * omega[:, None, :], K)
        low = torch.linalg.cholesky(lam)
        return torch.cholesky_solve(y[..., None], low)[..., 0]

    def _asis(self, s, k, omega, w):
        dt = self.ar.dtype
        steps = self.asis_steps
        normals = tf.normal(w[:, :2 * steps], dt) * self.asis_sd
        log_u = torch.log(tf.uniform(w[:, 2 * steps:], dt))
        tau = s['tau']
        spatial_a = torch.sqrt(tau)[:, None] * s['spatial']
        xb = s['beta'] @ self.X.T
        a_lin = torch.sum((k - omega * xb) * spatial_a, dim=-1)
        c_quad = 0.5 * torch.sum(omega * spatial_a * spatial_a, dim=-1)
        a0 = self.tau_shape - 0.5 * self.q
        b0 = self.tau_rate

        def logf(lt):
            t = torch.exp(lt)
            return a0 * lt - b0 * t + a_lin * torch.rsqrt(t) - c_quad / t

        lt = torch.log(tau)
        f_lt = logf(lt)
        for i in range(steps):
            prop = lt + normals[:, i]
            f_prop = logf(prop)
            acc = log_u[:, i] < f_prop - f_lt
            lt = torch.where(acc, prop, lt)
            f_lt = torch.where(acc, f_prop, f_lt)
        new_t = torch.exp(lt)
        inv = torch.rsqrt(new_t)[:, None]
        s['eta'] = (torch.sqrt(tau)[:, None] * s['eta']) * inv
        s['spatial'] = spatial_a * inv
        s['tau'] = new_t

    def step(self, s, keys, t):
        """One Gibbs step at step index ``t`` for every chain; returns
        the new state dict."""
        ar, dt, n = self.ar, self.ar.dtype, self.n
        s = dict(s)

        def words(update, count):
            return tf.words(keys, t, update, count)

        k = s['z'] - 0.5
        lin_b = s['beta'] @ self.X.T + s['spatial']
        lin_a = s['alpha'] @ self.Wf.T
        omega = pg_draw(words(0, 2), torch.cat([lin_b, lin_a], dim=-1))
        omega_b, omega_a = omega[:, :n], omega[:, n:]
        for i in range(self.sweeps):
            base = 1 + _SWEEP * i
            g = tf.gamma(self.tau_shape, words(base + _TAU, tf.GAMMA_WORDS),
                         dt)
            tau = g / (0.5 * self._quad(s['eta']) + self.tau_rate)
            eta = self._eta(
                s, k, omega_b, tau,
                tf.normal(words(base + _EPS1, 2 * n), dt),
                tf.normal(words(base + _NOISE, 2 * self.q), dt))
            spatial = ar.mm(eta, self.K.T)
            beta = self._mvn(
                ar.mm(k - omega_b * spatial, self.X),
                ar.mm(self.X.T * omega_b[:, None, :], self.X) + self.b_prec,
                tf.normal(words(base + _BETA, 2 * self.p), dt))
            s.update(tau=tau, eta=eta, spatial=spatial, beta=beta)
            self._asis(s, k, omega_b,
                       words(base + _ASIS, 3 * self.asis_steps))
        wt = s['z'][:, self.vs]
        a = ar.mm(self.Wf.T, (wt * omega_a)[..., None] * self.Wf) \
            + self.a_prec
        b = ar.mm(wt * (self.yf - 0.5), self.Wf)
        s['alpha'] = self._mvn(
            b, a, tf.normal(words(self.alpha_update, 2 * self.qa), dt))
        log_d = -torch.nn.functional.softplus(s['alpha'] @ self.Wf.T)
        log_prod = torch.zeros_like(s['spatial']).index_add_(1, self.vs,
                                                             log_d)
        p_occ = torch.sigmoid(s['beta'] @ self.X.T + s['spatial']
                              + log_prod)
        u = tf.uniform(words(self.z_update, n), dt)
        s['z'] = torch.where(self.obs, torch.ones((), dtype=dt,
                                                  device=ar.device),
                             (u < p_occ).to(dt))
        return s

    def follow(self, s, keys, step, steps):
        """``steps`` steps from the state ``s`` at step index ``step``:
        returns {'alpha', 'beta', 'tau'}, each (steps, chains[, dim])."""
        out = {'alpha': [], 'beta': [], 'tau': []}
        for j in range(steps):
            s = self.step(s, keys, step + j)
            for name in out:
                out[name].append(s[name])
        return {k: torch.stack(v) for k, v in out.items()}


def build(data, args, device, control=False):
    """The reference sampler (float64) or its precision control (float32
    with TF32 products, rounded by :class:`.operators.Arith` and
    multiplied in float32) on ``device``; the card's own TF32 products
    stay off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ar = Arith(device, torch.float32 if control else torch.float64,
               tf32=control)
    return LogitRSR(data, args, ar)
