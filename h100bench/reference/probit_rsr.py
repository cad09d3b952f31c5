"""The probit RSR Gibbs step (Albert-Chib truncated-normal utilities, the
collapsed Woodbury ladder), in plain torch.

A plain rewrite of the documented sampler (upstream OccuSpytial
``ProbitRSRGibbs``, with the port's collapsed ladder and scale move), for
one configuration's data and settings: the same draws from the same
stream (:mod:`.threefry`) and the same updates, each chain independent,
in the arithmetic of :class:`.operators.Arith`. The spatial term is K
eta, K the (n, q) top eigenvectors of the Moran operator (built here by
upstream's construction, :func:`moran_basis`), with the ICAR precision
reduced to Q_rsr = K'QK. The site effect eps ~ N(0, 1) sits on top, so a
site's utility is u ~ N(X beta + K eta + eps, 1). One step, per chain
(update indices of the step's words in brackets):

1. u | z (0): with eps integrated out, N(X beta + K eta, 2) truncated to
   u > 0 where z = 1 and u < 0 where z = 0, by the inverse CDF; then the
   scale move (1) on the eps-marginal density: (u, beta, eta) times g,
   g^2 = 2 G / S, G ~ Gamma((n + p + q) / 2), S = |u - X beta - K
   eta|^2 / 2 + tau eta'Q_rsr eta + beta'B beta;
2. per sweep i, base 2 + 6 i: tau ~ Gamma(shape, 0.5 eta'Q_rsr eta +
   rate) (base); with A = tau Q_rsr + K'K / 2 and its Cholesky factor L,
   beta | u with eta and eps out (base + 1): precision X'X / 2 + B -
   (K'X)'A^-1 (K'X) / 4, linear term X'u / 2 - (K'X)'A^-1 K'u / 4;
   eta | u, beta with eps out (base + 2): N(A^-1 K'(u - X beta) / 2,
   A^-1), the noise L'^-1 eps; eps | rest (base + 3): N((u - X beta - K
   eta) / 2, 1/2); the scale move (base + 4) over (u, beta, eta, eps),
   with G ~ Gamma((2 n + p + q) / 2) and S = |u - X beta - K eta -
   eps|^2 + |eps|^2 + tau eta'Q_rsr eta + beta'B beta; the ASIS
   random-walk MH move of log tau (base + 5) under the ancillary field
   sqrt(tau) K eta, 12 sub-steps of sd 1;
3. the visit utilities v | alpha, y (2 + 6 sweeps) truncated by the
   detections; alpha | v over the occupied sites' visits (next); z from
   a uniform (next): P(z = 1) = sigmoid(log Phi(lin) + sum_v log
   Phi(-w_v alpha) - log Phi(-lin)), lin = X beta + K eta + eps, and 1
   at sites with a detection.

Priors: tau ~ Gamma(0.5 + 0.5 q, 0.005), alpha, beta ~ N(0, 10 I) (B =
I / 10). The initial state: z from the data, tau ~ Gamma(0.5) / 0.005,
alpha, beta standard normals, eta 5 times standard normals, eps standard
normals (updates 1, 3, 4, 5 and 6 of step 0 under the init keys).
"""

import math

import numpy as np
import scipy.linalg
import scipy.sparse as sps
import torch
from torch.special import log_ndtr, ndtri

from . import threefry as tf
from .logit_icar import _pack
from .operators import Arith

_SWEEP = 6
_TAU, _BETA, _ETA, _EPS, _PX, _ASIS = range(_SWEEP)
#: init updates of the reduced-basis eta and of eps
_INIT_ETA, _INIT_EPS = 5, 6


def moran_basis(X, Q, r=0.5, q=None):
    """Upstream's reduced basis: P = I - X (X'X)^-1 X' by a Cholesky
    factor of X'X and a triangular solve, the Moran operator M = n P'AP /
    sum(A) with A = -offdiag(Q), its eigenvectors by
    ``numpy.linalg.eigh``, and the top ``q`` of them (those with
    eigenvalue at least ``r`` when ``q`` is None). Returns (K (n, q),
    Q_rsr = K'QK, M's eigenvalues in ascending order)."""
    x = np.asarray(X, np.float64)
    n = x.shape[0]
    low = np.linalg.cholesky(x.T @ x)
    half = scipy.linalg.solve_triangular(low, x.T, lower=True)
    proj = np.eye(n) - half.T @ half
    qd = np.asarray(Q.todense() if sps.issparse(Q) else Q, np.float64)
    adj = -qd
    np.fill_diagonal(adj, 0.0)
    moran = n * (proj.T @ adj @ proj) / adj.sum()
    w, v = np.linalg.eigh(moran)
    q_dim = int(q) if q else int((w >= r).sum())
    k = v[:, -q_dim:]
    return k, k.T @ qd @ k, w


#: where the sampler clamps the normal quantile's argument, [c, 1 - c]:
#: the machine epsilon of its float type, so that in float32 (the
#: configurations' precision) a utility is drawn at most ~5.2 sigma into
#: the tail beyond its truncation point (~8 sigma in float64)
CLAMP_FLOAT32 = 2.0 ** -23


def truncnorm_sign(loc, positive, u, clamp=CLAMP_FLOAT32):
    """N(loc, 1) truncated to (0, inf) where ``positive``, else to
    (-inf, 0), from one uniform each by the inverse CDF in log space;
    the CDF argument is kept inside [clamp, 1 - clamp]."""
    def quantile(log_q):
        return ndtri(torch.clamp(torch.exp(log_q), clamp, 1.0 - clamp))

    tiny = torch.finfo(u.dtype).tiny
    up = loc - quantile(log_ndtr(loc) + torch.log1p(-u))
    down = loc + quantile(log_ndtr(-loc)
                          + torch.log(torch.clamp(u, min=tiny)))
    return torch.where(positive, up, down)


class ProbitRSR:
    """The sampler of one dataset and one set of sampler arguments
    (``r`` or ``q`` of the basis, ``spatial_sweeps``; the collapsed
    ladder, the exact scale move and ASIS MH, the defaults), its
    utilities' quantile clamped at ``clamp``."""

    def __init__(self, data, args, ar, clamp=CLAMP_FLOAT32):
        for key, want in (('collapsed', True), ('px', True),
                          ('asis', True), ('asis_method', 'mh')):
            if args.get(key, want) != want:
                raise ValueError(f'no reference for {key}={args[key]!r}')
        Q, W, X, y = data['Q'], data['W'], data['X'], data['y']
        self.ar, self.clamp = ar, clamp
        x = np.asarray(X, np.float64)
        n, p = x.shape
        self.n, self.p = n, p
        k, q_rsr, _ = moran_basis(x, Q, args.get('r', 0.5), args.get('q'))
        self.q = k.shape[1]
        self.sweeps = int(args.get('spatial_sweeps') or 1)
        self.asis_sd, self.asis_steps = 1.0, 12
        w_flat, y_flat, vs, surveyed, obs = _pack(W, y, n)
        dev = ar.device
        self.X = ar.tensor(x)
        self.K = ar.tensor(k)
        self.Q_rsr = ar.tensor(q_rsr)
        self.KTK = ar.tensor(k.T @ k)
        self.KTX = ar.tensor(k.T @ x)
        self.XTX = ar.tensor(x.T @ x)
        self.Wf = ar.tensor(w_flat)
        self.positive_visit = torch.as_tensor(y_flat > 0.5, device=dev)
        self.vs = torch.as_tensor(vs, device=dev)
        self.surveyed = torch.as_tensor(surveyed, device=dev)
        self.obs = torch.as_tensor(obs, device=dev)
        self.qa = self.Wf.shape[1]
        self.tau_rate = 0.005
        self.tau_shape = 0.5 + 0.5 * self.q
        self.b_prec = torch.eye(p, dtype=ar.dtype, device=dev) / 10
        self.a_prec = torch.eye(self.qa, dtype=ar.dtype, device=dev) / 10
        self.omega_a_update = 2 + _SWEEP * self.sweeps
        self.alpha_update = self.omega_a_update + 1
        self.z_update = self.omega_a_update + 2

    # ---------------------------------------------------------------- #

    def state_from(self, states):
        """The reference's state from a carry's state dict (any device or
        float type)."""
        keep = ('z', 'tau', 'eta', 'spatial', 'alpha', 'beta', 'eps')
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
            'eps': tf.normal(tf.words(keys, 0, _INIT_EPS, 2 * self.n), dt),
        }

    def run_keys(self, seed, chains):
        return tf.chain_keys(seed, chains, tf.RUN, self.ar.device)

    # ---------------------------------------------------------------- #

    @staticmethod
    def _mvn(b, low, eps):
        """N(A^-1 b, A^-1) from standard normals ``eps``, A = L L'."""
        mean = torch.cholesky_solve(b[..., None], low)[..., 0]
        fluct = torch.linalg.solve_triangular(
            low.transpose(-1, -2), eps[..., None], upper=True)[..., 0]
        return mean + fluct

    def _quad(self, eta):
        """eta'Q_rsr eta per chain, at least 0."""
        return torch.clamp(torch.sum(eta * self.ar.mm(eta, self.Q_rsr),
                                     dim=-1), min=0.0)

    def _scale(self, s, gamma_draw, marginal):
        """The scale move: (u, beta, eta, K eta) times g, eps too unless
        ``marginal``; g^2 = 2 G / S."""
        xb = s['beta'] @ self.X.T
        quad = s['tau'] * self._quad(s['eta'])
        if marginal:
            r = s['u'] - xb - s['spatial']
            rss = 0.5 * torch.sum(r * r, dim=-1) + quad
        else:
            r = s['u'] - xb - s['spatial'] - s['eps']
            rss = torch.sum(r * r, dim=-1) + torch.sum(
                s['eps'] * s['eps'], dim=-1) + quad
        total = rss + torch.sum(s['beta'] * (s['beta'] @ self.b_prec.T),
                                dim=-1)
        g = torch.sqrt(2.0 * gamma_draw / total)[:, None]
        names = ('u', 'beta', 'eta', 'spatial') + (
            () if marginal else ('eps',))
        for name in names:
            s[name] = g * s[name]

    def _px_gamma(self, w, marginal):
        dim = self.n + self.p + self.q + (0 if marginal else self.n)
        return tf.gamma(0.5 * dim, w, self.ar.dtype)

    def _beta_eta(self, s, tau, eps_beta, eps_eta):
        """The collapsed draws of beta, then eta, from one factor of
        A = tau Q_rsr + K'K / 2."""
        ar = self.ar
        a_eta = tau[:, None, None] * self.Q_rsr + 0.5 * self.KTK
        low = torch.linalg.cholesky(a_eta)
        u = s['u']
        sol_x = torch.cholesky_solve(self.KTX.expand(
            low.shape[0], -1, -1), low)
        sol_u = torch.cholesky_solve(ar.mm(u, self.K)[..., None], low)[..., 0]
        a_beta = 0.5 * self.XTX + self.b_prec - 0.25 * ar.mm(
            self.KTX.T, sol_x)
        a_beta = 0.5 * (a_beta + a_beta.transpose(-1, -2))
        b_beta = 0.5 * ar.mm(u, self.X) - 0.25 * ar.mm(
            sol_u[:, None, :], self.KTX)[:, 0]
        beta = self._mvn(b_beta, torch.linalg.cholesky(a_beta), eps_beta)
        b_eta = 0.5 * ar.mm(u - beta @ self.X.T, self.K)
        eta = self._mvn(b_eta, low, eps_eta)
        return beta, eta

    def _asis(self, s, w):
        dt = self.ar.dtype
        steps = self.asis_steps
        normals = tf.normal(w[:, :2 * steps], dt) * self.asis_sd
        log_u = torch.log(tf.uniform(w[:, 2 * steps:], dt))
        tau = s['tau']
        spatial_a = torch.sqrt(tau)[:, None] * s['spatial']
        resid = s['u'] - s['beta'] @ self.X.T - s['eps']
        a_lin = torch.sum(resid * spatial_a, dim=-1)
        c_quad = 0.5 * torch.sum(spatial_a * spatial_a, dim=-1)
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

        root2 = math.sqrt(2.0)
        loc = s['beta'] @ self.X.T + s['spatial']
        s['u'] = root2 * truncnorm_sign(loc / root2, s['z'] > 0.5,
                                        tf.uniform(words(0, n), dt),
                                        self.clamp)
        self._scale(s, self._px_gamma(words(1, tf.GAMMA_WORDS), True),
                    marginal=True)
        for i in range(self.sweeps):
            base = 2 + _SWEEP * i
            g = tf.gamma(self.tau_shape, words(base + _TAU, tf.GAMMA_WORDS),
                         dt)
            tau = g / (0.5 * self._quad(s['eta']) + self.tau_rate)
            beta, eta = self._beta_eta(
                s, tau, tf.normal(words(base + _BETA, 2 * self.p), dt),
                tf.normal(words(base + _ETA, 2 * self.q), dt))
            spatial = ar.mm(eta, self.K.T)
            eps = 0.5 * (s['u'] - beta @ self.X.T - spatial) + tf.normal(
                words(base + _EPS, 2 * n), dt) / root2
            s.update(tau=tau, beta=beta, eta=eta, spatial=spatial, eps=eps)
            self._scale(s, self._px_gamma(
                words(base + _PX, tf.GAMMA_WORDS), False), marginal=False)
            self._asis(s, words(base + _ASIS, 3 * self.asis_steps))
        visits = self.Wf.shape[0]
        v = truncnorm_sign(s['alpha'] @ self.Wf.T, self.positive_visit,
                           tf.uniform(words(self.omega_a_update, visits),
                                      dt), self.clamp)
        wt = s['z'][:, self.vs]
        a = ar.mm(self.Wf.T, wt[..., None] * self.Wf) + self.a_prec
        b = ar.mm(wt * v, self.Wf)
        s['alpha'] = self._mvn(
            b, torch.linalg.cholesky(a),
            tf.normal(words(self.alpha_update, 2 * self.qa), dt))
        lin = s['beta'] @ self.X.T + s['spatial'] + s['eps']
        log_d = log_ndtr(-(s['alpha'] @ self.Wf.T))
        log_prod = torch.zeros_like(lin).index_add_(1, self.vs, log_d)
        p_occ = torch.sigmoid(log_ndtr(lin) + log_prod - log_ndtr(-lin))
        u = tf.uniform(words(self.z_update, n), dt)
        s['z'] = torch.where(self.obs, torch.ones((), dtype=dt,
                                                  device=ar.device),
                             (u < p_occ).to(dt))
        del s['u']
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
    with TF32 products) on ``device``, its quantile clamped where the
    configuration's float32 sampler clamps it."""
    ar = Arith(device, torch.float32 if control else torch.float64,
               tf32=control)
    return ProbitRSR(data, args, ar)
