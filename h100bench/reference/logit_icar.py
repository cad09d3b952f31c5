"""The logit ICAR Gibbs step (Polya-Gamma augmentation), in plain torch.

A plain rewrite of the documented sampler, for one configuration's
data and settings: the same draws from the same stream
(:mod:`.threefry`) and the same updates, each chain independent, in the
arithmetic of :class:`.operators.Arith`. One step:

1. omega ~ PG(1, [X beta + eta, W alpha]) over the sites' and the
   visits' lanes (update 0);
2. per sweep i (updates 1 + 5 i ...): tau | eta ~ Gamma(shape, 0.5
   eta'Q eta + rate); the collapsed beta / eta draw from one multi-row
   solve against tau Q + diag(omega) with rows [Omega X, k, 1, pert],
   pert = sqrt(omega) eps1 + sqrt(tau) B eps2; the ASIS random-walk MH
   move of log tau under the ancillary field;
3. alpha | z, omega_a, then z | rest from uniforms.

Priors: tau ~ Gamma(0.5 + 0.5 (n - 1), 0.005), alpha, beta ~ N(0, 10 I).
The initial state: z from the data, tau ~ Gamma(0.5) / 0.005, eta a
centred normal field, alpha and beta standard normals (updates 1-4 of
step 0 under the init keys).
"""

import numpy as np
import torch

from . import threefry as tf
from .operators import Arith, Dense, Stencil
from .polyagamma import pg_draw

_SWEEP = 5
_TAU, _BETA, _EPS1, _NOISE, _ASIS = range(5)


def _pack(W, y, n):
    """Visits flattened site by site in ascending site order."""
    sites = sorted(W)
    w_flat = np.concatenate([np.atleast_2d(W[s]) for s in sites])
    y_flat = np.concatenate([np.atleast_1d(y[s]) for s in sites])
    visit_site = np.concatenate(
        [np.full(len(np.atleast_1d(y[s])), s) for s in sites])
    surveyed = np.zeros(n, bool)
    surveyed[sites] = True
    obs = np.zeros(n, bool)
    for s in sites:
        obs[s] = np.asarray(y[s]).sum() > 0
    return w_flat, y_flat, visit_site.astype(np.int64), surveyed, obs


class LogitICAR:
    """The sampler of one dataset and one set of sampler arguments
    (those of the configuration and the cell: ``solver``, ``cg_iters``,
    ``spatial_sweeps``, ``lattice``; ASIS MH with sd 1.2
    over 12 sub-steps)."""

    def __init__(self, data, args, ar):
        Q, W, X, y = data['Q'], data['W'], data['X'], data['y']
        self.ar = ar
        n = np.asarray(X).shape[0]
        self.n = n
        solver = args.get('solver', 'cg')
        if args.get('lattice') is not None:
            solver = 'stencil'
        if solver == 'cg':
            self.ops = Dense(Q, args.get('cg_iters', 8), ar)
        elif solver == 'stencil':
            rows, cols, nb = args['lattice'][:3]
            self.ops = Stencil(Q, rows, cols, nb, args.get('cg_iters', 15),
                               ar)
        else:
            raise ValueError(f'no reference for solver {solver!r}')
        self.sweeps = int(args.get('spatial_sweeps') or
                          {'cg': 3}.get(solver, 1))
        self.asis_sd, self.asis_steps = 1.2, 12
        w_flat, y_flat, vs, surveyed, obs = _pack(W, y, n)
        self.X = ar.tensor(X)
        self.Wf = ar.tensor(w_flat)
        self.yf = ar.tensor(y_flat)
        self.vs = torch.as_tensor(vs, device=ar.device)
        self.surveyed = torch.as_tensor(surveyed, device=ar.device)
        self.obs = torch.as_tensor(obs, device=ar.device)
        self.p, self.qa = self.X.shape[1], self.Wf.shape[1]
        self.tau_rate = 0.005
        self.tau_shape = 0.5 + 0.5 * (n - 1)
        self.b_prec = torch.eye(self.p, dtype=ar.dtype,
                                device=ar.device) / 10
        self.a_prec = torch.eye(self.qa, dtype=ar.dtype,
                                device=ar.device) / 10
        self.alpha_update = 1 + _SWEEP * self.sweeps
        self.z_update = self.alpha_update + 1

    # ---------------------------------------------------------------- #

    def state_from(self, states):
        """The reference's state from a carry's state dict (any device or
        float type)."""
        keep = ('z', 'tau', 'eta', 'alpha', 'beta', 'eta_warm')
        return {k: states[k].to(self.ar.device).to(self.ar.dtype)
                for k in keep}

    def init_state(self, seed, chains):
        ar, dt = self.ar, self.ar.dtype
        keys = tf.chain_keys(seed, chains, tf.INIT, ar.device)
        z0 = torch.where(self.surveyed, self.obs.to(dt),
                         torch.ones((), dtype=dt, device=ar.device))
        tau = tf.gamma(0.5, tf.words(keys, 0, 1, tf.GAMMA_WORDS), dt) \
            / self.tau_rate
        eta = tf.normal(tf.words(keys, 0, 2, 2 * self.n), dt)
        return {
            'z': z0.expand(chains, self.n).clone(),
            'tau': tau,
            'eta': eta - eta.mean(dim=-1, keepdim=True),
            'alpha': tf.normal(tf.words(keys, 0, 3, 2 * self.qa), dt),
            'beta': tf.normal(tf.words(keys, 0, 4, 2 * self.p), dt),
            'eta_warm': torch.zeros((chains, self.p + 3, self.n), dtype=dt,
                                    device=ar.device),
        }

    def run_keys(self, seed, chains):
        return tf.chain_keys(seed, chains, tf.RUN, self.ar.device)

    # ---------------------------------------------------------------- #

    def _mvn(self, b, prec, eps):
        """N(prec^-1 b, prec^-1) from standard normals ``eps``."""
        low = torch.linalg.cholesky(prec)
        mean = torch.cholesky_solve(b[..., None], low)[..., 0]
        fluct = torch.linalg.solve_triangular(
            low.transpose(-1, -2), eps[..., None], upper=True)[..., 0]
        return mean + fluct

    def _beta_eta(self, s, omega, tau, eps_beta, eps1, eps2):
        ar, x, p = self.ar, self.X, self.p
        k = s['z'] - 0.5
        a_t = omega[:, None, :] * x.T
        pert = torch.sqrt(omega) * eps1 + torch.sqrt(tau)[:, None] * \
            self.ops.noise(eps2)
        rhs = torch.cat([a_t, k[:, None], torch.ones_like(k)[:, None],
                         pert[:, None]], dim=1)
        sol, warm = self.ops.solve(rhs, s['eta_warm'], omega, tau)
        g, gk, h, gp = sol[:, :p], sol[:, p], sol[:, p + 1], sol[:, p + 2]
        hsum = torch.sum(h, dim=-1, keepdim=True)
        ca = g - (torch.sum(g, dim=-1, keepdim=True) / hsum[:, None]) \
            * h[:, None, :]
        ck = gk - (torch.sum(gk, dim=-1, keepdim=True) / hsum) * h
        s_mat = (ar.mm(x.T * omega[:, None, :], x) + self.b_prec
                 - ar.mm(a_t, ca.transpose(-1, -2)))
        s_mat = 0.5 * (s_mat + s_mat.transpose(-1, -2))
        l_vec = ar.mm(k, x) - ar.mm(a_t, ck[:, :, None])[..., 0]
        beta = self._mvn(l_vec, s_mat, eps_beta)
        e = gk - torch.einsum('cp,cpn->cn', beta, g) + gp
        eta = e - h * (torch.sum(e, dim=-1, keepdim=True)
                       / torch.sum(h, dim=-1, keepdim=True))
        return beta, eta, warm

    def _asis(self, s, omega, w):
        dt = self.ar.dtype
        steps = self.asis_steps
        normals = tf.normal(w[:, :2 * steps], dt) * self.asis_sd
        log_u = torch.log(tf.uniform(w[:, 2 * steps:], dt))
        tau, eta = s['tau'], s['eta']
        sa = torch.sqrt(tau)[:, None] * eta
        xb = s['beta'] @ self.X.T
        a_lin = torch.sum((s['z'] - 0.5 - omega * xb) * sa, dim=-1)
        c_quad = 0.5 * torch.sum(omega * sa * sa, dim=-1)
        a0 = self.tau_shape - 0.5 * (self.n - 1)
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
        s['tau'] = new_t
        s['eta'] = sa * torch.rsqrt(new_t)[:, None]

    def step(self, s, keys, t):
        """One Gibbs step at step index ``t`` for every chain; returns
        the new state dict."""
        ar, dt, n = self.ar, self.ar.dtype, self.n
        s = dict(s)

        def words(update, count):
            return tf.words(keys, t, update, count)

        lin_b = s['beta'] @ self.X.T + s['eta']
        lin_a = s['alpha'] @ self.Wf.T
        omega = pg_draw(words(0, 2), torch.cat([lin_b, lin_a], dim=-1))
        omega_b, omega_a = omega[:, :n], omega[:, n:]
        for i in range(self.sweeps):
            base = 1 + _SWEEP * i
            g = tf.gamma(self.tau_shape, words(base + _TAU, tf.GAMMA_WORDS),
                         dt)
            quad = self.ops.quad(s['eta'])
            tau = g / (0.5 * torch.clamp(quad, min=0.0) + self.tau_rate)
            beta, eta, warm = self._beta_eta(
                s, omega_b, tau,
                tf.normal(words(base + _BETA, 2 * self.p), dt),
                tf.normal(words(base + _EPS1, 2 * n), dt),
                tf.normal(words(base + _NOISE, 2 * self.ops.noise_dim), dt),
            )
            s.update(tau=tau, eta=eta, beta=beta, eta_warm=warm)
            self._asis(s, omega_b, words(base + _ASIS, 3 * self.asis_steps))
        wt = s['z'][:, self.vs]
        a = ar.mm(self.Wf.T, (wt * omega_a)[..., None] * self.Wf) \
            + self.a_prec
        b = ar.mm(wt * (self.yf - 0.5), self.Wf)
        s['alpha'] = self._mvn(
            b, a, tf.normal(words(self.alpha_update, 2 * self.qa), dt))
        log_d = -torch.nn.functional.softplus(s['alpha'] @ self.Wf.T)
        log_prod = torch.zeros_like(s['eta']).index_add_(1, self.vs, log_d)
        p_occ = torch.sigmoid(s['beta'] @ self.X.T + s['eta'] + log_prod)
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
    with TF32 products) on ``device``."""
    ar = Arith(device, torch.float32 if control else torch.float64,
               tf32=control)
    return LogitICAR(data, args, ar)

