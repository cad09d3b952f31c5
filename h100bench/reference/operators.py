"""The spatial operators of the eta regimes, worked out from Q.

Each regime gives, for the ICAR precision Q of the data:

- ``quad(eta)``: eta' Q eta per chain;
- ``noise(eps)``: B eps with B B' = Q, for the regime's documented
  layout of the standard normals ``eps`` (``noise_dim`` of them);
- ``solve(rhs, warm, omega, tau)``: the regime's fixed-iteration
  preconditioned CG on (tau Q + diag(omega)) x = rhs from the warm start
  ``warm``, returning (x, the next warm start).

They are built from Q alone, with numpy and scipy on the host, and run
in the arithmetic of :class:`Arith`: float64 for the reference; float32
with TF32 products for the precision control.
"""

import math

import numpy as np
import scipy.sparse as sps
import torch


class Arith:
    """Where and how the reference computes. ``dtype`` is float64 for
    the reference. ``tf32`` rounds both operands of every dense matrix
    product to TF32 (10 mantissa bits) and multiplies in float32: the
    card's TF32 tensor-core product, the control one rung below the
    float32 the configuration states."""

    def __init__(self, device, dtype=torch.float64, tf32=False):
        self.device = torch.device(device)
        self.dtype = dtype
        self.tf32 = tf32

    def tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device).to(
            self.dtype)

    def round(self, x):
        if not self.tf32:
            return x
        bits = x.to(torch.float32).contiguous().view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)

    def mm(self, a, b):
        """``a @ b`` as a dense product of the configured precision."""
        if not self.tf32:
            return a @ b
        return (self.round(a) @ self.round(b)).to(self.dtype)


def pcg(matvec, precond, b, x0, iters):
    """Exactly ``iters`` preconditioned CG iterations on each row of
    ``b`` (..., rows, n), denominators clamped at 1e-30."""
    tiny = 1e-30

    def dot(u, v):
        return torch.sum(u * v, dim=-1, keepdim=True)

    r = b - matvec(x0)
    z = precond(r)
    p, rz, x = z, dot(r, z), x0
    for _ in range(int(iters)):
        ap = matvec(p)
        alpha = rz / torch.clamp(dot(p, ap), min=tiny)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = dot(r, z)
        p = z + (rz_new / torch.clamp(rz, min=tiny)) * p
        rz = rz_new
    return x


def _dense_q(q):
    return np.asarray(q.todense() if sps.issparse(q) else q, np.float64)


class Dense:
    """The dense eigenbasis regime (``solver='cg'``): Q = U S U' by
    ``numpy.linalg.eigh`` of the dense float64 Q (eigenvalues clipped at
    0), B = U[:, 1:] sqrt(S[1:]) over n - 1 normals, and the PCG in the
    eigenbasis with the diagonal preconditioner 1 / (tau S + mean
    omega); the warm start is the previous solution's eigen
    coefficients."""

    def __init__(self, q, iters, ar):
        qd = _dense_q(q)
        s, u = np.linalg.eigh(qd)
        s = np.clip(s, 0.0, None)
        self.ar, self.iters = ar, int(iters)
        self.n = qd.shape[0]
        self.noise_dim = self.n - 1
        self.q = ar.tensor(qd)
        self.s = ar.tensor(s)
        self.u = ar.tensor(u)
        self.bt = ar.tensor((u[:, 1:] * np.sqrt(s[1:])).T)

    def quad(self, eta):
        return torch.sum(eta * self.ar.mm(eta, self.q), dim=-1)

    def noise(self, eps):
        return self.ar.mm(eps, self.bt)

    def solve(self, rhs, warm, omega, tau):
        ar, u = self.ar, self.u
        t = tau[:, None, None]
        om = omega[:, None, :]
        tau_s = t * self.s
        dinv = 1.0 / (tau_s + torch.mean(omega, dim=-1)[:, None, None])

        def matvec(v):
            return tau_s * v + ar.mm(om * ar.mm(v, u.T), u)

        x = pcg(matvec, lambda r: dinv * r, ar.mm(rhs, u), warm, self.iters)
        return ar.mm(x, u.T), x


class _SiteBasis:
    """A regime whose PCG runs in the site basis with the sparse Q."""

    def _sparse(self, q):
        q = sps.csr_matrix(q, dtype=np.float64)
        coo = q.tocoo()
        idx = np.vstack([coo.row, coo.col])
        return torch.sparse_coo_tensor(
            torch.as_tensor(idx), torch.as_tensor(coo.data), q.shape,
            check_invariants=True,
        ).coalesce().to(self.ar.device).to(self.ar.dtype)

    def qv(self, v):
        """Q v for v (..., n), a sparse product in the arithmetic's
        float type (the program's matvec is elementwise)."""
        flat = v.reshape(-1, v.shape[-1])
        return torch.sparse.mm(self.qs, flat.T).T.reshape(v.shape)

    def quad(self, eta):
        return torch.sum(eta * self.qv(eta), dim=-1)

    def noise(self, eps):
        return torch.sparse.mm(self.inc, eps.T).T

    def _incidence(self, src, dst, w_sqrt, n):
        m = len(src)
        rows = np.concatenate([src, dst])
        cols = np.concatenate([np.arange(m), np.arange(m)])
        vals = np.concatenate([w_sqrt, -w_sqrt])
        self.noise_dim = m
        return torch.sparse_coo_tensor(
            torch.as_tensor(np.vstack([rows, cols]).astype(np.int64)),
            torch.as_tensor(vals.astype(np.float64)), (n, m),
            check_invariants=True,
        ).coalesce().to(self.ar.device).to(self.ar.dtype)

    def solve(self, rhs, warm, omega, tau):
        t = tau[:, None, None]
        om = omega[:, None, :]

        def matvec(v):
            return t * self.qv(v) + om * v

        x = pcg(matvec, lambda r: self.precond(r, omega, tau), rhs, warm,
                self.iters)
        return x, x


class Stencil(_SiteBasis):
    """The lattice regime (``solver='stencil'``), rook or queen, rho = 1:
    B is the edge incidence with the normals laid out direction by
    direction, (0, 1), (1, 0), then for the queen (1, 1) and (1, -1),
    each over its edges' source cells row-major; the preconditioner is
    (tau * symbol + mean omega)^-1 in the orthonormal 2-D DCT-II basis,
    the symbol being the Neumann symbol of the lattice operator."""

    def __init__(self, q, rows, cols, neighbors, iters, ar):
        self.ar, self.iters = ar, int(iters)
        self.rows, self.cols = rows, cols
        n = rows * cols
        self.qs = self._sparse(q)
        grid = np.arange(n).reshape(rows, cols)
        dirs = [(0, 1), (1, 0)] + ([(1, 1), (1, -1)] if neighbors == 8
                                   else [])
        src, dst = [], []
        for dr, dc in dirs:
            er, ec = rows - dr, cols - abs(dc)
            if dc >= 0:
                src.append(grid[:er, :ec].ravel())
                dst.append(grid[dr:, dc:].ravel())
            else:
                src.append(grid[:er, -dc:].ravel())
                dst.append(grid[dr:, :ec].ravel())
        src, dst = np.concatenate(src), np.concatenate(dst)
        self.inc = self._incidence(src, dst, np.ones(len(src)), n)
        self.cr = ar.tensor(self._dct(rows))
        self.cc = ar.tensor(self._dct(cols))
        ct = np.cos(np.pi * np.arange(rows) / rows)[:, None]
        cp = np.cos(np.pi * np.arange(cols) / cols)[None, :]
        sym = (4.0 - 2.0 * (ct + cp) if neighbors == 4
               else 8.0 - 2.0 * (ct + cp + 2.0 * ct * cp))
        self.sym = ar.tensor(np.maximum(sym, 0.0))

    @staticmethod
    def _dct(m):
        k = np.arange(m)[:, None]
        i = np.arange(m)[None, :]
        mat = np.cos(np.pi * k * (2 * i + 1) / (2 * m)) * math.sqrt(2.0 / m)
        mat[0] *= math.sqrt(0.5)
        return mat

    def precond(self, r, omega, tau):
        ar = self.ar
        g = r.reshape(r.shape[:-1] + (self.rows, self.cols))
        coef = ar.mm(ar.mm(self.cr, g), self.cc.T)
        cbar = (torch.sum(omega, dim=-1) / omega.shape[-1])
        coef = coef / (tau[:, None, None, None] * self.sym
                       + cbar[:, None, None, None])
        return ar.mm(ar.mm(self.cr.T, coef), self.cc).reshape(r.shape)
