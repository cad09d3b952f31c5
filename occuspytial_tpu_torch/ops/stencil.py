"""Matrix-free lattice ICAR operators for large site counts.

Port of the JAX package's ``ops/stencil.py``. When the spatial graph is
a rectangular lattice (the construction of :func:`.icar.
lattice_precision`), everything the eta draw needs is expressed on the
(rows, cols) grid without a dense Q:

- ``matvec``: Q v = deg * v - rho * (sum of the neighbours) by shifted
  slice-adds, O(n) elementwise work, no product;
- ``noise``: an exact factor B with B B' = Q through the edge incidence
  decomposition Q = rho * sum_edges (e_i - e_j)(e_i - e_j)' + (1 - rho) D;
- ``precond_apply``: the solve with the lattice operator's Neumann symbol
  in the 2-D DCT-II basis, two (rows x rows) and two (cols x cols)
  products per application;
- ``cg_solve`` and ``constrained_mvnorm``: the warm-started PCG of
  :mod:`.cg` and the constrained draw on top of them. On the card a
  float32 solve of a lattice that fits one SM (:func:`takes_kernel`) is
  one launch of the CUDA kernel of :mod:`.cuda_stencil`.

The host-side setup (``degree_grid``, ``shift_matrix``, ``dct_basis``,
``symbol_grid``, ``setup``) is numpy and gives the JAX package's arrays.

Shapes: site vectors are (..., n) with n = rows * cols in row-major grid
order; the solves take rhs and x0 (chains, rows, n), omega (chains, n)
and tau (chains,). Noise enters as arguments: ``noise`` reads one flat
(..., noise_dim(spec)) block of standard normals, laid out as

    [(0, 1) edges: rows x (cols - 1)] [(1, 0): (rows - 1) x cols]
    queen only: [(1, 1): (rows - 1) x (cols - 1)] [(1, -1): same]
    rho < 1 only: [sites: rows x cols]

each block row-major on the grid, in the order the JAX ``noise`` draws
its per-direction keys.
"""

import dataclasses

import numpy as np
import torch

from . import cuda_stencil
from .cg import _batch, pcg
from .mvnorm import sum_to_zero
from .sites import LOCAL


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Static description of the lattice behind an ICAR precision."""

    rows: int
    cols: int
    max_neighbors: int = 8  # 4 = rook, 8 = queen
    rho: float = 1.0

    def __post_init__(self):
        if self.max_neighbors not in (4, 8):
            raise ValueError(
                'Maximum number of neighbors should be one of {4, 8}'
            )

    @property
    def n(self):
        """Total number of lattice sites."""
        return self.rows * self.cols


def _dirs(spec):
    """Edge directions (dr, dc) in the order the noise blocks are laid
    out: right, down, then the two diagonals for queen."""
    dirs = [(0, 1), (1, 0)]
    if spec.max_neighbors == 8:
        dirs += [(1, 1), (1, -1)]
    return dirs


def noise_dim(spec):
    """Standard normals one ``noise`` call reads: one per edge, plus one
    per site when rho < 1."""
    r, c = spec.rows, spec.cols
    edges = sum((r - dr) * (c - abs(dc)) for dr, dc in _dirs(spec))
    return edges + (spec.n if spec.rho < 1.0 else 0)


def degree_grid(spec):
    """Number of neighbors per cell, as an (rows, cols) numpy array."""
    r, c = spec.rows, spec.cols
    deg = np.zeros((r, c))
    deg[:, 1:] += 1
    deg[:, :-1] += 1
    deg[1:, :] += 1
    deg[:-1, :] += 1
    if spec.max_neighbors == 8:
        deg[1:, 1:] += 1
        deg[:-1, :-1] += 1
        deg[1:, :-1] += 1
        deg[:-1, 1:] += 1
    return deg


def matvec(spec, fixed, v):
    """Q v on flattened site vectors v (..., n); ``fixed['lat_deg']`` is
    the (rows, cols) degree grid.

    The neighbour sum is taken from the zero-padded grid as eight shifted
    slices, added in the order of the JAX package's slice-adds (left,
    right, up, down, then the diagonals): the same float32 sums, with
    no product, and a chain's result does not depend on the batch.
    """
    r, c = spec.rows, spec.cols
    g = v.reshape(v.shape[:-1] + (r, c))
    gp = torch.nn.functional.pad(g, (1, 1, 1, 1))
    acc = gp[..., 1:r + 1, 0:c] + gp[..., 1:r + 1, 2:c + 2]
    acc = acc + gp[..., 0:r, 1:c + 1]
    acc = acc + gp[..., 2:r + 2, 1:c + 1]
    if spec.max_neighbors == 8:
        acc = acc + gp[..., 0:r, 0:c]
        acc = acc + gp[..., 2:r + 2, 2:c + 2]
        acc = acc + gp[..., 0:r, 2:c + 2]
        acc = acc + gp[..., 2:r + 2, 0:c]
    out = fixed['lat_deg'] * g - spec.rho * acc
    return out.reshape(v.shape)


def quad_form(spec, fixed, v):
    """v' Q v over the last axis (the tau update)."""
    return torch.sum(v * matvec(spec, fixed, v), dim=-1)


def noise(spec, fixed, eps):
    """B eps with B B' = Q, exactly, from ``eps`` (..., noise_dim(spec))
    standard normals in the layout of the module docstring: each edge
    (i, j) adds sqrt(rho) eps_e to site i and subtracts it from site j;
    with rho < 1 each site adds sqrt((1 - rho) deg) eps_i."""
    r, c = spec.rows, spec.cols
    lead = eps.shape[:-1]
    out = eps.new_zeros(lead + (r, c))
    # sqrt of the float32 rho, as the JAX package rounds it
    sr = float(np.sqrt(np.asarray(spec.rho, np.float32)))
    off = 0
    for dr, dc in _dirs(spec):
        er, ec = r - dr, c - abs(dc)
        e = sr * eps[..., off:off + er * ec].reshape(lead + (er, ec))
        off += er * ec
        if dc >= 0:
            out[..., :er, :ec] += e
            out[..., dr:, dc:] -= e
        else:  # anti-diagonal: (i, j + 1) -> (i + 1, j)
            out[..., :er, -dc:] += e
            out[..., dr:, :ec] -= e
    if spec.rho < 1.0:
        eps_d = eps[..., off:off + spec.n].reshape(lead + (r, c))
        out = out + torch.sqrt((1.0 - spec.rho) * fixed['lat_deg']) * eps_d
    return out.reshape(lead + (spec.n,))


def shift_matrix(m, dtype=np.float32):
    """(m, m) tridiagonal 0/1 matrix: (S v)_i = v_{i-1} + v_{i+1}."""
    s = np.zeros((m, m), dtype)
    idx = np.arange(m - 1)
    s[idx, idx + 1] = 1.0
    s[idx + 1, idx] = 1.0
    return s


def dct_basis(m):
    """Orthonormal DCT-II basis matrix (m, m) and path-Laplacian symbol
    angles, as numpy (one-time setup)."""
    k = np.arange(m)[:, None]
    i = np.arange(m)[None, :]
    mat = np.cos(np.pi * k * (2 * i + 1) / (2 * m))
    mat *= np.sqrt(2.0 / m)
    mat[0] *= np.sqrt(0.5)
    theta = np.pi * np.arange(m) / m
    return mat, theta


def symbol_grid(spec):
    """Neumann symbol of the lattice operator on the DCT mode grid."""
    _, th = dct_basis(spec.rows)
    _, ph = dct_basis(spec.cols)
    ct = np.cos(th)[:, None]
    cp = np.cos(ph)[None, :]
    if spec.max_neighbors == 4:
        sym = 4.0 - spec.rho * 2.0 * (ct + cp)
    else:
        sym = 8.0 - spec.rho * 2.0 * (ct + cp + 2.0 * ct * cp)
    return np.maximum(sym, 0.0)


def setup(spec, dtype=np.float32):
    """One-time numpy setup bundle for the stencil solver (the JAX
    package's arrays; the shift matrices serve its product-form matvec
    and are kept for parity of the fixed arrays)."""
    deg = degree_grid(spec).astype(dtype)
    cr, _ = dct_basis(spec.rows)
    cc, _ = dct_basis(spec.cols)
    return {
        'lat_deg': deg,
        'lat_dct_r': cr.astype(dtype),
        'lat_dct_c': cc.astype(dtype),
        'lat_sym': symbol_grid(spec).astype(dtype),
        'lat_shift_r': shift_matrix(spec.rows, dtype),
        'lat_shift_c': shift_matrix(spec.cols, dtype),
    }


def noise_index(spec, row0, row1):
    """Indices in the ``noise`` layout of the standard normals that the
    sites of lattice rows [row0, row1) need: per direction every edge with
    its source row in [row0 - 1, row1 + 1) (the edges that touch the
    rows, from the row above included), then, with rho < 1, the rows' own
    site normals. In this order they are the layout of
    :func:`..parallel.sharded_stencil.band_noise`."""
    r, c = spec.rows, spec.cols
    a, b = max(row0 - 1, 0), min(row1 + 1, r)
    out, off = [], 0
    for dr, dc in _dirs(spec):
        ec = c - abs(dc)
        out.append(np.arange(off + a * ec, off + (b - dr) * ec))
        off += (r - dr) * ec
    if spec.rho < 1.0:
        out.append(np.arange(off + row0 * c, off + row1 * c))
    return np.concatenate(out).astype(np.int64)


def precond_apply(spec, fixed, tau, cbar, v, sites=LOCAL):
    """(tau * symbol + cbar)^{-1} v in the DCT basis; v is (..., n), tau
    and cbar broadcast against the (..., rows, cols) grid.

    A band of a 2-D run holds the columns of its rows in
    ``fixed['lat_dct_r']`` (rows, band rows) and its rows of ``v``: its
    product is its share of the coefficients, which ``sites.psum`` sums
    over the band's ranks (one all-reduce of the coefficient field per
    apply), and its output is its own rows. In one process this is the
    whole transform."""
    cr, cc = fixed['lat_dct_r'], fixed['lat_dct_c']
    g = v.reshape(v.shape[:-1] + (cr.shape[1], spec.cols))
    coef = sites.psum(torch.matmul(torch.matmul(cr, g), cc.T), 'dct')
    coef = coef / (tau * fixed['lat_sym'] + cbar)
    out = torch.matmul(torch.matmul(cr.T, coef), cc)
    return out.reshape(v.shape)


def takes_kernel(spec, device, dtype, band=None):
    """Whether :func:`cg_solve` runs as the CUDA kernel
    (:func:`.cuda_stencil.stencil_pcg_cuda`): float32 on a CUDA device,
    the whole field (no ``band``: a band's preconditioner sums over its
    ranks inside the apply) and a lattice within the kernel's on-chip
    budget (:func:`.cuda_stencil.fits`)."""
    return (torch.device(device).type == 'cuda' and dtype == torch.float32
            and band is None and cuda_stencil.fits(spec.rows, spec.cols))


def cg_solve(spec, fixed, rhs, x0, omega, tau, iters, return_resid=False,
             band=None):
    """Solve (tau*Q + diag(omega)) x = rhs matrix-free by DCT-
    preconditioned CG, ``iters`` iterations from ``x0``; rhs and x0 are
    (chains, rows, n), omega (chains, n), tau (chains,). With
    ``return_resid=True`` also returns the per-chain relative residual
    (:func:`.cg.pcg`). ``band``: the operators of a band of a 2-D run
    (:class:`..parallel.sharded_stencil.BandOps`), whose arrays are then
    the band's: the same algorithm, its site sums over the band's
    ranks. Where :func:`takes_kernel` holds, one launch of the CUDA
    kernel (:func:`.cuda_stencil.stencil_pcg_cuda`) does the work of
    :func:`cg_solve_plain`, which runs every other case."""
    if takes_kernel(spec, rhs.device, rhs.dtype, band):
        return cuda_stencil.stencil_pcg_cuda(
            spec, fixed, rhs, x0, omega, tau, iters,
            return_resid=return_resid,
        )
    return cg_solve_plain(spec, fixed, rhs, x0, omega, tau, iters,
                          return_resid=return_resid, band=band)


def cg_solve_plain(spec, fixed, rhs, x0, omega, tau, iters,
                   return_resid=False, band=None):
    """:func:`cg_solve` in torch ops: :func:`.cg.pcg` with
    :func:`matvec` and :func:`precond_apply`."""
    op, sites = (matvec, LOCAL) if band is None else (band.matvec,
                                                      band.sites)
    t, om = _batch(tau, omega)
    # tau and cbar against the (chains, rows, lattice rows, cols) grid
    t4 = t[..., None]
    cbar = (sites.sum(omega, dim=-1) / spec.n)[..., None, None, None]

    def mv(v):
        return t * op(spec, fixed, v) + om * v

    def pc(v):
        return precond_apply(spec, fixed, t4, cbar, v, sites)

    return pcg(mv, pc, rhs, x0, iters, return_resid=return_resid,
               sites=sites)


def constrained_mvnorm(spec, fixed, b, omega, tau, warm, iters, eps1, eps,
                       return_resid=False, band=None):
    """Constrained eta draw (1'eta = 0) for the lattice ICAR model: y =
    b + sqrt(omega) eps1 + sqrt(tau) B eps ~ N(b, Lambda), the solve of
    Lambda [x, h] = [y, 1] from ``warm`` (chains, 2, n), then the kriging
    projection. ``eps1`` (chains, n), ``eps`` (chains, noise_dim(spec)),
    or for a ``band`` (see :func:`cg_solve`) its sites' and its edges'
    normals. Returns ``(eta, new_warm)``, plus the per-chain relative
    residual when ``return_resid=True``."""
    field, sites = (noise, LOCAL) if band is None else (band.noise,
                                                        band.sites)
    t = torch.as_tensor(tau, dtype=b.dtype, device=b.device)
    y = b + torch.sqrt(omega) * eps1 + torch.sqrt(t)[..., None] * field(
        spec, fixed, eps
    )
    rhs = torch.stack([y, torch.ones_like(y)], dim=-2)
    out = cg_solve(spec, fixed, rhs, warm, omega, tau, iters,
                   return_resid=return_resid, band=band)
    sol = out[0] if return_resid else out
    eta = sum_to_zero(sol[..., 0, :], sol[..., 1, :], sites)
    return (eta, sol, out[1]) if return_resid else (eta, sol)
