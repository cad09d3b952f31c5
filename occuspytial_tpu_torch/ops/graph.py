"""Matrix-free ICAR operators for arbitrary sparse adjacency graphs.

Port of the JAX package's ``ops/graph.py``: the general-graph analog of
:mod:`.stencil`, on static-shape padded neighbour lists instead of a
sparse matrix type.

- ``build`` (host, numpy/scipy) flattens Q once into an ELL layout, per
  site neighbour index and weight panels (n, k_max), plus the edge list
  of the exact noise factor, a small deflation eigenbasis and, where the
  bandwidth allows, block-tridiagonal dense tiles in RCM (or natural)
  order. It also builds the per-site edge-incidence panel that ``noise``
  sums (below); the other arrays are the JAX package's (the deflation
  basis above 512 sites up to its Lanczos start, see ``_bottom_eigs``).
- ``matvec``: Q v = deg * v - sum_k w_k * v[nbr_k], one gather.
- ``noise``: exact B eps with B B' = Q through the weighted incidence
  factor Q = sum_e w_e (e_i - e_j)(e_i - e_j)' + diag(surplus). The JAX
  package scatter-adds over the edge list; on CUDA the scatter
  (``index_add_``) sums with atomics in an order that changes from run to
  run, so here each site gathers its own incident edges from a host-built
  (n, k_max) panel of edge indices and signed weights (padding at weight
  0) and sums them in a fixed order: one ``random_state``, one run.
- ``precond_apply``: deflated Jacobi, the bottom eigenbasis of Q solved
  exactly and Jacobi on its complement.
- ``banded_matvec``: Q in the permuted order as three batched float32
  products over the (nb, bs, bs) tiles (TF32 stays off, see
  :func:`.._device.resolve_device`: rounding Q's entries breaks the zero
  row sums the CG relies on).
- ``cg_solve``: in the banded layout the whole CG runs in the permuted,
  padded space (rhs, warm start and omega permuted once per solve);
  otherwise on the ELL gathers in the original order.

Shapes as in :mod:`.stencil`: site vectors (..., n); the solves take rhs
and x0 (chains, rows, n), omega (chains, n), tau (chains,). ``noise``
reads (..., noise_dim(spec)) standard normals: one per edge, in the order
of ``gr_esrc``/``gr_edst``, then one per site when the graph has a
surplus (a proper CAR).
"""

import dataclasses

import numpy as np
import torch

from .cg import _batch, _mm, pcg
from .mvnorm import sum_to_zero
from .sites import LOCAL

#: panel-size cap for the block-tridiagonal layout: 3 * nb * bs^2 * 4 B of
#: device memory for the tiles; past it the ELL gathers take over. The
#: JAX package's value, a TPU tuning kept here until it is re-measured on
#: the card: it decides the layout, not the answer
_BANDED_BYTES_CAP = 192 * 1024 * 1024

#: index arrays of the built graph, held as int64 on the device
INDEX_KEYS = ('gr_idx', 'gr_esrc', 'gr_edst', 'gr_perm', 'gr_iperm',
              'gr_inc_idx')


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static summary of a built graph; the arrays live in the sampler's
    ``fixed`` dict under ``gr_*`` keys."""

    n: int
    k_max: int
    n_edges: int
    has_surplus: bool
    deflate: int
    #: dense-tile size of the block-tridiagonal CG operator (0 = ELL
    #: gathers only: bandwidth too large for the panel cap)
    block: int = 0
    #: n padded up to a multiple of ``block`` (0 when block == 0)
    n_pad: int = 0


def noise_dim(spec):
    """Standard normals one ``noise`` call reads."""
    return spec.n_edges + (spec.n if spec.has_surplus else 0)


def build(Q, deflate=64, dtype=np.float32, block='auto'):
    """Flatten a precision matrix into static-shape graph panels.

    Returns ``(spec, arrays)`` with ``arrays`` mapping ``gr_*`` keys to
    numpy arrays. ``Q`` is any scipy.sparse matrix or a dense array; it
    must be symmetric with non-positive off-diagonal entries and no row
    whose off-diagonal mass exceeds its diagonal (an (I)CAR precision).
    ``deflate`` is the rank of the bottom-eigenbasis preconditioner block
    (0 disables; capped at n - 2). ``block``: ``'auto'`` takes the
    block-tridiagonal layout whenever the RCM (or natural) bandwidth fits
    the panel cap, ``0`` disables it, an int forces that tile size.
    """
    import scipy.sparse as sps

    q = Q.tocoo() if sps.issparse(Q) else sps.coo_matrix(np.asarray(Q))
    n = q.shape[0]
    if q.shape[0] != q.shape[1]:
        raise ValueError('Q must be square')

    off = q.row != q.col
    r, c, w = q.row[off], q.col[off], -q.data[off]
    keep = w != 0.0
    r, c, w = r[keep], c[keep], w[keep]
    if np.any(w < 0):
        raise ValueError(
            'Q must have non-positive off-diagonal entries '
            '(CAR/ICAR precision form)'
        )
    # matvec uses the rows as given, noise factors the upper triangle and
    # the banded layout mirrors the sub-diagonal: an asymmetric Q would
    # give three operators that disagree
    q_csr = q.tocsr()
    asym = abs(q_csr - q_csr.T)
    if asym.nnz and asym.max() > 1e-8 * max(1.0, abs(q_csr).max()):
        raise ValueError('Q must be symmetric')
    diag = np.zeros(n)
    np.add.at(diag, q.row[~off], q.data[~off])

    rowsum = np.zeros(n)
    np.add.at(rowsum, r, w)
    surplus = diag - rowsum
    tol = 1e-8 * max(1.0, float(np.abs(diag).max()))
    if np.any(surplus < -tol):
        raise ValueError(
            'Q has a row whose off-diagonal mass exceeds its diagonal; '
            'not a valid CAR/ICAR precision'
        )
    surplus = np.maximum(surplus, 0.0)
    has_surplus = bool(surplus.max() > tol)

    # ELL panels: per-row neighbour indices/weights, padded to the max
    # degree with self-indices at weight zero (gathers stay in bounds)
    deg_count = np.zeros(n, np.int64)
    np.add.at(deg_count, r, 1)
    k_max = max(int(deg_count.max()), 1)
    idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k_max))
    wgt = np.zeros((n, k_max), dtype)
    order = np.argsort(r, kind='stable')
    rs, cs, ws = r[order], c[order], w[order]
    if rs.size:
        row_start = np.r_[0, np.flatnonzero(rs[1:] != rs[:-1]) + 1]
        run_len = np.diff(np.r_[row_start, rs.size])
        pos = np.arange(rs.size) - np.repeat(row_start, run_len)
        idx[rs, pos] = cs.astype(np.int32)
        wgt[rs, pos] = ws.astype(dtype)

    # undirected edge list (each pair once) for the noise factor
    upper = r < c
    esrc = r[upper].astype(np.int32)
    edst = c[upper].astype(np.int32)
    ew = w[upper].astype(dtype)

    arrays = {
        'gr_idx': idx,
        'gr_w': wgt,
        'gr_deg': diag.astype(dtype),
        'gr_esrc': esrc,
        'gr_edst': edst,
        'gr_ew_sqrt': np.sqrt(ew).astype(dtype),
        'gr_surplus_sqrt': np.sqrt(surplus).astype(dtype),
    }
    arrays['gr_inc_idx'], arrays['gr_inc_w'] = incidence_panel(
        esrc, edst, arrays['gr_ew_sqrt'], n
    )

    m = int(min(max(deflate, 0), max(n - 2, 0)))
    if m > 0:
        vals, vecs = _bottom_eigs(q.tocsr(), m)
        arrays['gr_defl_vals'] = vals.astype(dtype)
        arrays['gr_defl_vecs'] = vecs.astype(dtype)

    bs, n_pad = _banded_panels(q.tocsr(), arrays, block, dtype)

    spec = GraphSpec(
        n=n, k_max=k_max, n_edges=int(esrc.size),
        has_surplus=has_surplus, deflate=m, block=bs, n_pad=n_pad,
    )
    return spec, arrays


def incidence_panel(esrc, edst, ew_sqrt, n):
    """Per-site incident edges: ``(inc_idx, inc_w)``, both (n, k) with k
    the largest site degree (at least 1). Row i lists the edges with i as
    source (weight +sqrt(w_e)), then those with i as destination
    (-sqrt(w_e)), each in edge order, the order of the JAX package's
    scatter; padding points at edge 0 with weight 0."""
    n_edges = esrc.size
    site = np.concatenate([esrc, edst]).astype(np.int64)
    edge = np.tile(np.arange(n_edges, dtype=np.int64), 2)
    sign = np.concatenate([np.ones(n_edges), -np.ones(n_edges)])
    order = np.argsort(site, kind='stable')
    site, edge, sign = site[order], edge[order], sign[order]
    count = np.bincount(site, minlength=n)
    k = max(int(count.max()) if n_edges else 0, 1)
    pos = np.arange(site.size) - np.repeat(np.cumsum(count) - count, count)
    inc_idx = np.zeros((n, k), np.int32)
    inc_w = np.zeros((n, k), ew_sqrt.dtype)
    inc_idx[site, pos] = edge
    inc_w[site, pos] = sign * ew_sqrt[edge]
    return inc_idx, inc_w


def _banded_panels(q_csr, arrays, block, dtype):
    """Attach the block-tridiagonal layout to ``arrays`` if viable.

    Orders the graph by reverse Cuthill-McKee or keeps the natural order,
    whichever has the smaller bandwidth; the tile size is the smallest
    multiple of 128 covering it, so every off-diagonal entry lands in the
    diagonal or the first sub-diagonal block row.
    """
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    if block == 0:
        return 0, 0
    n = q_csr.shape[0]

    def bandwidth(qm):
        qc = qm.tocoo()
        return int(np.abs(qc.row - qc.col).max()) if qc.nnz else 0

    perm = np.asarray(
        reverse_cuthill_mckee(q_csr, symmetric_mode=True), np.int64
    )
    q_rcm = q_csr[perm][:, perm]
    bw_nat, bw_rcm = bandwidth(q_csr), bandwidth(q_rcm)
    if bw_nat <= bw_rcm:
        perm, qp, bw = np.arange(n, dtype=np.int64), q_csr, bw_nat
    else:
        qp, bw = q_rcm, bw_rcm

    if block == 'auto':
        bs = 128 * max((bw + 127) // 128, 1)
        nb = -(-n // bs)
        if nb < 2 or 3 * nb * bs * bs * 4 > _BANDED_BYTES_CAP:
            return 0, 0
    else:
        bs = int(block)
        if bs % 128 or bs < bw:
            raise ValueError(
                f'block={bs} must be a multiple of 128 covering the '
                f'bandwidth ({bw})'
            )
        nb = -(-n // bs)
    n_pad = nb * bs

    diag_p = np.zeros((nb, bs, bs), dtype)
    sub_p = np.zeros((nb, bs, bs), dtype)
    qp = sps.csr_matrix(qp)
    for i in range(nb):
        r0, r1 = i * bs, min((i + 1) * bs, n)
        blk = qp[r0:r1, r0:r1].toarray()
        diag_p[i, : r1 - r0, : r1 - r0] = blk
        if i:
            c0 = (i - 1) * bs
            blk = qp[r0:r1, c0 : i * bs].toarray()
            sub_p[i, : r1 - r0, :] = blk

    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    # super-diagonal panels stored explicitly: sup_p[i] = sub_p[i + 1]'
    sup_p = np.roll(sub_p, -1, axis=0).transpose(0, 2, 1).copy()
    arrays['gr_bd_diag'] = diag_p
    arrays['gr_bd_sub'] = sub_p
    arrays['gr_bd_sup'] = sup_p
    arrays['gr_perm'] = perm.astype(np.int32)
    arrays['gr_iperm'] = iperm.astype(np.int32)
    # permuted and padded companions for the in-band preconditioner
    deg_p = np.ones(n_pad, dtype)
    deg_p[:n] = arrays['gr_deg'][perm]
    arrays['gr_deg_p'] = deg_p
    if 'gr_defl_vecs' in arrays:
        vecs_p = np.zeros((n_pad, arrays['gr_defl_vecs'].shape[1]), dtype)
        vecs_p[:n] = arrays['gr_defl_vecs'][perm]
        arrays['gr_defl_vecs_p'] = vecs_p
    return bs, n_pad


def _bottom_eigs(q_csr, m):
    """m smallest eigenpairs of the (PSD, possibly singular) precision:
    dense ``eigh`` up to 512 sites, else shift-invert Lanczos at a small
    negative shift (``Q + sigma I`` is positive definite even for the
    singular ICAR case).

    Lanczos starts from a fixed pseudo-random vector. The JAX package
    lets ARPACK draw its start, which changes from call to call within a
    process: two builds then span the same subspace with vectors that
    differ in sign and in the last bits, which float32 storage can turn
    into other draws. With a fixed start every build of one Q gives the
    same basis, so one ``random_state`` gives one run."""
    from scipy.sparse.linalg import eigsh

    n = q_csr.shape[0]
    if n <= 512:
        vals, vecs = np.linalg.eigh(q_csr.toarray())
        return vals[:m], vecs[:, :m]
    sigma = -1e-3 * max(1.0, float(q_csr.diagonal().max()))
    v0 = np.random.default_rng(0).standard_normal(n)
    vals, vecs = eigsh(q_csr, k=m, sigma=sigma, which='LM', v0=v0)
    order = np.argsort(vals)
    return np.maximum(vals[order], 0.0), vecs[:, order]


def matvec(spec, fixed, v):
    """Q v on (..., n) vectors: one gather and a padded-lane sum."""
    return ell_matvec(fixed, v, v)


def ell_matvec(fixed, v, full):
    """The rows of Q v that ``fixed`` holds: ``v`` (..., rows) is the
    vector at those rows and ``full`` (..., n) the whole vector, which
    ``gr_idx`` indexes. In one process both are the field's vector; a band
    of a 2-D run holds its rows of the panels and gathers ``full``."""
    nb = full[..., fixed['gr_idx']]  # (..., rows, k_max)
    return fixed['gr_deg'] * v - torch.sum(fixed['gr_w'] * nb, dim=-1)


def quad_form(spec, fixed, v):
    """v' Q v over the last axis (the tau update)."""
    return torch.sum(v * matvec(spec, fixed, v), dim=-1)


def noise(spec, fixed, eps):
    """Exact B eps with B B' = Q from ``eps`` (..., noise_dim(spec)): each
    site sums its incident edges' signed ``sqrt(w_e) eps_e`` over the
    incidence panel (fixed order, no atomics), plus ``sqrt(surplus) eps``
    per site when the graph has a surplus."""
    return incidence_noise(spec, fixed, eps, spec.n_edges)


def incidence_noise(spec, fixed, eps, n_edges):
    """The rows of B eps that ``fixed`` holds: ``eps`` (..., n_edges +
    rows if the graph has a surplus) holds the normals of the ``n_edges``
    edges that ``gr_inc_idx`` indexes, then one per row. In one process
    these are all the edges and sites; a band of a 2-D run holds its
    sites' incidence rows remapped to its edges (:func:`noise_index`)."""
    e = eps[..., :n_edges]
    out = torch.sum(fixed['gr_inc_w'] * e[..., fixed['gr_inc_idx']], dim=-1)
    if spec.has_surplus:
        rows = fixed['gr_inc_idx'].shape[0]
        out = out + fixed['gr_surplus_sqrt'] * eps[
            ..., n_edges:n_edges + rows
        ]
    return out


def noise_index(spec, arrays, site0, site1):
    """The edges that the sites [site0, site1) need for their rows of
    ``noise`` (host side, numpy): ``(edges, inc_idx, inc_w)``, the sorted
    ids of the edges incident to the sites and the sites' rows of the
    incidence panel (``arrays['gr_inc_idx']``, ``'gr_inc_w'``) with each
    edge id replaced by its position in ``edges`` (padding at position 0,
    weight 0). Each site sums the same terms in the same order as in the
    whole field's panel."""
    inc_idx = np.asarray(arrays['gr_inc_idx'])[site0:site1]
    inc_w = np.asarray(arrays['gr_inc_w'])[site0:site1]
    real = inc_w != 0
    edges = np.unique(inc_idx[real]).astype(np.int64)
    local = np.where(real, np.searchsorted(edges, inc_idx), 0)
    return edges, local.astype(inc_idx.dtype), inc_w.copy()


def banded_matvec(spec, fixed, v):
    """Q_perm v through the block-tridiagonal tiles; ``v`` is (...,
    n_pad) in the permuted order. Three batched float32 products (one
    per tile row: diagonal, sub- and super-diagonal) over all leading
    rows at once, with the off-diagonal terms as block shifts."""
    nb, bs = spec.n_pad // spec.block, spec.block
    lead = v.shape[:-1]
    # (nb, rows, bs): tile-major, so each tile multiplies all rows at once
    vb = v.reshape(-1, nb, bs).transpose(0, 1)
    y = torch.matmul(vb, fixed['gr_bd_diag'].transpose(-1, -2))
    sub = torch.matmul(vb[:-1], fixed['gr_bd_sub'][1:].transpose(-1, -2))
    sup = torch.matmul(vb[1:], fixed['gr_bd_sup'][:-1].transpose(-1, -2))
    y = y + torch.nn.functional.pad(sub, (0, 0, 0, 0, 1, 0)) \
        + torch.nn.functional.pad(sup, (0, 0, 0, 0, 0, 1))
    return y.transpose(0, 1).reshape(lead + (spec.n_pad,))


def _deflated_jacobi(jac, u, s, tau, cbar, r, sites=LOCAL):
    """Deflated-Jacobi apply (SPD by construction): exact spectral
    treatment 1/(tau*s_i + cbar) on the bottom eigenbasis U, symmetric
    Jacobi on its complement,

        M^{-1} = U D_s^{-1} U' + (I - UU') D_j (I - UU').

    The products with U fold every chain's rows into one matrix; ``u`` may
    be stored in another dtype (``eig_dtype``). The two thin products
    ``r U`` and ``w U`` contract over the sites, through ``sites`` (a band
    of a 2-D run holds its rows of U and sums them over its ranks)."""
    ru = sites.psum(_mm(r, u))
    r_perp = r - _mm(ru, u.T)
    w = r_perp * jac
    w_perp = w - _mm(sites.psum(_mm(w, u)), u.T)
    return w_perp + _mm(ru / (tau * s + cbar), u.T)


def _cbar(spec, omega, sites):
    """The mean of omega over the field's sites, as ``sum / n`` (a band
    sums its sites over its ranks), so one rank gives one process's
    bits."""
    return sites.sum(omega, dim=-1, keepdim=True) / spec.n


def precond_apply(spec, fixed, tau, omega, r, band=None):
    """Deflated-Jacobi preconditioner in the original (ELL) order; tau
    and omega broadcast against ``r``. ``band``: the operators of a band
    of a 2-D run (:class:`..parallel.sharded_graph.GraphBandOps`), whose
    arrays are then the band's rows and whose site sums run over its
    ranks."""
    sites = LOCAL if band is None else band.sites
    jac = 1.0 / (tau * fixed['gr_deg'] + omega)
    if spec.deflate == 0:
        return r * jac
    return _deflated_jacobi(
        jac, fixed['gr_defl_vecs'], fixed['gr_defl_vals'], tau,
        _cbar(spec, omega, sites), r, sites,
    )


class _FieldMoves:
    """The banded layout's moves in one process, with the names of a
    band's (:class:`..parallel.sharded_graph.GraphBandOps`): into the
    permuted order, zero on the padded tail of ``tail`` lanes, and back."""

    def __init__(self, spec):
        self.tail = spec.n_pad - spec.n

    def to_run(self, x, fixed):
        return torch.nn.functional.pad(x[..., fixed['gr_perm']],
                                       (0, self.tail))

    def from_run(self, x, fixed):
        return x[..., fixed['gr_iperm']]

    def banded_matvec(self, spec, fixed, v):
        return banded_matvec(spec, fixed, v)


def cg_solve(spec, fixed, rhs, x0, omega, tau, iters, return_resid=False,
             band=None):
    """Solve (tau*Q + diag(omega)) x = rhs matrix-free, ``iters``
    iterations from ``x0``; rhs and x0 (chains, rows, n), omega (chains,
    n), tau (chains,). With ``return_resid=True`` also returns the
    per-chain relative residual (:func:`.cg.pcg`).

    With a banded layout (``spec.block > 0``) the CG runs in the permuted
    space on the tiles: rhs, warm start and omega are permuted together
    once per solve and padded (omega with 1, which keeps the padded
    subsystem SPD with solution zero).

    ``band``: the operators of a band of a 2-D run
    (:class:`..parallel.sharded_graph.GraphBandOps`), whose arrays are
    then the band's: its sites' ELL rows, or its run of the permuted
    blocks. The same algorithm, its site sums over the band's ranks; the
    band's moves carry its sites to and from its block run."""
    sites = LOCAL if band is None else band.sites
    t, om = _batch(tau, omega)
    if not spec.block:
        op = matvec if band is None else band.matvec

        def mv(v):
            return t * op(spec, fixed, v) + om * v

        def pc(v):
            return precond_apply(spec, fixed, t, om, v, band)

        return pcg(mv, pc, rhs, x0, iters, return_resid=return_resid,
                   sites=sites)

    moves = _FieldMoves(spec) if band is None else band
    k, tail = rhs.shape[-2], moves.tail
    moved = moves.to_run(torch.cat(
        [rhs, x0, om.expand(rhs.shape[:-2] + (1, om.shape[-1]))], dim=-2),
        fixed)
    real = moved.shape[-1] - tail
    omega_p = torch.nn.functional.pad(moved[..., 2 * k:, :real], (0, tail),
                                      value=1.0)
    jac = 1.0 / (t * fixed['gr_deg_p'] + omega_p)

    def mv(v):
        return t * moves.banded_matvec(spec, fixed, v) + omega_p * v

    if spec.deflate:
        u, s = fixed['gr_defl_vecs_p'], fixed['gr_defl_vals']
        cbar = _cbar(spec, omega, sites)[..., None]

        def pc(r):
            return _deflated_jacobi(jac, u, s, t, cbar, r, sites)
    else:
        def pc(r):
            return r * jac

    out = pcg(mv, pc, moved[..., :k, :], moved[..., k:2 * k, :], iters,
              return_resid=return_resid, sites=sites)
    if return_resid:
        return moves.from_run(out[0], fixed), out[1]
    return moves.from_run(out, fixed)


def constrained_mvnorm(spec, fixed, b, omega, tau, warm, iters, eps1, eps,
                       return_resid=False, band=None):
    """Constrained eta draw (1'eta = 0) on an arbitrary graph: the
    perturbed right-hand side from ``eps1`` (chains, n) and ``eps``
    (chains, noise_dim(spec)), the solve of Lambda [x, h] = [y, 1] from
    ``warm`` (chains, 2, n), then the kriging projection. Returns ``(eta,
    new_warm)``, plus the per-chain relative residual when
    ``return_resid=True``. ``band`` (see :func:`cg_solve`): ``eps1`` is
    then its sites' normals and ``eps`` its edges' and sites' (the layout
    of its ``noise``)."""
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
