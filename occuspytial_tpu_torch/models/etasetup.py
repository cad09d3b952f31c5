"""Shared host-side setup for the matrix-free eta solvers.

Port of the JAX package's ``models/etasetup.py``. The logit and probit
ICAR samplers solve the same family of systems ``(tau*Q + diag(omega)) x
= b`` for the spatial field (probit with omega = 1). Both large-n layouts,
the lattice stencil and the arbitrary-graph panels, are chosen and built
once on the host here, so each sampler's constructor and ``_configure``
stay a thin dispatch.
"""

import numpy as np
import torch

from ..ops import graph as graph_ops
from ..ops import stencil

#: from this site count a sparse Q selects the matrix-free graph path (a
#: dense eigendecomposition of Q stops being a sane default)
GRAPH_AUTO_THRESHOLD = 4096

#: the matrix-free regimes and the op module that serves each
OPS = {'stencil': stencil, 'graph': graph_ops}


def resolve_solver(solver, lattice, Q, n_sites, dense):
    """``(solver, lattice)`` as both ICAR samplers resolve them: a
    ``lattice`` (a :class:`~..ops.stencil.LatticeSpec` or its fields)
    selects ``'stencil'`` unless another solver is named; ``'stencil'``
    needs a lattice; with no solver named, a sparse Q from
    :data:`GRAPH_AUTO_THRESHOLD` sites selects ``'graph'``, else
    ``dense`` (the sampler's dense choice for this site count)."""
    if lattice is not None:
        if not isinstance(lattice, stencil.LatticeSpec):
            lattice = stencil.LatticeSpec(*lattice)
        if solver in (None, 'stencil'):
            solver = 'stencil'
    if solver == 'stencil' and lattice is None:
        raise ValueError("solver='stencil' requires the `lattice` argument")
    if solver is None:
        import scipy.sparse as sps

        solver = (
            'graph' if sps.issparse(Q) and n_sites >= GRAPH_AUTO_THRESHOLD
            else dense
        )
    return solver, lattice


def default_cg_iters(solver, graph_rank):
    """Default ``cg_iters`` (the JAX package's measured budgets): for the
    graph paired with the deflation rank, 7 from rank 512, 10 from 256,
    else 24; 15 otherwise (the stencil's: its DCT preconditioner is near
    exact; the dense solvers other than the logit 'cg' do not iterate)."""
    if solver != 'graph':
        return 15
    if graph_rank >= 512:
        return 7
    return 10 if graph_rank >= 256 else 24


def setup_stencil(lattice, Q, n):
    """Validate ``Q`` against the declared lattice; return the fixed
    arrays. The lattice is trusted only after a random matvec against Q
    (numpy, float64) matches the stencil's (float32, CPU tensors)."""
    import scipy.sparse as sps

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
