"""ICAR precision-matrix construction and one-time spectral setup.

Host-side numpy/scipy helpers that run once at sampler construction
(the same arithmetic as the JAX package's ``ops/icar.py``, so a given Q
yields bit-identical arrays):

- ``lattice_precision``: Q = diag(rowsum(A)) - rho * A over a rook or
  queen lattice adjacency (reference utils.py:38-103 without libpysal).
- ``icar_spectral`` / ``icar_sqrt_factor``: Q = U S U' and the eigenfactor
  B = U[:, 1:] * sqrt(s[1:]) with B B' = Q (reference gibbs/logit.py:64-67).
- ``psd_sqrt_factor``: the nonsingular analog (reference
  gibbs/logit.py:317-320).
- ``verify_spatial_precision``: the singularity check of reference
  gibbs/base.py:166-170.
- ``moran_basis``: the Reduced Spatial Regression basis (reference
  gibbs/logit.py:415-447), dense ``eigh`` or, for a sparse Q from
  :data:`_MORAN_LANCZOS_THRESHOLD` sites, matrix-free Lanczos.
"""

import numpy as np
import scipy.sparse as sps
from scipy.sparse.linalg import LinearOperator, eigsh


def lattice_precision(lat_row, lat_col, max_neighbors=8, rho=1.0):
    """Spatial precision matrix of a rectangular lattice, as scipy COO.

    ``max_neighbors=4`` uses the rook criterion, ``8`` the queen
    criterion. ``rho=1`` gives the singular intrinsic autoregressive
    precision.
    """
    if max_neighbors == 8:
        offsets = [(-1, -1), (-1, 0), (-1, 1), (0, -1)]
    elif max_neighbors == 4:
        offsets = [(-1, 0), (0, -1)]
    else:
        raise ValueError(
            'Maximum number of neighbors should be one of {4, 8}'
        )

    rows_idx, cols_idx = [], []
    grid = np.arange(lat_row * lat_col).reshape(lat_row, lat_col)
    for dr, dc in offsets:
        r0 = max(0, -dr)
        r1 = lat_row - max(0, dr)
        c0 = max(0, -dc)
        c1 = lat_col - max(0, dc)
        rows_idx.append(grid[r0:r1, c0:c1].ravel())
        cols_idx.append(grid[r0 + dr:r1 + dr, c0 + dc:c1 + dc].ravel())
    i = np.concatenate(rows_idx)
    j = np.concatenate(cols_idx)
    data = np.ones(i.size * 2, dtype=np.int64)
    adj = sps.coo_matrix(
        (data, (np.concatenate([i, j]), np.concatenate([j, i]))),
        shape=(lat_row * lat_col, lat_row * lat_col),
    ).tocsr()
    deg = np.asarray(adj.sum(axis=1)).ravel()
    q = sps.diags(deg, dtype=adj.dtype) - rho * adj
    return q.tocoo()


def to_dense(q):
    """Dense float64 view of a sparse-or-dense precision matrix."""
    if sps.issparse(q):
        return np.asarray(q.todense(), dtype=np.float64)
    return np.asarray(q, dtype=np.float64)


def verify_spatial_precision(q):
    """Raise unless Q is singular (an ICAR precision must be)."""
    qc = sps.csc_matrix(q) if not sps.issparse(q) else q.tocsc()
    eig = eigsh(
        qc.astype(np.float64), k=1, which='SA',
        return_eigenvectors=False, sigma=0.001,
    )
    if eig[0] >= 1e-4:
        raise ValueError('Spatial precision matrix Q must be singular.')


def icar_spectral(q_dense):
    """``(eigvals, eigvecs, sqrt_factor)`` of the singular ICAR precision:
    eigenvalues clipped nonnegative, ``sqrt_factor = U[:, 1:] *
    sqrt(s[1:])`` without the (theoretically zero) smallest one."""
    s, u = np.linalg.eigh(q_dense)
    s = np.clip(s, 0.0, None)
    return s, u, u[:, 1:] * np.sqrt(s[1:])


def icar_sqrt_factor(q_dense):
    """Eigenfactor B (n, n-1) with B B' = Q for the singular ICAR precision."""
    return icar_spectral(q_dense)[2]


def psd_sqrt_factor(q_dense):
    """Eigenfactor E with E E' = Q for a (nonsingular) PSD precision."""
    s, u = np.linalg.eigh(q_dense)
    s = np.clip(s, 0.0, None)
    return u * np.sqrt(s)


#: from this size a sparse Q routes the Moran eigenbasis through
#: matrix-free Lanczos instead of a dense O(n^3) ``eigh``
_MORAN_LANCZOS_THRESHOLD = 2048


def moran_basis(x, q, r=0.5, num_eigs=None):
    """Moran-operator eigenbasis for Reduced Spatial Regression.

    Builds P = I - X (X'X)^{-1} X', the Moran operator M = n * P' A P /
    sum(A) with A = -offdiag(Q), and keeps the top ``num_eigs``
    eigenvectors of M (or those with eigenvalue >= ``r`` when
    ``num_eigs`` is None). Returns ``(K, q_rsr)``: K is (n, q) and
    q_rsr = K' Q K.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if num_eigs is None and not 0 <= r <= 1:
        raise ValueError('Threshold value needs to be in [0, 1]')
    xtx_inv_xt = np.linalg.solve(x.T @ x, x.T)

    if sps.issparse(q) and n >= _MORAN_LANCZOS_THRESHOLD:
        return _moran_basis_lanczos(x, q.tocsr(), r, num_eigs, xtx_inv_xt)

    p = -(x @ xtx_inv_xt)
    p[np.diag_indices_from(p)] += 1.0

    q_dense = to_dense(q)
    a = -q_dense.copy()
    np.fill_diagonal(a, 0.0)
    moran = n * (p.T @ a @ p) / a.sum()

    w, v = np.linalg.eigh(moran)
    if num_eigs:
        q_dim = int(num_eigs)
    else:
        q_dim = int((w >= r).sum())
        if not q_dim:
            raise ValueError(
                'The Moran Operator Matrix of the data has no positive '
                'eigenvalues. Set threshold to a lower value'
            )
    k = v[:, -q_dim:]
    q_rsr = k.T @ q_dense @ k
    return k, q_rsr


def _moran_basis_lanczos(x, q_csr, r, num_eigs, xtx_inv_xt):
    """Matrix-free top-q Moran eigenbasis (sparse Q, large n): the
    operator's matvec is ``c * P(A(P v))`` and the top eigenpairs come
    from ``eigsh(which='LA')``. In threshold mode (``num_eigs=None``) the
    block doubles until the smallest retrieved eigenvalue falls below
    ``r``, capped at n/4."""
    n = x.shape[0]
    a = -(q_csr - sps.diags(q_csr.diagonal())).tocsr()
    scale = n / a.sum()

    def pmat(v):
        return v - x @ (xtx_inv_xt @ v)

    op = LinearOperator(
        (n, n), matvec=lambda v: scale * pmat(a @ pmat(v)),
        dtype=np.float64,
    )

    if num_eigs:
        w, v = eigsh(op, k=int(num_eigs), which='LA')
        order = np.argsort(w)
        w, v = w[order], v[:, order]
    else:
        k_try = 64
        while True:
            k_try = min(k_try, n - 2)
            w, v = eigsh(op, k=k_try, which='LA')
            order = np.argsort(w)
            w, v = w[order], v[:, order]
            if w[0] < r or k_try >= max(n // 4, 64):
                break
            k_try *= 2
        keep = w >= r
        if not keep.any():
            raise ValueError(
                'The Moran Operator Matrix of the data has no positive '
                'eigenvalues. Set threshold to a lower value'
            )
        w, v = w[keep], v[:, keep]
    q_rsr = v.T @ (q_csr @ v)
    # the Lanczos basis is orthonormal to rounding only: symmetrize
    return v, 0.5 * (q_rsr + q_rsr.T)
