"""Gaussian draws parametrized by precision matrices, batched over chains.

Port of the JAX package's ``ops/mvnorm.py``: the kriging projection
``sum_to_zero``, the small-dimension ``precision_mvnorm`` (Cholesky
unrolled into elementwise ops for d <= 6, as there) and the exact
Cholesky draw of the constrained ICAR field ``constrained_icar_mvnorm``
(the ``solver='chol'`` regime), its closed-form unit-noise analog
``constrained_icar_mvnorm_unit`` (the probit ICAR field) and the reduced
basis draw ``rsr_mvnorm`` (the RSR field). Leading dimensions are the
chains.

Every function takes its standard normals as optional arguments, so a
test can feed both this port and the JAX package the same noise; when
they are omitted they come from ``torch.randn`` with ``generator``.
"""

import torch


def _normals(eps, shape, like, generator):
    if eps is not None:
        return eps
    return torch.randn(
        shape, dtype=like.dtype, device=like.device, generator=generator
    )


def cholesky_solve(rhs, chol):
    """Solve ``L L' X = rhs`` for the lower factor ``chol`` (..., d, d)
    and ``rhs`` (..., d, k) by two triangular solves. On CUDA,
    ``torch.cholesky_solve`` runs through MAGMA, whose calls synchronise
    the stream with the host; ``solve_triangular`` (cuBLAS) does not."""
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y,
                                         upper=True)


def sum_to_zero(x, z):
    """Kriging projection onto ``1'v = 0`` along the last axis: given
    ``x = Lambda^{-1} y`` and ``z = Lambda^{-1} 1``, ``x - z sum(x)/sum(z)``
    (reference distributions.pyx:24-39)."""
    return x - z * (
        torch.sum(x, dim=-1, keepdim=True) / torch.sum(z, dim=-1, keepdim=True)
    )


#: up to this dimension the Cholesky factor and solves are unrolled into
#: elementwise ops over the batch (the p ~ 3 regression blocks)
_UNROLL_DIM = 6


def _chol_unrolled(a, d):
    low = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            low[i][j] = torch.sqrt(s) if i == j else s / low[j][j]
    return low


def _fwd_unrolled(low, b, d):
    y = [None] * d
    for i in range(d):
        s = b[i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y[i] = s / low[i][i]
    return y


def _bwd_unrolled(low, y, d):
    x = [None] * d
    for i in reversed(range(d)):
        s = y[i]
        for k in range(i + 1, d):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return x


def precision_mvnorm(b, prec, eps=None, generator=None, chol=None):
    """Draw from N(Lambda^{-1} b, Lambda^{-1}) for ``b`` (..., d) and
    ``prec`` (..., d, d): mean by two triangular solves, fluctuation
    ``L'^{-1} eps`` (reference distributions.pyx:42-110). ``chol``, the
    lower Cholesky factor of ``prec`` when the caller already has it,
    skips the factorization."""
    eps = _normals(eps, b.shape, b, generator)
    d = b.shape[-1]
    if chol is None and d <= _UNROLL_DIM:
        low = _chol_unrolled(prec, d)
        cols = [b[..., i] for i in range(d)]
        noise = [eps[..., i] for i in range(d)]
        mean = _bwd_unrolled(low, _fwd_unrolled(low, cols, d), d)
        fluct = _bwd_unrolled(low, noise, d)
        return torch.stack([m + f for m, f in zip(mean, fluct)], dim=-1)
    if chol is None:
        chol = torch.linalg.cholesky_ex(prec).L
    mean = cholesky_solve(b[..., None], chol)[..., 0]
    fluct = torch.linalg.solve_triangular(
        chol.transpose(-1, -2), eps[..., None], upper=True
    )[..., 0]
    return mean + fluct


def lambda_cholesky_solve(rhs, omega, tau, q_dense):
    """Solve ``(tau*Q + diag(omega)) X = rhs`` exactly for stacked rows
    ``rhs`` (..., rows, n) by a batched Cholesky factorization."""
    t = torch.as_tensor(tau, dtype=omega.dtype, device=omega.device)
    lam = t[..., None, None] * q_dense + torch.diag_embed(omega)
    # cholesky_ex: no host-side error check (which would synchronise)
    chol = torch.linalg.cholesky_ex(lam).L
    return cholesky_solve(rhs.transpose(-1, -2), chol).transpose(-1, -2)


def constrained_icar_mvnorm(b, omega, tau, q_dense, sqrt_factor, eps1=None,
                            eps2=None, generator=None):
    """Draw eta ~ N(Lambda^{-1} b, Lambda^{-1}) restricted to 1'eta = 0,
    ``Lambda = tau*Q + diag(omega)`` (reference gibbs/logit.py:16-99):

    1. y = b + sqrt(omega) eps1 + sqrt(tau) B eps2, B B' = Q, so
       y ~ N(b, Lambda);
    2. solve Lambda [x, z] = [y, 1] with one Cholesky factorization;
    3. kriging-project: eta = x - z sum(x)/sum(z).
    """
    eps1 = _normals(eps1, b.shape, b, generator)
    eps2 = _normals(
        eps2, b.shape[:-1] + (sqrt_factor.shape[1],), b, generator
    )
    t = torch.as_tensor(tau, dtype=b.dtype, device=b.device)
    y = b + torch.sqrt(omega) * eps1 + torch.sqrt(t)[..., None] * (
        eps2 @ sqrt_factor.T
    )
    rhs = torch.stack([y, torch.ones_like(y)], dim=-2)
    sol = lambda_cholesky_solve(rhs, omega, tau, q_dense)
    return sum_to_zero(sol[..., 0, :], sol[..., 1, :])


def constrained_icar_mvnorm_unit(b, tau, eigvecs, eigvals, eps=None,
                                 generator=None):
    """The constrained draw for unit noise, ``Lambda = tau*Q + I`` (the
    probit ICAR eta conditional): Lambda is diagonal in Q's eigenbasis
    U, so with ``d = tau*s + 1``

        y' = U'b + sqrt(d) eps,  x = U (y' / d),  z = U (U'1 / d),

    then the kriging projection. ``b`` and ``eps`` (chains, n), ``tau``
    (chains,)."""
    eps = _normals(eps, b.shape, b, generator)
    t = torch.as_tensor(tau, dtype=b.dtype, device=b.device)
    d = t[..., None] * eigvals + 1.0
    y_spec = b @ eigvecs + torch.sqrt(d) * eps
    x = (y_spec / d) @ eigvecs.T
    ones_spec = torch.sum(eigvecs, dim=0)  # U'1
    z = (ones_spec / d) @ eigvecs.T
    return sum_to_zero(x, z)


def rsr_mvnorm(b, omega, tau, q_rsr, k_basis, sqrt_factor, eps1=None,
               eps2=None, generator=None):
    """Draw the RSR eta (chains, q) from N(Lambda^{-1} b, Lambda^{-1}),
    ``Lambda = tau*Q_rsr + K' diag(omega) K`` with K the (n, q) Moran
    basis and ``sqrt_factor`` E (q, q), E E' = Q_rsr (reference
    gibbs/logit.py:269-337):

        y = b + K'(sqrt(omega) eps1) + sqrt(tau) E eps2 ~ N(b, Lambda),

    then one batched Cholesky solve. ``eps1`` (chains, n), ``eps2``
    (chains, q). The K' diag(omega) K contraction is a float32 product
    (the port keeps TF32 off on the card)."""
    eps1 = _normals(eps1, omega.shape, b, generator)
    eps2 = _normals(eps2, b.shape, b, generator)
    t = torch.as_tensor(tau, dtype=b.dtype, device=b.device)
    y = (
        b + (torch.sqrt(omega) * eps1) @ k_basis
        + torch.sqrt(t)[..., None] * (eps2 @ sqrt_factor.T)
    )
    lam = t[..., None, None] * q_rsr + (
        k_basis.T * omega[..., None, :]
    ) @ k_basis
    chol = torch.linalg.cholesky_ex(lam).L
    return cholesky_solve(y[..., None], chol)[..., 0]
