"""Batched preconditioned conjugate gradients for the eta draw.

Port of the JAX package's ``ops/cg.py`` (its ``cg_impl='xla'`` path):
``(tau*Q + diag(omega)) x = rhs`` for stacked right-hand sides, with the
spectral preconditioner ``tau*Q + mean(omega) I`` that the one-time
eigendecomposition ``Q = U S U'`` applies exactly. The eigenbasis variant
:func:`icar_cg_solve_spectral` runs the iteration in Q's eigenbasis, where
the preconditioner is diagonal and each operator application costs two
matrix products. It is the sampler's default solve and the plain version
of the CUDA kernel in :mod:`.cuda_cg`.

Shapes: right-hand sides are (..., rows, n) with any leading batch (the
chains); ``omega`` is (..., n) and ``tau`` has the batch shape. A fixed
iteration count keeps the work per step fixed; residuals are reported,
not acted on.
"""

import torch

from .sites import LOCAL


def pcg(matvec, precond, b, x0, iters, return_resid=False, sites=LOCAL):
    """Preconditioned CG on each row of ``b`` (..., rows, n), exactly
    ``iters`` iterations, with denominators clamped at 1e-30 so converged
    rows stay frozen. With ``return_resid=True`` also returns
    ``max_rows ||r_k|| / ||b||`` per batch element. Inner products and
    norms are sums over the last axis through ``sites`` (a band of a 2-D
    run sums them over its ranks)."""
    tiny = 1e-30

    def dot(u, v):
        return sites.sum(u * v, dim=-1, keepdim=True)

    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = dot(r, z)
    x = x0
    for _ in range(int(iters)):
        ap = matvec(p)
        denom = dot(p, ap)
        alpha = rz / torch.clamp(denom, min=tiny)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = z + beta * p
        rz = rz_new
    if not return_resid:
        return x
    rel = torch.sqrt(torch.amax(
        dot(r, r)[..., 0] / torch.clamp(dot(b, b)[..., 0], min=tiny),
        dim=-1,
    ))
    return x, rel


def _batch(tau, omega):
    """``tau`` and ``omega`` broadcast against (..., rows, n)."""
    tau = torch.as_tensor(tau, dtype=omega.dtype, device=omega.device)
    return tau[..., None, None], omega[..., None, :]


def icar_cg_solve(rhs, x0, omega, tau, q_dense, eigvecs, eigvals, iters):
    """Site-basis PCG: three matrix products per iteration."""
    t, om = _batch(tau, omega)
    cbar = torch.mean(omega, dim=-1)[..., None, None]
    pinv = 1.0 / (t * eigvals + cbar)

    def matvec(v):
        return t * (v @ q_dense) + om * v

    def precond(r):
        return ((r @ eigvecs) * pinv) @ eigvecs.T

    return pcg(matvec, precond, rhs, x0, iters)


def _mm(v, mat):
    """``v @ mat`` with ``v`` cast to the storage dtype of ``mat`` and
    the result in ``v``'s dtype.

    The product folds every chain's rows into one (chains * rows, n)
    matrix. On the card cuBLAS picks its kernel by that row count, so a
    chain's sums may be taken in another order when the chain count
    changes: one solve then agrees to float32 rounding (the 1e-4
    tolerance of the CG tests), and a long run, whose accept/reject
    decisions amplify rounding, gives chain c the same distribution but
    not the same draws. On the CPU the same holds between row counts
    that the library blocks alike (2 and 3 chains of 6 rows:
    tests/test_torch_logit.py), not between any two. The CUDA kernel of
    :mod:`.cuda_cg` fixes its order of sums and gives a chain the same bits
    at every chain count.
    """
    return torch.matmul(v.to(mat.dtype), mat).to(v.dtype)


def icar_cg_solve_spectral(
    rhs, warm_spec, omega, tau, eigvecs, eigvals, iters,
    return_resid=False,
):
    """Eigenbasis PCG: operator ``tau*S*v + U'(omega o (U v))`` and the
    diagonal preconditioner ``1 / (tau*S + mean(omega))``.

    ``warm_spec`` is the previous solution in the eigenbasis (the second
    output). Returns ``(x_site, x_spec)`` or, with ``return_resid=True``,
    ``(x_site, x_spec, rel)`` with ``rel`` per batch element.
    """
    t, om = _batch(tau, omega)
    cbar = torch.mean(omega, dim=-1)[..., None, None]
    tau_s = t * eigvals.to(omega.dtype)
    dinv = 1.0 / (tau_s + cbar)
    b_spec = _mm(rhs, eigvecs)

    def matvec(v):
        return tau_s * v + _mm(om * _mm(v, eigvecs.T), eigvecs)

    def precond(r):
        return dinv * r

    out = pcg(matvec, precond, b_spec, warm_spec, iters,
              return_resid=return_resid)
    if return_resid:
        x_spec, rel = out
        return _mm(x_spec, eigvecs.T), x_spec, rel
    return _mm(out, eigvecs.T), out
