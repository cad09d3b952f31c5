"""Site-axis sharding of the lattice ICAR operators (row bands + halos).

Port of the JAX package's ``parallel/sharded_stencil.py``. The (rows,
cols) grid is split into contiguous row bands, one per rank of a
``torch.distributed`` group (the JAX ``'sites'`` mesh axis). The lattice
operator couples adjacent rows only, so one halo exchange of each band's
boundary rows per matvec is the whole communication of the operator;
the CG's inner products are sums over the ranks.

- ``matvec_sharded``: Q v for this rank's band, the same sums in the same
  order as :func:`..ops.stencil.matvec` on the gathered vector;
- ``cg_solve_sharded``: the fixed-iteration CG with the diagonal (Jacobi)
  preconditioner (the DCT preconditioner of the single-device path is
  global), inner products summed over the ranks.

Call them on every rank of the group, each with its own band (for
example through :class:`._spmd.World`). ``group=None`` is the default
group.
"""

import torch

from ._spmd import exchange_halo, psum


def check_extent(spec, world):
    """Raise unless ``world`` ranks split the lattice rows evenly."""
    if spec.rows % world:
        raise ValueError(
            f"the 'sites' extent {world} must divide the lattice rows "
            f'{spec.rows}'
        )


def matvec_sharded(spec, deg_local, v_local, group=None):
    """Q v for this rank's row band; one halo exchange per call.

    ``deg_local`` (band_rows, cols) and ``v_local`` (..., band_rows, cols):
    the band's blocks of the site grid, every leading row of ``v`` served
    by the one exchange. Rook (4) and queen (8) neighbourhoods, rho from
    ``spec``. The neighbours are added in the JAX slice-add order (left,
    right, up, down, then the diagonals), as in ``ops/stencil.matvec``.
    """
    top, bottom = exchange_halo(v_local, group)
    g = torch.cat([top[..., None, :], v_local, bottom[..., None, :]], dim=-2)
    gp = torch.nn.functional.pad(g, (1, 1))
    r, c = v_local.shape[-2], v_local.shape[-1]
    acc = gp[..., 1:r + 1, 0:c] + gp[..., 1:r + 1, 2:c + 2]
    acc = acc + gp[..., 0:r, 1:c + 1]
    acc = acc + gp[..., 2:r + 2, 1:c + 1]
    if spec.max_neighbors == 8:
        acc = acc + gp[..., 0:r, 0:c]
        acc = acc + gp[..., 2:r + 2, 2:c + 2]
        acc = acc + gp[..., 0:r, 2:c + 2]
        acc = acc + gp[..., 2:r + 2, 0:c]
    return deg_local * v_local - spec.rho * acc


def cg_solve_sharded(
    spec, deg_local, rhs_local, x0_local, omega_local, tau, iters,
    group=None,
):
    """Solve (tau*Q + diag(omega)) x = rhs with site-sharded operands.

    Per rank: ``rhs_local``/``x0_local`` (r, band_rows*cols), the rank's
    band of each row flattened; ``omega_local`` (band_rows*cols,);
    ``tau`` a scalar. ``iters`` Jacobi-preconditioned CG iterations (no
    early exit); inner products summed over the group with a 1e-30
    floor on their denominators, as the JAX ``cg_solve_sharded``.
    """
    band = tuple(deg_local.shape)
    m = band[0] * band[1]
    tau = torch.as_tensor(tau, dtype=rhs_local.dtype, device=rhs_local.device)

    def mv(v):  # (r, m)
        out = matvec_sharded(
            spec, deg_local, v.reshape(v.shape[:-1] + band), group
        ).reshape(v.shape)
        return tau * out + omega_local * v

    inv_diag = 1.0 / (
        tau * deg_local.reshape(m) * torch.ones_like(omega_local)
        + omega_local
    )

    def dot(a, b):
        return psum(torch.sum(a * b, dim=-1, keepdim=True), group)

    tiny = torch.tensor(1e-30, dtype=rhs_local.dtype, device=rhs_local.device)
    x = x0_local
    r = rhs_local - mv(x0_local)
    p = inv_diag * r
    rz = dot(r, p)
    for _ in range(int(iters)):
        ap = mv(p)
        alpha = rz / torch.maximum(dot(p, ap), tiny)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rzn = dot(r, z)
        beta = rzn / torch.maximum(rz, tiny)
        p = z + beta * p
        rz = rzn
    return x
