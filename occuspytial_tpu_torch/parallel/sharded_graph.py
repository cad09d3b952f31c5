"""Site-axis sharding of the banded graph operators (block runs + halos).

Port of the JAX package's ``parallel/sharded_graph.py``. In the
RCM-permuted block space of :func:`..ops.graph.build` the operator
couples adjacent blocks only, so the ``nb`` blocks split into contiguous
runs, one per rank of a ``torch.distributed`` group (the JAX ``'sites'``
mesh axis), and a matvec exchanges one boundary block per neighbour.

Everything here works in the permuted, padded block space: the caller
permutes and pads once on the host, as ``ops/graph.cg_solve`` does, and
hands each rank its run of the ``(nb, bs, bs)`` panels and of the
``(..., nb*bs)`` vectors.

- ``banded_matvec_sharded``: Q_perm v for this rank's run, the products
  of :func:`..ops.graph.banded_matvec` on the gathered vector;
- ``cg_solve_sharded``: the deflated-Jacobi preconditioned CG of
  ``ops/graph.cg_solve``, inner products and the thin deflation products
  summed over the ranks.
"""

import torch

from ._spmd import exchange_halo, psum


def check_extent(spec, world):
    """Raise unless ``world`` ranks split the banded layout's blocks
    evenly (the message of the JAX ``shard_sampler_2d``)."""
    nb = spec.n_pad // spec.block if spec.block else 0
    if not spec.block or nb % world:
        raise ValueError(
            f"the 'sites' mesh extent {world} must divide the banded "
            f'layout block count {nb} (site count {spec.n_pad} / block '
            f'{spec.block}); rebuild with graph_block set to a tile size '
            f'that yields a divisible block count'
        )


def banded_matvec_sharded(diag_l, sub_l, sup_l, v_local, group=None):
    """``Q_perm v`` for this rank's block run; one halo exchange.

    ``diag_l``/``sub_l``/``sup_l``: (nb_local, bs, bs) panel runs;
    ``v_local``: (..., nb_local, bs). Three batched float32 products over
    the blocks, diagonal, sub- and super-diagonal, summed in that order.
    """
    top, bottom = exchange_halo(v_local, group)
    nb, bs = v_local.shape[-2], v_local.shape[-1]
    lead = v_local.shape[:-2]
    # (nb, rows, bs): block-major, each tile multiplies every row at once
    vb = v_local.reshape(-1, nb, bs).transpose(0, 1)
    vm = torch.cat([top.reshape(1, -1, bs), vb[:-1]], dim=0)
    vp = torch.cat([vb[1:], bottom.reshape(1, -1, bs)], dim=0)
    y = (
        torch.matmul(vb, diag_l.transpose(-1, -2))
        + torch.matmul(vm, sub_l.transpose(-1, -2))
        + torch.matmul(vp, sup_l.transpose(-1, -2))
    )
    return y.transpose(0, 1).reshape(lead + (nb, bs))


def cg_solve_sharded(
    panels_local, rhs_local, x0_local, omega_local, tau, iters,
    defl_vecs_local=None, defl_vals=None, group=None,
):
    """Solve ``(tau*Q + diag(omega)) x = rhs`` with site-sharded blocks.

    Per rank: ``panels_local`` = (diag, sub, sup), each (nb_local, bs,
    bs); ``rhs_local``/``x0_local`` (r, nb_local*bs); ``omega_local``
    (nb_local*bs,), all in the permuted, padded order with omega 1 on the
    padded tail. ``defl_vecs_local`` (nb_local*bs, m) with ``defl_vals``
    (m,) select the deflated-Jacobi preconditioner; each of its two thin
    products with the basis is summed over the group. ``iters`` CG
    iterations, no early exit.
    """
    diag_l, sub_l, sup_l = panels_local
    nb_local, bs = diag_l.shape[0], diag_l.shape[1]
    m = nb_local * bs
    tau = torch.as_tensor(tau, dtype=rhs_local.dtype, device=rhs_local.device)

    def mv(v):  # (r, m)
        vb = v.reshape(v.shape[:-1] + (nb_local, bs))
        qv = banded_matvec_sharded(diag_l, sub_l, sup_l, vb, group)
        return tau * qv.reshape(v.shape) + omega_local * v

    # the degree is the diagonal of the diagonal panels
    deg_l = torch.diagonal(diag_l, dim1=-2, dim2=-1).reshape(m)
    jac = 1.0 / (tau * deg_l + omega_local)

    if defl_vecs_local is not None:
        # the global mean of omega over the real and padded lanes
        tot = psum(torch.stack([
            torch.sum(omega_local),
            torch.tensor(float(omega_local.numel()), dtype=omega_local.dtype,
                         device=omega_local.device),
        ]), group)
        cbar = tot[0] / tot[1]
        u = defl_vecs_local
        dinv = 1.0 / (tau * defl_vals + cbar)

        def pc(r):
            ru = psum(r @ u, group)  # (r, m) -> (r, k)
            r_perp = r - ru @ u.T
            w = r_perp * jac
            wu = psum(w @ u, group)
            w_perp = w - wu @ u.T
            return w_perp + (ru * dinv) @ u.T
    else:
        def pc(r):
            return r * jac

    def dot(a, b):
        return psum(torch.sum(a * b, dim=-1, keepdim=True), group)

    tiny = torch.tensor(1e-30, dtype=rhs_local.dtype, device=rhs_local.device)
    x = x0_local
    r = rhs_local - mv(x0_local)
    p = pc(r)
    rz = dot(r, p)
    for _ in range(int(iters)):
        ap = mv(p)
        alpha = rz / torch.maximum(dot(p, ap), tiny)
        x = x + alpha * p
        r = r - alpha * ap
        z = pc(r)
        rzn = dot(r, z)
        beta = rzn / torch.maximum(rz, tiny)
        p = z + beta * p
        rz = rzn
    return x
