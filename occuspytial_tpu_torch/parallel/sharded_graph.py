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

The 2-D (chains x sites) sampler runs the unsharded sampler's own
algorithm on each band (:class:`GraphBandOps`, the JAX package's layout,
``occuspytial_tpu/parallel/__init__.py:41-53``): a rank holds a
contiguous band of sites in the original order (its ELL and incidence
rows, its rows of the deflation basis) and a contiguous run of the
permuted, padded blocks (its panels and its rows of the permuted basis).
The permutation spans the ranks, so a banded solve moves its operands
from the site bands to the block runs and its solution back, each by one
exact all-reduce of a zero field-sized buffer.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ops import graph
from ._spmd import exchange_halo, psum
from .sharded_stencil import BandSites


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


def banded_matvec_sharded(diag_l, sub_l, sup_l, v_local, group=None,
                          reduce=None):
    """``Q_perm v`` for this rank's block run; one halo exchange.

    ``diag_l``/``sub_l``/``sup_l``: (nb_local, bs, bs) panel runs;
    ``v_local``: (..., nb_local, bs). Three batched float32 products over
    the blocks, diagonal, sub- and super-diagonal, summed in that order,
    in the form of :func:`..ops.graph.banded_matvec`: the first rank's
    first block has no sub-diagonal product and the last rank's last
    block no super-diagonal one, so one rank is that function bit for
    bit. ``reduce``: the halo's sum (see :func:`._spmd.exchange_halo`).
    """
    top, bottom = exchange_halo(v_local, group, reduce)
    first = dist.get_rank(group) == 0
    last = dist.get_rank(group) == dist.get_world_size(group) - 1
    nb, bs = v_local.shape[-2], v_local.shape[-1]
    lead = v_local.shape[:-2]
    # (nb, rows, bs): block-major, each tile multiplies every row at once
    vb = v_local.reshape(-1, nb, bs).transpose(0, 1)
    y = torch.matmul(vb, diag_l.transpose(-1, -2))
    if first:
        vm, sub_p = vb[:-1], sub_l[1:]
    else:
        vm, sub_p = torch.cat([top.reshape(1, -1, bs), vb[:-1]]), sub_l
    if last:
        vp, sup_p = vb[1:], sup_l[:-1]
    else:
        vp, sup_p = torch.cat([vb[1:], bottom.reshape(1, -1, bs)]), sup_l
    sub = torch.matmul(vm, sub_p.transpose(-1, -2))
    sup = torch.matmul(vp, sup_p.transpose(-1, -2))
    y = y + torch.nn.functional.pad(sub, (0, 0, 0, 0, int(first), 0)) \
        + torch.nn.functional.pad(sup, (0, 0, 0, 0, 0, int(last)))
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


def check_bands(spec, extent):
    """Raise unless ``extent`` site ranks split the graph ``spec``: the
    extent must divide the site count and, in the banded layout, the
    block count (the JAX ``shard_sampler_2d``'s messages; the ELL layout
    has no blocks)."""
    if spec.n % extent:
        raise ValueError(
            f"the 'sites' mesh extent {extent} must divide the site count "
            f'{spec.n}'
        )
    if spec.block:
        check_extent(spec, extent)


@dataclasses.dataclass(frozen=True)
class GraphBand:
    """Site rank ``index`` of ``extent`` in a 2-D run on a graph: sites
    [site0, site1) and flat visits [visit0, visit1) in the original order,
    blocks [blk0, blk1) of the permuted, padded banded layout (none in the
    ELL layout), and ``edges``, the sorted ids of the edges incident to
    its sites (:func:`..ops.graph.noise_index`)."""

    index: int
    extent: int
    site0: int
    site1: int
    visit0: int
    visit1: int
    blk0: int
    blk1: int
    edges: np.ndarray = dataclasses.field(compare=False, repr=False)

    def noise_index(self, spec):
        """Indices in the ``noise`` layout of the standard normals its
        sites need: its edges, then (a surplus) its sites' own."""
        if not spec.has_surplus:
            return self.edges
        return np.concatenate([
            self.edges, spec.n_edges + np.arange(self.site0, self.site1)])


def graph_bands(spec, arrays, visit_site, extent):
    """The ``extent`` bands of the graph ``spec`` (``arrays``: its
    incidence panel), each with its run of ``visit_site`` (numpy, the site
    of each flat visit), its block run and its edges. Raises unless
    ``extent`` divides the site count and, banded, the block count."""
    check_bands(spec, extent)
    per = spec.n // extent
    nb = spec.n_pad // spec.block if spec.block else 0
    out = []
    for i in range(extent):
        s0, s1 = i * per, (i + 1) * per
        v0, v1 = np.searchsorted(visit_site, [s0, s1])
        edges = graph.noise_index(spec, arrays, s0, s1)[0]
        out.append(GraphBand(i, extent, s0, s1, int(v0), int(v1),
                             i * nb // extent, (i + 1) * nb // extent,
                             edges))
    return out


def band_fixed(spec, fixed, band):
    """The graph arrays of ``fixed`` (the field's) as ``band`` holds them:
    its sites' rows of the ELL panels, the surplus and the deflation basis;
    its incidence rows remapped to its edges; its block run of the
    panels, of the permuted companions and of ``gr_perm`` (cut at the
    field's sites). The field's edge list and inverse permutation are not
    needed. Tensors are copied, so pickling ships only the band."""
    dense = torch.contiguous_format
    out = {k: v for k, v in fixed.items()
           if k not in ('gr_esrc', 'gr_edst', 'gr_ew_sqrt', 'gr_iperm')}
    sl = slice(band.site0, band.site1)
    for name in ('gr_deg', 'gr_idx', 'gr_w', 'gr_surplus_sqrt',
                 'gr_defl_vecs'):
        if name in out:
            out[name] = out[name][sl].clone(memory_format=dense)
    _, inc_idx, inc_w = graph.noise_index(spec, fixed, band.site0,
                                          band.site1)
    out['gr_inc_idx'] = torch.as_tensor(inc_idx).to(fixed['gr_inc_idx'])
    out['gr_inc_w'] = torch.as_tensor(inc_w).to(fixed['gr_inc_w'])
    if spec.block:
        blocks = slice(band.blk0, band.blk1)
        lanes = slice(band.blk0 * spec.block, band.blk1 * spec.block)
        for name in ('gr_bd_diag', 'gr_bd_sub', 'gr_bd_sup'):
            out[name] = out[name][blocks].clone(memory_format=dense)
        for name in ('gr_deg_p', 'gr_defl_vecs_p'):
            if name in out:
                out[name] = out[name][lanes].clone(memory_format=dense)
        out['gr_perm'] = out['gr_perm'][
            lanes.start:min(lanes.stop, spec.n)].clone()
    return out


class GraphBandOps:
    """The graph operators of one band of a 2-D run, in the place of
    :mod:`..ops.graph` as a band sampler's ``_ops`` (the names and
    signatures a step calls). Its ``fixed`` arrays are the band's
    (:func:`band_fixed`). ``matvec`` gathers the field vector; the banded
    solve moves its operands to the band's block run and back and
    exchanges block halos; ``quad_form``, the solve's inner products and
    its deflation products sum over the group through
    :class:`.sharded_stencil.BandSites`. Timed, the all-reduces are
    labelled ``'perm'`` (the moves), ``'gather'``, ``'halo'`` and
    ``'sum'``."""

    def __init__(self, band, spec, group, timed=False):
        self.band = band
        self.group = group
        self.sites = BandSites(group, timed, slice(band.site0, band.site1),
                               spec.n)
        self.tail = 0
        if spec.block:
            self.tail = max(band.blk1 * spec.block - spec.n, 0)

    def to_run(self, x, fixed):
        """The band's block run (..., run lanes) of the field of which
        ``x`` (..., band sites) is the band's part, in the permuted order,
        zero on the padded tail."""
        [field] = self.sites.gather(x, label='perm')
        run = field[..., fixed['gr_perm']]
        return torch.nn.functional.pad(run, (0, self.tail))

    def from_run(self, x, fixed):
        """The band's sites (..., band sites) of the field of which ``x``
        (..., run lanes) is the band's block run."""
        buf = x.new_zeros(x.shape[:-1] + (self.sites.n,))
        buf[..., fixed['gr_perm']] = x[..., :x.shape[-1] - self.tail]
        return self.sites.band(self.sites.psum(buf, 'perm'))

    def banded_matvec(self, spec, fixed, v):
        nb = self.band.blk1 - self.band.blk0
        vb = v.reshape(v.shape[:-1] + (nb, spec.block))
        return banded_matvec_sharded(
            fixed['gr_bd_diag'], fixed['gr_bd_sub'], fixed['gr_bd_sup'], vb,
            self.group, self._halo,
        ).reshape(v.shape)

    def _halo(self, buf):
        return self.sites.psum(buf, 'halo')

    def matvec(self, spec, fixed, v):
        [field] = self.sites.gather(v, label='gather')
        return graph.ell_matvec(fixed, v, field)

    def quad_form(self, spec, fixed, v):
        return self.sites.sum(v * self.matvec(spec, fixed, v), dim=-1)

    def noise(self, spec, fixed, eps):
        return graph.incidence_noise(spec, fixed, eps,
                                     len(self.band.edges))

    def cg_solve(self, spec, fixed, *args, **kwargs):
        return graph.cg_solve(spec, fixed, *args, band=self, **kwargs)

    def constrained_mvnorm(self, spec, fixed, *args, **kwargs):
        return graph.constrained_mvnorm(spec, fixed, *args, band=self,
                                        **kwargs)
