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

The 2-D (chains x sites) sampler runs the unsharded sampler's own
algorithm on each band (:class:`BandOps`): the same stencil, the band's
share of the noise ``B eps`` from the normals the whole field gives its
edges (:func:`band_noise`), and the unsharded solve's DCT
preconditioner, whose coefficients need every row: each rank transforms
its rows and one all-reduce of the (..., rows, cols) coefficient field per
apply sums them (:func:`..ops.stencil.precond_apply`).
"""

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import stencil
from ..ops.sites import Sites
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


@dataclasses.dataclass(frozen=True)
class Band:
    """Site rank ``index`` of ``extent`` in a 2-D run: lattice rows
    [row0, row1), sites [site0, site1) and flat visits [visit0, visit1)
    (visits are site-major, so a band's visits are contiguous)."""

    index: int
    extent: int
    row0: int
    row1: int
    site0: int
    site1: int
    visit0: int
    visit1: int

    def noise_index(self, spec):
        """Indices in the ``noise`` layout of the standard normals its
        rows need (:func:`..ops.stencil.noise_index`)."""
        return stencil.noise_index(spec, self.row0, self.row1)


def bands(spec, visit_site, extent):
    """The ``extent`` row bands of the lattice ``spec``, each with its
    sites and its run of ``visit_site`` (numpy, the site of each flat
    visit). Raises unless ``extent`` divides the lattice rows."""
    check_extent(spec, extent)
    per = spec.rows // extent
    out = []
    for i in range(extent):
        r0, r1 = i * per, (i + 1) * per
        s0, s1 = r0 * spec.cols, r1 * spec.cols
        v0, v1 = np.searchsorted(visit_site, [s0, s1])
        out.append(Band(i, extent, r0, r1, s0, s1, int(v0), int(v1)))
    return out


class BandSites(Sites):
    """The site reductions of a band: each partial result all-reduced
    over the band's ``sites`` group. With ``timed=True`` the card is
    synchronised around each all-reduce and its seconds are summed by
    label into ``seconds`` (calls into ``calls``). Given its run of sites
    ``span`` (a slice) of a field of ``n`` sites, it also moves between
    the band and the field (:meth:`gather`, :meth:`band`)."""

    def __init__(self, group, timed=False, span=None, n=None):
        self.group = group
        self.timed = timed
        self.span, self.n = span, n
        self.seconds, self.calls = {}, {}

    def gather(self, *xs, label='field'):
        """The whole fields (..., n) of the bands ``xs`` (..., band
        sites): each rank writes its band of every x into one zero buffer
        and one all-reduce sums them, exactly (every other term is 0)."""
        if len(xs) == 1:
            buf = xs[0].new_zeros(xs[0].shape[:-1] + (self.n,))
            buf[..., self.span] = xs[0]
            return [self.psum(buf, label)]
        flat = [x.reshape(-1, x.shape[-1]) for x in xs]
        buf = flat[0].new_zeros((sum(f.shape[0] for f in flat), self.n))
        buf[:, self.span] = torch.cat(flat)
        buf = self.psum(buf, label)
        out, row = [], 0
        for x, f in zip(xs, flat):
            # a copy each: a fresh allocation, as the operand of one
            # process would be
            out.append(buf[row:row + f.shape[0]].reshape(
                x.shape[:-1] + (self.n,)).clone())
            row += f.shape[0]
        return out

    def band(self, x):
        return x[..., self.span].contiguous()

    def psum(self, x, label=None):
        if not self.timed:
            return psum(x, self.group)
        label = label or 'sum'
        sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        dist.all_reduce(x, group=self.group)
        sync()
        self.seconds[label] = self.seconds.get(label, 0.0) + (
            time.perf_counter() - t0)
        self.calls[label] = self.calls.get(label, 0) + 1
        return x


def band_noise(spec, fixed, eps, band):
    """The band's rows of ``B eps`` (:func:`..ops.stencil.noise`) from
    ``eps`` (..., len(noise_index(spec, row0, row1))): the normals of the
    edges with a source row in [row0 - 1, row1 + 1), then (rho < 1) the
    band's site normals. Each site sums its edges' terms in the order of
    the whole-field noise, so the band's rows are the whole field's bit
    for bit."""
    r, c = spec.rows, spec.cols
    a, b = max(band.row0 - 1, 0), min(band.row1 + 1, r)
    lead = eps.shape[:-1]
    out = eps.new_zeros(lead + (b - a, c))
    sr = float(np.sqrt(np.asarray(spec.rho, np.float32)))
    off = 0
    for dr, dc in stencil._dirs(spec):
        er, ec = b - a - dr, c - abs(dc)
        e = sr * eps[..., off:off + er * ec].reshape(lead + (er, ec))
        off += er * ec
        if dc >= 0:
            out[..., :er, :ec] += e
            out[..., dr:, dc:] -= e
        else:  # anti-diagonal: (i, j + 1) -> (i + 1, j)
            out[..., :er, -dc:] += e
            out[..., dr:, :ec] -= e
    out = out[..., band.row0 - a:band.row1 - a, :]
    if spec.rho < 1.0:
        rows = band.row1 - band.row0
        eps_d = eps[..., off:off + rows * c].reshape(lead + (rows, c))
        out = out + torch.sqrt((1.0 - spec.rho) * fixed['lat_deg']) * eps_d
    return out.reshape(lead + ((band.row1 - band.row0) * c,))


class BandOps:
    """The lattice operators of one band of a 2-D run, in the place of
    :mod:`..ops.stencil` as a band sampler's ``_ops`` (the names and
    signatures a step calls). Its ``fixed`` arrays are the band's:
    ``lat_deg`` its rows, ``lat_dct_r`` the DCT columns of its rows.
    ``matvec`` exchanges halos with the neighbouring bands; ``quad_form``,
    the solve's inner products and its preconditioner sum over the group
    through :class:`BandSites`."""

    def __init__(self, band, group, timed=False):
        self.band = band
        self.group = group
        self.sites = BandSites(group, timed)

    def matvec(self, spec, fixed, v):
        rows = (self.band.row1 - self.band.row0, spec.cols)
        return matvec_sharded(
            spec, fixed['lat_deg'], v.reshape(v.shape[:-1] + rows),
            self.group,
        ).reshape(v.shape)

    def quad_form(self, spec, fixed, v):
        return self.sites.sum(v * self.matvec(spec, fixed, v), dim=-1)

    def noise(self, spec, fixed, eps):
        return band_noise(spec, fixed, eps, self.band)

    def cg_solve(self, spec, fixed, *args, **kwargs):
        return stencil.cg_solve(spec, fixed, *args, band=self, **kwargs)

    def constrained_mvnorm(self, spec, fixed, *args, **kwargs):
        return stencil.constrained_mvnorm(spec, fixed, *args, band=self,
                                          **kwargs)
