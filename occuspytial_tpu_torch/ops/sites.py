"""Reductions over the site axis, the one place a band of sites sums.

Every sum or contraction over the sites that a sampler step makes goes
through a :class:`Sites` object. In one process it is the very torch op
the callers made before (``torch.sum`` over a dimension, a matrix
product), so the bits do not change. A band of a 2-D (chains x sites)
run holds a subclass whose :meth:`Sites.psum` sums the band's partial
results over its ``sites`` process group
(:class:`..parallel.sharded_stencil.BandSites`), the counterpart of the
psums GSPMD inserts into the JAX package's partitioned step. A dense
solve needs the whole field: :meth:`Sites.gather` and :meth:`Sites.band`
move between a band and the field, and are the identity here.
"""

import torch


class Sites:
    """The site reductions of one process (the whole field)."""

    def psum(self, x, label=None):
        """The sum of ``x`` over the ranks that share the field: ``x``
        itself here. ``label`` names the reduction for a timed run."""
        return x

    def sum(self, x, dim=-1, keepdim=False):
        """``torch.sum`` over the site dimension ``dim``."""
        return self.psum(torch.sum(x, dim=dim, keepdim=keepdim))

    def contract(self, a, b):
        """``a @ b`` contracting over the sites (a's last dimension)."""
        return self.psum(a @ b)

    def gather(self, *xs, label=None):
        """The whole fields (..., n) of which ``xs`` (each (..., sites))
        are this process's bands: ``xs`` themselves here. A band of a 2-D
        run gathers them in one all-reduce
        (:class:`..parallel.sharded_stencil.BandSites`)."""
        return xs

    def band(self, x):
        """This process's band (..., sites) of a whole field ``x`` (...,
        n): ``x`` itself here."""
        return x


#: the reductions of a sampler that holds the whole field
LOCAL = Sites()


def lincomb(w, rows):
    """``w @ rows`` for ``w`` (..., p) with a small p (the regression
    coefficients) and ``rows`` (..., p, n): the sum ``w[..., 0] rows[0] +
    w[..., 1] rows[1] + ...`` in that order, elementwise. Each chain's
    entries are then the same bits whatever the chain count: on the card a
    batched product picks its kernel, and with it its order of sums, by
    the number of rows."""
    out = w[..., 0, None] * rows[..., 0, :]
    for j in range(1, w.shape[-1]):
        out = out + w[..., j, None] * rows[..., j, :]
    return out
