"""Site bands of a field with no lattice and no graph: the dense eta
regimes (``'chol'``, ``'cg'``, ``'spectral'``) and the RSR samplers in a
2-D (chains x sites) run.

The JAX ``shard_sampler_2d`` lays these samplers' site-indexed arrays
over ``'sites'`` and keeps their dense operators replicated (Q, its
eigenbasis and noise factor, the Moran basis and its q-space products,
``occuspytial_tpu/parallel/__init__.py:99-107``); GSPMD partitions the
step and gathers a site field wherever a product needs all of it. The
port writes that out:

- a band is a contiguous run of n / S sites and the contiguous run of
  the visits at them (:func:`site_bands`);
- a product that only multiplies a site field into a dense operator or
  out of it takes the band's rows of the operator (the Moran basis K,
  the ICAR noise factor B, the spectral eigenbasis U; :func:`band_fixed`)
  and, where it contracts over the sites, sums over the chain row's
  ranks;
- a solve against tau*Q + diag(omega) (Cholesky, the torch-op CG or the
  CUDA kernel, unchanged) and the quad form eta'Q eta need the whole
  field: one exact all-reduce of a zero field-sized buffer gathers the
  chain row's operands (:meth:`.sharded_stencil.BandSites.gather`),
  every rank of the row solves the whole field and keeps its band. A
  band-partitioned CG would make an all-reduce of its (chains, rows, n)
  iterate every iteration, and could not run the CUDA kernel.
"""

import dataclasses

import numpy as np
import torch


def check_extent(n, extent):
    """Raise unless ``extent`` ranks split the ``n`` sites evenly (the
    JAX ``shard_sampler_2d``'s message)."""
    if n % extent:
        raise ValueError(
            f"the 'sites' mesh extent {extent} must divide the site count "
            f'{n}'
        )


@dataclasses.dataclass(frozen=True)
class SiteBand:
    """Site rank ``index`` of ``extent`` in a 2-D run of a dense regime or
    an RSR sampler: sites [site0, site1) and flat visits [visit0, visit1)
    (visits are site-major, so a band's visits are contiguous)."""

    index: int
    extent: int
    site0: int
    site1: int
    visit0: int
    visit1: int

    def noise_index(self, spec):
        """None: no normal of the field noise is indexed by a site (the
        ICAR noise ``B eps`` draws n - 1 basis normals, RSR q), so every
        band draws all of them."""
        return None


def site_bands(n, visit_site, extent):
    """The ``extent`` contiguous bands of ``n`` sites, each with its run
    of ``visit_site`` (numpy, the site of each flat visit). Raises unless
    ``extent`` divides ``n``."""
    check_extent(n, extent)
    per = n // extent
    out = []
    for i in range(extent):
        s0, s1 = i * per, (i + 1) * per
        v0, v1 = np.searchsorted(visit_site, [s0, s1])
        out.append(SiteBand(i, extent, s0, s1, int(v0), int(v1)))
    return out


def band_fixed(fixed, band, rows):
    """``fixed`` as ``band`` holds it: the site rows of the arrays named
    in ``rows``, the other arrays whole. Tensors are copied, so pickling
    ships only the band."""
    out = dict(fixed)
    for name in rows:
        out[name] = fixed[name][band.site0:band.site1].clone(
            memory_format=torch.contiguous_format)
    return out
