"""Static-shape occupancy survey data (host side, numpy).

Same container as the JAX package's ``data`` module: the reference's
dict-of-ragged-arrays detection data (reference data.pyx:34-147) packed
once into padded dense arrays plus masks,

    W          (n_surveyed, v_max, n_alpha)  detection design, zero-padded
    y          (n_surveyed, v_max)           detection outcomes, zero-padded
    visit_mask (n_surveyed, v_max)           True for real (site, visit) cells
    surveyed   (n,)                          True where the site was surveyed
    obs        (n,)                          True where ever detected

plus the flat-visits views the sampler's hot path uses. Everything here is
numpy; the sampler moves what it needs to its device once.
"""

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class OccupancyData:
    """Padded, masked survey data.

    Detection arrays are *compact*: their leading axis covers only the
    ``n_surveyed`` surveyed sites; ``site_idx`` maps each compact row back
    to its full-lattice site.
    """

    W: np.ndarray           # (n_surveyed, v_max, n_alpha)
    y: np.ndarray           # (n_surveyed, v_max)
    visit_mask: np.ndarray  # (n_surveyed, v_max) bool
    site_idx: np.ndarray    # (n_surveyed,) int32: compact row -> site
    surveyed: np.ndarray    # (n_sites,) bool
    obs: np.ndarray         # (n_sites,) bool
    # flat-visits views: every real (site, visit) cell once, no padding
    W_flat: np.ndarray      # (total_visits, n_alpha)
    y_flat: np.ndarray      # (total_visits,)
    visit_site: np.ndarray  # (total_visits,) int32: visit row -> site

    @property
    def n_sites(self):
        """Total number of lattice sites."""
        return self.surveyed.shape[0]

    @property
    def total_visits(self):
        """Total number of real (site, visit) cells."""
        return self.W_flat.shape[0]

    @property
    def n_surveyed(self):
        """Number of surveyed sites."""
        return self.W.shape[0]

    @property
    def max_visits(self):
        """Visit-grid padding width (max visits at any site)."""
        return self.W.shape[1]

    @property
    def n_alpha(self):
        """Number of detection covariates."""
        return self.W.shape[2]

    def visits(self):
        """Number of visits per site (0 for unsurveyed sites)."""
        out = np.zeros(self.n_sites, dtype=np.int64)
        out[np.asarray(self.site_idx)] = np.asarray(
            self.visit_mask
        ).sum(axis=1)
        return out

    def flat_index(self):
        """(n_surveyed, v_max) int64 index of each padded cell's row in
        the flat-visits arrays (0 for padded cells; mask them with
        ``visit_mask``). Lets a per-site sum over visits run over the
        padded grid in a fixed order instead of a scatter-add."""
        mask = np.asarray(self.visit_mask)
        idx = np.zeros(mask.shape, dtype=np.int64)
        idx[mask] = np.arange(int(mask.sum()))
        return idx


def pack_detection_data(W, y, n_sites, dtype=np.float32):
    """Pack dict-of-ragged-arrays survey data into an OccupancyData.

    Parameters mirror the reference constructor (reference
    gibbs/base.py:84-88): ``W`` maps site index -> (visits_i, n_alpha)
    design matrix; ``y`` maps site index -> (visits_i,) detection
    indicators. Sites absent from the dicts are unsurveyed.
    """
    if set(W) != set(y):
        raise ValueError('W and y must contain the same site keys')
    sites = sorted(W)
    if sites and (min(sites) < 0 or max(sites) >= n_sites):
        raise ValueError('site keys must lie in [0, n_sites)')

    ns = len(sites)
    w_list = []
    y_list = []
    n_alpha = None
    for s in sites:
        wi = np.atleast_2d(np.asarray(W[s], dtype=np.float32))
        yi = np.atleast_1d(np.asarray(y[s], dtype=np.float32))
        if n_alpha is None:
            n_alpha = wi.shape[1]
        if wi.shape[0] != yi.shape[0]:
            raise ValueError(
                f'site {s}: W has {wi.shape[0]} visits but y has '
                f'{yi.shape[0]}'
            )
        if wi.shape[1] != n_alpha:
            raise ValueError(
                f'site {s}: expected {n_alpha} detection covariates, '
                f'got {wi.shape[1]}'
            )
        w_list.append(wi)
        y_list.append(yi)
    if n_alpha is None:
        n_alpha = 1
    v_max = max((w.shape[0] for w in w_list), default=1)
    w_pad = np.zeros((ns, v_max, n_alpha), dtype=np.float32)
    y_pad = np.zeros((ns, v_max), dtype=np.float32)
    mask = np.zeros((ns, v_max), dtype=bool)
    for row in range(ns):
        v = w_list[row].shape[0]
        w_pad[row, :v] = w_list[row]
        y_pad[row, :v] = y_list[row]
        mask[row, :v] = True

    site_idx = np.asarray(sites, dtype=np.int32)
    surveyed = np.zeros(n_sites, dtype=bool)
    surveyed[site_idx] = True
    w_pad = w_pad.astype(dtype, copy=False)
    y_pad = y_pad.astype(dtype, copy=False)

    obs = np.zeros(n_sites, dtype=bool)
    obs[site_idx] = (y_pad * mask).sum(axis=1) > 0

    # flat-visits views: select real cells row-major (visits are packed
    # at the front of each padded row, so order is site-major)
    flat = mask.reshape(-1)
    n_alpha = w_pad.shape[2]
    w_flat = w_pad.reshape(-1, n_alpha)[flat]
    y_flat = y_pad.reshape(-1)[flat]
    visit_site = np.repeat(site_idx, mask.sum(axis=1)).astype(np.int32)
    return OccupancyData(
        W=w_pad, y=y_pad, visit_mask=mask, site_idx=site_idx,
        surveyed=surveyed, obs=obs,
        W_flat=w_flat, y_flat=y_flat, visit_site=visit_site,
    )


def as_occupancy_data(W, y, n_sites, dtype=np.float32):
    """Coerce (dicts | Data | OccupancyData) into an OccupancyData."""
    if isinstance(W, OccupancyData):
        return W
    if isinstance(W, Data):
        W = W.raw
    if isinstance(y, Data):
        y = y.raw
    return pack_detection_data(W, y, n_sites, dtype=dtype)


class Data:
    """Drop-in compatible ragged survey-data container.

    API parity with the reference's Cython ``Data`` (reference
    data.pyx:34-147): a dict of per-site arrays with ``surveyed``,
    ``visits(sites)`` and concatenating ``__getitem__``. Host-side
    convenience only; samplers convert to :class:`OccupancyData` once.
    """

    def __init__(self, data):
        if not isinstance(data, dict):
            raise TypeError('Data expects a dict of per-site arrays')
        self.raw = data
        self.surveyed = list(data)

    def visits(self, sites):
        """Number of visits (first-dim length) per site."""
        if isinstance(sites, (list, tuple)):
            return tuple(
                np.asarray(self.raw[s]).shape[0] for s in sites
            )
        return np.asarray(self.raw[sites]).shape[0]

    def __getitem__(self, sites):
        """Site data; sequences concatenate along the first axis
        (reference data.pyx:117-140)."""
        if isinstance(sites, (list, tuple)):
            return np.concatenate(
                [np.asarray(self.raw[s]) for s in sites], axis=0
            )
        return self.raw[sites]

    def __len__(self):
        return len(self.raw)

    def __reduce__(self):
        return self.__class__, (self.raw,)
