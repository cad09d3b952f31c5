"""Posterior sample container: summaries, diagnostics and plots.

API-parity re-design of reference posterior.py:30-105
(``PosteriorParameter``) without the arviz dependency: ``.summary`` is
built from :mod:`occuspytial_tpu_torch.diagnostics` (the estimators arviz
uses) and the plot methods render with matplotlib directly.
``__getitem__`` returns the raw (chains, draws[, dim]) arrays, matching
the array shapes arviz's ``InferenceData.posterior`` exposes in the
reference (reference posterior.py:52-61, 103-104).
"""

import numpy as np

from . import diagnostics


class PosteriorParameter:
    """Posterior samples of ('alpha', 'beta', 'tau') across chains.

    Parameters
    ----------
    samples : Dict[str, np.ndarray] or Chain instances
        Either a mapping from parameter name to a (chains, draws[, dim])
        array, or one-or-more :class:`~occuspytial_tpu_torch.chain.Chain`
        objects (one per chain), mirroring the reference constructor
        (reference posterior.py:49-61).
    """

    def __init__(self, *samples):
        if len(samples) == 1 and isinstance(samples[0], dict):
            self._samples = {
                k: np.asarray(v) for k, v in samples[0].items()
            }
        else:  # Chain instances, one per chain
            chains = samples
            names = chains[0]._names
            self._samples = {
                name: np.stack([np.asarray(c[name]) for c in chains])
                for name in names
            }
        self._names = tuple(self._samples)

    @property
    def data(self):
        """Mapping of parameter name -> (chains, draws[, dim]) array."""
        return self._samples

    def _iter_scalars(self):
        """Yield (label, (chains, draws) array) for each scalar component."""
        for name, arr in self._samples.items():
            if arr.ndim == 2:
                yield name, arr
            else:
                for j in range(arr.shape[2]):
                    yield f'{name}[{j}]', arr[:, :, j]

    @property
    def summary(self):
        """Summary statistics table (reference posterior.py:63-76).

        Columns: mean, sd, hdi_3%, hdi_97%, mcse_mean, mcse_sd, ess_bulk,
        ess_tail, r_hat — the arviz ``az.summary`` contract.
        """
        import pandas as pd

        rows = {
            label: diagnostics.summary_stats(arr)
            for label, arr in self._iter_scalars()
        }
        return pd.DataFrame.from_dict(rows, orient='index')

    # ------------------------------------------------------------------ #
    # plotting (matplotlib; parity with reference posterior.py:78-101)
    # ------------------------------------------------------------------ #

    def plot_trace(self, **kwargs):
        """Density + trace panel per scalar parameter."""
        import matplotlib.pyplot as plt

        scalars = list(self._iter_scalars())
        fig, axes = plt.subplots(
            len(scalars), 2, figsize=(10, 2.2 * len(scalars)),
            squeeze=False, **kwargs,
        )
        for i, (label, arr) in enumerate(scalars):
            for c in range(arr.shape[0]):
                _kde_line(axes[i][0], arr[c])
                axes[i][1].plot(arr[c], lw=0.6, alpha=0.8)
            axes[i][0].set_title(label)
            axes[i][1].set_title(label)
        fig.tight_layout()
        return axes

    def plot_auto_corr(self, max_lag=100, **kwargs):
        """Autocorrelation function per scalar parameter and chain."""
        import matplotlib.pyplot as plt

        scalars = list(self._iter_scalars())
        fig, axes = plt.subplots(
            1, len(scalars), figsize=(3 * len(scalars), 2.6),
            squeeze=False, **kwargs,
        )
        for i, (label, arr) in enumerate(scalars):
            ax = axes[0][i]
            for c in range(arr.shape[0]):
                x = arr[c] - arr[c].mean()
                n = x.size
                acf = np.correlate(x, x, 'full')[n - 1:n - 1 + max_lag]
                denom = acf[0] if acf[0] else 1.0
                ax.bar(np.arange(acf.size), acf / denom, width=1.0, alpha=0.6)
            ax.set_title(label)
        fig.tight_layout()
        return axes

    def plot_pair(self, **kwargs):
        """Pairwise scatter of the scalar parameters."""
        import matplotlib.pyplot as plt

        scalars = list(self._iter_scalars())
        k = len(scalars)
        fig, axes = plt.subplots(
            k - 1, k - 1, figsize=(2.2 * k, 2.2 * k), squeeze=False,
            **kwargs,
        )
        for i in range(1, k):
            for j in range(k - 1):
                ax = axes[i - 1][j]
                if j < i:
                    ax.scatter(
                        scalars[j][1].ravel(), scalars[i][1].ravel(),
                        s=2, alpha=0.3,
                    )
                    if i == k - 1:
                        ax.set_xlabel(scalars[j][0])
                    if j == 0:
                        ax.set_ylabel(scalars[i][0])
                else:
                    ax.axis('off')
        fig.tight_layout()
        return axes

    def plot_density(self, **kwargs):
        """Posterior density with HDI markers per scalar parameter."""
        import matplotlib.pyplot as plt

        scalars = list(self._iter_scalars())
        fig, axes = plt.subplots(
            1, len(scalars), figsize=(3 * len(scalars), 2.6),
            squeeze=False, **kwargs,
        )
        for i, (label, arr) in enumerate(scalars):
            ax = axes[0][i]
            _kde_line(ax, arr.ravel())
            lo, hi = diagnostics.hdi(arr)
            ax.axvline(lo, color='k', ls='--', lw=0.8)
            ax.axvline(hi, color='k', ls='--', lw=0.8)
            ax.set_title(label)
        fig.tight_layout()
        return axes

    def plot_ess(self, n_points=20, **kwargs):
        """Evolution of bulk ESS with the number of draws."""
        import matplotlib.pyplot as plt

        scalars = list(self._iter_scalars())
        fig, axes = plt.subplots(
            1, len(scalars), figsize=(3 * len(scalars), 2.6),
            squeeze=False, **kwargs,
        )
        for i, (label, arr) in enumerate(scalars):
            ax = axes[0][i]
            draws = arr.shape[1]
            xs = np.unique(
                np.linspace(4, draws, min(n_points, draws)).astype(int)
            )
            ys = [diagnostics.ess_bulk(arr[:, :t]) for t in xs]
            ax.plot(xs, ys, marker='o', ms=3)
            ax.set_title(label)
            ax.set_xlabel('draws')
        fig.tight_layout()
        return axes

    def to_inference_data(self):
        """Bridge into the arviz ecosystem (reference posterior.py:52-61).

        Returns an ``arviz.InferenceData`` whose ``posterior`` group holds
        the same (chain, draw[, dim]) arrays as :attr:`data`. Lazy and
        optional: arviz is not a dependency of this package — the import
        happens here, and a clear ``ImportError`` is raised when it is
        absent (the built-in ``.summary``/``plot_*`` need no arviz).
        """
        try:
            import arviz as az
        except ImportError as exc:  # pragma: no cover - env dependent
            raise ImportError(
                'to_inference_data() requires the optional arviz package '
                "(pip install arviz); the built-in .summary and plot_* "
                'methods work without it'
            ) from exc
        return az.convert_to_inference_data(self._samples)

    def __getitem__(self, name):
        return self._samples[name]

    def __repr__(self):
        shapes = {k: v.shape for k, v in self._samples.items()}
        return f'PosteriorParameter({shapes})'


def _kde_line(ax, x, gridsize=200):
    """Gaussian-KDE density line (Scott's rule)."""
    x = np.asarray(x, dtype=np.float64)
    sd = x.std()
    if sd == 0:
        ax.axvline(x[0])
        return
    bw = 1.06 * sd * x.size ** (-1 / 5)
    grid = np.linspace(x.min() - 3 * bw, x.max() + 3 * bw, gridsize)
    dens = np.exp(
        -0.5 * ((grid[:, None] - x[None, :]) / bw) ** 2
    ).sum(axis=1) / (x.size * bw * np.sqrt(2 * np.pi))
    ax.plot(grid, dens, lw=1.0)
