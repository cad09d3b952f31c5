"""Preallocated per-parameter sample storage (host side).

API parity with reference chain.py. In this package the sampler loop
writes whole stacked tensors and copies them to the host once, so
``Chain`` is a host-side convenience for incremental workflows (streaming draws out of
chunked runs, resuming, growing storage) rather than the per-iteration
store it is in the reference (reference gibbs/base.py:227-239).

Rebuild design: one contiguous ``(capacity, total_dim)`` row buffer with
named column slices, instead of the reference's dict of per-parameter
arrays — ``full`` is then a zero-copy view and block writes land in one
contiguous assignment per chunk.
"""

import numpy as np


class Chain:
    """Fixed-capacity store of posterior draws.

    Parameters
    ----------
    params : Dict[str, int]
        Parameter name -> dimensionality (1 for scalars).
    size : int
        Initial capacity (rows); grow it later with :meth:`expand`.
    """

    def __init__(self, params, size):
        self._names = tuple(params)
        self._scalar = frozenset(k for k, d in params.items() if d <= 1)
        cols, offset = {}, 0
        for name, dim in params.items():
            cols[name] = slice(offset, offset + max(int(dim), 1))
            offset += max(int(dim), 1)
        self._cols = cols
        self._buf = np.zeros((int(size), offset))
        self._fill = 0

    @property
    def size(self):
        """Current capacity in rows."""
        return self._buf.shape[0]

    @property
    def full(self):
        """All parameters side by side, trimmed to the filled rows
        (a view into the underlying buffer, not a copy)."""
        return self._buf[: self._fill]

    def _require_room(self, rows):
        if self._fill + rows > self.size:
            raise ValueError(
                'Chain is full, cannot hold '
                f'{self._fill + rows} > {self.size} draws'
            )

    def append(self, params):
        """Write one draw per parameter; raises once capacity is hit."""
        self._require_room(1)
        row = self._buf[self._fill]
        for name, value in params.items():
            row[self._cols[name]] = value
        self._fill += 1

    def extend(self, params):
        """Write a block of draws per parameter (vectorized append).

        ``params`` maps name -> (m[, dim]) array. Rebuild addition:
        the sampler loop emits draws in blocks, not one at a time.
        All validation happens before any write, so a failing call never
        leaves the store partially updated.
        """
        blocks = {k: np.atleast_2d(np.asarray(v, dtype=float).T).T
                  for k, v in params.items()}
        rows = {b.shape[0] for b in blocks.values()}
        if len(rows) > 1:
            raise ValueError(
                'all parameter blocks must share one leading length, '
                f'got {sorted(rows)}'
            )
        m = rows.pop() if rows else 0
        self._require_room(m)
        window = self._buf[self._fill:self._fill + m]
        for name, block in blocks.items():
            window[:, self._cols[name]] = block
        self._fill += m

    def expand(self, size):
        """Grow capacity by ``size`` rows (reference chain.py contract)."""
        extra = np.zeros((int(size), self._buf.shape[1]))
        self._buf = np.concatenate([self._buf, extra], axis=0)

    def __getitem__(self, name):
        filled = self._buf[: self._fill, self._cols[name]]
        return filled[:, 0] if name in self._scalar else filled

    def __len__(self):
        return self._fill

    def __repr__(self):
        names = ', '.join(self._names)
        return f'Chain[{names}] ({self._fill}/{self.size} draws)'
