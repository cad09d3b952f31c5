"""The comparison that decides ``correct``.

The reference follows ``check_steps`` Gibbs steps from a state and its
draws are set beside the program's draws of the same steps. Per chain
the gap is the largest over those steps and over every component of

- alpha and beta: |program - reference| / max(1, |reference|);
- tau: |program - reference| / reference.

A pair is one chain at one starting point: the start (the reference's
own initial state from the seed against the program's first burn-in
steps) and each sampled window block (the program's state at the
block's start). The number compared, :data:`STAT`, is the
:data:`LEVEL` quantile of the pairs' gaps: the rare pair in which a
rounding difference flips one accept/reject decision, and so moves a
draw by far more than rounding, stays above it (sound runs flip up to
six pairs in a hundred, most in the 10,000-site cell); a fault that
leaves more than a tenth of the pairs wrong, such as one 64-row tile of
K3 (about a sixth of the chains at 64), does not.
"""

import numpy as np

NAMES = ('alpha', 'beta', 'tau')


def chain_gaps(prog, ref):
    """(chains,) largest relative gap; ``prog`` and ``ref`` map each of
    :data:`NAMES` to (steps, chains[, dim]) arrays."""
    out = None
    for name in NAMES:
        p = np.asarray(prog[name], np.float64)
        r = np.asarray(ref[name], np.float64)
        if p.shape != r.shape:
            raise ValueError(f'{name}: program {p.shape} against reference '
                             f'{r.shape}')
        scale = np.abs(r) if name == 'tau' else np.maximum(np.abs(r), 1.0)
        g = np.abs(p - r) / scale
        g = np.where(np.isfinite(g), g, np.inf)
        g = g.reshape(g.shape[0], g.shape[1], -1).max(axis=(0, 2))
        out = g if out is None else np.maximum(out, g)
    return out


#: the quantile of the (chain, start) gaps that is compared, and its name
LEVEL = 0.90
STAT = 'gap_q90'


def quantile(gaps, level=LEVEL):
    """The ``level`` quantile over every (chain, start) pair of
    ``gaps``, a list of (chains,) arrays, one per start."""
    return float(np.quantile(np.concatenate(
        [np.atleast_1d(g) for g in gaps]), level))


def first_steps(post, steps):
    """The program's draws of a block's first ``steps`` steps as
    (steps, chains[, dim]) arrays; ``post`` maps names to (chains, draws
    [, dim])."""
    return {n: np.moveaxis(np.asarray(post[n])[:, :steps], 1, 0)
            for n in NAMES}


def verdict(checks):
    """Whether every number is within its limit."""
    return all(c['value'] <= c['limit'] for c in checks.values())
