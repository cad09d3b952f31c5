"""The check that no JAX code ran in a benchmark process."""

import sys

#: top-level module names, compared whole, that a run may not hold: the
#: JAX stack and the JAX package that the port was made from (the port,
#: ``occuspytial_tpu_torch``, only shares its first letters)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'occuspytial_tpu')


def forbidden_modules(modules=None):
    """Sorted names in ``modules`` (default ``sys.modules``) whose
    top-level name, the part before the first dot, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split('.')[0] in FORBIDDEN)
