"""PG draw (``ops/cuda_pg.py``, ``csrc/pg_devroye.cu``): device time of
the Polya-Gamma kernel K1 per Gibbs step, in microseconds. K1's work
depends on the data (rejection rounds), so no roofline is claimed."""

import re

#: the kernel's name in the device trace
PATTERN = re.compile(r'pg_devroye_kernel')


def read(ctx):
    sec, count = ctx['trace'].time_of(PATTERN.search)
    if count == 0:
        return None
    return 1e6 * sec / ctx['steps']
