"""Stencil eta solve (``ops/cuda_stencil.py``, ``csrc/stencil_pcg.cu``):
device time of the lattice PCG kernel per Gibbs step, in microseconds.
None where the step solves the lattice in torch ops (no such kernel in
the trace)."""

import re

#: the kernel's name in the device trace
PATTERN = re.compile(r'stencil_pcg')


def read(ctx):
    sec, count = ctx['trace'].time_of(PATTERN.search)
    if count == 0:
        return None
    return 1e6 * sec / ctx['steps']
