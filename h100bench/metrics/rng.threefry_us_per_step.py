"""Threefry draw plan (``rng.py``: ``DrawPlan``, ``csrc/pg_devroye.cu``
``threefry_plan``): device time of the draw-plan kernel per Gibbs step,
in microseconds. None where the step draws its words in int64 torch ops
(no such kernel in the trace)."""

import re

#: the kernel's name in the device trace
PATTERN = re.compile(r'threefry_plan_kernel')


def read(ctx):
    sec, count = ctx['trace'].time_of(PATTERN.search)
    if count == 0:
        return None
    return 1e6 * sec / ctx['steps']
