"""Probit latent utilities (``ops/truncnorm.py``; ``models/probit.py``:
``_update_omega_b``, ``_update_omega_a``, ``_update_z``): device time of
the kernels of the normal quantile and log-CDF (``ndtri``, ``log_ndtr``)
per Gibbs step, in microseconds: the inverse-CDF truncated normals of
the site and visit utilities and the occupancy odds. None where none
ran (the logit samplers)."""

import re

#: torch's elementwise kernels of the two special functions
PATTERN = re.compile(r'ndtri|log_ndtr')


def read(ctx):
    sec, count = ctx['trace'].time_of(PATTERN.search)
    if count == 0:
        return None
    return 1e6 * sec / ctx['steps']
