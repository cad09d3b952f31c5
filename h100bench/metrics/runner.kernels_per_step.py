"""Runner (``models/base.py``: ``_run``, ``_StepGraph``): kernels that
ran on the card in the traced stretch (copies and sets left out) per
Gibbs step, block boundaries included."""


def read(ctx):
    kernels = ctx['trace'].kernels()
    if not kernels:
        return None
    return len(kernels) / ctx['steps']
