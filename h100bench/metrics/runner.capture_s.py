"""Runner (``models/base.py:_StepGraph``): seconds the program's own
timer gives its step-graph captures in set-up (``capture_seconds``,
summed over the captures made)."""


def read(ctx):
    return ctx['capture_s'] if ctx['capture_s'] > 0 else None
