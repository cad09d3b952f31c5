"""Device (H100): the share of the traced stretch of whole ``sample()``
blocks in which no kernel, copy or set ran on the card, in percent,
with the gaps that the profiler itself makes left out of both the idle
time and the stretch: those under its buffer requests and flushes, and
those under a ``cudaGraphLaunch``, which the profiler lengthens by
recording every node (untraced, the window steps no slower than the
traced kernels' busy time a step, so the host is ahead there). What is
left: the device's gaps between kernels and the host's work between
blocks."""

#: host events of the profiler's own, and the profiled graph launch
PROFILER = ('Activity Buffer Request', 'Buffer Flush', 'cudaGraphLaunch')


def read(ctx):
    tr = ctx['trace']
    if tr.wall_s <= 0 or not tr.device:
        return None
    gaps = tr.gaps()
    own = sum(sec for label, sec in gaps if label in PROFILER)
    idle = sum(sec for _, sec in gaps) - own
    return 100.0 * idle / (tr.wall_s - own)
