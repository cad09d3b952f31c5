"""Reading a ``torch.profiler`` trace of whole ``sample()`` blocks.

The interval arithmetic is that of the port's step profiler: device busy
time is the union of the kernels' intervals, the idle share is 1 -
busy / wall. Memory copies and sets count as device work; kernels are
counted without them.
"""


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The device and host events of one profiled stretch.

    ``device``: (name, start_us, end_us) of every device activity
    (kernels, copies, sets); ``host``: the same of the host's ranges and
    runtime calls; ``start_us``/``end_us``: the stretch on the same
    clock."""

    def __init__(self, device, host, start_us, end_us):
        self.device = device
        self.host = host
        self.start_us = start_us
        self.end_us = end_us

    @classmethod
    def from_profiler(cls, prof):
        """The events of ``prof`` over their whole span; a
        ``record_function`` range, which the profiler mirrors on the
        device's timeline, counts as host only."""
        device, host = [], []
        for e in prof.events():
            item = (e.name, e.time_range.start, e.time_range.end)
            on_device = (e.device_type.name == 'CUDA'
                         and not getattr(e, 'is_user_annotation', False)
                         and not e.name.startswith('h100bench.'))
            (device if on_device else host).append(item)
        return cls(device, host, min(a for _, a, _ in device + host),
                   max(b for _, _, b in device + host))

    @property
    def wall_s(self):
        return (self.end_us - self.start_us) * 1e-6

    @property
    def busy_s(self):
        return busy_us([(a, b) for _, a, b in self.device]) * 1e-6

    def kernels(self):
        return [d for d in self.device
                if not d[0].startswith(('Memcpy', 'Memset'))]

    def time_of(self, match):
        """(seconds, count) of the device kernels whose name ``match``
        accepts."""
        hits = [b - a for name, a, b in self.kernels() if match(name)]
        return sum(hits) * 1e-6, len(hits)

    def top_ops(self, k=10):
        by = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], sec] for name, sec in top]

    #: gaps shorter than this (microseconds) are the device's own
    #: between two kernels of a launch or a graph, not the host's
    SHORT_GAP_US = 2.0

    def gaps(self):
        """(label, seconds) of every idle gap of the device in the
        stretch: each gap between busy intervals is charged to the
        innermost host range or call that holds its midpoint; a gap under
        :attr:`SHORT_GAP_US` is labelled as one between kernels."""
        busy = merged([(a, b) for _, a, b in self.device])
        edges = [self.start_us] + [x for ab in busy for x in ab] + \
            [self.end_us]
        short = f'between kernels (gaps < {self.SHORT_GAP_US:g} us)'
        out = []
        for i in range(0, len(edges) - 1, 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            if b - a < self.SHORT_GAP_US:
                label = short
            else:
                mid = 0.5 * (a + b)
                inner = [h for h in self.host if h[1] <= mid <= h[2]]
                label = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                         else 'no host range')
            out.append((label, (b - a) * 1e-6))
        return out

    def idle_gaps(self, k=10):
        """The idle device time of the stretch summed by the label of
        :meth:`gaps`, the ``k`` largest."""
        by = {}
        for label, sec in self.gaps():
            by[label] = by.get(label, 0.0) + sec
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], sec] for name, sec in top]
