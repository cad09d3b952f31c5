"""Where a Gibbs step's time goes: phase spans inside the step, host spans
around it. Off by default.

    from occuspytial_tpu_torch import tracing
    tracing.enable()
    s.sample(64, chains=64, progressbar=False)      # recaptures the step
    tracing.report(reset=True)                      # drop the capture run
    s.sample(64, chains=64, progressbar=False, resume_from=s.final_carry)
    print(tracing.report())
    tracing.disable()

**Phases** (:func:`phase`) partition one Gibbs step. ``step`` is the
root, opened by the runner (``models/base.py``) around the sampler's
``_step`` and the store of its draws; ``eta_solve`` lies inside
``beta_eta``; every other phase lies directly inside ``step``:

- ``draws``: the step's Threefry words (``rng.DrawPlan``); the normal and
  gamma transforms of the words count with the update that takes them;
- ``pg`` (logit): the linear predictors and the Pólya-Gamma draw;
  ``latent`` (probit): the truncated-normal site and visit utilities;
  ``px`` (probit): the parameter-expansion scale moves, one before the
  sweeps and one a sweep;
- ``tau``, ``beta_eta`` and ``asis``: once a spatial sweep; ``beta_eta``
  holds the blocked update, or the eta and beta draws, and inside it
  ``eta_solve`` the eta solve (K3, the stencil or graph PCG, Cholesky,
  the eigenbasis draw, the probit RSR sampler's ``eta @ K'``) and, for
  the probit RSR sampler's collapsed ladder, ``rsr_factor``: the batched
  Cholesky factor that its beta and eta draws share; for the logit RSR
  sampler's reduced-basis draw (``ops/mvnorm.py: rsr_mvnorm``)
  ``rsr_precision``, forming tau Q_rsr + K' diag(omega) K, and
  ``rsr_factor``, its factor and solves;
- ``alpha``, ``z``; ``store``: the step's new state into the captured
  graph's buffers, or the host loop's copies of the draws.

On a CUDA card each begin and end is a one-thread marker kernel
(``csrc/span_mark.cu``) that reads the card's nanosecond clock
(``%globaltimer``) and adds to a small int64 accumulator on the card, one
per device, made by the first step that marks (a capture's warm-up step,
never inside the capture). A captured step holds its marks and binds the
accumulator's address; :func:`report` reads it at a synchronisation. On
the CPU the same arithmetic runs on the host's ``time.perf_counter_ns``
(the host loop is synchronous there). Two counters come with them:
``launch_gap``, the time from one step's end to the next step's begin in
one chunk of a run, and ``block_boundary``, from a chunk's last step end
to the next chunk's first step begin (``sample()``'s return, the solver
health read, the draws to numpy, the next call's copies of the carry);
a captured step knows it is its chunk's first because the graph's slot
counter is 0 there.

With tracing off, :func:`phase` returns one shared null context after a
bool check, and a replay runs no Python, so a step captured with tracing
off holds no mark. The tracing state is part of the step graph's
signature (``GibbsBase._graph_signature``): toggling it recaptures.

**Host spans** (:func:`span`) are ``torch.profiler.record_function``
ranges named ``occuspytial.<name>`` around the runner's host work:
``sample``, ``sample.capture``, ``sample.replay``, ``sample.to_host``,
``sample.health`` and ``sample.carry``. They cost a bool check and a
call (about 0.1 us) unless a profiler is collecting or tracing is on.

Tracing is per process: the ranks of ``parallel.sample_parallel_2d`` and
the workers of ``parallel.sample_parallel`` run in processes of their
own, where it stays off, so they are not traced. The accumulators are
read for all devices together: trace one device at a time.
"""

import contextlib
import ctypes
import time

import torch

from . import _build

#: the phases, ``step`` (the root) first
PHASES = ('step', 'draws', 'pg', 'latent', 'px', 'tau', 'asis',
          'beta_eta', 'eta_solve', 'rsr_factor', 'alpha', 'z', 'store',
          'rsr_precision')
#: each phase's parent phase
PARENT = {name: ('beta_eta' if name in ('eta_solve', 'rsr_factor',
                                        'rsr_precision')
                 else 'step') for name in PHASES}
PARENT['step'] = None

# the accumulator's layout, as csrc/span_mark.cu reads it
_FIRST, _LAST, _LAST_END, _GAP, _GAP_N, _BOUNDARY, _BOUNDARY_N = range(7)
_HEADER = 8
_P = len(PHASES)
_BEGIN, _SUM, _COUNT = _HEADER, _HEADER + _P, _HEADER + 2 * _P
_SIZE = _HEADER + 3 * _P

_NULL = contextlib.nullcontext()

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _apply(acc, now, close, open_, first):
    """One mark on a host accumulator: the marker kernel's arithmetic."""
    if acc[_FIRST] == 0:
        acc[_FIRST] = now
    acc[_LAST] = now
    if close >= 0:
        acc[_SUM + close] += now - acc[_BEGIN + close]
        acc[_COUNT + close] += 1
        if close == 0:
            acc[_LAST_END] = now
    if open_ >= 0:
        acc[_BEGIN + open_] = now
        if open_ == 0 and acc[_LAST_END] != 0:
            at = _BOUNDARY if first else _GAP
            acc[at] += now - acc[_LAST_END]
            acc[at + 1] += 1


class _HostAccumulator:
    """The phases of steps run on the CPU, on the host's clock."""

    def __init__(self):
        self.values = [0] * _SIZE

    def mark(self, close, open_, first=False):
        _apply(self.values, time.perf_counter_ns(), close, open_,
               bool(first))

    def read(self):
        return list(self.values)

    def zero(self):
        self.values = [0] * _SIZE


class _DeviceAccumulator:
    """The phases of steps run on one CUDA card: an int64 tensor there
    that the marker kernels update. Made outside any stream capture (a
    capture would record its zeroing into the graph)."""

    def __init__(self, device):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f'tracing: first mark on {device} inside a stream capture; '
                'mark once before capturing'
            )
        self.device = device
        self.values = torch.zeros(_SIZE, dtype=torch.int64, device=device)
        #: (close, open) of each mark recorded into a stream capture
        self.captured = []

    def mark(self, close, open_, first=False):
        """``first``: a bool, or the captured step's device slot counter
        (the kernel reads whether it is 0)."""
        if torch.cuda.is_current_stream_capturing():
            self.captured.append((close, open_))
        if isinstance(first, torch.Tensor):
            slot, flag = first.data_ptr(), -1
        else:
            slot, flag = None, int(bool(first))
        lib = _TRACER.library()
        with torch.cuda.device(self.device):
            err = lib.span_mark_launch(
                self.values.data_ptr(), _P, close, open_, slot, flag,
                torch.cuda.current_stream(self.device).cuda_stream,
            )
        _build.check(lib, 'span_mark', err)

    def read(self):
        torch.cuda.synchronize(self.device)
        return self.values.tolist()

    def zero(self):
        self.values.zero_()


class _Tracer:
    """The process's tracing state: on or off, one accumulator per
    device, and the accumulator of the step being marked (None outside a
    step: a phase outside a step marks nothing)."""

    def __init__(self):
        self.on = False
        self.accumulators = {}
        self.current = None
        self.lib = None

    def library(self):
        """The marker kernel's library, built at first use."""
        if self.lib is None:
            lib = _build.load('span_mark')
            lib.span_mark_launch.argtypes = _ARGTYPES
            lib.span_mark_launch.restype = ctypes.c_int
            self.lib = lib
        return self.lib

    def accumulator(self, device):
        if device.type == 'cpu':
            key = 'cpu'
        else:
            key = (device.type, torch.cuda.current_device()
                   if device.index is None else device.index)
        acc = self.accumulators.get(key)
        if acc is None:
            acc = (_HostAccumulator() if key == 'cpu'
                   else _DeviceAccumulator(torch.device(*key)))
            self.accumulators[key] = acc
        return acc


_TRACER = _Tracer()


class _Phase:
    """A phase inside a step: a mark on the step's accumulator at its
    begin and at its end."""

    __slots__ = ('index',)

    def __init__(self, index):
        self.index = index

    def __enter__(self):
        acc = _TRACER.current
        if acc is not None:
            acc.mark(-1, self.index)

    def __exit__(self, *exc):
        acc = _TRACER.current
        if acc is not None:
            acc.mark(self.index, -1)


class _Step:
    """The root phase: selects the device's accumulator for the phases
    inside it."""

    __slots__ = ('device', 'first', 'acc')

    def __init__(self, device, first):
        self.device = device
        self.first = first

    def __enter__(self):
        self.acc = _TRACER.accumulator(self.device)
        _TRACER.current = self.acc
        self.acc.mark(-1, 0, self.first)

    def __exit__(self, *exc):
        self.acc.mark(0, -1)
        _TRACER.current = None


_PHASE = {name: _Phase(i) for i, name in enumerate(PHASES)}


def enable():
    """Turn tracing on in this process. On a machine with a CUDA card
    the marker kernel is built and loaded here, at the first call."""
    if torch.cuda.is_available():
        _TRACER.library()
    _TRACER.on = True


def disable():
    """Turn tracing off; what was accumulated stays for :func:`report`."""
    _TRACER.on = False


def enabled():
    """Whether tracing is on in this process."""
    return _TRACER.on


def phase(name, device=None, first=False):
    """A context manager that marks phase ``name`` of :data:`PHASES`
    while tracing is on, else a shared null context. ``step`` takes the
    ``device`` the step runs on and ``first``: whether the step is its
    chunk's first (a bool), or a captured step's device slot counter."""
    if not _TRACER.on:
        return _NULL
    if name == 'step':
        return _Step(device, first)
    return _PHASE[name]


def captured_marks(device):
    """The marks recorded into stream captures on CUDA ``device`` since
    its first mark, in order: ``(close, open)`` phase indices of
    :data:`PHASES`, -1 for none, as the marker kernel takes them (a
    captured step's marks are those of the capture it ran in)."""
    return list(_TRACER.accumulator(torch.device(device)).captured)


def span(name):
    """``torch.profiler.record_function('occuspytial.' + name)`` while a
    profiler collects or tracing is on, else a shared null context."""
    if _TRACER.on or torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function('occuspytial.' + name)
    return _NULL


def report(reset=False):
    """What the phases accumulated since the last reset, read at a
    synchronisation, or ``{}`` if no step was marked:

    - ``spans``: phase name -> ``parent``, ``sum_s`` (seconds in the
      phase, summed), ``count`` and ``self_s`` (``sum_s`` less the sums
      of its child phases), for each phase that ran;
    - ``launch_gap`` and ``block_boundary``: ``sum_s`` and ``count``;
    - ``first_stamp_s`` and ``last_stamp_s``: the first and the last
      mark's clock reading (the card's ``%globaltimer``, or the host's
      ``perf_counter_ns``), in seconds.

    ``reset`` zeroes the accumulators after the read (between runs: a
    phase open across a reset reads wrong)."""
    total = [0] * _SIZE
    firsts, lasts = [], []
    for acc in _TRACER.accumulators.values():
        values = acc.read()
        if values[_FIRST]:
            firsts.append(values[_FIRST])
            lasts.append(values[_LAST])
        for i in range(_GAP, _SIZE):
            total[i] += values[i]
        if reset:
            acc.zero()
    if not total[_COUNT]:
        return {}
    spans = {}
    for i, name in enumerate(PHASES):
        if total[_COUNT + i]:
            spans[name] = {'parent': PARENT[name],
                           'sum_s': 1e-9 * total[_SUM + i],
                           'count': total[_COUNT + i]}
    for name, entry in spans.items():
        entry['self_s'] = entry['sum_s'] - sum(
            child['sum_s'] for child in spans.values()
            if child['parent'] == name)
    return {
        'spans': spans,
        'launch_gap': {'sum_s': 1e-9 * total[_GAP],
                       'count': total[_GAP_N]},
        'block_boundary': {'sum_s': 1e-9 * total[_BOUNDARY],
                           'count': total[_BOUNDARY_N]},
        'first_stamp_s': 1e-9 * min(firsts),
        'last_stamp_s': 1e-9 * max(lasts),
    }
