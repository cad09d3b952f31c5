"""Run one benchmark cell of the PyTorch/CUDA port once and print its line.

    python3 -m h100bench.run --workload icar1k.k3.c64 --seed 123 \
        --seconds 30 --trace 0

One process, one run, on one CUDA card (it exits with 2 and prints no
result without one):

1. set-up, timed from the start of the process (``setup_s``): the
   dataset, the sampler with the configuration's and the route's
   arguments and the chains drawn from ``--seed``, the kernels'
   libraries (built into the checkout's ``build/`` when absent), the
   initial carry, a burn-in ``sample()`` call (which captures the step
   graph) and one ``sample()`` call of the window's block length; then,
   outside ``setup_s``, such calls for the traffic's fixed
   ``settle_seconds`` of wall time (a fresh process on the H100 steps
   more slowly for its first 16-26 s);
2. the window: ``sample(block, chains, resume_from=carry,
   progressbar=False)`` back to back, each resumed from the last one's
   ``final_carry`` (one long run, bit for bit), until ``--seconds`` have
   passed; it ends with a ``torch.cuda.synchronize()``;
3. after the window: with ``--trace 1`` two more blocks under
   ``torch.profiler`` and the cell's per-layer metrics; the window's
   checks (no capture, every kernel launched as often as the captured
   step records); the peak card memory; the program's state freed; the
   plain reference over a sample of the window's blocks; the check that
   no JAX module was loaded.

The last line of standard output is the result; the numbers compared
are also the last lines of standard error.
"""

import time

T0 = time.perf_counter()


def _process_age():
    """Seconds since this process started (Linux ``/proc``), 0 where it
    cannot be read."""
    try:
        with open('/proc/self/stat') as fh:
            ticks = int(fh.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as fh:
            up = float(fh.read().split()[0])
        import os

        return max(0.0, up - ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return 0.0


#: the process's age when this module started loading
AGE0 = _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import guard, judge, spec  # noqa: E402
from .ess import min_ess  # noqa: E402
from .trace import Trace  # noqa: E402

#: build and kernel caches of anything the run compiles, at fixed paths
#: inside the checkout (the port builds its kernels into build/ itself)
CACHE_DIRS = {
    'TRITON_CACHE_DIR': spec.ROOT / 'build' / 'triton',
    'TORCH_EXTENSIONS_DIR': spec.ROOT / 'build' / 'torch_extensions',
}

#: blocks profiled in a ``--trace 1`` run
TRACE_BLOCKS = 2


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _sampler_args(cfg, tr):
    args = dict(cfg.get('sampler_args', {}))
    args.update(tr.get('sampler_args', {}))
    if args.get('lattice') is not None:
        args['lattice'] = tuple(args['lattice'])
    return args


def _counters():
    from occuspytial_tpu_torch.models.base import KERNEL_COUNTERS

    return KERNEL_COUNTERS


class Cell:
    """One run of one cell: set-up, window, trace and checks. ``device``
    is ``'cuda'`` on the card; ``'cpu'`` runs the same control flow on
    the program's plain path (the harness's own tests), without the
    measurements that need the card.

    Set-up ends with one block of the window's length, then the settle
    blocks for the traffic's ``settle_seconds``: on the H100 a fresh
    process first steps ~14% slower (64-step blocks of 252 ms against
    219 ms at 64 chains) and switches for good to the faster rate 16-26
    s after it starts, at the same SM clock; a window that opened before
    the switch mixed the two rates. The settle blocks run for a fixed
    wall time, so no work of the program can lengthen them: they are
    left out of ``setup_s`` and reported as the part ``settle``.
    ``steady=False`` skips them (the control's readings, which time
    nothing)."""

    def __init__(self, cell, seed, device='cuda', steady=True):
        self.cell = cell
        self.cfg = cell['config_spec']
        self.tr = cell['traffic_spec']
        self.seed = int(seed)
        self.device = device
        self.cuda = device == 'cuda'
        self.args = _sampler_args(self.cfg, self.tr)
        self.chains = int(self.tr['chains'])
        self.block = int(self.tr['block'])
        self.steady = steady
        self.parts = {}

    def _sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def _timed(self, part, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        self._sync()
        self.parts[part] = time.perf_counter() - t
        return out

    # ------------------------------------------------------------ set-up

    def setup(self, t0):
        t = time.perf_counter()
        self.parts['age'] = AGE0
        self.parts['start'] = t - t0
        import torch  # noqa: F401

        import occuspytial_tpu_torch as port

        self.parts['import'] = time.perf_counter() - t
        gen = spec.generator(self.cfg['generator'])
        self.data = self._timed('data', gen.generate, self.cfg['data'],
                                self.cfg['data_seed'])
        self.built = {}
        if self.cuda:
            from occuspytial_tpu_torch import _build

            def load():
                names = self.tr.get('kernels', [])
                self.built = _build.build(names)
                for name in names:
                    _build.load(name)

            self._timed('kernels', load)
        cls = getattr(port, self.cfg['sampler'])
        d = self.data
        self.sampler = self._timed(
            'sampler', cls, d['Q'], d['W'], d['X'], d['y'],
            random_state=self.seed, device=self.device, **self.args)
        s = self.sampler
        carry = self._timed('init', s.init_carry, self.chains)
        t = time.perf_counter()
        self.burn_post = s.sample(int(self.tr['burnin']), chains=self.chains,
                                  resume_from=carry, progressbar=False)
        self._sync()
        burn = time.perf_counter() - t
        self.parts['burnin'] = burn - sum(
            r.capture_seconds for r in self._runners())
        self.carry = s.final_carry
        self.burn_resid = getattr(s, 'last_solver_resid', None)
        t = time.perf_counter()
        self._block()
        self._sync()
        self.parts['first_block'] = time.perf_counter() - t
        self.capture_s = sum(r.capture_seconds for r in self._runners())
        self.parts['capture'] = self.capture_s
        self.setup_s = time.perf_counter() - t0 + AGE0
        self.warm_blocks = 1
        t = time.perf_counter()
        settle = float(self.tr['settle_seconds']) if self.steady else 0.0
        self.settle_ms = []
        while time.perf_counter() - t < settle:
            b = time.perf_counter()
            self._block()
            self.warm_blocks += 1
            self.settle_ms.append(round(1e3 * (time.perf_counter() - b)))
        self._sync()
        self.parts['settle'] = time.perf_counter() - t

    def _block(self):
        """One ``sample()`` call of the window's length from the carry."""
        post = self.sampler.sample(self.block, chains=self.chains,
                                   resume_from=self.carry, progressbar=False)
        self.carry = self.sampler.final_carry
        return post

    def _runners(self):
        return list(getattr(self.sampler, '_graph_runners', {}).values())

    # ------------------------------------------------------------ window

    def window(self, seconds):
        s, k = self.sampler, int(self.tr['check_blocks'])
        pick = np.random.default_rng([self.seed % 2 ** 63, 1])
        self.runners_before = [(r, r.capture_seconds)
                               for r in self._runners()]
        self.launches_before = ([c.launches for c in _counters()]
                                if self.cuda else None)
        draws = {n: [] for n in judge.NAMES}
        sampled, blocks, ends, resid = [], 0, [], []
        start = time.perf_counter()
        while True:
            carry_in = self.carry
            post = s.sample(self.block, chains=self.chains,
                            resume_from=carry_in, progressbar=False)
            self.carry = s.final_carry
            resid.append(getattr(s, 'last_solver_resid', 0.0))
            for n in judge.NAMES:
                draws[n].append(post[n])
            item = (blocks, carry_in, self.carry, post)
            if len(sampled) < k:
                sampled.append(item)
            else:
                r = int(pick.integers(0, blocks + 1))
                if r < k:
                    sampled[r] = item
            blocks += 1
            ends.append(time.perf_counter())
            if ends[-1] - start >= seconds:
                break
        self._sync()
        self.window_s = time.perf_counter() - start
        self.block_s = np.diff([start] + ends)
        self.blocks = blocks
        self.resid = max(resid)
        self.sampled = sorted(sampled, key=lambda it: it[0])
        self.draws = {n: np.concatenate(v, axis=1) for n, v in draws.items()}

    def window_checks(self):
        """Captures made in the window, and kernel launches that differ
        from what the captured step records times the steps taken."""
        after = self._runners()
        captures = sum(1 for r in after
                       if all(r is not b for b, _ in self.runners_before))
        captures += sum(1 for r, sec in self.runners_before
                        if r.capture_seconds != sec
                        or all(r is not a for a in after))
        mismatch = 0
        if self.cuda:
            steps = self.blocks * self.block
            got = [c.launches - b
                   for c, b in zip(_counters(), self.launches_before)]
            runner = after[0] if after else None
            per = runner.per_replay if runner else [0] * len(got)
            want = [p * steps for p in per]
            mismatch = sum(abs(g - w) for g, w in zip(got, want))
            self.launch_counts = {'got': got, 'want': want}
        return captures, mismatch

    # ------------------------------------------------------------ trace

    def profile(self):
        """Per-layer metrics and the breakdown from ``TRACE_BLOCKS``
        profiled blocks after the window."""
        if not self.cuda:
            raise RuntimeError('the traced stretch needs the CUDA card')
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        s = self.sampler
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function('h100bench.stretch'):
                for _ in range(TRACE_BLOCKS):
                    with record_function('h100bench.block'):
                        s.sample(self.block, chains=self.chains,
                                 resume_from=self.carry, progressbar=False)
                    self.carry = s.final_carry
                torch.cuda.synchronize()
        raw = Trace.from_profiler(prof)
        marks = [h for h in raw.host if h[0] == 'h100bench.stretch']
        tr = Trace(raw.device, raw.host, min(h[1] for h in marks),
                   max(h[2] for h in marks))
        ctx = {
            'trace': tr, 'steps': TRACE_BLOCKS * self.block,
            'chains': self.chains, 'n': int(np.asarray(self.data['X'])
                                            .shape[0]),
            'p': int(np.asarray(self.data['X']).shape[1]),
            'args': self.args, 'capture_s': self.capture_s,
            'per_replay': self._runners()[0].per_replay,
            'window_step_s': self.window_s / (self.blocks * self.block),
            'peaks': spec.peaks(), 'config': self.cfg, 'traffic': self.tr,
        }
        metrics = {}
        for m in self.cell['per_layer']:
            value = spec.metric(m['name']).read(ctx)
            if value is not None:
                metrics[m['name']] = {'value': float(value),
                                      'unit': m['unit']}
        self.trace_info = {
            'trace_busy_s': tr.busy_s, 'trace_window_s': tr.wall_s,
            'trace_device_events': len(tr.device),
            'trace_host_events': len(tr.host),
            'trace_read_s': time.perf_counter() - t,
        }
        self.breakdown = {'device_ops': tr.top_ops(),
                          'idle_gaps': tr.idle_gaps()}
        return metrics

    # ------------------------------------------------------------ checks

    def release(self):
        """Free the program's state (the sampler, its graphs and their
        memory); what the reference needs moves to the host first."""
        def host(c):
            return c._replace(keys=c.keys.cpu(), states={
                k: v.cpu() for k, v in c.states.items()})

        self.sampled = [(j, host(a), host(b), post)
                        for j, a, b, post in self.sampled]
        self.carry = None
        self.sampler = None
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()

    def reference_checks(self, program=None):
        """The gap of the program's draws (or of ``program``, a stand-in
        made by :func:`spec.reference`'s ``build`` the same way, for the
        precision control) from the reference's, and the count of carry
        bookkeeping faults."""
        import torch

        ref_mod = spec.reference(self.cfg['reference'])
        ref = ref_mod.build(self.data, self.args, self.device)
        steps = int(self.tr['check_steps'])
        burnin = int(self.tr['burnin'])
        keys = ref.run_keys(self.seed, self.chains)
        gaps = []
        # the start: the reference's own initial state from the seed
        s0 = ref.init_state(self.seed, self.chains)
        want = ref.follow(s0, keys, 0, steps)
        got = (judge.first_steps(self.burn_post, steps) if program is None
               else program.follow(program.init_state(
                   self.seed, self.chains), keys, 0, steps))
        gaps.append(judge.chain_gaps(_np(got), _np(want)))
        faults = 0
        for j, cin, cout, post in self.sampled:
            step0 = burnin + self.block * (self.warm_blocks + j)
            faults += int(cin.step != step0)
            faults += int(cout.step != step0 + self.block)
            faults += int(not torch.equal(cin.keys, keys.cpu()))
            faults += int(not torch.equal(cout.keys, keys.cpu()))
            for n in judge.NAMES:
                last = np.asarray(post[n])[:, -1]
                faults += int(not np.array_equal(
                    last, cout.states[n].numpy()))
            want = ref.follow(ref.state_from(cin.states), keys, step0, steps)
            if program is None:
                got = judge.first_steps(post, steps)
            else:
                got = program.follow(program.state_from(cin.states), keys,
                                     step0, steps)
            gaps.append(judge.chain_gaps(_np(got), _np(want)))
        self.gaps = gaps
        return judge.quantile(gaps), faults


def _np(d):
    return {k: (v.detach().cpu().numpy() if hasattr(v, 'detach')
                else np.asarray(v)) for k, v in d.items()}


def _device_name():
    import torch

    return torch.cuda.get_device_name(0)


def _power_limit():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'not read'


def run(cell, seed, seconds, trace, device='cuda', t0=None):
    """One run of ``cell``; returns the result dict (the line's object)."""
    t0 = T0 if t0 is None else t0
    c = Cell(cell, seed, device)
    c.setup(t0)
    log(f'h100bench setup {json.dumps({"setup_s": c.setup_s, **c.parts})}'
        f' kernels built now: {sorted(c.built) or "none"}; settle block ms:'
        f' {c.settle_ms}')
    c.window(seconds)
    steps = c.blocks * c.block
    bad = np.zeros(c.blocks, bool)
    for n in judge.NAMES:
        arr = c.draws[n].reshape(c.chains, c.blocks, c.block, -1)
        bad |= ~np.all(np.isfinite(arr), axis=(0, 2, 3))
    failed = int(bad.sum())
    captures, mismatch = c.window_checks()
    metrics, extra = {}, {}
    if trace:
        metrics = c.profile()
    else:
        worst, label = min_ess(c.draws)
        values = {
            'chain_steps_per_s': c.chains * steps / c.window_s,
            'min_ess_per_s': worst / c.window_s,
            'setup_s': c.setup_s,
        }
        for m in cell['end_to_end']:
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}
        extra = {'min_ess': worst, 'worst': label}
    device_info = {'platform': 'gpu' if c.cuda else 'cpu',
                   'kind': _device_name() if c.cuda else 'cpu',
                   'count': int(cell.get('chips', 1))}
    if c.cuda:
        import torch

        device_info['memory_peak_bytes'] = int(
            torch.cuda.max_memory_allocated())
    if trace:
        device_info['busy_s'] = c.trace_info['trace_busy_s']
        device_info['window_s'] = c.trace_info['trace_window_s']
    quart = np.quantile(c.block_s, [0, 0.25, 0.5, 0.75, 1]).tolist()
    log('h100bench window ' + json.dumps({
        'window_s': c.window_s, 'blocks': c.blocks, 'block': c.block,
        'steps': steps, 'block_s_quantiles': quart,
        'block_ms': [round(1e3 * b) for b in c.block_s],
        'solver_resid_max': {'burnin': c.burn_resid, 'window': c.resid},
        **extra,
        **getattr(c, 'launch_counts', {}), **getattr(c, 'trace_info', {})}))
    c.release()
    t = time.perf_counter()
    gap, faults = c.reference_checks()
    log(f'h100bench reference {time.perf_counter() - t:.3f} s over '
        f'{len(c.gaps)} starting points, gaps by chain (max): '
        f'{[float(np.max(g)) for g in c.gaps]}')
    limits = c.tr['limits']
    checks = {
        judge.STAT: {'value': gap, 'limit': limits[judge.STAT]},
        'carry_faults': {'value': faults, 'limit': 0},
        'window_captures': {'value': captures, 'limit': 0},
        'launch_mismatch': {'value': mismatch, 'limit': 0},
    }
    result = {
        'correct': judge.verdict(checks) and failed == 0,
        'attempted': c.blocks,
        'failed': failed,
        'metrics': metrics,
        'device': device_info,
    }
    if trace:
        result['breakdown'] = c.breakdown
    result['checks'] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, path in CACHE_DIRS.items():
        os.environ[var] = str(path)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell.get('chips', 1)):
        log(f'h100bench: {args.workload} needs {cell.get("chips", 1)} CUDA '
            f'card(s); torch sees '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    log(f'h100bench card: {_power_limit()}')
    bad = guard.forbidden_modules()
    if bad:
        log(f'h100bench: JAX modules loaded in this process: {bad}')
        return 3
    for name, chk in result['checks'].items():
        log(f'check {name}: {chk["value"]!r} (limit {chk["limit"]!r})')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
