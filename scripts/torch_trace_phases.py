#!/usr/bin/env python3
"""What the port's phase spans (``occuspytial_tpu_torch.tracing``) cost
on the CUDA card, and whether they agree with the profiler.

For one benchmark cell (``h100bench``: its configuration, route and
chains; the chains drawn from ``--seed``), in one process:

1. the cell's set-up (``h100bench.run.Cell.setup``: sampler, burn-in
   and one block, without the settle blocks), tracing off;
2. segments of ``--segment`` seconds of back-to-back ``sample()`` blocks,
   tracing off and on in turns (off, on, on, off, ...) for ``--seconds``:
   each segment's chain-steps/s and start (seconds since this script
   started), and with tracing on its phases a step; a copy of the
   sampler keeps the step captured with marks, so no segment recaptures;
3. the stretch: 8 traced blocks on the host clock against the sums of
   ``step``, ``launch_gap`` and ``block_boundary``, and the step's child
   phases against the step;
4. ``%globaltimer``'s resolution: ``--marks`` back-to-back pairs of
   marks, each read alone;
5. two blocks under ``torch.profiler`` with tracing on: each phase's
   program sum against the profiler's time between its marker kernels
   (start to start), the launch gap the same way, and the device events
   of ``occuspytial.*`` host ranges that ``h100bench.trace`` would count
   as kernels (it should count none);
6. two blocks under the profiler with tracing off: kernels a step as
   ``runner.kernels_per_step`` reads them, and the idle gaps by host range.

Writes every reading as JSON to ``--out`` (default
``build/trace_phases_<workload>.json``) and prints a summary.

    python3 scripts/torch_trace_phases.py --workload icar1k.k3.c64 \\
        [--seconds 60] [--segment 3] [--seed 2147483777] [--out PATH]
"""

import argparse
import copy
import json
import os
import statistics
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def _age():
    return time.perf_counter() - T0


def _per_step(rep):
    spans = rep['spans']
    steps = spans['step']['count']
    out = {name: {'us_per_step': 1e6 * v['sum_s'] / steps,
                  'self_us_per_step': 1e6 * v['self_s'] / steps,
                  'per_step': v['count'] / steps}
           for name, v in spans.items()}
    out['launch_gap_us_per_step'] = 1e6 * rep['launch_gap']['sum_s'] / steps
    out['block_boundary_ms'] = (1e3 * rep['block_boundary']['sum_s']
                                / max(rep['block_boundary']['count'], 1))
    return out


def _between_marks(starts, seq, block):
    """Each phase's summed time between its marker kernels' starts (us),
    the marks of every step in the order ``seq`` of (close, open) phase
    indices; and the launch gaps' sum and count (a block's first step
    opens after a block boundary, not a gap)."""
    from occuspytial_tpu_torch.tracing import PHASES

    sums, begin = {}, {}
    gap_sum, gap_n, last_end = 0.0, 0, None
    for i, t in enumerate(starts):
        close, open_ = seq[i % len(seq)]
        if close >= 0:
            sums[PHASES[close]] = sums.get(PHASES[close], 0.0) + \
                t - begin[close]
            if close == 0:
                last_end = t
        if open_ >= 0:
            begin[open_] = t
            if open_ == 0 and last_end is not None and \
                    i % (len(seq) * block):
                gap_sum += t - last_end
                gap_n += 1
    return sums, gap_sum, gap_n


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    import torch

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function('h100bench.stretch'):
            fn()
            torch.cuda.synchronize()
    return prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, default=2 ** 31 + 777)
    ap.add_argument('--seconds', type=float, default=60.0)
    ap.add_argument('--segment', type=float, default=3.0)
    ap.add_argument('--marks', type=int, default=300)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()

    import torch

    from h100bench import run, spec
    from h100bench.trace import Trace
    from occuspytial_tpu_torch import tracing

    c = run.Cell(spec.cell(spec.load_benchmark(), args.workload), args.seed,
                 steady=False)
    c.setup(T0)
    chains, block = c.chains, c.block
    dev = torch.device('cuda')
    out = {'workload': args.workload, 'seed': args.seed,
           'device': torch.cuda.get_device_name(0)}

    s_off = c.sampler
    carry = {False: c.carry}
    s_on = copy.copy(s_off)
    tracing.enable()
    s_on.sample(block, chains=chains, progressbar=False,
                resume_from=carry[False])
    carry[True] = s_on.final_carry
    tracing.disable()
    out['setup_s'] = _age()

    # 2. tracing off and on in turns
    segments = []
    order = [False, True, True, False]
    k = 0
    while _age() - out['setup_s'] < args.seconds:
        on = order[k % 4]
        k += 1
        s = s_on if on else s_off
        (tracing.enable if on else tracing.disable)()
        tracing.report(reset=True)
        torch.cuda.synchronize()
        start, t, steps = _age(), time.perf_counter(), 0
        while time.perf_counter() - t < args.segment:
            s.sample(block, chains=chains, progressbar=False,
                     resume_from=carry[on])
            carry[on] = s.final_carry
            steps += block
        torch.cuda.synchronize()
        seg = {'on': on, 'start_s': start,
               'chain_steps_per_s': chains * steps / (time.perf_counter() - t)}
        if on:
            seg['phases'] = _per_step(tracing.report())
        segments.append(seg)
    tracing.disable()
    out['segments'] = segments
    for on in (False, True):
        rates = [g['chain_steps_per_s'] for g in segments if g['on'] == on]
        out[f'median_{"on" if on else "off"}'] = statistics.median(rates)
    late = [g for g in segments if g['start_s'] >= 45.0]
    if late:
        out['late_median_off'] = statistics.median(
            g['chain_steps_per_s'] for g in late if not g['on'])
        out['late_median_on'] = statistics.median(
            g['chain_steps_per_s'] for g in late if g['on'])

    # 3. the stretch on the host clock
    tracing.enable()
    tracing.report(reset=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(8):
        s_on.sample(block, chains=chains, progressbar=False,
                    resume_from=carry[True])
        carry[True] = s_on.final_carry
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rep = tracing.report()
    spans = rep['spans']
    step = spans['step']['sum_s']
    children = sum(v['sum_s'] for v in spans.values()
                   if v['parent'] == 'step')
    covered = (step + rep['launch_gap']['sum_s']
               + rep['block_boundary']['sum_s'])
    out['stretch'] = {'wall_s': wall, 'covered_s': covered,
                      'covered_over_wall': covered / wall,
                      'children_over_step': children / step,
                      'phases': _per_step(rep), 'report': rep}

    # 4. back-to-back marks, each pair read alone
    tracing.report(reset=True)
    gaps = []
    for _ in range(args.marks):
        with tracing.phase('step', dev, first=True):
            pass
        gaps.append(round(1e9 * tracing.report(reset=True)['spans']
                          ['step']['sum_s']))
    nonzero = sorted({g for g in gaps if g > 0})
    out['marks'] = {'ns_min': min(gaps), 'ns_median': statistics.median(gaps),
                    'ns_max': max(gaps), 'zero': gaps.count(0),
                    'distinct_ns': nonzero[:20],
                    'steps_between_distinct_ns': sorted(
                        {b - a for a, b in zip(nonzero, nonzero[1:])})[:10]}

    # 5. the profiler against the program, tracing on; the mark order of
    # one step from a fresh capture
    known = len(tracing.captured_marks(dev))
    s_rec = copy.copy(s_on)
    s_rec.sample(block, chains=chains, progressbar=False,
                 resume_from=carry[True])
    seq = tracing.captured_marks(dev)[known:]
    rec_carry = s_rec.final_carry
    tracing.report(reset=True)

    def two_blocks(s, key):
        def run():
            for _ in range(2):
                s.sample(block, chains=chains, progressbar=False,
                         resume_from=key[0])
                key[0] = s.final_carry
        return run

    prof = _profiled(two_blocks(s_rec, [rec_carry]))
    rep = tracing.report()
    tracing.disable()
    events = sorted((e for e in prof.events()
                     if 'span_mark_kernel' in e.name),
                    key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in events]
    agree = {'marks_per_step': len(seq), 'marker_events': len(starts),
             'steps': 2 * block}
    if seq and len(starts) == len(seq) * 2 * block:
        prof_sum, gap_sum, gap_n = _between_marks(starts, seq, block)
        agree['phases'] = {
            name: {'program_us': 1e6 * rep['spans'][name]['sum_s'],
                   'profiler_us': prof_sum[name],
                   'ratio': 1e6 * rep['spans'][name]['sum_s']
                   / prof_sum[name]}
            for name in prof_sum}
        agree['launch_gap'] = {
            'program_us': 1e6 * rep['launch_gap']['sum_s'],
            'profiler_us': gap_sum, 'program_n': rep['launch_gap']['count'],
            'profiler_n': gap_n}
    raw = Trace.from_profiler(prof)
    agree['occuspytial_on_device'] = sorted(
        {d[0] for d in raw.device if d[0].startswith('occuspytial.')})
    agree['annotation_flags'] = sorted({
        (e.name, e.device_type.name, bool(getattr(e, 'is_user_annotation',
                                                  False)))
        for e in prof.events() if e.name.startswith('occuspytial.')})
    out['profiler_on'] = agree

    # 6. tracing off under the profiler: kernels a step, idle gaps
    prof = _profiled(two_blocks(s_off, [carry[False]]))
    raw = Trace.from_profiler(prof)
    marks = [h for h in raw.host if h[0] == 'h100bench.stretch']
    trace = Trace(raw.device, raw.host, min(h[1] for h in marks),
                  max(h[2] for h in marks))
    out['profiler_off'] = {
        'kernels_per_step': len(trace.kernels()) / (2 * block),
        'occuspytial_on_device': sorted(
            {d[0] for d in raw.device if d[0].startswith('occuspytial.')}),
        'busy_s': trace.busy_s, 'wall_s': trace.wall_s,
        'idle_gaps': trace.idle_gaps(),
    }
    out['card'] = os.popen('nvidia-smi --query-gpu=name,power.limit '
                           '--format=csv,noheader').read().strip()

    path = args.out or os.path.join('build',
                                    f'trace_phases_{args.workload}.json')
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w') as fh:
        json.dump(out, fh, indent=1, default=float)
    summary = {k: out[k] for k in ('workload', 'card', 'setup_s',
                                   'median_off', 'median_on')}
    summary.update({k: out.get(k) for k in ('late_median_off',
                                            'late_median_on')})
    summary['cost'] = 1 - out['median_on'] / out['median_off']
    summary['stretch'] = {k: out['stretch'][k] for k in (
        'covered_over_wall', 'children_over_step')}
    summary['phases'] = {k: round(v['us_per_step'], 2) if isinstance(v, dict)
                         else round(v, 3)
                         for k, v in out['stretch']['phases'].items()}
    summary['marks'] = out['marks']
    summary['profiler_on'] = {k: v for k, v in out['profiler_on'].items()
                              if k != 'phases'}
    summary['ratios'] = {k: round(v['ratio'], 4) for k, v in
                         out['profiler_on'].get('phases', {}).items()}
    summary['profiler_off'] = {k: v for k, v in out['profiler_off'].items()
                               if k != 'idle_gaps'}
    summary['idle_gaps_off'] = out['profiler_off']['idle_gaps'][:6]
    print(json.dumps(summary, default=float), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
