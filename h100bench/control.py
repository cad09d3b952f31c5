"""Readings of the comparison that decides ``correct``, for setting its
limit: the program's and the precision control's, seed by seed.

    python3 -m h100bench.control --workload icar1k.k3.c64 \
        --seeds 11,12,13 --seconds 5

For each seed, in one process on the card: the cell's set-up and a
window of ``--seconds``, then the number compared twice over the same
starting points: once for the program's draws (the lower reading) and
once for the control, the plain reference computed one precision rung
below the configuration's (float32 with TF32 products) and put in the
program's place (the upper reading). One JSON line per seed, with every
(chain, start) gap of both (``--pairs``), from which the number
compared can be read at any quantile and for a fault confined to some
chains (the control's gaps on those chains, the program's on the
rest). The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time

import numpy as np

from . import spec
from .run import CACHE_DIRS, Cell, log


def _pairs(gaps):
    return [np.asarray(g, float).tolist() for g in gaps]


def readings(cell, seed, seconds, device='cuda', pairs=False):
    """{'seed', 'program', 'control'}: the number compared and the
    largest chain gap of each, for one seed; with ``pairs`` every
    (chain, start) gap of both, one list per start."""
    c = Cell(cell, seed, device, steady=False)
    c.setup(time.perf_counter())
    c.window(seconds)
    c.release()
    program, faults = c.reference_checks()
    prog_gaps = c.gaps
    ctl = spec.reference(c.cfg['reference']).build(
        c.data, c.args, device, control=True)
    control, _ = c.reference_checks(program=ctl)
    out = {'seed': seed, 'program': program,
           'program_max': float(max(np.max(g) for g in prog_gaps)),
           'control': control,
           'control_max': float(max(np.max(g) for g in c.gaps)),
           'carry_faults': faults, 'blocks': c.blocks}
    if pairs:
        out.update(program_pairs=_pairs(prog_gaps),
                   control_pairs=_pairs(c.gaps))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True,
                    help='comma-separated whole numbers')
    ap.add_argument('--seconds', type=float, default=5.0)
    ap.add_argument('--pairs', action='store_true',
                    help='print every (chain, start) gap')
    args = ap.parse_args(argv)
    import os

    for var, path in CACHE_DIRS.items():
        os.environ[var] = str(path)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        log('h100bench.control needs a CUDA card')
        return 2
    for seed in (int(s) for s in args.seeds.split(',')):
        print(json.dumps({'workload': args.workload,
                          **readings(cell, seed, args.seconds,
                                       pairs=args.pairs)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
