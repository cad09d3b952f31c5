"""Finding a cell's files by the names in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix; each lives in a file
of its own under this folder, found by that name:

- ``configs/<config>.json``: the dataset generator and its sizes, the
  sampler and its arguments, the plain reference, the source;
- ``traffic/<traffic>.json``: the chains, the sampler arguments of the
  route, the burn-in, the block of one ``sample()`` call, the kernels
  the cell loads, the correctness sample and the limits;
- ``generators/<generator>.py``: ``generate(params, data_seed)``;
- ``reference/<reference>.py``: ``build(data, args, device, control)``;
- ``metrics/<metric>.py``: ``read(ctx)`` of one per-layer metric.

Nothing here names a cell: a new cell is new files and new entries.
"""

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(path=None):
    with open(path or ROOT / 'BENCHMARK.json') as fh:
        return json.load(fh)


def _json(kind, name):
    path = HERE / kind / f'{name}.json'
    if not path.is_file():
        raise FileNotFoundError(f'no {kind[:-1]} file {path.name} under '
                                f'{HERE.name}/{kind}')
    with open(path) as fh:
        return json.load(fh)


def config(name):
    return _json('configs', name)


def traffic(name):
    return _json('traffic', name)


def cell(bench, workload):
    """The workload entry ``workload`` of ``bench`` with its
    configuration and traffic files read, and the metrics that apply to
    it: ``end_to_end`` and ``per_layer`` are the entries whose
    ``workloads`` list names it, or that have none."""
    found = [w for w in bench['workloads'] if w['name'] == workload]
    if not found:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
    w = dict(found[0])

    def applies(m):
        return 'workloads' not in m or workload in m['workloads']

    w['config_spec'] = config(w['config'])
    w['traffic_spec'] = traffic(w['traffic'])
    w['end_to_end'] = [m for m in bench['end_to_end'] if applies(m)]
    w['per_layer'] = [m for m in bench['per_layer'] if applies(m)]
    return w


def generator(name):
    return importlib.import_module(f'{__package__}.generators.{name}')


def reference(name):
    return importlib.import_module(f'{__package__}.reference.{name}')


def metric(name):
    """The module of per-layer metric ``name`` (its file name is the
    metric's name, dots and all)."""
    path = HERE / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'{__package__}.metrics.{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks():
    with open(HERE / 'peaks.json') as fh:
        return json.load(fh)
