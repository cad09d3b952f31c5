"""Tiny cells for the harness's CPU tests: the configurations' files with
their sizes cut to a few hundred sites, run on the program's plain
path."""

import pytest

from h100bench import spec

#: sizes a CPU test holds, by generator
TINY_DATA = {
    'make_data': {'n': 150, 'ns': 75, 'lattice': [10, 15]},
    'lattice': {'rows': 12, 'cols': 14, 'ns': 80},
}


def tiny_cell(workload, chains=4, **traffic):
    """The workload's cell with tiny data, ``chains`` chains, 4-step
    burn-in and blocks, and ``traffic`` overriding the route. A workload
    that ``BENCHMARK.json`` does not list is read as ``<config>.<traffic>``
    from the files (a route kept for a later cell)."""
    bench = spec.load_benchmark()
    if workload not in {w['name'] for w in bench['workloads']}:
        config, name = workload.split('.', 1)
        bench = dict(bench, workloads=[{'name': workload, 'config': config,
                                        'traffic': name, 'chips': 1}])
    cell = spec.cell(bench, workload)
    cfg = dict(cell['config_spec'])
    cfg['data'] = dict(cfg['data'], **TINY_DATA[cfg['generator']])
    tr = dict(cell['traffic_spec'], chains=chains, burnin=4, block=4,
              check_blocks=3, settle_seconds=0, **traffic)
    args = dict(tr.get('sampler_args', {}))
    if 'lattice' in args:
        d = cfg['data']
        args['lattice'] = [d['rows'], d['cols'], args['lattice'][2]]
    tr['sampler_args'] = args
    return dict(cell, config_spec=cfg, traffic_spec=tr)


@pytest.fixture
def tiny():
    """:func:`tiny_cell`."""
    return tiny_cell


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card; the CPU tests hold the control flow')
    return torch.device('cuda')
