"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from h100bench import judge, spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
LINE = re.compile(r'^[^\t\n]{1,200}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


@pytest.fixture(scope='module')
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= len(bench['command']) <= 32
    assert all(LINE.match(w) for w in bench['command'])
    for p in bench['paths']:
        assert re.match(r'^[A-Za-z0-9_./-]{1,200}$', p)
        assert not p.startswith('/') and '..' not in p.split('/')
        assert not p.endswith('_torch')
    assert 1 <= bench['run_seconds'] <= 51
    assert isinstance(bench['run_seconds'], int)
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    names = [e['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for e in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ('configs', 'workloads'):
        assert len({e['name'] for e in bench[k]}) == len(bench[k])
    metrics = bench['end_to_end'] + bench['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES


def test_entries(bench):
    cells = {w['name'] for w in bench['workloads']}
    e2e = {m['name'] for m in bench['end_to_end']}
    assert 'setup_s' in e2e
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith(bench['paths'][0] + '/')
        assert LINE.match(c['source']) and LINE.match(c['why'])
        assert any(w['config'] == c['name'] for w in bench['workloads'])
    pairs = set()
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and LINE.match(w['why'])
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
    for m in bench['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    layers = {}
    for m in bench['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                          'source', 'layer', 'moves'}
        assert m['moves'] in e2e and LINE.match(m['layer'])
        assert set(m.get('workloads', cells)) <= cells
        layers.setdefault(m['layer'].split(' (')[0], set()).add(m['layer'])
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
    # one module, one spelling of its layer
    assert all(len(v) == 1 for v in layers.values())
    for w in bench['workloads']:
        has = [m for m in bench['per_layer']
               if w['name'] in m.get('workloads', [w['name']])]
        assert has and len(e2e) >= 2


def test_every_named_file_is_found(bench):
    for w in bench['workloads']:
        cell = spec.cell(bench, w['name'])
        cfg, tr = cell['config_spec'], cell['traffic_spec']
        assert cfg['name'] == w['config']
        assert hasattr(spec.generator(cfg['generator']), 'generate')
        assert hasattr(spec.reference(cfg['reference']), 'build')
        for key in ('chains', 'block', 'burnin', 'check_blocks',
                    'check_steps', 'limits'):
            assert key in tr, (w['traffic'], key)
        assert judge.STAT in tr['limits']
    for m in bench['per_layer']:
        assert callable(spec.metric(m['name']).read)


def test_unknown_names_raise(bench):
    with pytest.raises(KeyError):
        spec.cell(bench, 'no.such.cell')
    with pytest.raises(FileNotFoundError):
        spec.traffic('no.such.traffic')
