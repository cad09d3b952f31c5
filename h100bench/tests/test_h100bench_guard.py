"""The JAX check, and the command's refusal to run without a card or
without the program beside it."""

import json
import os
import shutil
import subprocess
import sys

from h100bench import guard, spec


def test_forbidden_by_whole_top_level_name():
    mods = ['jax', 'jax.numpy', 'jaxlib.xla_client', 'flax.linen',
            'occuspytial_tpu', 'occuspytial_tpu.models.logit',
            'occuspytial_tpu_torch', 'occuspytial_tpu_torch.models',
            'jaxtyping', 'numpy']
    assert guard.forbidden_modules(mods) == sorted(mods[:6])


def _run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', **(extra_env or {}))
    return subprocess.run(
        [sys.executable, '-m', 'h100bench.run', '--workload',
         'icar1k.k3.c64', '--seed', str(2 ** 31 + 7), '--seconds', '1',
         '--trace', '0'],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_harness_alone_in_a_directory_fails(tmp_path):
    shutil.copy(spec.ROOT / 'BENCHMARK.json', tmp_path)
    paths = json.loads((spec.ROOT / 'BENCHMARK.json').read_text())['paths']
    for p in paths:
        shutil.copytree(spec.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns('__pycache__'))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_harness_imports_no_jax():
    code = ('import sys; import h100bench.run, h100bench.control, '
            'h100bench.reference.logit_icar; '
            'from h100bench import guard; '
            'print(guard.forbidden_modules())')
    out = subprocess.run([sys.executable, '-c', code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
