"""Build the CUDA kernels from ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is a plain-C shared library compiled by ``nvcc``
for ``sm_90a`` (Hopper) into ``build/occuspytial_tpu_torch/`` beside the
package, and loaded with ``ctypes``. The file name carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused. :func:`build` starts one ``nvcc`` per source, all together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'build' / \
    'occuspytial_tpu_torch'

#: no --use_fast_math: the kernels use the IEEE-accurate math library
FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_LIBS = {}


def sources():
    """Kernel names (source file stems) in ``csrc/``."""
    return sorted(p.stem for p in SOURCE_DIR.glob('*.cu'))


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on ``PATH``,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get('CUDA_HOME')
    if home and Path(home, 'bin', 'nvcc').exists():
        return str(Path(home, 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def _target(name):
    src = (SOURCE_DIR / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'{name}-{digest[:16]}.so'


def build(names=None):
    """Compile the named kernels (default: all) that are not built yet.

    Returns name -> (seconds, compiler log) for each kernel compiled now;
    the log holds ``ptxas -v``'s registers and shared memory per kernel.
    Raises with the compiler's output when a build fails.
    """
    names = sources() if names is None else list(names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *FLAGS, '-o', str(tmp), str(SOURCE_DIR / f'{name}.cu')]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, time.perf_counter(),
        )
    out, failed = {}, []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        out[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f'{name}:\n{log}')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return out


def load(name):
    """The loaded shared library of kernel ``name``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check(lib, prefix, err):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        fn = getattr(lib, f'{prefix}_error_string')
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f'{prefix} launch failed: CUDA error {err} '
            f'({fn(err).decode()})'
        )
