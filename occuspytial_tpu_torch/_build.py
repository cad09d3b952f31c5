"""Build the CUDA kernels from ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is a plain-C shared library compiled by ``nvcc``
for ``sm_90a`` (Hopper) into ``build/occuspytial_tpu_torch/`` beside the
package, and loaded with ``ctypes``. The file name carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused. :func:`build` starts one ``nvcc`` per source, all together.
Each kernel counts its own launches on the card (:class:`LaunchCounter`).
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


#: kernels that :func:`build` compiles only when named: the phase-span
#: marker, built at ``tracing.enable()``'s first call on CUDA
ON_REQUEST = ('span_mark',)


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
    """Compile the named kernels (default: every one in ``csrc/`` but
    those of :data:`ON_REQUEST`) that are not built yet.

    Returns name -> (seconds, compiler log) for each kernel compiled now;
    the log holds ``ptxas -v``'s registers and shared memory per kernel.
    Raises with the compiler's output when a build fails.
    """
    if names is None:
        names = [n for n in sources() if n not in ON_REQUEST]
    else:
        names = list(names)
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


class LaunchCounter:
    """Launches of one kernel, counted by the card: the wrapper passes the
    kernel a uint64 counter on the launch's device, and thread 0 of block
    0 of every launch adds one to it. A launch recorded into a CUDA graph
    is so counted at each replay, and a capture that launches nothing
    adds nothing.

    :attr:`launches` reads the device counters (a synchronisation) plus
    what was added on the host (another process's launches, read there);
    assigning it zeroes the device counters and sets the host part.
    :attr:`recorded` counts the launches recorded into stream captures
    (the kernel nodes of the graphs made), which launch nothing until
    a replay.
    """

    def __init__(self, name):
        self.name = name
        self._counters = {}
        self._host = 0
        self.recorded = 0

    def pointer(self, device):
        """The counter argument of one launch on ``device``: the device
        counter's address, made (zeroed) at the kernel's first launch
        there. Making it inside a stream capture would record its
        zeroing into the graph, so a capture raises unless the kernel has
        launched on the device before; a launch made inside a capture
        adds one to :attr:`recorded`."""
        import torch

        capturing = torch.cuda.is_current_stream_capturing()
        counter = self._counters.get(device.index)
        if counter is None:
            if capturing:
                raise RuntimeError(
                    f'{self.name}: first launch on {device} inside a '
                    'stream capture; launch it once before capturing'
                )
            counter = torch.zeros(1, dtype=torch.int64, device=device)
            self._counters[device.index] = counter
        if capturing:
            self.recorded += 1
        return counter.data_ptr()

    @property
    def launches(self):
        return self._host + sum(int(c.item())
                                for c in self._counters.values())

    @launches.setter
    def launches(self, value):
        for c in self._counters.values():
            c.zero_()
        self._host = int(value)
