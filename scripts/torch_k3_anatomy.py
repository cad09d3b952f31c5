#!/usr/bin/env python3
"""Take K3 (``csrc/icar_cg.cu``) apart on the card: where a solve's time goes.

Run from the repository root on a machine with one CUDA card:
``python3 scripts/torch_k3_anatomy.py``. It writes copies of the kernel's
source into ``build/occuspytial_tpu_torch/k3_anatomy/`` (text substitutions
of the shipped source; the package keeps no variant), builds them with the
package's flags and runs each at the main path's shapes (64 chains x 6
rows x n = 1000, 8 iterations; a random orthogonal U):

- ``traced``: the shipped kernel plus a clock read (``%globaltimer``) by
  thread 0 of every block at the end of each product's k-loop, of its
  epilogue, of each row pass and of each grid barrier; prints the median
  over blocks and phases of each part;
- ``no_copy``: the ring's protocol and the tensor-core work without the
  TMA copies (the stages keep stale data);
- ``no_mma``: the copies without the ``wgmma``;
- ``neither``: the ring's protocol, epilogues, row passes and barriers
  alone.

The variants' results are wrong by design; only their times are read. Each
solve is timed by CUDA events over a captured graph of 10 launches, the
shipped kernel first and last. Prints the card's name and power limit.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from occuspytial_tpu_torch import _build  # noqa: E402
from occuspytial_tpu_torch._device import resolve_device  # noqa: E402
from occuspytial_tpu_torch.ops import cuda_cg  # noqa: E402

OUT = _build.BUILD_DIR / 'k3_anatomy'
CHAINS, ROWS, N, ITERS = 64, 6, 1000, 8
#: events a block may record, and their names
EVENTS = 128
NAMES = {0: 'start', 1: 'k-loop', 2: 'epilogue', 3: 'barrier', 4: 'row pass'}

COPIES = '''        tma_2d(st, amap, kt * kBK, m0, &R.full[stage]);
        tma_3d(st + kABytes, &P.map_u, kt * kBK, n0, sel, &R.full[stage]);
'''
EXPECT = 'mbar_expect_tx(&R.full[stage], kStageBytes);'
MMA = '''            wgmma_tf32(lh, al[s], sw128_desc(b + 32 * s));
            wgmma_tf32_n96(hh, ah[s], sw128_desc(b + 32 * s));
'''


def _sub(src, pairs):
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f'csrc/icar_cg.cu has changed: {old[:60]!r}')
        src = src.replace(old, new)
    return src


def traced(src):
    """The shipped source with the clock reads (and room for them at the
    end of the scratch)."""
    rec = '''__device__ __forceinline__ void rec(const Params& P, int& ev, int id) {
    if (threadIdx.x == 0 && ev < %d) {
        P.trace[(blockIdx.x * %d + ev) * 2] = id;
        P.trace[(blockIdx.x * %d + ev) * 2 + 1] = global_ns();
        ++ev;
    }
}

// ------------------------------------------------------------ the ring --''' % (
        EVENTS - 1, EVENTS, EVENTS)
    src = _sub(src, [
        ('    unsigned long long* launches;',
         '    unsigned long long* trace;\n    unsigned long long* launches;'),
        ('// ------------------------------------------------------------ '
         'the ring --', rec),
        ('const CUtensorMap* amap1, int split, int jobs, uint32_t q) {',
         'const CUtensorMap* amap1, int split, int jobs, uint32_t q, '
         'int& ev) {'),
        ('        consume(P, R, wg, q);\n',
         '        consume(P, R, wg, q);\n        rec(P, ev, 1);\n'),
        ('        consumers_sync();  // the staged sums are read\n',
         '        consumers_sync();  // the staged sums are read\n'
         '        rec(P, ev, 2);\n'),
        ('                                          uint32_t q) {',
         '                                          uint32_t q, int& ev) {'),
        ('amap, amap, total, total, q);', 'amap, amap, total, total, q, ev);'),
        ('    uint32_t q = 0;  // k-slices through the ring, the same in every '
         'role\n',
         '    uint32_t q = 0;  // k-slices through the ring, the same in every '
         'role\n    int ev = 0;\n    rec(P, ev, 0);\n'),
        ('2 * total, q);', '2 * total, q, ev);'),
        ('        row_pass(P, it, true, it == P.iters - 1);\n',
         '        row_pass(P, it, true, it == P.iters - 1);\n'
         '        rec(P, ev, 4);\n'),
        ('        + ((size_t)chains + 3) / 4 * 4);',
         '        + ((size_t)chains + 3) / 4 * 4) + 1024 * %d * 4;' % EVENTS),
        ('    P.cbar = s + 2 * per_row;\n',
         '    P.cbar = s + 2 * per_row;\n    P.trace = (unsigned long long*)'
         '(P.cbar + ((size_t)chains + 3) / 4 * 4);\n'),
    ])
    for arr in ('map_w', 'map_p', 'map_x'):
        src = src.replace(f'(P, R, &P.{arr}, q);', f'(P, R, &P.{arr}, q, ev);')
    return src.replace('grid_barrier(grid);\n',
                       'grid_barrier(grid);\n    rec(P, ev, 3);\n')


def variants(src):
    no_copy = [(COPIES, ''), (EXPECT, 'mbar_expect_tx(&R.full[stage], 0);')]
    no_mma = [(MMA, '')]
    return {
        'shipped': src,
        'traced': traced(src),
        'no_copy': _sub(src, no_copy),
        'no_mma': _sub(src, no_mma),
        'neither': _sub(src, no_copy + no_mma),
    }


def build(sources):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f'{name}.cu'
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, '-o', str(OUT / f'{name}.so'),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'{name}:\n{log}')
        lib = ctypes.CDLL(str(OUT / f'{name}.so'))
        lib.icar_cg_launch.argtypes = cuda_cg._ARGTYPES
        lib.icar_cg_launch.restype = ctypes.c_int
        lib.icar_cg_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.icar_cg_scratch_floats.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    dev = resolve_device('cuda')
    libs = build(variants(
        (_build.SOURCE_DIR / 'icar_cg.cu').read_text()))
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.linalg.qr(torch.randn((N, N), device=dev, generator=gen))[0]
    ld = cuda_cg.row_stride(N)
    ops = cuda_cg.k3_operands(u.contiguous())
    s = torch.zeros(ld, device=dev)
    s[:N] = 8.0 * torch.rand(N, device=dev, generator=gen)
    rhs = torch.randn((CHAINS, ROWS, ld), device=dev, generator=gen)
    x0 = 0.1 * torch.randn((CHAINS, ROWS, ld), device=dev, generator=gen)
    om = 0.05 + 0.25 * torch.rand((CHAINS, ld), device=dev, generator=gen)
    tau = 0.5 + torch.rand(CHAINS, device=dev, generator=gen)
    x_site, x_spec = torch.empty_like(rhs), torch.empty_like(rhs)
    rel = torch.empty(CHAINS, device=dev)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)

    def launcher(lib, iters):
        scratch = torch.zeros(lib.icar_cg_scratch_floats(CHAINS, ROWS, N),
                              device=dev)

        def run():
            err = lib.icar_cg_launch(
                ops.data_ptr(), s.data_ptr(), rhs.data_ptr(), x0.data_ptr(),
                om.data_ptr(), tau.data_ptr(), x_site.data_ptr(),
                x_spec.data_ptr(), rel.data_ptr(), scratch.data_ptr(),
                counter.data_ptr(), CHAINS, ROWS, N, iters,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f'launch failed: {err}')
        return run, scratch

    def graph_ms(run):
        run()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(10):
                run()
        g.replay()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(5):
            g.replay()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / 50

    order = ['shipped', 'no_copy', 'no_mma', 'neither', 'shipped']
    for name in order:
        ms = {it: graph_ms(launcher(libs[name], it)[0]) for it in (0, ITERS)}
        print(f'{name:8s} iters={ITERS} {ms[ITERS]:.4f} ms, iters=0 '
              f'{ms[0]:.4f} ms, an iteration '
              f'{(ms[ITERS] - ms[0]) / ITERS * 1e3:.2f} us')

    run, scratch = launcher(libs['traced'], ITERS)
    run()
    torch.cuda.synchronize()
    total = libs['traced'].icar_cg_scratch_floats(CHAINS, ROWS, N)
    area = scratch[total - 1024 * EVENTS * 4:].view(torch.int64)
    trace = area.view(1024, EVENTS, 2).cpu().numpy()
    parts, start, end = {}, None, None
    for blk in trace:
        prev = None
        for ident, t in blk:
            if int(ident) not in NAMES or t <= 0:
                break
            if prev is not None:
                parts.setdefault(NAMES[int(ident)], []).append(
                    (t - prev) / 1e3)
            prev = t
            start = t if start is None else min(start, t)
            end = t if end is None else max(end, t)
    print(f'traced solve (iters={ITERS}): {(end - start) / 1e3:.1f} us from '
          'the first block start to the last event')
    for name in ('k-loop', 'epilogue', 'barrier', 'row pass'):
        v = np.asarray(parts[name])
        print(f'  {name:9s} median {np.median(v):.2f} us, p90 '
              f'{np.percentile(v, 90):.2f} us over {v.size} (block, phase)')
    print('  (barrier: from the block\'s last work of the phase to its exit '
          'from the grid barrier, so it holds the wait for slower blocks)')


if __name__ == '__main__':
    main()
