"""Eta solve by library products (``ops/cg.py`` ``'xla'``, the stencil's
DCT preconditioner in ``ops/stencil.py``, the graph's banded tiles and
deflation products in ``ops/graph.py``): device time of the kernels whose
names mark them as cuBLAS or CUTLASS matrix products, per Gibbs step, in
milliseconds. Every such product of a step belongs to the eta update
except the dense regime's noise product and tau's quadratic form."""

import re

#: names of matrix-product kernels of cuBLAS and CUTLASS on the H100
PATTERN = re.compile(r'gemm|gemv|xmma|cutlass|Kernel2', re.IGNORECASE)
#: the port's own kernels, never counted here
OWN = re.compile(r'icar_cg_kernel|pg_devroye_kernel')


def read(ctx):
    sec, count = ctx['trace'].time_of(
        lambda name: bool(PATTERN.search(name)) and not OWN.search(name))
    if count == 0:
        return None
    return 1e3 * sec / ctx['steps']
