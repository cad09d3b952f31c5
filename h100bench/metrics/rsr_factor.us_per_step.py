"""Collapsed RSR factor (``models/probit.py``: ``ProbitRSRGibbs.
_collapsed_factor`` and the triangular solves of the collapsed beta and
eta draws): device time of the batched Cholesky factor and its
triangular solves per Gibbs step, in microseconds, by the names of the
kernels that compute them. On the H100 (torch 2.11, CUDA 12.8) the
factor is cuSOLVER's batched ``potrf`` (``potrf_cta_lower_batch``,
``potrf_syrk_*``, ``potrfBatch_trsm_lower``) and the zeroing of its upper
triangle (``triu_tril_kernel``), and each solve is cuBLAS's batched
``trsm`` (``batch_trsm_left_kernel``, two launches at q = 128) with its
pointer set-up (``offsetPointerArray_kernel``). The copies torch makes
of the operands are not counted: their kernels have no name of their
own. None where no such kernel ran."""

import re

#: the factor's and the solves' kernels (MAGMA's potrf too, should torch
#: route the factor there)
PATTERN = re.compile(r'potrf|trsm|trsv|offsetPointerArray|triu_tril',
                     re.IGNORECASE)


def read(ctx):
    sec, count = ctx['trace'].time_of(PATTERN.search)
    if count == 0:
        return None
    return 1e6 * sec / ctx['steps']
