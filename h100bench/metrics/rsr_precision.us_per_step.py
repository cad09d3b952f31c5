"""RSR q-space precision (``ops/mvnorm.py: rsr_mvnorm``): device time a
Gibbs step of the kernels that form, factor and solve with the reduced
basis precision Lambda = tau Q_rsr + K' diag(omega) K, in microseconds,
by the names of the kernels that compute them. On the H100 (torch 2.11,
CUDA 12.8) at (32, 1256, 1256): the product K' diag(omega) K is cuBLAS's
float32 GEMM (a name with ``gemm``); ``torch.linalg.cholesky_ex`` takes
cuSOLVER's batched factor (``potrf_cta_lower_batch``, ``potrf_syrk_*``,
``potrfBatch_trsm_lower``) and zeroes the upper triangle
(``triu_tril_kernel``); the two triangular solves of the mean are
cuBLAS's batched ``trsm`` (``batch_trsm_left_kernel``) with its pointer
set-up (``offsetPointerArray_kernel``). The step's other products are
GEMMs too and are caught with them. Forming the product's operand K'
diag(omega), tau Q_rsr and the sum are elementwise kernels with no name
of their own and are not counted. None where no such kernel ran."""

import re

#: the product's, the factor's and the solves' kernels
PATTERN = re.compile(r'gemm|syrk|potrf|trsm|trsv|offsetPointerArray|'
                     r'triu_tril', re.IGNORECASE)


def read(ctx):
    sec, count = ctx['trace'].time_of(PATTERN.search)
    if count == 0:
        return None
    return 1e6 * sec / ctx['steps']
