"""The collapsed probit RSR sweep through the hand-written CUDA kernel.

The q-space part of ``ProbitRSRGibbs``'s collapsed beta and eta draws in
one launch of ``csrc/collapsed_rsr.cu``: one block a chain factors A =
tau Q_rsr + K'K/2 in shared memory, takes the beta draw's right-hand
sides and the eta draw through the factor, and draws beta (p x p) and
eta. It replaces no Pallas kernel (the JAX package leaves these draws to
XLA). ``ProbitRSRGibbs`` takes it for float32 CUDA tensors whose sizes
:func:`fit <fits>` (:func:`takes_kernel`); every other case runs the torch
ops of ``models/probit.py``, the plain version. A chain's bits depend on
its own inputs alone: the same at every chain count and from launch to
launch.
"""

import ctypes

import torch

from .. import _build
from .mvnorm import _UNROLL_DIM

#: the kernel's largest basis dimension (``kMaxQ`` of the source): A lives
#: in shared memory with room for two blocks an SM
MAX_Q = 128
#: the kernel's most covariates (``kMaxP``): the unrolled p x p draw's
MAX_P = _UNROLL_DIM

_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def fits(q, p):
    """Whether a basis of ``q`` columns and ``p`` covariates fit the
    kernel's on-chip budget."""
    return 1 <= q <= MAX_Q and 1 <= p <= MAX_P


def takes_kernel(q, p, device, dtype):
    """Whether the collapsed sweep runs as the kernel: float32 on a CUDA
    device, sizes that :func:`fit <fits>`."""
    return (torch.device(device).type == 'cuda' and dtype == torch.float32
            and fits(q, p))


def load():
    """The kernel's library, built first if needed (``nvcc``, seconds)."""
    lib = _build.load('collapsed_rsr')
    lib.collapsed_rsr_launch.argtypes = _ARGTYPES
    lib.collapsed_rsr_launch.restype = ctypes.c_int
    lib.collapsed_rsr_blocks_per_sm.restype = ctypes.c_int
    return lib


def collapsed_rsr_cuda(tau, ku, xu, eps_beta, eps_eta, fixed):
    """The collapsed (beta, eta) draws of one sweep in one kernel launch.

    ``tau`` (chains,), ``ku`` = K'u and ``eps_eta`` (chains, q), ``xu`` =
    X'u and ``eps_beta`` (chains, p), ``fixed`` the sampler's arrays
    (``Q_rsr``, ``KTK``, ``KTX``, ``XTX``, ``b_prec``, ``b_prec_by_mu``),
    all float32 on one CUDA device, sizes that :func:`fit <fits>`. Raises
    on anything else. Returns ``(beta, eta)``: beta ~ its collapsed
    conditional (eta and eps integrated out) and eta | beta, as
    ``ProbitRSRGibbs._update_beta_collapsed`` and
    ``_update_eta_collapsed`` draw them from the same noise; a chain whose
    A is not positive definite comes out NaN. Each launch adds one to
    ``collapsed_rsr_cuda.counter`` on the card (:class:`.._build.
    LaunchCounter`); the first launch on a device must come before any
    capture.
    """
    dev = tau.device
    if dev.type != 'cuda':
        raise ValueError(f'the collapsed RSR kernel runs on CUDA, not {dev}')
    if ku.dim() != 2 or xu.dim() != 2:
        raise ValueError('expected ku (chains, q) and xu (chains, p)')
    (chains, q), p = ku.shape, xu.shape[-1]
    if not fits(q, p):
        raise ValueError(
            f'q = {q}, p = {p} exceed the kernel\'s q <= {MAX_Q}, '
            f'p <= {MAX_P}'
        )
    # the per-chain inputs, then the fixed arrays the kernel reads
    shapes = {'Q_rsr': (q, q), 'KTK': (q, q), 'KTX': (q, p), 'XTX': (p, p),
              'b_prec': (p, p), 'b_prec_by_mu': (p,)}
    tensors = {'tau': (tau, (chains,)), 'ku': (ku, (chains, q)),
               'xu': (xu, (chains, p)), 'eps_beta': (eps_beta, (chains, p)),
               'eps_eta': (eps_eta, (chains, q))}
    tensors.update({k: (fixed[k], shape) for k, shape in shapes.items()})
    for name, (t, shape) in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(
                f'the collapsed RSR kernel takes float32, got {name} '
                f'{t.dtype}'
            )
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, tau on {dev}')
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f'{name} has shape {tuple(t.shape)}, expected {tuple(shape)}'
            )
    args = [t.contiguous() for t, _ in tensors.values()]
    beta = torch.empty((chains, p), device=dev, dtype=torch.float32)
    eta = torch.empty((chains, q), device=dev, dtype=torch.float32)
    lib = load()
    launches = collapsed_rsr_cuda.counter.pointer(dev)
    with torch.cuda.device(dev):
        err = lib.collapsed_rsr_launch(
            *(a.data_ptr() for a in args), beta.data_ptr(), eta.data_ptr(),
            launches, chains, q, p,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, 'collapsed_rsr', err)
    return beta, eta


collapsed_rsr_cuda.counter = _build.LaunchCounter('collapsed_rsr')
