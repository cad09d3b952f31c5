"""K3's operand preparation on the CPU (``ops/cuda_cg.py:k3_operands``).

The CUDA kernel (``csrc/icar_cg.cu``) multiplies the vector batch by U
and by U' on the tensor cores in TF32, each operand split into a head
and a remainder ("3xTF32": lo*hi + hi*lo + hi*hi), and reads both
eigenbases K-major from one (4, n, ld) tensor made once per sampler.
The kernel runs only on the card; these tests hold what surrounds it
here: the prepared operands' layout and split, and a plain emulation of
the kernel's product built from them against the JAX kernel's two
products (``occuspytial_tpu/ops/pallas_cg.py:_cg_kernel``: ``jnp.dot(v,
u)`` and ``_dot_ut``, the ``dot_general`` contracting U's second
dimension), on the same numpy-seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from occuspytial_tpu_torch import LogitICARGibbs
from occuspytial_tpu_torch.ops.cuda_cg import (
    k3_operands,
    row_stride,
    tf32_split,
)
from occuspytial_tpu_torch.utils import make_data

torch.set_num_threads(1)

#: low mantissa bits a TF32 number leaves clear
TF32_LOW = 0x1FFF


def _orthogonal(n, seed):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.standard_normal((n, n)))[0].astype(np.float32)


def _bits(t):
    return t.contiguous().view(torch.int32).numpy().astype(np.int64) \
        & 0xFFFFFFFF


@pytest.mark.parametrize('n', [64, 333, 1000])
def test_operands_layout_and_split(n):
    """Shape (4, n, ld) with ld = n rounded up to 4 (TMA's 16-byte rows),
    zero padding, heads and remainders with the low 13 mantissa bits
    clear, head + remainder within 2**-22 |U| of U, and the second pair
    the split of U' (the K-major operand of ``w U``)."""
    u = _orthogonal(n, seed=n)
    ops = k3_operands(torch.from_numpy(u))
    ld = row_stride(n)
    assert ld % 4 == 0 and n <= ld < n + 4
    assert ops.shape == (4, n, ld) and ops.dtype == torch.float32
    assert ops.is_contiguous() and ops.stride(1) == ld
    assert torch.count_nonzero(ops[:, :, n:]) == 0
    for i, want in enumerate((u, u.T)):
        head, rest = ops[2 * i, :, :n], ops[2 * i + 1, :, :n]
        assert not (_bits(head) & TF32_LOW).any()
        assert not (_bits(rest) & TF32_LOW).any()
        whole = head.double() + rest.double()
        err = np.abs(whole.numpy() - want.astype(np.float64))
        assert (err <= 2.0 ** -22 * np.abs(want)).all()
        # the head is the nearest TF32 number: within half its last place
        assert (np.abs(head.numpy().astype(np.float64) - want)
                <= 2.0 ** -11 * np.abs(want)).all()


def test_split_matches_the_kernel_bits():
    """The kernel's integer split on hand-picked values: a tie rounds
    away from zero in magnitude (the +0x1000 carry), negatives split as
    their magnitudes do, zero and powers of two are their own heads."""
    x = torch.tensor([1.0, -1.0, 0.0, 2.0 ** -20, 1.0 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-38,
                      1.0e30], dtype=torch.float32)
    head, rest = tf32_split(x)
    bits = _bits(x)
    want = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    assert np.array_equal(head.numpy(), want)
    assert head[4] == 1.0 + 2.0 ** -10 and head[5] == -(1.0 + 2.0 ** -10)
    assert head[6] == 1.0 and rest[6] == 2.0 ** -12
    assert torch.equal(head[:4], x[:4]) and not rest[:4].any()
    d = (x - head).numpy()
    want_rest = (_bits(torch.from_numpy(d)) & 0xFFFFE000).astype(
        np.uint32).view(np.float32)
    assert np.array_equal(rest.numpy(), want_rest)


def _emulate(v, head_b, rest_b):
    """The kernel's product of v (rows, n) with B given K-major as
    (cols, n) head and remainder: v split as the kernel splits it in
    registers, lo*hi + hi*lo + hi*hi summed exactly (float64)."""
    vh, vl = (t.double() for t in tf32_split(torch.from_numpy(v)))
    bh, bl = head_b.double(), rest_b.double()
    return (vl @ bh.T + vh @ bl.T + vh @ bh.T).numpy()


@pytest.mark.parametrize('n', [64, 333, 1000])
def test_emulated_products_match_the_jax_kernel(n):
    """Both products from the prepared operands against the JAX kernel's
    ``jnp.dot(v, u)`` (``b_spec``, ``w U``) and ``_dot_ut`` (``v U'``).
    Tolerance 1e-6 of sum_k |v_k| |u_k| per element: the split drops
    lo*lo and keeps each factor to 2**-22 of itself (~5e-7 of that sum
    at most, ~1e-8 in practice), and a float32 dot's rounding is ~6e-8
    of it; 1e-6 is well above both and far below a wrong layout or a
    transposed operand (errors of order 1)."""
    u = _orthogonal(n, seed=7 + n)
    rng = np.random.default_rng(n)
    v = rng.standard_normal((2 * 6, n)).astype(np.float32)
    ops = k3_operands(torch.from_numpy(u))[:, :, :n]
    uj, vj = jnp.asarray(u), jnp.asarray(v)
    dot_u = np.asarray(jnp.dot(vj, uj, preferred_element_type=jnp.float32))
    dot_ut = np.asarray(lax.dot_general(
        vj, uj, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ))
    # v U reads U' K-major (operands 2, 3); v U' reads U (operands 0, 1)
    for got, want, scale in (
        (_emulate(v, ops[2], ops[3]), dot_u, np.abs(v) @ np.abs(u)),
        (_emulate(v, ops[0], ops[1]), dot_ut, np.abs(v) @ np.abs(u).T),
    ):
        assert got.shape == want.shape == (12, n)
        assert (np.abs(got - want) <= 1e-6 * scale).all()
    # and against the exact product: the emulation is float32-accurate,
    # not merely TF32-accurate (a TF32 product alone is off by ~1e-3)
    exact = v.astype(np.float64) @ u.astype(np.float64)
    assert (np.abs(_emulate(v, ops[2], ops[3]) - exact)
            <= 2.0 ** -20 * (np.abs(v) @ np.abs(u))).all()


def test_pallas_on_the_cpu_is_the_plain_solve():
    """``cg_impl='pallas'`` on the CPU runs the plain solve: the same
    draws and final carry as ``'xla'`` bit for bit, and no prepared
    operands in ``fixed`` (they are made only on the card)."""
    Q, W, X, y, *_ = make_data(n=150, ns=100, p=3, q=2, random_state=5)
    runs = {}
    for impl in ('xla', 'pallas'):
        s = LogitICARGibbs(Q, W, X, y, random_state=5, solver='cg',
                           cg_impl=impl, device='cpu')
        assert 'k3_operands' not in s.fixed
        post = s.sample(6, burnin=2, chains=2, progressbar=False)
        runs[impl] = (post, s.final_carry)
    (px, cx), (pp, cp) = runs['xla'], runs['pallas']
    for name in ('alpha', 'beta', 'tau'):
        assert np.array_equal(np.asarray(px[name]), np.asarray(pp[name]))
    for name, val in cx.states.items():
        assert torch.equal(val, cp.states[name]), name

