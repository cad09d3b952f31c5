"""Scalar log-tau move for the ASIS interweave, batched over chains.

Port of the JAX package's ``models/interweave.py``. The ancillary tau
conditional has the form

    log f(log t) = a0*log t - b0*t + A/sqrt(t) - C/t

and the move updates ``lt = log tau`` per chain:

- ``'mh'``: ``steps`` random-walk Metropolis sub-steps with proposal sd
  ``sd``;
- ``'slice'``: one Neal (2003) slice-sampling update with capped
  stepping-out and a shrinkage loop truncated at ``steps``.

:func:`ancillary_tau_move` runs the move and rescales the field, for the
logit and the probit samplers alike. Each move takes all of its noise up
front as arguments (the JAX version
draws it up front too), so a test can feed both versions the same draws;
:func:`noise_from_words` makes that noise from the sampler's stream.
"""

import torch

from .. import rng


def noise_words(method, steps):
    """32-bit words one move consumes per chain."""
    return 3 + steps if method == 'slice' else 3 * steps


def noise_from_words(w, method, steps, dtype):
    """The move's noise from (chains, noise_words) words: for 'mh'
    ``(normals, uniforms)`` of (chains, steps) each; for 'slice'
    ``(exponential, u_place, u_j, u_shrink)``."""
    if method == 'slice':
        u = rng.uniform(w, dtype)
        return -torch.log(u[:, 0]), u[:, 1], u[:, 2], u[:, 3:]
    return (
        rng.normal(w[:, :2 * steps], dtype),
        rng.uniform(w[:, 2 * steps:], dtype),
    )


def mh_log_move(lt0, logf, sd, steps, noise):
    """``steps`` random-walk MH sub-steps on ``lt0`` (chains,);
    ``noise = (normals, uniforms)``, each (chains, steps)."""
    normals, uniforms = noise
    props = normals * sd
    log_us = torch.log(uniforms)
    lt, f_lt = lt0, logf(lt0)
    for i in range(steps):
        prop = lt + props[:, i]
        f_prop = logf(prop)
        # logf(lt) is kept, not recomputed: the same value, half the ops
        accept = log_us[:, i] < f_prop - f_lt
        lt = torch.where(accept, prop, lt)
        f_lt = torch.where(accept, f_prop, f_lt)
    return lt


def slice_log_move(lt0, logf, width, steps, noise, expands=8):
    """One slice-sampling update of ``lt0`` (stepping-out + shrinkage);
    ``noise = (exponential, u_place, u_j, u_shrink (chains, steps))``."""
    e_y, u_place, u_j, us = noise
    y_level = logf(lt0) - e_y
    left = lt0 - width * u_place
    right = left + width
    # Neal's capped stepping-out: the expansion budget is split uniformly
    # between the two ends (required for exactness)
    j_cap = torch.floor(expands * u_j).to(torch.int32)
    k_cap = (expands - 1) - j_cap
    for i in range(expands):
        left = torch.where(
            (i < j_cap) & (logf(left) > y_level), left - width, left
        )
        right = torch.where(
            (i < k_cap) & (logf(right) > y_level), right + width, right
        )
    # shrinkage: the FIRST accepted proposal is the draw; a rejected one
    # becomes the bracket end on its side of lt0
    lt = lt0
    done = torch.zeros_like(lt0, dtype=torch.bool)
    for i in range(steps):
        prop = left + us[:, i] * (right - left)
        ok = (logf(prop) >= y_level) & ~done
        reject = ~done & ~ok
        lt = torch.where(ok, prop, lt)
        left = torch.where(reject & (prop < lt0), prop, left)
        right = torch.where(reject & (prop >= lt0), prop, right)
        done = done | ok
    return lt


def log_tau_move(lt0, logf, method, sd, steps, noise):
    """Dispatch on the configured ASIS move type."""
    if method == 'slice':
        return slice_log_move(lt0, logf, sd, steps, noise)
    return mh_log_move(lt0, logf, sd, steps, noise)


def ancillary_tau_move(s, spatial_a, a_lin, c_quad, a0, b0, method, sd,
                       steps, noise):
    """The ASIS tau interweave (Yu & Meng 2011) on state ``s``: a move of
    log tau under ``log f = a0*log t - b0*t + a_lin/sqrt(t) - c_quad/t``
    (the ancillary field ``spatial_a = sqrt(tau) * spatial`` held fixed),
    then eta and spatial rescaled to the new tau. Per-chain tensors."""
    def logf(log_t):
        t = torch.exp(log_t)
        return a0 * log_t - b0 * t + a_lin * torch.rsqrt(t) - c_quad / t

    rt = torch.sqrt(s['tau'])
    lt = log_tau_move(torch.log(s['tau']), logf, method, sd, steps, noise)
    new_t = torch.exp(lt)
    inv_rt = torch.rsqrt(new_t)
    s['tau'] = new_t
    s['eta'] = (rt[:, None] * s['eta']) * inv_rt[:, None]
    s['spatial'] = spatial_a * inv_rt[:, None]
    return s
