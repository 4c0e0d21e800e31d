"""The reference's inverse-rendering steps over the lobes with sheen: a copy
of ``reference/inverse.py`` (loss, gradients and Adam) that departs from it
in two places only.

* ``loss_and_grads`` renders with this package's ``trace_sample`` (the
  lobe dispatch and container with the sheen lobe), not the original's;
  the step is the original's: ``spp`` samples of every pixel (samples
  0..spp-1, one stratum, no MIS) under the step's seed, the mean over the
  frame of the squared error against the target.
* ``run`` switches TF32 off for its steps (the camera's rays are matrix
  products, which a card would otherwise round to TF32), as the
  benchmark's command does for the whole run, so the reference is float32
  wherever it is called from.

The rest is the original's: the frame rendered in blocks of pixels, each
block's loss differentiated at once, the gradients summed over blocks in
float64, Adam's moments and arithmetic in float64 (Kingma and Ba, 2015:
beta1 0.9, beta2 0.999, eps 1e-8, bias corrected; the constants imported
from the original) and the parameters stored as float32 values after each
update.
"""
from __future__ import annotations

import torch

from reference.inverse import BETA1, BETA2, EPS

from .integrator import trace_sample


def loss_and_grads(tb, cam, tracer, px, py, target, params, seed, *, spp, max_depth, block):
    """(loss, {name: gradient}) of one step at float64 ``params``."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    n_valid = float(px.shape[0])
    total = 0.0
    for s0 in range(0, px.shape[0], block):
        bx, by, bt = px[s0:s0 + block], py[s0:s0 + block], target[s0:s0 + block]
        c = torch.zeros((bx.shape[0], 3), dtype=torch.float32, device=bx.device)
        for s in range(spp):
            r, _, _ = trace_sample(tb, cam, tracer, bx, by, s, seed, max_depth=max_depth,
                                   mis=False, strata=1, params=leaves)
            c = c + r
        e = c / spp - bt
        part = (e * e).sum()
        (part.to(torch.float64) / n_valid).backward()
        total += float(part.detach().to(torch.float64))
    return total / n_valid, {k: v.grad.detach() for k, v in leaves.items()}


def run(tb, cam, tracer, px, py, target, params, seeds, *, spp, max_depth, lr, block,
        state=None):
    """Steps of Adam from float64 ``params``, one a seed, from a fresh Adam
    or from ``state`` = (first moments, second moments, steps taken).
    Returns the losses, the first step's gradients, the parameters after
    the last step and the state then."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = {k: v.detach().clone() for k, v in params.items()}
    if state is None:
        state = ({k: torch.zeros_like(v) for k, v in p.items()},
                 {k: torch.zeros_like(v) for k, v in p.items()}, 0)
    m, s2, t0 = dict(state[0]), dict(state[1]), state[2]
    losses, first = [], None
    for i, seed in enumerate(seeds, start=t0 + 1):
        loss, g = loss_and_grads(tb, cam, tracer, px, py, target, p, seed, spp=spp,
                                 max_depth=max_depth, block=block)
        losses.append(loss)
        first = g if first is None else first
        for k in p:
            m[k] = BETA1 * m[k] + (1.0 - BETA1) * g[k]
            s2[k] = BETA2 * s2[k] + (1.0 - BETA2) * g[k] * g[k]
            mhat = m[k] / (1.0 - BETA1 ** i)
            vhat = s2[k] / (1.0 - BETA2 ** i)
            p[k] = (p[k] - lr * mhat / (torch.sqrt(vhat) + EPS)).to(torch.float32).to(p[k].dtype)
    return losses, first, p, (m, s2, t0 + len(seeds))
