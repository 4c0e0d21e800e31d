"""The reference's inverse-rendering steps: loss, gradients and Adam.

A step renders ``spp`` samples of every pixel (samples 0..spp-1, one
stratum, no MIS) under the step's seed, takes the mean over the frame of
the squared error against the target, and moves the trainable fields by
Adam (Kingma and Ba, 2015: beta1 0.9, beta2 0.999, eps 1e-8, bias
corrected). The frame is rendered in blocks of pixels and each block's
loss is differentiated at once, so the gradients are sums over blocks,
kept in float64, as are Adam's moments and its arithmetic. The parameters
are stored as float32 values after each update, the precision the
configuration states for them: late in a run a step moves a parameter by
little more than float32's resolution, and a float64 parameter would part
from the program's by that rounding alone.
"""
from __future__ import annotations

import torch

from .integrator import trace_sample

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


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
