"""Entropic optimal transport (log-domain Sinkhorn) in PyTorch.

Counterpart of moda_tpu/ops/sinkhorn.py: the debiased Sinkhorn divergence
behind the bone-location regularizer (geomloss SamplesLoss("sinkhorn",
p=2, blur) semantics, eps = blur^2), fixed iteration counts.
"""
from __future__ import annotations

import math

import torch


def _cost_p2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C_ij = |x_i - y_j|^2 / 2."""
    sq = (x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :] - 2.0 * x @ y.T
    return 0.5 * torch.clamp(sq, min=0.0)


def _sinkhorn_potentials(C, a_log, b_log, eps, iters):
    f = torch.zeros(C.shape[0], dtype=C.dtype, device=C.device)
    g = torch.zeros(C.shape[1], dtype=C.dtype, device=C.device)
    for _ in range(iters):
        g = -eps * torch.logsumexp((f[:, None] - C) / eps + a_log[:, None], 0)
        f = -eps * torch.logsumexp((g[None, :] - C) / eps + b_log[None, :], 1)
    return f, g


def ot_cost(x, y, eps=0.0025, iters=50):
    """<pi, C> under entropic OT with uniform marginals."""
    n, m = x.shape[0], y.shape[0]
    a_log = torch.full((n,), -math.log(n), device=x.device)
    b_log = torch.full((m,), -math.log(m), device=x.device)
    f, g = _sinkhorn_potentials(_cost_p2(x, y), a_log, b_log, eps, iters)
    return (torch.exp(a_log) * f).sum() + (torch.exp(b_log) * g).sum()


def sinkhorn_divergence(x, y, blur=0.05, iters=50):
    """S_eps = OT(x,y) - (OT(x,x) + OT(y,y)) / 2."""
    eps = blur ** 2
    return (ot_cost(x, y, eps, iters) - 0.5 * ot_cost(x, x, eps, iters)
            - 0.5 * ot_cost(y, y, eps, iters))
