"""Eval-time full-image rendering with host-level ray chunking: counterpart
of moda_tpu/render/evalrender.py (the reference's render_vid,
train_utils.py:1344-1362, and the chunked loop of nerf_render,
moda.py:874-899).

Each chunk holds a fixed number of rays, the last one padded by repeating
its last ray, as in the JAX package (whose fixed size keeps one compiled
program); outputs are cut back to the frame's rays. A chunk's rays are not
independent everywhere: the VolSDF ``beta_min`` floor reads the mean
near-far span of the chunk, so the chunk size and the padding are part of
the result in both packages.

Renders run on the plain fp32 view (``MoDAModel.precise()``) under
``torch.no_grad()``: no kernel launch, no graph. Random draws follow
render/pipeline.py's ``draws`` idiom: a ``draws`` dict, shaped for one
chunk, is applied to every chunk, as the JAX renderer passes one key to
every chunk; without it each chunk draws from ``generator``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from moda_tpu_torch.render import rays as RB
from moda_tpu_torch.render.pipeline import Draws, render_rays


def make_frame_renderer(model, render_size: int, ndepth: int, chunk: int = 32768,
                        with_flow: bool = False):
    """Returns ``render_frame(rtk [1,4,4], kaug [1,4], frameid [1], dataid [1],
    rtk_target=None, frameid_target=None, draws=None, generator=None)`` ->
    dict of numpy images [render_size, render_size, C]. with_flow and a
    target camera render flo_coarse against the paired frame (the eval
    grid, train_utils.py:500-505) through the full fine_iter pass."""
    view = model.precise()

    @torch.no_grad()
    def render_frame(rtk, kaug, frameid, dataid, rtk_target=None, frameid_target=None,
                     draws: Optional[Draws] = None,
                     generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
        dev = view.device

        def put(x, dtype=None):
            return None if x is None else torch.as_tensor(x, dtype=dtype, device=dev)

        flow = with_flow and rtk_target is not None
        rays = RB.build_rays_image(
            view, put(rtk, torch.float32), put(kaug, torch.float32), put(frameid).long(),
            put(dataid).long(), render_size,
            rtk_target=put(rtk_target, torch.float32) if flow else None,
            frameid_target=put(frameid_target).long() if flow else None)
        R = rays["rays_o"].shape[0]
        outs = []
        for c0 in range(0, R, chunk):
            piece = {}
            for k, v in rays.items():
                if v.dim() >= 1 and v.shape[0] == R:
                    v = v[c0:c0 + chunk]
                    if v.shape[0] < chunk:
                        v = torch.cat([v, v[-1:].expand((chunk - v.shape[0],) + v.shape[1:])])
                piece[k] = v
            outs.append(render_rays(view, piece, ndepth, fine_iter=flow, perturb=0.0,
                                    draws=draws, generator=generator))
        return {k: torch.cat([o[k] for o in outs])[:R].cpu().numpy()
                .reshape(render_size, render_size, -1) for k in outs[0]}

    return render_frame
