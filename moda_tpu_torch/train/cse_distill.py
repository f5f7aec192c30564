"""CSE feature distillation: fit the CSE net to precomputed surface
embeddings. The port of moda_tpu/train/cse_distill.py: minimize
||CSENet(img) - feat||^2 over masked pixels with AdamW (torch's AdamW has
optax.adamw's betas, epsilon and decoupled weight decay), so the net can
(re)generate the Densepose features of preprocessing.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from moda_tpu_torch.fields.cse import CSENet
from moda_tpu_torch.runtime import Device, resolve_device


class CSEDistiller:
    def __init__(self, lr: float = 1e-4, seed: int = 0, device: Device = None):
        """Runs on the card unless device="cpu" is passed; the net's
        initializer draws from a generator seeded with ``seed``."""
        self.device = resolve_device(device)
        self.net = CSENet(generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.opt = torch.optim.AdamW(self.net.parameters(), lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def step(self, imgs, feats, masks) -> torch.Tensor:
        """One AdamW step on a batch: imgs [N,S,S,3], feats [N,S/2,S/2,16],
        masks [N,S/2,S/2,1]. Returns the loss before the step."""
        imgs, feats, masks = self._t(imgs), self._t(feats), self._t(masks)
        pred = self.net(imgs)
        err = ((pred - feats) ** 2).sum(-1, keepdim=True) * masks
        loss = err.sum() / torch.clamp(masks.sum(), min=1.0)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def train(self, batches: Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]],
              steps: int):
        """``steps`` steps from ``batches``, which yield (imgs, feats, masks)
        as ``step`` takes them. Returns the losses."""
        losses = [self.step(*b) for _, b in zip(range(steps), batches)]
        return [float(v) for v in losses]

    @torch.no_grad()
    def predict(self, imgs: np.ndarray) -> np.ndarray:
        return self.net(self._t(imgs)).cpu().numpy()
