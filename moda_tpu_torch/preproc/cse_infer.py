"""DensePose-CSE pixel-embedding inference in PyTorch: counterpart of
moda_tpu/preproc/cse_infer.py (the reference's offline CSE features,
preprocess/libs/cselib.py ``run_cse``).

Given a BGR frame and its object mask, the predictor gives the 16 x 112 x
112 continuous-surface-embedding map of the mask's box and the
closest-vertex map against the mesh's vertex-embedding table. Only the
dense head of the known box runs (masks come from the segmentation stage):

  image -> ResNet50-FPN (fields/resnet_fpn.py) -> roi_align(p2, box)
        -> CSE head (8 conv3x3 of 512) -> ConvTranspose 4x4 stride 2 -> E=16

The graph is plain PyTorch (cuDNN convolutions on the card); no Pallas
kernel lies on this path. ``roi_align`` copies the JAX package's crop (one
sample a bin, clamped at size - 2), not torchvision's nor ``grid_sample``.
The frame is resized by cv2's float INTER_LINEAR and the vertex map by its
INTER_NEAREST, both through data/imageio.py.

Weights: the JAX package's converted tree (``convert_cse_checkpoint``, the
layout of cse.npz) enters through ``bridge.cse_from_jax``; the converters
here write that tree bit-equal to the JAX package's from a detectron2
checkpoint (``.pkl`` or ``.pth``, read by ``load_detectron2_state_dict``).
``reference_state_dict`` makes seeded random weights in detectron2's layout
at the published widths.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.fields.resnet_fpn import _hwio, convert_resnet50_fpn, reference_backbone_sd
from moda_tpu_torch.runtime import resolve_device

# detectron2 DensePose pixel means (BGR): the converted checkpoint's
# preprocessing contract, not a tunable
_PIXEL_MEAN = np.asarray([103.530, 116.280, 123.675], np.float32)
_PIXEL_STD = np.asarray([1.0, 1.0, 1.0], np.float32)
ROI_SIDE = 56          # p2 crop; the head doubles it to the 112 x 112 map
EMPTY_FEAT = (16, 112, 112)

HEAD_PREFIX = "roi_heads.densepose_head."
PRED_PREFIX = "roi_heads.densepose_predictor."


class CSEHead(torch.nn.Module):
    """DensePoseV1ConvXHead + the embedding predictor: ``n_convs`` conv3x3 +
    ReLU, then ConvTranspose(4, stride 2, padding 1) to ``embed_dim``.
    Named as the JAX head (``conv{i}``; the ConvTranspose ``predictor``
    crosses as ``predictor_kernel``/``predictor_bias``, bridge._leaves)."""

    def __init__(self, n_convs: int = 8, hidden: int = 512, embed_dim: int = 16,
                 cin: int = 256):
        super().__init__()
        self.n_convs, self.embed_dim = n_convs, embed_dim
        for i in range(n_convs):
            setattr(self, f"conv{i + 1}", torch.nn.Conv2d(cin if i == 0 else hidden, hidden, 3,
                                                          1, 1))
        self.predictor = torch.nn.ConvTranspose2d(hidden, embed_dim, 4, 2, 1)

    def forward(self, x):
        for i in range(self.n_convs):
            x = torch.relu(getattr(self, f"conv{i + 1}")(x))
        return self.predictor(x)


def normalize_image(imp: np.ndarray, device) -> torch.Tensor:
    """[S, S, 3] float32 BGR (zero padding included) -> [1, 3, S, S] on
    ``device``, normalised as detectron2 does: the padding reads -mean."""
    x = torch.from_numpy(np.ascontiguousarray(imp)).to(device)
    mean = torch.from_numpy(_PIXEL_MEAN).to(device)
    std = torch.from_numpy(_PIXEL_STD).to(device)
    return ((x - mean) / std).permute(2, 0, 1)[None]


def pad_resized(img: np.ndarray, size: int):
    """The frame scaled (cv2's float INTER_LINEAR) so its longer side is
    ``size``, zero-padded at the bottom and right to size x size; returns
    (padded, scale, (resized height, width))."""
    H, W = img.shape[:2]
    scale = size / max(H, W)
    imr = IO.resize(img.astype(np.float32), (int(round(W * scale)), int(round(H * scale))))
    imp = np.zeros((size, size, 3), np.float32)
    imp[: imr.shape[0], : imr.shape[1]] = imr
    return imp, scale, imr.shape[:2]


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int,
              spatial_scale: float) -> torch.Tensor:
    """Bilinear crops of ``feat`` [C, H, W] at ``boxes`` [N, 4] (x0, y0, x1,
    y1, image px) -> [N, C, out, out]; a box [4] gives [C, out, out].

    moda_tpu's ``roi_align`` (cse_infer.py:64-84) box by box: one sample at
    each bin's centre, the top-left tap clamped to [0, size - 2], its weight
    to [0, 1], in the same float32 arithmetic."""
    single = boxes.dim() == 1
    b = boxes.reshape(-1, 4) * spatial_scale
    H, W = feat.shape[1:]
    grid = torch.arange(out_size, dtype=torch.float32, device=feat.device) + 0.5
    ys = b[:, 1:2] + grid * (b[:, 3:4] - b[:, 1:2]) / out_size - 0.5
    xs = b[:, 0:1] + grid * (b[:, 2:3] - b[:, 0:1]) / out_size - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, H - 2).long()
    x0 = torch.clamp(torch.floor(xs), 0, W - 2).long()
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, :, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[:, None, :]
    yy, xx = y0[:, :, None], x0[:, None, :]
    f00, f01 = feat[:, yy, xx], feat[:, yy, xx + 1]        # [C, N, out, out]
    f10, f11 = feat[:, yy + 1, xx], feat[:, yy + 1, xx + 1]
    out = (f00 * (1 - wy) * (1 - wx) + f01 * (1 - wy) * wx
           + f10 * wy * (1 - wx) + f11 * wy * wx).transpose(0, 1)
    return out[0] if single else out


class CSEPredictor:
    """The pipeline's ``cse_fn``: (img_bgr_uint8 [H, W, 3], mask [H, W]) ->
    (feat [16, 112, 112] unit-norm embeddings, vert_map [H, W] closest
    mesh-vertex index inside the box times the mask (0 without a vertex
    table), bbox [4] xyxy: the mask's box padded by 2% of the longer side).
    An empty mask gives zeros and the full-frame box, as the JAX package's.

    Built from the JAX package's trees (cse.npz's ``backbone`` and
    ``head``) on ``device``: the card unless ``device="cpu"``. The graph
    runs under inference_mode; ``calls`` counts the frames it ran."""

    def __init__(self, backbone_params: Mapping, head_params: Mapping,
                 vertex_embeddings: Optional[np.ndarray] = None, input_size: int = 448,
                 device=None):
        from moda_tpu_torch.bridge import cse_from_jax

        self.device = resolve_device(device)
        self.backbone, self.head = cse_from_jax(
            {"backbone": backbone_params, "head": head_params}, self.device)
        self.vertex_embeddings = (None if vertex_embeddings is None
                                  else np.asarray(vertex_embeddings, np.float32))
        self._table = (None if vertex_embeddings is None
                       else torch.from_numpy(self.vertex_embeddings).to(self.device))
        self.input_size = int(input_size)
        self.calls = 0

    def embed(self, imp: np.ndarray, box: np.ndarray) -> torch.Tensor:
        """The padded input [S, S, 3] and the box in its pixels -> unit-norm
        embeddings [E, 112, 112] on the device."""
        with torch.inference_mode():
            p2 = self.backbone(normalize_image(imp, self.device))["p2"][0]
            roi = roi_align(p2, torch.from_numpy(box).to(self.device), ROI_SIDE, 0.25)
            emb = self.head(roi[None])[0]
            return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=0, keepdim=True),
                                     min=1e-8)

    def closest_vertices(self, emb: torch.Tensor) -> np.ndarray:
        """argmax over the table of emb . table -> [112, 112] vertex ids."""
        with torch.inference_mode():
            E = emb.shape[0]
            sims = emb.reshape(E, -1).T @ self._table.T
            return torch.argmax(sims, dim=-1).reshape(emb.shape[1:]).cpu().numpy()

    def __call__(self, img: np.ndarray, mask: np.ndarray):
        H, W = mask.shape
        ys, xs = np.nonzero(mask > 0)
        if len(ys) == 0:
            return (np.zeros(EMPTY_FEAT, np.float32), np.zeros((H, W), np.float32),
                    np.asarray([0, 0, W, H], np.float32))
        pad = 0.02 * max(H, W)
        box = np.asarray([max(xs.min() - pad, 0), max(ys.min() - pad, 0),
                          min(xs.max() + pad, W), min(ys.max() + pad, H)], np.float32)
        imp, scale, _ = pad_resized(img, self.input_size)
        emb = self.embed(imp, box * scale)
        vert_map = np.zeros((H, W), np.float32)
        if self._table is not None:
            vids = self.closest_vertices(emb)
            x0, y0, x1, y1 = [int(round(v)) for v in box]
            bh, bw = max(y1 - y0, 1), max(x1 - x0, 1)
            up = IO.resize(vids.astype(np.float32), (bw, bh), IO.INTER_NEAREST)
            vert_map[y0:y0 + bh, x0:x0 + bw] = up * mask[y0:y0 + bh, x0:x0 + bw]
        self.calls += 1
        return emb.cpu().numpy(), vert_map, box


# ------------------------------------------------------------- converters
def convert_cse_head(sd: Mapping[str, np.ndarray], prefix: str = HEAD_PREFIX,
                     pred_prefix: str = PRED_PREFIX, n_convs: int = 8) -> Dict:
    """detectron2 DensePose head + predictor tensors -> the JAX package's
    CSEHead tree (Flax conv kernels; the ConvTranspose weight [I, O, kh, kw]
    spatially flipped into [kh, kw, I, O], as the JAX head runs it as an
    input-dilated conv), bit-equal to moda_tpu's ``convert_cse_head``."""
    params: Dict = {}
    for i in range(n_convs):
        params[f"conv{i + 1}"] = {
            "kernel": _hwio(sd[f"{prefix}body_conv_fcn{i + 1}.weight"]),
            "bias": sd[f"{prefix}body_conv_fcn{i + 1}.bias"].astype(np.float32)}
    w = sd[f"{pred_prefix}embed_lowres.weight"][:, :, ::-1, ::-1]
    params["predictor_kernel"] = np.ascontiguousarray(
        np.transpose(w, (2, 3, 0, 1))).astype(np.float32)
    params["predictor_bias"] = sd[f"{pred_prefix}embed_lowres.bias"].astype(np.float32)
    return params


def load_detectron2_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A detectron2 checkpoint file -> {key: numpy array}. ``.pkl``: a
    pickle of numpy arrays (under 'model', or the dict itself); otherwise a
    torch file (``.pth``) read by ``torch.load``."""
    if path.endswith(".pkl"):
        import pickle
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        model = data.get("model", data)
        return {k: np.asarray(v) for k, v in model.items()
                if isinstance(v, np.ndarray) or np.isscalar(v)}
    ck = torch.load(path, map_location="cpu", weights_only=False)
    model = ck.get("model", ck)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in model.items()}


def convert_cse_checkpoint(sd: Mapping[str, np.ndarray]) -> Dict:
    """A detectron2 DensePose-CSE state dict -> cse.npz's tree {backbone,
    head[, vertex_embeddings]}: the trees of moda_tpu's
    ``convert_cse_checkpoint`` (which wraps them in its predictor; here
    ``CSEPredictor(tree["backbone"], tree["head"], tree.get(
    "vertex_embeddings"), device=...)`` builds one). The vertex table is the
    first ``*embedder*.weight`` tensor, as there."""
    tree = {"backbone": convert_resnet50_fpn(sd), "head": convert_cse_head(sd)}
    for k in sd:
        if "embedder" in k and k.endswith(".weight"):
            tree["vertex_embeddings"] = sd[k].astype(np.float32)
            break
    return tree


def reference_state_dict(seed: int = 0, n_convs: int = 8, hidden: int = 512,
                         embed_dim: int = 16, n_vertices: int = 0) -> Dict[str, np.ndarray]:
    """A DensePose-CSE R50-FPN state dict in detectron2's layout holding
    seeded random weights: the backbone (``reference_backbone_sd``), the
    head's convs (std 1/sqrt(fan_in), biases 0.1 std) and the predictor's
    ConvTranspose [hidden, E, 4, 4] (0.05 std), as tests/test_cse_infer.py
    draws them. The defaults are the published widths (8 x conv 512, E =
    16: ~45 M parameters with the backbone). ``n_vertices`` > 0 adds a
    unit-norm vertex table ``roi_heads.embedder.embeddings.mesh.weight``."""
    rng = np.random.default_rng(seed)
    sd = reference_backbone_sd(rng)
    for i in range(n_convs):
        cin = 256 if i == 0 else hidden
        sd[f"{HEAD_PREFIX}body_conv_fcn{i + 1}.weight"] = (
            rng.standard_normal((hidden, cin, 3, 3)) / np.sqrt(cin * 9)).astype(np.float32)
        sd[f"{HEAD_PREFIX}body_conv_fcn{i + 1}.bias"] = (
            rng.standard_normal(hidden) * 0.1).astype(np.float32)
    sd[f"{PRED_PREFIX}embed_lowres.weight"] = (
        rng.standard_normal((hidden, embed_dim, 4, 4)) * 0.05).astype(np.float32)
    sd[f"{PRED_PREFIX}embed_lowres.bias"] = (rng.standard_normal(embed_dim) * 0.1).astype(
        np.float32)
    if n_vertices:
        t = rng.standard_normal((n_vertices, embed_dim))
        sd["roi_heads.embedder.embeddings.mesh.weight"] = (
            t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float32)
    return sd
