"""PointRend instance segmentation in PyTorch: counterpart of
moda_tpu/preproc/pointrend_infer.py (the reference's mask stage,
preprocess/mask.py, a detectron2 R50-FPN PointRend model).

  image -> ResNet50-FPN (fields/resnet_fpn.py, + p6)
        -> RPN head (shared conv, objectness + anchor deltas)
        -> proposal decode + NMS                         (host numpy)
        -> box head (roi_align 7x7, 2 FC, class scores + box deltas)
        -> coarse mask head (roi_align 14x14 -> FC -> 7x7 logits)
        -> PointRend subdivision (uncertain-point MLP refinement on p2)

The towers and heads are plain PyTorch in NCHW (cuDNN convolutions,
``torch.matmul``) on the predictor's device; no Pallas kernel lies on this
path. The sequential parts run on the host in numpy, copied from the JAX
package and bit-equal to it: ``make_anchors``, ``decode_deltas``, ``nms``,
``assign_fpn_level``, the top-k and the uncertain-point choice. The ROI
crops of one FPN level run as one batched ``roi_align`` (the arithmetic of
the JAX package's box-by-box crop); ``point_sample`` copies its own clamp
convention (not ``grid_sample``). cv2's float resizes become
data/imageio.py's (one multi-channel resize of the 80 coarse maps a
subdivision step, where the JAX package makes 80).

Layouts. The RPN's NCHW outputs are permuted to (h, w, anchor) before they
are flattened, the order of Flax's NHWC ``reshape(-1)`` and of
``make_anchors``. The box and coarse heads flatten their ROI features
NCHW, as detectron2 does; the JAX tree's ``fc1`` kernels have their rows in
NHWC order (``convert_pointrend_checkpoint``), which
``bridge.pointrend_from_jax`` turns back.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.fields.resnet_fpn import (ResNetFPN, _hwio, convert_resnet50_fpn,
                                              reference_backbone_sd)
from moda_tpu_torch.preproc.cse_infer import (load_detectron2_state_dict, normalize_image,
                                              pad_resized, roi_align)
from moda_tpu_torch.runtime import resolve_device

ANCHOR_SIZES = (32, 64, 128, 256, 512)  # p2..p6
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
SCALE_CLAMP = float(np.log(1000.0 / 16))
PRE_NMS_TOPK = 1000   # proposals kept a level before NMS
POST_NMS_TOPK = 100
RPN_NMS_IOU = 0.7
BOX_WEIGHTS = (10, 10, 5, 5)
ROI_CHANNELS = 256
DETECT_LOGIT = 6.0  # reference_state_dict's raise of one class's score logit


class RPNHead(nn.Module):
    """Shared 3x3 conv + objectness / delta predictors (A anchors a place)."""

    def __init__(self, channels: int = ROI_CHANNELS, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, 1, 1)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, x):
        t = F.relu(self.conv(x))
        return self.objectness_logits(t), self.anchor_deltas(t)


class BoxHead(nn.Module):
    """FastRCNNConvFCHead (2 FC) + class / box predictors on [N, 256, 7, 7]."""

    def __init__(self, fc_dim: int = 1024, num_classes: int = 80):
        super().__init__()
        self.fc1 = nn.Linear(ROI_CHANNELS * 49, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, x):
        x = F.relu(self.fc1(x.flatten(1)))
        x = F.relu(self.fc2(x))
        return self.cls_score(x), self.bbox_pred(x)


class CoarseMaskHead(nn.Module):
    """PointRend's coarse head: [N, 256, 14, 14] -> [N, C, 7, 7] logits."""

    def __init__(self, fc_dim: int = 1024, num_classes: int = 80, output_side: int = 7):
        super().__init__()
        self.num_classes, self.output_side = num_classes, output_side
        self.reduce_channel_dim_conv = nn.Conv2d(ROI_CHANNELS, ROI_CHANNELS, 1)
        self.reduce_spatial_dim_conv = nn.Conv2d(ROI_CHANNELS, ROI_CHANNELS, 2, 2)
        self.fc1 = nn.Linear(ROI_CHANNELS * 49, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.prediction = nn.Linear(fc_dim, num_classes * output_side ** 2)

    def forward(self, x):
        x = F.relu(self.reduce_channel_dim_conv(x))
        x = F.relu(self.reduce_spatial_dim_conv(x))
        x = F.relu(self.fc1(x.flatten(1)))
        x = F.relu(self.fc2(x))
        return self.prediction(x).reshape(-1, self.num_classes, self.output_side,
                                          self.output_side)


class PointHead(nn.Module):
    """StandardPointHead: a per-point MLP on (p2 feature, coarse logits), the
    coarse logits concatenated again before every layer."""

    def __init__(self, fc_dim: int = 256, num_fc: int = 3, num_classes: int = 80):
        super().__init__()
        self.num_fc = num_fc
        cin = ROI_CHANNELS + num_classes
        for i in range(num_fc):
            setattr(self, f"fc{i + 1}", nn.Linear(cin, fc_dim))
            cin = fc_dim + num_classes
        self.predictor = nn.Linear(cin, num_classes)

    def forward(self, fine, coarse):  # [N, P, 256], [N, P, C]
        x = torch.cat([fine, coarse], -1)
        for i in range(self.num_fc):
            x = torch.cat([F.relu(getattr(self, f"fc{i + 1}")(x)), coarse], -1)
        return self.predictor(x)


class PointRendNet(nn.Module):
    """The modules of the JAX tree's five parts, under their names."""

    def __init__(self, num_classes: int = 80, fc_dim: int = 1024, point_dim: int = 256,
                 point_fc: int = 3):
        super().__init__()
        self.backbone = ResNetFPN()
        self.rpn = RPNHead()
        self.box_head = BoxHead(fc_dim, num_classes)
        self.coarse = CoarseMaskHead(fc_dim, num_classes)
        self.point = PointHead(point_dim, point_fc, num_classes)


# -------------------------------------------------------------- host utils
def make_anchors(h: int, w: int, stride: int, size: int) -> np.ndarray:
    """d2 DefaultAnchorGenerator grid for one level -> [H*W*A, 4] xyxy."""
    boxes = []
    for r in ANCHOR_RATIOS:
        area = float(size * size)
        bw = np.sqrt(area / r)
        bh = bw * r
        boxes.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
    base = np.asarray(boxes, np.float32)  # [A, 4]
    sx = (np.arange(w, dtype=np.float32)) * stride
    sy = (np.arange(h, dtype=np.float32)) * stride
    gx, gy = np.meshgrid(sx, sy)
    shifts = np.stack([gx, gy, gx, gy], -1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_deltas(anchors: np.ndarray, deltas: np.ndarray,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> np.ndarray:
    """d2 Box2BoxTransform.apply_deltas."""
    wa = anchors[:, 2] - anchors[:, 0]
    ha = anchors[:, 3] - anchors[:, 1]
    cxa = anchors[:, 0] + 0.5 * wa
    cya = anchors[:, 1] + 0.5 * ha
    dx, dy, dw, dh = [deltas[:, i] / weights[i] for i in range(4)]
    dw = np.minimum(dw, SCALE_CLAMP)
    dh = np.minimum(dh, SCALE_CLAMP)
    cx = dx * wa + cxa
    cy = dy * ha + cya
    w = np.exp(dw) * wa
    h = np.exp(dh) * ha
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float,
        max_keep: Optional[int] = None) -> List[int]:
    """Greedy NMS: indices kept, best first. ``max_keep`` stops after that
    many, the first ``max_keep`` of the whole run (the JAX package runs it
    all and then cuts)."""
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1 or len(keep) == max_keep:
            break
        rest = order[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        b = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a + b - inter, 1e-8)
        order = rest[iou <= iou_thr]
    return keep


def assign_fpn_level(boxes: np.ndarray) -> np.ndarray:
    """d2 level assignment: floor(4 + log2(sqrt(area)/224)), clamp p2..p5."""
    area = np.maximum((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1e-8)
    lvl = np.floor(4 + np.log2(np.sqrt(area) / 224.0))
    return np.clip(lvl, 2, 5).astype(np.int32)


def point_sample(feat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``feat`` [C, H, W] at ``pts`` [P, 2] in [0, 1]^2
    (x, y), half-pixel centres -> [P, C]; moda_tpu's ``point_sample``
    (pointrend_infer.py:172-187): the top-left tap clamped to [0, size - 2],
    its weight to [0, 1]."""
    H, W = feat.shape[1:]
    x = pts[:, 0] * W - 0.5
    y = pts[:, 1] * H - 0.5
    x0 = torch.clamp(torch.floor(x), 0, W - 2).long()
    y0 = torch.clamp(torch.floor(y), 0, H - 2).long()
    wx = torch.clamp(x - x0, 0.0, 1.0)[:, None]
    wy = torch.clamp(y - y0, 0.0, 1.0)[:, None]
    f00, f01 = feat[:, y0, x0].T, feat[:, y0, x0 + 1].T
    f10, f11 = feat[:, y0 + 1, x0].T, feat[:, y0 + 1, x0 + 1].T
    return (f00 * (1 - wy) * (1 - wx) + f01 * (1 - wy) * wx
            + f10 * wy * (1 - wx) + f11 * wy * wx)


class PointRendPredictor:
    """img_bgr_uint8 [H, W, 3] -> (mask [H, W] uint8, score, box in image px
    or None): the best detection among ``keep_classes`` (COCO ids; None =
    any class) above ``score_thresh``, its mask refined by
    ``subdivision_steps`` PointRend steps of ``subdivision_points`` points
    and pasted into the frame. No detection gives an empty mask, score 0
    and no box, as the JAX package's.

    Built from the JAX package's tree (pointrend.npz) on ``device``: the
    card unless ``device="cpu"``. The graph runs under inference_mode;
    ``calls`` counts the frames it ran."""

    def __init__(self, params: Mapping, num_classes: int = 80, input_size: int = 512,
                 keep_classes=None, score_thresh: float = 0.3, subdivision_steps: int = 5,
                 subdivision_points: int = 784, device=None):
        from moda_tpu_torch.bridge import pointrend_from_jax

        self.device = resolve_device(device)
        self.net = pointrend_from_jax(params, self.device)
        if self.net.coarse.num_classes != num_classes:
            raise ValueError(f"the weights hold {self.net.coarse.num_classes} classes, "
                             f"not {num_classes}")
        self.num_classes = num_classes
        self.input_size = int(input_size)
        self.keep_classes = keep_classes
        self.score_thresh = score_thresh
        self.steps = subdivision_steps
        self.npts = subdivision_points
        self.calls = 0

    # ------------------------------------------------------------ stages
    def features(self, imp: np.ndarray) -> Dict[str, torch.Tensor]:
        """The padded input [S, S, 3] -> {p2..p6} [1, 256, h, w] on the device."""
        with torch.inference_mode():
            f = self.net.backbone(normalize_image(imp, self.device))
            return {**f, "p6": f["p5"][:, :, ::2, ::2]}

    def rpn_outputs(self, feats) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per level p2..p6: objectness [h*w*A] and deltas [h*w*A, 4] on the
        host, in (h, w, anchor) order."""
        with torch.inference_mode():
            outs = []
            for lvl in ("p2", "p3", "p4", "p5", "p6"):
                logits, deltas = self.net.rpn(feats[lvl])
                outs.append((logits[0].permute(1, 2, 0), deltas[0].permute(1, 2, 0)))
            return [(lg.cpu().numpy().reshape(-1), dl.cpu().numpy().reshape(-1, 4))
                    for lg, dl in outs]

    def _proposals(self, feats, hw) -> Tuple[np.ndarray, np.ndarray]:
        all_boxes, all_scores = [], []
        for li, (sc, dl) in enumerate(self.rpn_outputs(feats)):
            h, w = feats[f"p{li + 2}"].shape[2:]
            anchors = make_anchors(h, w, 2 ** (li + 2), ANCHOR_SIZES[li])
            k = min(PRE_NMS_TOPK, len(sc))
            top = np.argpartition(-sc, k - 1)[:k]
            boxes = decode_deltas(anchors[top], dl[top])
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, hw[1])
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, hw[0])
            all_boxes.append(boxes)
            all_scores.append(sc[top])
        boxes = np.concatenate(all_boxes)
        scores = np.concatenate(all_scores)
        wh_ok = ((boxes[:, 2] - boxes[:, 0]) > 1) & ((boxes[:, 3] - boxes[:, 1]) > 1)
        boxes, scores = boxes[wh_ok], scores[wh_ok]
        keep = nms(boxes, scores, RPN_NMS_IOU, POST_NMS_TOPK)
        return boxes[keep], scores[keep]

    def _roi_multilevel(self, feats, boxes: np.ndarray, out: int) -> torch.Tensor:
        """roi_align of each box on its FPN level -> [N, 256, out, out], one
        batched crop a level."""
        lvls = assign_fpn_level(boxes)
        b = torch.from_numpy(np.ascontiguousarray(boxes, np.float32)).to(self.device)
        rois = torch.empty((len(boxes), ROI_CHANNELS, out, out), device=self.device)
        for lv in np.unique(lvls):
            idx = torch.from_numpy(np.nonzero(lvls == lv)[0]).to(self.device)
            rois[idx] = roi_align(feats[f"p{lv}"][0], b[idx], out, 1.0 / (2 ** int(lv)))
        return rois

    def _detect(self, feats, hw):
        props, _ = self._proposals(feats, hw)
        if len(props) == 0:
            return None
        with torch.inference_mode():
            scores, deltas = self.net.box_head(self._roi_multilevel(feats, props, 7))
            prob = torch.softmax(scores, -1).cpu().numpy()[:, :-1]  # drop background
            deltas = deltas.cpu().numpy().reshape(len(props), self.num_classes, 4)
        cls_ids = np.arange(self.num_classes)
        if self.keep_classes is not None:
            sel = np.zeros(self.num_classes, bool)
            sel[list(self.keep_classes)] = True
            prob = prob * sel[None]
        flat = prob.reshape(-1)
        best = int(np.argmax(flat))
        ri, ci = best // self.num_classes, best % self.num_classes
        score = float(flat[best])
        if score < self.score_thresh:
            return None
        box = decode_deltas(props[ri: ri + 1], deltas[ri, ci][None], weights=BOX_WEIGHTS)[0]
        box[0::2] = box[0::2].clip(0, hw[1])
        box[1::2] = box[1::2].clip(0, hw[0])
        return box, int(cls_ids[ci]), score

    def _refine_mask(self, feats, box: np.ndarray, cls: int) -> np.ndarray:
        """Coarse 7x7 logits -> PointRend subdivision on p2 features."""
        with torch.inference_mode():
            all_coarse = self.net.coarse(self._roi_multilevel(feats, box[None], 14))
            all_coarse = all_coarse[0].cpu().numpy()                  # [C, 7, 7]
            p2 = feats["p2"][0]
            H2, W2 = p2.shape[1:]
            coarse_hwc = np.ascontiguousarray(all_coarse.transpose(1, 2, 0))
            side = 7
            m = all_coarse[cls].copy()
            for _ in range(self.steps):
                side *= 2
                m = IO.resize(m, (side, side))
                cm = IO.resize(coarse_hwc, (side, side))                # [side, side, C]
                unc = -np.abs(m).reshape(-1)
                P = min(self.npts, side * side)
                pick = np.argpartition(-unc, P - 1)[:P]
                py, px = pick // side, pick % side
                # point coords in the box frame [0, 1] -> image px -> p2 grid [0, 1]
                u = (px + 0.5) / side
                v = (py + 0.5) / side
                ix = box[0] + u * (box[2] - box[0])
                iy = box[1] + v * (box[3] - box[1])
                pts = np.stack([ix / 4.0 / W2, iy / 4.0 / H2], -1)  # p2 stride 4
                fine = point_sample(p2, torch.from_numpy(pts.astype(np.float32)).to(self.device))
                cpts = torch.from_numpy(cm.reshape(-1, cm.shape[-1])[pick].astype(np.float32))
                ref = self.net.point(fine[None], cpts.to(self.device)[None])[0, :, cls]
                m.reshape(-1)[pick] = ref.cpu().numpy()
        return m

    def as_mask_fn(self):
        """Adapter for preproc.pipeline.write_masks (img -> binary mask)."""
        return lambda img: self(img)[0]

    def __call__(self, img: np.ndarray):
        H, W = img.shape[:2]
        S = self.input_size
        imp, scale, (rh, rw) = pad_resized(img, S)
        feats = self.features(imp)
        det = self._detect(feats, (rh, rw))
        self.calls += 1
        if det is None:
            return np.zeros((H, W), np.uint8), 0.0, None
        box, cls, score = det
        m = self._refine_mask(feats, box, cls)
        x0, y0, x1, y1 = [int(round(v)) for v in box]
        bw, bh = max(x1 - x0, 1), max(y1 - y0, 1)
        mfull = np.zeros((S, S), np.float32)
        mres = IO.resize(m, (bw, bh))
        y1c, x1c = min(y0 + bh, S), min(x0 + bw, S)
        mfull[y0:y1c, x0:x1c] = mres[: y1c - y0, : x1c - x0]
        mimg = IO.resize(mfull[:rh, :rw], (W, H))
        return (mimg > 0).astype(np.uint8), score, box / scale


# ------------------------------------------------------------- converters
def load_pointrend_checkpoint(path: str, device=None, **kw) -> PointRendPredictor:
    """A detectron2 PointRend checkpoint file -> PointRendPredictor."""
    return PointRendPredictor(convert_pointrend_checkpoint(load_detectron2_state_dict(path)),
                              device=device, **kw)


def _fc(sd, name):
    return {"kernel": sd[name + ".weight"].T.astype(np.float32),
            "bias": sd[name + ".bias"].astype(np.float32)}


def _conv(sd, name):
    return {"kernel": _hwio(sd[name + ".weight"]), "bias": sd[name + ".bias"].astype(np.float32)}


def _hwc_rows(kernel: np.ndarray) -> np.ndarray:
    """fc1 kernel rows in d2's CHW flatten of the 256 x 7 x 7 ROI -> rows in
    the JAX heads' HWC flatten."""
    k = kernel.reshape(ROI_CHANNELS, 7, 7, -1)
    return np.ascontiguousarray(k.transpose(1, 2, 0, 3)).reshape(ROI_CHANNELS * 49, -1)


def chw_rows(kernel) -> np.ndarray:
    """The inverse of ``_hwc_rows``: a JAX fc1 kernel's HWC rows -> torch's
    CHW flatten (bridge.pointrend_from_jax)."""
    k = np.asarray(kernel).reshape(7, 7, ROI_CHANNELS, -1)
    return np.ascontiguousarray(k.transpose(2, 0, 1, 3)).reshape(ROI_CHANNELS * 49, -1)


def convert_pointrend_checkpoint(sd: Mapping[str, np.ndarray], num_classes: int = 80) -> Dict:
    """detectron2 PointRend R50-FPN state dict -> the JAX package's tree
    (pointrend.npz), bit-equal to moda_tpu's converter: Flax conv kernels,
    Dense kernels [in, out], box and coarse ``fc1`` rows permuted from
    d2's CHW flatten to HWC, the point head's Conv1d k=1 as Dense. A
    missing key raises KeyError."""
    params = {"backbone": convert_resnet50_fpn(sd)}
    r = "proposal_generator.rpn_head."
    params["rpn"] = {n: _conv(sd, r + n) for n in ("conv", "objectness_logits", "anchor_deltas")}
    b = "roi_heads.box_head."
    fc1 = _fc(sd, b + "fc1")
    fc1["kernel"] = _hwc_rows(fc1["kernel"])
    params["box_head"] = {"fc1": fc1, "fc2": _fc(sd, b + "fc2"),
                          "cls_score": _fc(sd, "roi_heads.box_predictor.cls_score"),
                          "bbox_pred": _fc(sd, "roi_heads.box_predictor.bbox_pred")}
    c = "roi_heads.mask_coarse_head."
    fc1c = _fc(sd, c + "fc1")
    fc1c["kernel"] = _hwc_rows(fc1c["kernel"])
    params["coarse"] = {
        "reduce_channel_dim_conv": _conv(sd, c + "reduce_channel_dim_conv"),
        "reduce_spatial_dim_conv": _conv(sd, c + "reduce_spatial_dim_conv"),
        "fc1": fc1c, "fc2": _fc(sd, c + "fc2"), "prediction": _fc(sd, c + "prediction")}
    p = "roi_heads.mask_point_head."
    point = {}
    for name in ("fc1", "fc2", "fc3", "predictor"):
        # d2's point-head layers are Conv1d k=1: [O, I, 1] -> Dense [I, O]
        point[name] = {"kernel": sd[f"{p}{name}.weight"][..., 0].T.astype(np.float32),
                       "bias": sd[f"{p}{name}.bias"].astype(np.float32)}
    params["point"] = point
    return params


def reference_state_dict(seed: int = 0, num_classes: int = 80,
                         detect_class: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A PointRend R50-FPN state dict in detectron2's layout at the
    published widths (box head 2 x FC 1024, coarse head FC 1024 x 2 -> 7 x 7
    logits, point head 3 x FC 256; ~60 M parameters at 80 classes) holding
    seeded random weights. The backbone is ``reference_backbone_sd``'s. The
    RPN head and the box predictor are drawn as detectron2 initializes them
    (normal, std 0.01, bbox_pred 0.001, zero biases): proposals stay near
    their anchors, boxes near their proposals, and every class scores near
    1/81. The other layers are normal with std 1/sqrt(fan_in) and biases of
    std 0.1, as tests/test_pointrend_infer.py draws them, so the mask logits
    are of order 1, away from the threshold at 0; but the point head's
    predictor passes each class's coarse logit through with weight 1 beside
    draws a tenth that size (no bias), as a trained head refines the coarse
    mask. (Random ReLU features give each class's point logits an offset
    as large as their spread, and the first step, which replaces every
    point, then empties or fills the mask.) ``detect_class`` raises
    that class's ``cls_score`` bias by DETECT_LOGIT: it then scores ~0.8,
    above a score_thresh of 0.3, and a detection reaches the mask head."""
    rng = np.random.default_rng(seed)
    sd = reference_backbone_sd(rng)
    C = num_classes

    def layer(name, o, i, k=(), std=None, bias=0.1):
        fan = i * int(np.prod(k))
        sd[name + ".weight"] = (rng.standard_normal((o, i) + k)
                                * (std or 1 / np.sqrt(fan))).astype(np.float32)
        sd[name + ".bias"] = (rng.standard_normal(o) * bias).astype(np.float32)

    r, b = "proposal_generator.rpn_head.", "roi_heads.box_head."
    layer(r + "conv", 256, 256, (3, 3), std=0.01, bias=0)
    layer(r + "objectness_logits", 3, 256, (1, 1), std=0.01, bias=0)
    layer(r + "anchor_deltas", 12, 256, (1, 1), std=0.01, bias=0)
    layer(b + "fc1", 1024, 256 * 49)
    layer(b + "fc2", 1024, 1024)
    layer("roi_heads.box_predictor.cls_score", C + 1, 1024, std=0.01, bias=0)
    layer("roi_heads.box_predictor.bbox_pred", 4 * C, 1024, std=0.001, bias=0)
    c = "roi_heads.mask_coarse_head."
    layer(c + "reduce_channel_dim_conv", 256, 256, (1, 1))
    layer(c + "reduce_spatial_dim_conv", 256, 256, (2, 2))
    layer(c + "fc1", 1024, 256 * 49)
    layer(c + "fc2", 1024, 1024)
    layer(c + "prediction", C * 49, 1024)
    p = "roi_heads.mask_point_head."
    for name in ("fc1", "fc2", "fc3"):
        layer(p + name, 256, 256 + C, (1,))
    layer(p + "predictor", C, 256 + C, (1,), std=0.1 / np.sqrt(256 + C), bias=0)
    sd[p + "predictor.weight"][:, 256:, 0] += np.eye(C, dtype=np.float32)
    if detect_class is not None:
        sd["roi_heads.box_predictor.cls_score.bias"][detect_class] += DETECT_LOGIT
    return sd
