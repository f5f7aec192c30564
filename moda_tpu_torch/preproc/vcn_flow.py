"""VCN+ optical-flow inference in PyTorch: counterpart of
moda_tpu/preproc/vcn_flow.py.

The reference's learned-flow preprocessing network (third_party/vcnplus/
models/VCNplus.py), the inference path of auto_gen.py:69-150: the PSPNet
feature pyramid, per-level correlation volumes, butterfly4D + sepConv4d
volumetric filtering, truncated soft-argmax flow regression (flow_reg),
hypothesis fusion, and the out-of-range (occlusion) head at the finest
level. The expansion branch is left out, as in the JAX package: auto_gen.py
discards its outputs when it writes MoDA's flo-/occ- PFMs.

Parameters are the JAX package's tree (``convert_vcn_checkpoint``: BatchNorm
folded into conv scale and bias, torch's OIHW/OIDHW layouts) with torch
tensors for leaves (``bridge.vcn_from_jax``). Every convolution is
``F.conv2d``/``F.conv3d`` (cuDNN on the card), as the JAX package runs them
through XLA; no Pallas kernel lies on this path. Layout is NCHW and the
cost volumes are [B, C, u, v, h, w], u the x displacement.

Resizes: the JAX package's ``jax.image.resize(..., "linear")`` equals
``F.interpolate(align_corners=False)`` only where it enlarges (shrinking, it
antialiases); every resize of the graph enlarges or keeps a size, and
``_upsample`` asserts it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from moda_tpu_torch.data import imageio as IO

# md (search half-window per level) of the released vcn_rob checkpoint:
# auto_gen.py:46 with the default --maxdisp 256.
DEFAULT_MD = (4, 4, 4, 4, 4)


def leaky(x):
    return F.leaky_relu(x, 0.1)


def conv2d(x, p, stride=1, pad=1, dilation=1):
    """x [B,C,H,W], p {'w': [O,I,kh,kw], 'b': [O]}."""
    return F.conv2d(x, p["w"], p.get("b"), stride, pad, dilation)


def conv3d(x, p, stride=(1, 1, 1), pad=(0, 0, 0)):
    """x [B,C,D,H,W], p {'w': [O,I,kd,kh,kw], 'b': [O]}."""
    return F.conv3d(x, p["w"], p.get("b"), stride, pad)


def _upsample(x, size, mode):
    """F.interpolate to ``size`` (the trailing axes), which must enlarge or
    keep every axis: there the JAX package's linear resize is the same map."""
    if any(o < i for o, i in zip(size, x.shape[2:])):
        raise ValueError(f"resize of {tuple(x.shape[2:])} to {tuple(size)} shrinks an axis; "
                         "jax.image.resize antialiases there and F.interpolate does not")
    return F.interpolate(x, size=tuple(int(s) for s in size), mode=mode, align_corners=False)


def resize_bilinear(x, hw):
    """F.upsample(..., mode='bilinear', align_corners=False) on NCHW."""
    return _upsample(x, hw, "bilinear")


def cbr(x, p, stride=1, pad=1, dilation=1):
    return leaky(conv2d(x, p, stride, pad, dilation))


def residual_block(x, p, stride=1, dilation=1):
    """submodule.residualBlock (BN folded)."""
    pad = dilation if dilation > 1 else 1
    out = cbr(x, p["cbr1"], stride=stride, pad=pad, dilation=dilation)
    out = conv2d(out, p["cb2"], stride=1, pad=1)
    res = conv2d(x, p["ds"], stride=stride, pad=0) if "ds" in p else x
    return leaky(out + res)


def avg_pool_nchw(x, k):
    """VALID average pool with the stride equal to the kernel."""
    return F.avg_pool2d(x, k, stride=k)


def pyramid_pooling(x, p, levels=3):
    """submodule.pyramidPooling (levels=3 in both pspnet and bfmodule)."""
    h, w = x.shape[2:]
    if min(h, w) // 2 < 1:
        raise ValueError(f"pyramid pooling of a {h} x {w} map: the coarsest level must be at "
                         "least 2 px on its short side (an input of at least 128 px)")
    k_sizes = []
    for pool_size in np.linspace(1, min(h, w) // 2, levels, dtype=int):
        k_sizes.append((int(h / pool_size), int(w / pool_size)))
    k_sizes = k_sizes[::-1]
    pp_sum = x
    for i in range(levels):
        out = avg_pool_nchw(x, k_sizes[i])
        out = cbr(out, p[f"path{i}"], pad=0)
        out = resize_bilinear(out, (h, w))
        pp_sum = pp_sum + out / levels
    return leaky(pp_sum / 2.0)


def pspnet_forward(x, p):
    """submodule.pspnet(is_proj=False): image -> 5 pyramid levels
    (1/64,1/32,1/16,1/8,1/4), channels (128,128,128,64,64)."""
    c1 = cbr(x, p["convbnrelu1_1"], stride=2)
    c1 = cbr(c1, p["convbnrelu1_2"])
    c1 = cbr(c1, p["convbnrelu1_3"])
    pool1 = F.max_pool2d(c1, 3, 2, 1)  # pads with -inf
    rconv3 = residual_block(pool1, p["res_block3"], stride=2)
    conv4 = residual_block(rconv3, p["res_block5"], stride=2)
    conv5 = residual_block(conv4, p["res_block6"], stride=2)
    conv6 = residual_block(conv5, p["res_block7"], stride=2)
    conv6 = pyramid_pooling(conv6, p["pyramid_pooling"])

    conv6x = resize_bilinear(conv6, conv5.shape[2:])
    conv5 = cbr(torch.cat([conv5, cbr(conv6x, p["upconv6"])], 1), p["iconv5"])
    conv5x = resize_bilinear(conv5, conv4.shape[2:])
    conv4 = cbr(torch.cat([conv4, cbr(conv5x, p["upconv5"])], 1), p["iconv4"])
    conv4x = resize_bilinear(conv4, rconv3.shape[2:])
    conv3 = cbr(torch.cat([rconv3, cbr(conv4x, p["upconv4"])], 1), p["iconv3"])
    conv3x = resize_bilinear(conv3, pool1.shape[2:])
    conv2 = cbr(torch.cat([pool1, cbr(conv3x, p["upconv3"])], 1), p["iconv2"])
    return conv6, conv5, conv4, conv3, conv2


# ------------------------------------------------------------ 4D conv stack
def projfeat4d(x, p, stride=1):
    """conv4d.projfeat4d: 1x1 Conv3d over (u,v) with (h*w) untouched."""
    b, c, u, v, h, w = x.shape
    y = conv3d(x.reshape(b, c, u, v, h * w), p, stride=(stride, stride, 1))
    return y.reshape(b, -1, y.shape[2], y.shape[3], h, w)


def sep_conv4d(x, p, stride=1, full=False):
    """conv4d.sepConv4d: Conv3d (k,k,1) over (u,v) then (1,k,k) over (h,w).

    The torch forward applies conv2 (the uv conv) FIRST, then conv1; with
    full=False the (h,w) conv always has stride 1 (only u,v downsample).
    """
    b, c, u, v, h, w = x.shape
    k = p["conv2"]["w"].shape[2]  # ksize (3, or 1 for downsample convs)
    y = conv3d(x.reshape(b, c, u, v, h * w), p["conv2"],
               stride=(stride, stride, 1), pad=(k // 2, k // 2, 0))
    b, c2, u2, v2, _ = y.shape
    y = F.relu(y)
    hw_stride = stride if full else 1
    y = conv3d(y.reshape(b, c2, u2 * v2, h, w), p["conv1"],
               stride=(1, hw_stride, hw_stride), pad=(0, k // 2, k // 2))
    h2, w2 = y.shape[3], y.shape[4]
    if "proj" in p:
        y = conv2d(y.reshape(b, y.shape[1], u2 * v2 * h2, w2), p["proj"], pad=0)
    return y.reshape(b, -1, u2, v2, h2, w2)


def sep_conv4d_block(x, p, stride=1, full=True):
    """conv4d.sepConv4dBlock (residual pair of sepConv4d)."""
    out = F.relu(sep_conv4d(x, p["conv1"], stride=stride, full=full))
    if "ds" in p:
        if full:
            x = sep_conv4d(x, p["ds"], stride=stride, full=full)
        else:
            x = projfeat4d(x, p["ds"], stride=stride)
    elif stride != 1:
        raise ValueError("strided block needs downsample params")
    return F.relu(x + sep_conv4d(out, p["conv2"], stride=1, full=full))


def _resize_uv(x, uv):
    """Bilinear resize over the (u,v) axes of [b,c,u,v,h,w]: a trilinear
    resize of [b*c, 1, u, v, h*w] that keeps the last axis."""
    b, c, u, v, h, w = x.shape
    y = _upsample(x.reshape(b * c, 1, u, v, h * w), tuple(uv) + (h * w,), "trilinear")
    return y.reshape(b, c, uv[0], uv[1], h, w)


def _resize_hw6(x, hw):
    """Bilinear resize over the (h,w) axes of [b,c,u,v,h,w]."""
    b, c, u, v, h, w = x.shape
    y = resize_bilinear(x.reshape(b * c, u * v, h, w), hw)
    return y.reshape(b, c, u, v, hw[0], hw[1])


def butterfly4d(x, p, full=True):
    """conv4d.butterfly4D: U-net over the (u,v) axes of the cost volume."""
    out = F.relu(projfeat4d(x, p["proj"]))
    u, v = out.shape[2:4]
    out1 = sep_conv4d_block(out, p["conva1"], stride=2, full=full)
    u1, v1, h1, w1 = out1.shape[2:]
    out2 = sep_conv4d_block(out1, p["conva2"], stride=2, full=full)
    out2 = sep_conv4d_block(out2, p["convb3"], stride=1, full=full)
    tout1 = _resize_hw6(_resize_uv(out2, (u1, v1)), (h1, w1))
    out1 = sep_conv4d_block(tout1 + out1, p["convb2"], stride=1, full=full)
    tout = _resize_hw6(_resize_uv(out1, (u, v)), x.shape[4:6])
    return sep_conv4d_block(tout + out, p["convb1"], stride=1, full=full)


# ------------------------------------------------------------ flow modules
def corr_volume(ref, tgt, md: int, fac: int = 1):
    """VCN.corrf (eval path): cost[b,c,i,j,y,x] = ref(y,x)*tgt(y+dy,x+dx)
    with dx = i-md (u axis), dy = j-md//fac (v axis); leaky-relu'd.

    One product of ``ref`` with a strided view of every shifted window of
    the padded target, written into one allocation: at the finest level of
    the ~2 MP protocol the volume is [1, 64, 9, 9, h/4, w/4], ~2.8 GB."""
    b, c, h, w = ref.shape
    mdv = md // fac
    tp = F.pad(tgt, (md, md, mdv, mdv))
    win = tp.unfold(2, h, 1).unfold(3, w, 1)  # [b, c, v, u, h, w]
    vol = torch.empty((b, c, 2 * md + 1, 2 * mdv + 1, h, w), dtype=ref.dtype, device=ref.device)
    torch.mul(ref[:, :, None, None], win.transpose(2, 3), out=vol)
    return F.leaky_relu(vol, 0.1, inplace=True)  # [b,c,u,v,h,w]


def flow_reg(cost, md: int, fac: int = 1, wsize: int = 3):
    """VCNplus.flow_reg: truncated soft-argmax over the (u,v) window +
    local/global entropies. cost [B,u,v,h,w] -> ([B,2,h,w], [B,2,h,w])."""
    B, u, v, h, w = cost.shape
    flat = cost.reshape(B, u * v, h, w)
    idx = torch.argmax(flat, 1, keepdim=True)  # the first index wins a tie
    mask = torch.zeros_like(flat).scatter_(1, idx, 1.0)
    # dilate the argmax by a (2*wsize+1)^2 window over (u,v)
    k = 2 * wsize + 1
    mask = F.max_pool3d(mask.reshape(B, 1, u, v, h * w), (k, k, 1), 1, (wsize, wsize, 0))
    trunc = torch.where(mask.reshape(B, u * v, h, w) > 0, flat, -math.inf)
    prob = torch.softmax(trunc, 1).reshape(B, u, v, h, w)

    rx = torch.arange(-md, md + 1, dtype=cost.dtype, device=cost.device)  # u axis
    ry = torch.arange(-(md // fac), md // fac + 1, dtype=cost.dtype, device=cost.device)
    outx = torch.sum(prob * rx[None, :, None, None, None], (1, 2))
    outy = torch.sum(prob * ry[None, None, :, None, None], (1, 2))
    flow = torch.stack([outx, outy], 1)

    pc = torch.clamp(prob, 1e-9, 1 - 1e-9)
    local_ent = (-prob * torch.log(pc)).sum((1, 2)) / np.log(k ** 2)
    gprob = torch.softmax(flat, 1)
    gpc = torch.clamp(gprob, 1e-9, 1 - 1e-9)
    global_ent = (-gprob * torch.log(gpc)).sum(1) / np.log(u * v)
    return flow, torch.stack([local_ent, global_ent], 1)


def warp_by_flow(x, flo):
    """VCNplus.WarpModule: backward-warp x [B,C,H,W] by flo [B,2,H,W]
    (grid_sample align_corners=True, zero padding, in-range mask)."""
    B, C, H, W = x.shape
    gx = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, :] + flo[:, 0]
    gy = torch.arange(H, dtype=x.dtype, device=x.device)[None, :, None] + flo[:, 1]
    inb = (gx > 0) & (gx < W - 1) & (gy > 0) & (gy < H - 1)
    x0 = torch.clamp(torch.floor(gx), 0, W - 2).long()
    y0 = torch.clamp(torch.floor(gy), 0, H - 2).long()
    wx = torch.clamp(gx - x0, 0.0, 1.0)[:, None]
    wy = torch.clamp(gy - y0, 0.0, 1.0)[:, None]
    flat = x.reshape(B, C, H * W)

    def gather(yy, xx):
        idx = (yy * W + xx).reshape(B, 1, H * W).expand(B, C, H * W)
        return torch.gather(flat, 2, idx).reshape(B, C, H, W)

    f00 = gather(y0, x0)
    f01 = gather(y0, x0 + 1)
    f10 = gather(y0 + 1, x0)
    f11 = gather(y0 + 1, x0 + 1)
    out = (f00 * (1 - wy) * (1 - wx) + f01 * (1 - wy) * wx
           + f10 * wy * (1 - wx) + f11 * wy * wx)
    # zero-padding outside + the module's strict in-range mask
    valid = inb[:, None].to(x.dtype)
    return out * valid, inb


def conv_stack(x, p, n=7):
    """The PWC-style dilated fusion/OOR stacks (dcX_conv / dcX_convo)."""
    dil = (1, 2, 4, 8, 16, 1)
    for i in range(n - 1):
        x = cbr(x, p[f"c{i+1}"], pad=dil[i], dilation=dil[i])
    return conv2d(x, p[f"c{n}"], pad=1)


def cost_matching(params, level, up_flow, c1, c2, flowh, enth, md=DEFAULT_MD, fac=1):
    """VCN.cost_matching for one pyramid level (coarse->fine order 0..4)."""
    p = params[f"level{level}"]
    full = level == 4
    c1n = c1 / (torch.linalg.norm(c1, dim=1, keepdim=True) + 1e-9)
    c2n = c2 / (torch.linalg.norm(c2, dim=1, keepdim=True) + 1e-9)
    warp = c2n if level == 0 else warp_by_flow(c2n, up_flow)[0]
    lfac = fac if level == 0 else 1
    feat = corr_volume(c1n, warp, md[level], lfac)
    feat = butterfly4d(feat, p["f"], full=full)
    cost = sep_conv4d(feat, p["p"], stride=1, full=full)
    del feat

    b, c, u, v, h, w = cost.shape
    flowhh, enthh = flow_reg(cost.reshape(b * c, u, v, h, w), md[level], lfac)
    flowhh = flowhh.reshape(b, c, 2, h, w)
    if level > 0:
        flowhh = flowhh + up_flow[:, None]
    flowhh = flowhh.reshape(b, -1, h, w)
    enthh = enthh.reshape(b, -1, h, w)
    if level == 0:
        flowh, enth = flowhh, enthh
    else:
        flowh = torch.cat([flowhh, resize_bilinear(flowh * 2, (h, w))], 1)
        enth = torch.cat([enthh, resize_bilinear(enth, (h, w))], 1)

    x = torch.cat([enth, flowh, c1], 1)
    oor = conv_stack(x, p["oor"])[:, 0] if level == 4 else None
    va = conv_stack(x, p["fuse"])
    va = va.reshape(b, -1, 2, h, w)
    flow = (flowh.reshape(b, -1, 2, h, w) * torch.softmax(va, 1)).sum(1)
    return flow, flowh, enth, oor


def vcn_forward(params, im, md=DEFAULT_MD, fac=1):
    """VCN.forward (eval, flow path): im [2B,3,H,W] (ref then target)
    -> (flow [B,2,H,W] full-res, occ_logits [B,H/4,W/4])."""
    bs = im.shape[0] // 2
    H, W = im.shape[2:]
    feats = pspnet_forward(im, params["pspnet"])
    flow, flowh, enth, oor = None, None, None, None
    for level in range(5):
        c = feats[level]
        c1, c2 = c[:bs], c[bs:]
        if level == 0:
            up = None
        else:
            s = 2 ** (6 - level)
            up = resize_bilinear(flow, (H // s, W // s)) * 2
        flow, flowh, enth, oor = cost_matching(
            params, level, up, c1, c2, flowh, enth, md=md, fac=fac)
    flow = resize_bilinear(flow, (H, W)) * 4
    return flow, oor


class VCNFlowPredictor:
    """auto_gen.flow_inference drop-in: (imgL, imgR) uint8 BGR (cv2's
    order; preproc.pipeline.compute_flows flips the port's RGB frames) ->
    (flow [H,W,3] with all-ones conf channel, occ_logits [H,W]).

    The reference's resizing protocol (auto_gen.py:76-88): scale to ~2 MP
    (or by ``testres``), round up to multiples of 64, subtract the
    checkpoint's mean, run on the concatenated pair, rescale the flow back.
    The uint8 frames are resized as cv2 does (8-bit fixed point), the
    outputs with cv2's float resize. The graph runs under inference_mode on
    the device that holds ``params``; ``calls`` counts the pairs run."""

    def __init__(self, params: Dict, mean: Optional[np.ndarray] = None,
                 md: Tuple[int, ...] = DEFAULT_MD, fac: int = 1,
                 testres: float = -1.0):
        self.params = params
        self.device = params["pspnet"]["convbnrelu1_1"]["w"].device
        self.mean = np.asarray(mean if mean is not None
                               else [0.33, 0.33, 0.33], np.float32)
        self.md = tuple(md)
        self.fac = fac
        self.testres = testres
        self.calls = 0

    def as_flow_fn(self):
        """Adapter for preproc.pipeline.compute_flows (pair -> [H,W,2])."""
        return lambda a, b: self(a, b)[0][..., :2]

    def input_size(self, H: int, W: int) -> Tuple[int, int]:
        """(max_h, max_w): the network's input size for H x W frames."""
        testres = np.sqrt(2e6 / (H * W)) if self.testres <= 0 else self.testres
        max_h = int(H * testres // 64 * 64)
        max_w = int(W * testres // 64 * 64)
        if max_h < H * testres:
            max_h += 64
        if max_w < W * testres:
            max_w += 64
        return max_h, max_w

    def __call__(self, imgL: np.ndarray, imgR: np.ndarray):
        H, W = imgL.shape[:2]
        max_h, max_w = self.input_size(H, W)
        imL = IO.resize(imgL, (max_w, max_h)) / 255.0 - self.mean
        imR = IO.resize(imgR, (max_w, max_h)) / 255.0 - self.mean
        # the network consumes BGR (auto_gen.py:95); inputs are already BGR
        im = np.stack([imL, imR]).transpose(0, 3, 1, 2).astype(np.float32)
        with torch.inference_mode():
            flow, occ = vcn_forward(self.params, torch.from_numpy(im).to(self.device),
                                    md=self.md, fac=self.fac)
            flow = flow[0].cpu().numpy()
            occ = occ[0].cpu().numpy()
        self.calls += 1
        fx = IO.resize(flow[0], (W, H)) * W / max_w
        fy = IO.resize(flow[1], (W, H)) * H / max_h
        occ = IO.resize(occ, (W, H))
        flow3 = np.stack([fx, fy, np.ones_like(fx)], -1).astype(np.float32)
        return flow3, occ


# -------------------------------------------------------------- converter
def _f2(sd, conv, bn=None, eps=1e-5):
    """Fold torch conv(+BN) -> {'w','b'} keeping OIHW/OIDHW layout."""
    w = np.asarray(sd[conv + ".weight"], np.float32)
    b = np.asarray(sd[conv + ".bias"], np.float32) if conv + ".bias" in sd \
        else np.zeros(w.shape[0], np.float32)
    if bn is not None:
        g = np.asarray(sd[bn + ".weight"], np.float32)
        bb = np.asarray(sd[bn + ".bias"], np.float32)
        m = np.asarray(sd[bn + ".running_mean"], np.float32)
        v = np.asarray(sd[bn + ".running_var"], np.float32)
        s = g / np.sqrt(v + eps)
        w = w * s.reshape((-1,) + (1,) * (w.ndim - 1))
        b = (b - m) * s + bb
    return {"w": w, "b": b}


def _res_block(sd, pre):
    p = {"cbr1": _f2(sd, pre + ".convbnrelu1.cbr_unit.0",
                     pre + ".convbnrelu1.cbr_unit.1"),
         "cb2": _f2(sd, pre + ".convbn2.cb_unit.0", pre + ".convbn2.cb_unit.1")}
    if pre + ".downsample.0.weight" in sd:
        p["ds"] = _f2(sd, pre + ".downsample.0", pre + ".downsample.1")
    return p


def _sep(sd, pre, with_bn):
    if with_bn:
        p = {"conv1": _f2(sd, pre + ".conv1.0", pre + ".conv1.1"),
             "conv2": _f2(sd, pre + ".conv2.0", pre + ".conv2.1")}
        if pre + ".proj.0.weight" in sd:
            p["proj"] = _f2(sd, pre + ".proj.0", pre + ".proj.1")
    else:
        p = {"conv1": _f2(sd, pre + ".conv1"),
             "conv2": _f2(sd, pre + ".conv2")}
        if pre + ".proj.weight" in sd:
            p["proj"] = _f2(sd, pre + ".proj")
    return p


def _sepblock(sd, pre, full):
    p = {"conv1": _sep(sd, pre + ".conv1", True),
         "conv2": _sep(sd, pre + ".conv2", True)}
    if full:
        if pre + ".downsample.conv1.0.weight" in sd:
            p["ds"] = _sep(sd, pre + ".downsample", True)
    else:
        if pre + ".downsample.conv1.weight" in sd:
            p["ds"] = _f2(sd, pre + ".downsample.conv1",
                          pre + ".downsample.bn")
    return p


def _butterfly(sd, pre, full):
    return {"proj": _f2(sd, pre + ".proj.0.conv1", pre + ".proj.0.bn"),
            "conva1": _sepblock(sd, pre + ".conva1", full),
            "conva2": _sepblock(sd, pre + ".conva2", full),
            "convb3": _sepblock(sd, pre + ".convb3", full),
            "convb2": _sepblock(sd, pre + ".convb2", full),
            "convb1": _sepblock(sd, pre + ".convb1", full)}


def _stack(sd, names):
    """7-conv fusion/OOR stack; names = list of the 7 torch prefixes."""
    p = {}
    for i, n in enumerate(names[:-1]):
        p[f"c{i+1}"] = _f2(sd, n + ".0", n + ".1")
    p["c7"] = _f2(sd, names[-1])
    return p


def convert_vcn_checkpoint(sd: Dict[str, np.ndarray]) -> Dict:
    """vcn_rob-style state dict (numpy values; 'module.' prefix ok) ->
    params for vcn_forward (numpy leaves; ``bridge.vcn_from_jax`` makes
    them tensors)."""
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    psp = {}
    for i in (1, 2, 3):
        psp[f"convbnrelu1_{i}"] = _f2(sd, f"pspnet.convbnrelu1_{i}.cbr_unit.0",
                                      f"pspnet.convbnrelu1_{i}.cbr_unit.1")
    for rb in (3, 5, 6, 7):
        psp[f"res_block{rb}"] = _res_block(sd, f"pspnet.res_block{rb}.0")
    psp["pyramid_pooling"] = {
        f"path{i}": _f2(sd, f"pspnet.pyramid_pooling.path_module_list.{i}.cbr_unit.0",
                        f"pspnet.pyramid_pooling.path_module_list.{i}.cbr_unit.1")
        for i in range(3)}
    for up in (6, 5, 4, 3):
        psp[f"upconv{up}"] = _f2(sd, f"pspnet.upconv{up}.1.cbr_unit.0",
                                 f"pspnet.upconv{up}.1.cbr_unit.1")
    for ic in (5, 4, 3, 2):
        psp[f"iconv{ic}"] = _f2(sd, f"pspnet.iconv{ic}.cbr_unit.0",
                                f"pspnet.iconv{ic}.cbr_unit.1")
    params = {"pspnet": psp}

    for level, n in enumerate(LEVEL_NAMES):
        full = level == 4
        lp = {"f": _butterfly(sd, f"f{n}", full),
              "p": _sep(sd, f"p{n}", False),
              "fuse": _stack(sd, [f"dc{n}_conv{i}" for i in range(1, 8)])}
        if level == 4:
            lp["oor"] = _stack(sd, [f"dc{n}_convo.{i}" for i in range(7)])
        params[f"level{level}"] = lp
    return params


def load_vcn_checkpoint(path: str) -> Tuple[Dict, np.ndarray]:
    """Load a vcn_rob .pth (torch pickle) -> (params, mean_L)."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.numpy() for k, v in ck["state_dict"].items()}
    mean = np.asarray(ck.get("mean_L", [[0.33, 0.33, 0.33]])).mean(0)
    return convert_vcn_checkpoint(sd), mean


# ------------------------------------------------- seeded reference weights
LEVEL_NAMES = (6, 5, 4, 3, 2)  # the reference's names of levels 0..4 (coarse to fine)
# The published widths (gengshan-y/VCN, models/VCN.py and models/
# submodule.py). The feature widths are also those vcn_flow.py's pspnet
# docstring pins; the rest follow from the graph.
PSP_STEM = (16, 16, 32)
PSP_BLOCKS = {3: 64, 5: 128, 6: 128, 7: 128}
PSP_UP = 64      # upconv6/5/4; upconv3 gives 32
FEAT = (128, 128, 128, 64, 64)
FDIMB = (16, 16, 16, 16, 12)
STACK = (128, 128, 128, 96, 64, 32)


def reference_state_dict(seed: int = 0, div: int = 1) -> Dict[str, np.ndarray]:
    """A VCN+ state dict in the reference's layout (the keys and shapes that
    ``convert_vcn_checkpoint`` reads from vcn_rob.pth, with its 'module.'
    prefix) holding seeded random weights: convolutions drawn as torch
    initializes a new Conv (uniform, bound 1/sqrt(fan_in), biases too), and
    BatchNorm weights, biases, running means and variances away from the
    identity, so BN folding is exercised. ``div`` divides every channel
    width (1: the published widths; the tests run narrower).

    With He-scaled weights (std sqrt(2/fan_in)) the fusion logits grow large
    enough that fp32 rounding of the conv sums alone moves the fused flow
    to the edge of a 1e-3 px comparison between two correct
    implementations (tests/test_torch_vcn.py holds that case in float64);
    torch's default scale keeps them small."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def ch(c):
        return max(c // div, 1)

    def conv(name, cin, cout, k, bias=True):
        shape = (cout, cin) + tuple(k)
        bound = 1.0 / np.sqrt(cin * np.prod(k))  # torch's default Conv init
        sd[name + ".weight"] = rng.uniform(-bound, bound, shape).astype(np.float32)
        if bias:
            sd[name + ".bias"] = rng.uniform(-bound, bound, cout).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = rng.uniform(0.75, 1.25, c).astype(np.float32)
        sd[name + ".bias"] = (rng.standard_normal(c) * 0.05).astype(np.float32)
        sd[name + ".running_mean"] = (rng.standard_normal(c) * 0.05).astype(np.float32)
        sd[name + ".running_var"] = rng.uniform(0.75, 1.25, c).astype(np.float32)
        sd[name + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def cbr(name, cin, cout, k=3, unit="cbr_unit", bias=True):
        conv(f"{name}.{unit}.0", cin, cout, (k, k), bias)
        bn(f"{name}.{unit}.1", cout)

    stem = [ch(c) for c in PSP_STEM]
    for i, (cin, cout) in enumerate(zip([3] + stem[:2], stem)):
        cbr(f"pspnet.convbnrelu1_{i + 1}", cin, cout)
    cin = stem[2]
    for rb, c in PSP_BLOCKS.items():
        pre, c = f"pspnet.res_block{rb}.0", ch(c)
        cbr(pre + ".convbnrelu1", cin, c)
        cbr(pre + ".convbn2", c, c, unit="cb_unit")
        conv(pre + ".downsample.0", cin, c, (1, 1), bias=False)
        bn(pre + ".downsample.1", c)
        cin = c
    for i in range(3):
        cbr(f"pspnet.pyramid_pooling.path_module_list.{i}", cin, cin, 1, bias=False)
    feat = [ch(c) for c in FEAT]
    up = ch(PSP_UP)
    # upconv N + iconv N-1: [conv N-1 | upconv(conv N)] -> FEAT
    skips = {5: ch(PSP_BLOCKS[6]), 4: ch(PSP_BLOCKS[5]), 3: ch(PSP_BLOCKS[3]), 2: stem[2]}
    prev = ch(PSP_BLOCKS[7])
    for u, ic, out in ((6, 5, feat[1]), (5, 4, feat[2]), (4, 3, feat[3]), (3, 2, feat[4])):
        uo = up if u > 3 else ch(PSP_UP // 2)
        cbr(f"pspnet.upconv{u}.1", prev, uo)
        cbr(f"pspnet.iconv{ic}", skips[ic] + uo, out)
        prev = out

    hyp = 0  # flow hypotheses carried into each level's fusion
    for level, n in enumerate(LEVEL_NAMES):
        full, fa, fb = level == 4, feat[level], ch(FDIMB[level])
        conv(f"f{n}.proj.0.conv1", fa, fb, (1, 1, 1), bias=False)
        bn(f"f{n}.proj.0.bn", fb)
        for blk in ("conva1", "conva2", "convb3", "convb2", "convb1"):
            pre = f"f{n}.{blk}"
            for sep in ("conv1", "conv2"):
                conv(f"{pre}.{sep}.conv1.0", fb, fb, (1, 3, 3), bias=False)
                bn(f"{pre}.{sep}.conv1.1", fb)
                conv(f"{pre}.{sep}.conv2.0", fb, fb, (3, 3, 1), bias=False)
                bn(f"{pre}.{sep}.conv2.1", fb)
            if blk in ("conva1", "conva2"):  # stride 2 over (u, v)
                if full:
                    for k in ("conv1", "conv2"):
                        conv(f"{pre}.downsample.{k}.0", fb, fb, (1, 1, 1), bias=False)
                        bn(f"{pre}.downsample.{k}.1", fb)
                else:
                    conv(f"{pre}.downsample.conv1", fb, fb, (1, 1, 1), bias=False)
                    bn(f"{pre}.downsample.bn", fb)
        conv(f"p{n}.conv1", fb, fb, (1, 3, 3))
        conv(f"p{n}.conv2", fb, fb, (3, 3, 1))
        hyp += fb
        cin = 4 * hyp + fa  # [entropies | flows | features]
        names = ([f"dc{n}_conv{i}" for i in range(1, 8)],
                 [f"dc{n}_convo.{i}" for i in range(7)] if full else None)
        for stack, cout in zip(names, (2 * hyp, 1)):
            if stack is None:
                continue
            c = cin
            for name, width in zip(stack, STACK):
                conv(name + ".0", c, ch(width), (3, 3))
                bn(name + ".1", ch(width))
                c = ch(width)
            conv(stack[-1], c, cout, (3, 3))
    return {"module." + k: v for k, v in sd.items()}
