"""The training step: forward render -> losses -> grads -> update.

Counterpart of moda_tpu/train/step.py: the init, ft1 and ft2 stages (fine
pass, delta-skin MLP, uncertainty-guided active sampling) and the step's
branches (ft_cse's live CSE features, training without bones, the
freeze_coarse snapshot, gradient accumulation), K optimizer steps per call
(``chunk_steps``, the JAX step's lax.scan) and data parallelism over
processes (``comm``, parallel/dist.py). Each call makes K >= 1 steps:
each updates the model's parameters and the optimizer state in place, and
the call returns their (aux, host_out) stacked [K, ...]. Random draws come
from a ``torch.Generator`` or, for tests, from an explicit ``draws`` dict
per step (see render/rays.py,
render/pipeline.py and "eik_idx" [1000]).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as Fn

from moda_tpu_torch.parallel.dist import Shard, pair_index
from moda_tpu_torch.render import losses as L
from moda_tpu_torch.render.pipeline import REPLICATED_OUTPUTS, render_rays
from moda_tpu_torch.render.rays import build_rays, ray_count
from moda_tpu_torch.runtime import Device, resolve_device
from moda_tpu_torch.train.optim import (MoDAOptimizer, OptState, apply_freeze_masks,
                                        clip_by_group, reject_nonfinite)


def batch_rtk(model, rtk_all3: torch.Tensor, batch) -> torch.Tensor:
    """Per-batch rtk [2B,4,4]: root poses (rows 0-2) + intrinsics (row 3)."""
    rt = rtk_all3[batch["frameid"]]
    ks = model.ks_param[batch["dataid"]]
    return torch.cat([rt, ks[:, None, :]], 1)


def _segment_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """jax.ops.segment_sum: ids outside [0, n) are dropped, not raised on."""
    ok = (ids >= 0) & (ids < n)
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, torch.where(ok, ids, torch.zeros_like(ids)),
                          torch.where(ok, vals, torch.zeros_like(vals)))


def sil_loss_filter(sil_loss_samp, frameid, num_fr, sil_err_median, progress, warmup_steps,
                    scale_factor=10.0):
    """Frame-level outlier rejection against a host-provided running median.
    Returns (keep [R,1], frame_err [num_fr], frame_cnt [num_fr])."""
    err = sil_loss_samp[..., 0]
    sums = _segment_sum(err, frameid, num_fr)
    cnts = _segment_sum((err > 0).to(err.dtype), frameid, num_fr)
    frame_err = sums / torch.clamp(cnts, min=1e-9)
    bad_frame = frame_err > sil_err_median * scale_factor
    active = torch.as_tensor(progress, device=err.device) > warmup_steps
    keep = torch.where(active & bad_frame[frameid], 0.0, 1.0)[..., None]
    return keep, frame_err, cnts


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """np.median over the masked subset; +inf when the subset is empty."""
    n = mask.sum()
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    lo = s[torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)]
    hi = s[torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)]
    return torch.where(n > 0, 0.5 * (lo + hi), torch.full_like(lo, float("inf")))


def sil_loss_filter_line(sil_loss_samp, errid, frameid, num_fr, img_size, progress,
                         warmup_steps, scale_factor=10.0):
    """Line-level outlier rejection for lineload training: per-line mean
    sil error, per-frame mean over nonzero lines, frames above 10x the
    masked median of this step are rejected."""
    err = sil_loss_samp[..., 0]
    nlines = num_fr * img_size
    line_sum = _segment_sum(err, errid, nlines)
    line_cnt = _segment_sum((err > 0).to(err.dtype), errid, nlines)
    line_err = (line_sum / torch.clamp(line_cnt, min=1e-9)).reshape(num_fr, img_size)
    fr_cnt = (line_err > 0).sum(-1).to(err.dtype)
    frame_err = line_err.sum(-1) / (1e-9 + fr_cnt)
    med = masked_median(frame_err, frame_err > 0)
    bad_frame = frame_err > med * scale_factor
    active = torch.as_tensor(progress, device=err.device) > warmup_steps
    keep = torch.where(active & bad_frame[frameid], 0.0, 1.0)[..., None]
    return keep, frame_err, fr_cnt


# StepExtras fields that vary per step inside a chunk (stacked [K]); the
# others (shape_samp, base_rt, ...) hold for the epoch
CHUNK_STEP_FIELDS = ("progress", "loss_select", "root_update", "body_update",
                     "shape_update", "cvf_update", "sil_err_median",
                     "embed_alpha")
# the rays' fields the losses and the silhouette filters read
LOSS_RAY_KEYS = ("sil_at_samp", "vis_at_samp", "frameid", "errid")


class StepExtras(NamedTuple):
    """Per-step scalars/arrays prepared by the trainer."""

    progress: torch.Tensor
    loss_select: torch.Tensor
    root_update: torch.Tensor
    body_update: torch.Tensor
    shape_update: torch.Tensor
    cvf_update: torch.Tensor
    sil_err_median: torch.Tensor
    shape_samp: torch.Tensor
    shape_samp_valid: torch.Tensor
    embed_alpha: torch.Tensor
    base_rt: Optional[torch.Tensor] = None


def live_cse_feats(model, batch, progress, pairs=None):
    """ft_cse: the trainable CSE net on the batch's full crops, resized to
    img_size as jax.image.resize's "linear" upsampling (half-pixel centres,
    the bilinear of align_corners=False). Returns (live features [2B, 16,
    S*S] for the renderer, detached until ftcse_steps, and the 1e-5
    distillation loss against the precomputed features on the pixels that
    have them; with ``pairs`` over every rank's pixels)."""
    cfg = model.cfg
    S = cfg.img_size
    imgs = batch["imgs"].reshape(-1, 3, S, S).permute(0, 2, 3, 1)
    live = model.apply_csenet(imgs).permute(0, 3, 1, 2)
    live = Fn.interpolate(live, size=(S, S), mode="bilinear", align_corners=False)
    live = live.reshape(live.shape[0], live.shape[1], -1)
    pre = batch["dp_feats"]
    valid_px = (pre.abs().sum(1, keepdim=True) > 0).to(live.dtype)
    sq = ((live - pre) ** 2).sum(1, keepdim=True) * valid_px
    if pairs is None:
        loss = 1e-5 * sq.sum() / torch.clamp(valid_px.sum(), min=1.0)
    else:  # every rank's crops: their per-crop sums, gathered
        num, cnt = pairs.gather(sq.sum((1, 2)), valid_px.sum((1, 2)))
        loss = 1e-5 * num.sum() / torch.clamp(cnt.sum(), min=1.0)
    # the main losses reach the CSE net only after ftcse_steps
    used = torch.where(torch.as_tensor(progress) > cfg.ftcse_steps, live, live.detach())
    return used, loss


def micro_batches(batch: Dict[str, torch.Tensor], accu_steps: int):
    """accu_steps micro-batches of B // accu_steps pairs: the same slice of
    both halves of every [2B] array."""
    B = batch["frameid"].shape[0] // 2
    mb = B // accu_steps
    return [{k: torch.cat([v[j * mb:(j + 1) * mb], v[B + j * mb:B + (j + 1) * mb]], 0)
             for k, v in batch.items()} for j in range(accu_steps)]


def make_train_step(model, optimizer: MoDAOptimizer, *, nsample: int, ndepth: int,
                    use_fine: bool, use_dskin: bool, use_bones: bool,
                    nsample_active: int = 0, xyz_wt_snapshot=None, accu_steps: int = 1,
                    chunk_steps: int = 1, comm=None, device: Device = None):
    """Returns ``step(batches, extras0, per_step=None, generator=None,
    draws=None) -> (auxs, host_outs)``: K = chunk_steps whole optimizer
    steps, one after the other (the JAX step's lax.scan), on ``batches``
    (every field stacked [K, 2B, ...]). Step j reads ``extras0`` with its
    CHUNK_STEP_FIELDS replaced by ``per_step``'s slice j ({field: [K]};
    None keeps extras0's) and ``draws[j]`` (``draws``: None or a list of
    K). Each step updates ``model``'s parameters and ``optimizer.state`` in
    place before the next reads them; the outputs come back stacked [K,
    ...]. The step runs on the card unless device="cpu" is passed (the
    model must already live there).

    use_bones=False renders without the deformation model (the rays carry
    no bone keys). xyz_wt_snapshot: {component: {layer: kernel}}, the
    trunks' input-layer kernels at stage start, which freeze_coarse
    distils against. accu_steps > 1 splits each step's batch into
    micro-batches (``micro_batches``), averages their gradients and makes
    one update; each step's draws are then a list with one dict per
    micro-batch.

    comm (parallel/dist.py): data parallelism. ``batches`` hold this rank's
    share of the global batch (``dist.shard_batch``), draws are the global
    batch's, and the step computes what one process computes on the global
    batch; aux and host_out (with the global batch's "rtk" and "frameid")
    are the same on every rank."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, step asked for {dev}")
    cfg = model.cfg
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    if getattr(optimizer, "state", None) is None:
        optimizer.state = optimizer.init({k: v.detach() for k, v in params.items()})
    ft_cse = cfg.ft_cse and cfg.use_embed and not cfg.lineload

    def pairs_of(n_local: int, accu: int):
        """The Shard of this rank's rows of a global [2B] batch."""
        if comm is None:
            return None
        idx = torch.as_tensor(pair_index(comm.rank, comm.world, n_local, accu), device=dev)
        return Shard(comm, idx, 2 * n_local * comm.world)

    def loss_fn(batch, extras: StepExtras, draws, generator):
        draws = draws or {}
        pairs = pairs_of(batch["frameid"].shape[0] // 2, 1)
        base_rt = extras.base_rt if cfg.use_cam else None
        rtk_all3 = model.compute_rts(base_rt=base_rt)
        rtk = batch_rtk(model, rtk_all3, batch)
        csenet_loss = None
        if ft_cse:
            # batch mode only, as in the reference: line rows carry no crops
            live, csenet_loss = live_cse_feats(model, batch, extras.progress, pairs)
            batch = dict(batch, dp_feats=live)
        rays = build_rays(model, batch, rtk, nsample, nsample_active=nsample_active,
                          embed_alpha=extras.embed_alpha, generator=generator, draws=draws,
                          pairs=pairs)
        if not use_bones:
            for k in ("bone_rts", "bone_rts_target", "bones_rst", "rest_pose_code"):
                rays.pop(k, None)
        shard = None if pairs is None else pairs.sub(
            rays["ray_index"], ray_count(pairs.n // 2, nsample, nsample_active))
        rendered = render_rays(model, rays, ndepth, use_fine=use_fine, use_dskin=use_dskin,
                               draws=draws, generator=generator, shard=shard)
        if shard is not None:
            # the losses and filters read every rank's rays: the global bundle
            rendered = shard.gather_dict(rendered, [k for k in rendered
                                                    if k not in REPLICATED_OUTPUTS])
            rays = shard.gather_dict(rays, LOSS_RAY_KEYS)
        keep = torch.ones_like(rendered["sil_loss_samp"])
        frame_err = torch.zeros(model.num_fr, device=dev)
        frame_cnt = torch.zeros(model.num_fr, device=dev)
        if cfg.loss_flt:
            if cfg.lineload and "errid" in rays:
                keep, frame_err, frame_cnt = sil_loss_filter_line(
                    rendered["sil_loss_samp"] * cfg.sil_wt, rays["errid"], rays["frameid"],
                    model.num_fr, cfg.img_size, extras.progress, cfg.warmup_steps)
            else:
                keep, frame_err, frame_cnt = sil_loss_filter(
                    rendered["sil_loss_samp"] * cfg.sil_wt, rays["frameid"], model.num_fr,
                    extras.sil_err_median, extras.progress, cfg.warmup_steps)
        loss_extras = {
            "loss_select": extras.loss_select, "invalid_mask": keep,
            "shape_samp": extras.shape_samp, "shape_samp_valid": extras.shape_samp_valid,
            "progress": extras.progress,
        }
        if cfg.freeze_coarse and xyz_wt_snapshot is not None:
            loss_extras["xyz_wt_snapshot"] = xyz_wt_snapshot
        rtk_all = torch.cat([rtk_all3, torch.zeros(model.num_fr, 1, 4, device=dev)], 1)
        total, aux = L.total_loss(model, rendered, rays, rtk_all, loss_extras, draws=draws,
                                  generator=generator)
        if csenet_loss is not None and cfg.mt_cse:
            # distillation alone before mtcse_steps, added to the total after
            total = torch.where(torch.as_tensor(extras.progress) < cfg.mtcse_steps,
                                csenet_loss, total + csenet_loss)
            aux["csenet_loss"] = csenet_loss
        return total, aux, {"rtk": rtk.detach(), "frame_err": frame_err.detach(),
                            "frame_cnt": frame_cnt.detach()}

    def grads_of(total):
        plist = [params[n] for n in names]
        gl = torch.autograd.grad(total, plist, allow_unused=True)
        return {n: (torch.zeros_like(p) if g is None else g) for n, p, g in zip(names, plist, gl)}

    def accumulate(batch, extras, draws, generator):
        """One loss and gradient per micro-batch; the gradients' mean, the
        auxiliaries' mean, this batch's rtk, the frames' worst error and
        their summed counts."""
        grads, auxs, hosts = None, [], []
        for j, b in enumerate(micro_batches(batch, accu_steps)):
            total, aux, host = loss_fn(b, extras, None if draws is None else draws[j],
                                       generator)
            g = grads_of(total)
            grads = ({n: v / accu_steps for n, v in g.items()} if grads is None else
                     {n: grads[n] + g[n] / accu_steps for n in names})
            auxs.append({k: v.detach() for k, v in aux.items()})
            hosts.append(host)
        aux = {k: torch.stack([a[k] for a in auxs]).mean(0) for k in auxs[0]}
        with torch.no_grad():
            rtk = batch_rtk(model, model.compute_rts(
                base_rt=extras.base_rt if cfg.use_cam else None), batch)
        host_out = {"rtk": rtk,
                    "frame_err": torch.stack([h["frame_err"] for h in hosts]).amax(0),
                    "frame_cnt": torch.stack([h["frame_cnt"] for h in hosts]).sum(0)}
        return grads, aux, host_out

    def one_step(batch: Dict[str, torch.Tensor], extras: StepExtras, generator, draws):
        if accu_steps > 1:
            grads, aux, host_out = accumulate(batch, extras, draws, generator)
        else:
            total, aux, host_out = loss_fn(batch, extras, draws, generator)
            grads = grads_of(total)
        if comm is not None:
            grads = comm.mean_(grads)
            # the global batch's cameras; the frames' errors from rank 0
            # (a scatter-add's order may differ between ranks on the card)
            pairs = pairs_of(batch["frameid"].shape[0] // 2, accu_steps)
            host_out["rtk"], host_out["frameid"] = pairs.gather(host_out["rtk"],
                                                                batch["frameid"])
            comm.broadcast_([host_out["frame_err"], host_out["frame_cnt"]])
        grads, finite = reject_nonfinite(grads)
        grads = apply_freeze_masks(grads, {
            "root_update": extras.root_update, "body_update": extras.body_update,
            "shape_update": extras.shape_update, "cvf_update": extras.cvf_update}, cfg)
        grads, norms = clip_by_group(grads, cfg.clip_scale)
        state: OptState = optimizer.state
        root_rejected = torch.zeros((), device=dev)
        if cfg.root_stab_reject and "nerf_root_rts_g" in norms:
            # drop this step's root update when the root gradient norm exceeds
            # clip_scale after the 200-step grace period
            root_hot = (norms["nerf_root_rts_g"] > cfg.clip_scale) & (state.count >= 200)
            keep_root = 1.0 - root_hot.float()
            grads = {k: (g * keep_root if k.split(".", 1)[0] in ("nerf_root_rts", "root_code")
                         else g) for k, g in grads.items()}
            root_rejected = root_hot.float()
        old = {n: params[n].detach() for n in names}
        new_params, optimizer.state = optimizer.update(grads, state, old, finite)
        with torch.no_grad():
            for n in names:
                params[n].copy_(new_params[n])
        aux = {k: v.detach() for k, v in aux.items()}
        aux.update(norms)
        aux["grad_finite"] = finite.float()
        aux["root_step_rejected"] = root_rejected
        aux["lr"] = optimizer.sched(state.count.float())
        aux["shape_frozen"] = torch.as_tensor(extras.shape_update, dtype=torch.float32)
        return aux, host_out

    def step(batches: Dict[str, torch.Tensor], extras0: StepExtras,
             per_step: Optional[Dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None, draws=None):
        if batches["frameid"].shape[0] != chunk_steps:
            raise ValueError(f"batches stack {batches['frameid'].shape[0]} steps, the step "
                             f"makes {chunk_steps}")
        outs = []
        for j in range(chunk_steps):
            ex = extras0 if per_step is None else \
                extras0._replace(**{f: v[j] for f, v in per_step.items()})
            outs.append(one_step({k: v[j] for k, v in batches.items()}, ex, generator,
                                 None if draws is None else draws[j]))
        auxs = {k: torch.stack([torch.as_tensor(a[k]) for a, _ in outs]) for k in outs[0][0]}
        hosts = {k: torch.stack([h[k] for _, h in outs]) for k in outs[0][1]}
        return auxs, hosts

    return step
