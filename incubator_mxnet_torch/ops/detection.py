"""Detection operators: anchors, target assignment, decoding, NMS.

Counterpart of the JAX package's ``ops/detection.py`` (parity targets:
``MultiBoxPrior``/``MultiBoxTarget``/``MultiBoxDetection`` and
``box_nms``/``box_iou`` of the reference's ``src/operator/contrib``), the
op set of the SSD family.  Plain PyTorch, as the JAX package leaves these
to XLA: no kernel stands behind them.

Every op is fixed-shape and mask-based, as the reference's: suppressed or
invalid results are ``-1`` rows of a constant-shape output.  The batch is a
tensor dimension throughout, and nothing reads a value back to the host,
indexes with a boolean mask or copies from the host, so each op runs
inside a CUDA-graph capture (the step fold).  Two rules keep the results
equal to the JAX package's:

* every sort is stable (``jnp.argsort`` is), so ties (the ``-inf`` scores
  of positives and invalid anchors, equal scores) keep index order;
* the bipartite stage of matching takes, for each anchor, the last gt
  whose best anchor it is, as the JAX scatter's last writer in gt order
  does, and computes it without a scatter (a CUDA scatter with duplicate
  indices picks a writer at random).

NMS is a sequential scan over the K top candidates (K bounded by
``topk``/``nms_topk``), one step per candidate with the batch as a
tensor dimension.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import alias, register

__all__ = ["box_iou", "multibox_prior", "multibox_target", "multibox_detection",
           "box_nms"]


def _corner_iou(lhs, rhs, eps=1e-12):
    """IoU of corner-format boxes: lhs [..., N, 4] x rhs [..., M, 4] → [..., N, M]."""
    lx1, ly1, lx2, ly2 = lhs.unbind(-1)
    rx1, ry1, rx2, ry2 = rhs.unbind(-1)
    ix1 = torch.maximum(lx1[..., :, None], rx1[..., None, :])
    iy1 = torch.maximum(ly1[..., :, None], ry1[..., None, :])
    ix2 = torch.minimum(lx2[..., :, None], rx2[..., None, :])
    iy2 = torch.minimum(ly2[..., :, None], ry2[..., None, :])
    iw = torch.clamp(ix2 - ix1, min=0.0)
    ih = torch.clamp(iy2 - iy1, min=0.0)
    inter = iw * ih
    larea = torch.clamp(lx2 - lx1, min=0.0) * torch.clamp(ly2 - ly1, min=0.0)
    rarea = torch.clamp(rx2 - rx1, min=0.0) * torch.clamp(ry2 - ry1, min=0.0)
    union = larea[..., :, None] + rarea[..., None, :] - inter
    return inter / torch.clamp(union, min=eps)


def _center_to_corner(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


@register("box_iou", differentiable=False)
def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU.  lhs [..., N, 4], rhs [..., M, 4] → [..., N, M]."""
    if format == "center":
        lhs = _center_to_corner(lhs)
        rhs = _center_to_corner(rhs)
    return _corner_iou(lhs, rhs)


@register("contrib_MultiBoxPrior", differentiable=False)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor generation for a [B, C, H, W] feature map → [1, H·W·A, 4]
    corner boxes normalized to [0, 1], A = len(sizes) + len(ratios) - 1
    (all sizes at ratios[0], plus sizes[0] at each remaining ratio: the
    reference's combination rule).  Built on ``data``'s device from its
    shape alone, in float32."""
    if isinstance(sizes, (int, float)):
        sizes = (sizes,)
    if isinstance(ratios, (int, float)):
        ratios = (ratios,)
    h, w = data.shape[-2], data.shape[-1]
    step_y = steps[0] if steps and steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps and steps[1] > 0 else 1.0 / w
    dev = data.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")  # [H, W]

    wh = []
    for s in sizes:
        r = math.sqrt(ratios[0])
        wh.append((s * r, s / r))
    for ratio in ratios[1:]:
        r = math.sqrt(ratio)
        wh.append((sizes[0] * r, sizes[0] / r))
    # each width and height rounded to float32 first, as the JAX op holds
    # them in a float32 array; halving is then exact
    halves = [(float(np.float32(bw)) / 2, float(np.float32(bh)) / 2) for bw, bh in wh]
    boxes = torch.stack([torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)
                         for hw, hh in halves], dim=2)  # [H, W, A, 4]
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes.reshape(1, h * w * len(wh), 4)


def _encode_boxes(anchors, gt, variances):
    """SSD box encoding: corner anchors [N, 4] + corner gt [..., N, 4] →
    regression targets [..., N, 4]."""
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = torch.clamp(anchors[:, 2] - anchors[:, 0], min=1e-12)
    ah = torch.clamp(anchors[:, 3] - anchors[:, 1], min=1e-12)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    gw = torch.clamp(gt[..., 2] - gt[..., 0], min=1e-12)
    gh = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-12)
    return torch.stack([
        (gcx - acx) / aw / variances[0],
        (gcy - acy) / ah / variances[1],
        torch.log(gw / aw) / variances[2],
        torch.log(gh / ah) / variances[3],
    ], dim=-1)


def _decode_boxes(anchors, pred, variances, clip):
    """anchors [N, 4], pred [..., N, 4] → corner boxes [..., N, 4]."""
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    cx = pred[..., 0] * variances[0] * aw + acx
    cy = pred[..., 1] * variances[1] * ah + acy
    w = torch.exp(pred[..., 2] * variances[2]) * aw
    h = torch.exp(pred[..., 3] * variances[3]) * ah
    out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def _match_anchors(anchors, gt_boxes, gt_valid, overlap_threshold):
    """The reference's matching rule, dense and batched: every gt claims its
    best anchor (bipartite stage), then the other anchors match their best
    gt where the IoU reaches the threshold.  anchors [N, 4], gt_boxes
    [B, M, 4], gt_valid [B, M] → match [B, N] of gt indices or -1.

    The bipartite stage is the JAX op's scatter of ``j if force[j] else
    -1`` onto ``best_anchor[j]`` for j in gt order, the last writer
    winning: so anchor n takes the value of the last gt whose best anchor
    is n, a padded row (best anchor 0, not forced) writing -1 over an
    earlier forced gt."""
    iou = _corner_iou(anchors, gt_boxes)                   # [B, N, M]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_iou = iou.amax(dim=2)                             # [B, N]
    best_gt = torch.argmax(iou, dim=2)                     # the first largest, as jnp
    match = torch.where(best_iou >= overlap_threshold, best_gt, -1)
    best_anchor = torch.argmax(iou, dim=1)                 # [B, M]
    force = gt_valid & (iou.amax(dim=1) > 0)
    n, m = iou.shape[1:]
    claims = best_anchor[:, None, :] == torch.arange(n, device=iou.device)[None, :, None]
    # [B, N]: the last gt claiming each anchor, -1 where none does
    last = torch.where(claims, torch.arange(m, device=iou.device), -1).amax(dim=-1)
    safe = torch.clamp(last, min=0)
    forced = torch.where((last >= 0) & torch.gather(force, 1, safe), last, -1)
    return torch.where(forced >= 0, forced, match)


@register("contrib_MultiBoxTarget", differentiable=False)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor → ground-truth assignment for SSD training.

    anchor: [1, N, 4] corner boxes; label: [B, M, 5] rows of
    (class_id, xmin, ymin, xmax, ymax), padded with -1; cls_pred:
    [B, num_classes+1, N] (used for hard-negative mining when
    ``negative_mining_ratio > 0``).

    Returns (box_target [B, N·4], box_mask [B, N·4], cls_target [B, N])
    where cls_target is gt class + 1 for matched anchors, 0 for
    background, ``ignore_label`` for mined-out negatives.
    """
    anchors = anchor.reshape(-1, 4)
    n = anchors.shape[0]
    label = label.detach()
    b = label.shape[0]
    gt_cls = label[..., 0]
    gt_valid = gt_cls >= 0
    gt_boxes = label[..., 1:5]
    match = _match_anchors(anchors, gt_boxes, gt_valid, overlap_threshold)
    matched = match >= 0
    safe = torch.clamp(match, min=0)
    targets = _encode_boxes(anchors, torch.gather(gt_boxes, 1, safe[..., None].expand(b, n, 4)),
                            variances)
    box_target = torch.where(matched[..., None], targets, 0.0).reshape(b, -1)
    box_mask = matched[..., None].expand(b, n, 4).to(torch.float32).reshape(b, -1)
    cls_target = torch.where(matched, torch.gather(gt_cls, 1, safe).to(torch.int32) + 1, 0)
    if negative_mining_ratio > 0:
        # hard-negative mining: keep the top (ratio × #pos) background
        # anchors by background-loss proxy (1 - P(bg)); others → ignore
        bg_prob = cls_pred.detach()[:, 0]
        neg_score = torch.where(matched, -math.inf, 1.0 - bg_prob)
        neg_score = torch.where(neg_score >= (1.0 - negative_mining_thresh), neg_score,
                                -math.inf)
        num_pos = matched.sum(dim=1, dtype=torch.int32)
        budget = torch.clamp((negative_mining_ratio * num_pos).to(torch.int32),
                             min=int(minimum_negative_samples))
        order = torch.argsort(-neg_score, dim=1, stable=True)
        rank = torch.argsort(order, dim=1)  # the inverse permutation
        keep_neg = (rank < budget[:, None]) & torch.isfinite(neg_score)
        cls_target = torch.where(matched | keep_neg, cls_target, int(ignore_label))
    return box_target, box_mask, cls_target.to(torch.float32)


def _nms_keep(boxes, cls_id, valid, thresh, force_suppress):
    """Sequential NMS over candidates sorted by descending score, batched:
    boxes [B, K, 4], cls_id and valid [B, K] → keep mask [B, K]."""
    k = boxes.shape[1]
    iou = _corner_iou(boxes, boxes)
    sup = iou > thresh
    if not force_suppress:
        sup = sup & (cls_id[:, :, None] == cls_id[:, None, :])
    # sup[:, i, j]: j can suppress i, for j earlier than i
    sup = sup & torch.ones(k, k, dtype=torch.bool, device=boxes.device).tril(-1)
    keep = valid.clone()
    for i in range(k):
        suppressed = (keep & sup[:, i]).any(dim=1)
        keep[:, i] = keep[:, i] & ~suppressed
    return keep


def _topk_order(score, valid, k):
    """The first k indices by descending score, invalid ones last, ties in
    index order (a stable sort, as ``jnp.argsort``)."""
    return torch.argsort(-torch.where(valid, score, -math.inf), dim=-1, stable=True)[:, :k]


@register("contrib_MultiBoxDetection", differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5, force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=400):
    """Decode + per-class NMS → [B, N, 6] rows (class_id, score, xmin,
    ymin, xmax, ymax); suppressed/invalid rows are all -1.

    cls_prob: [B, num_classes+1, N] softmax class probabilities (class
    ``background_id`` is background), loc_pred: [B, N·4], anchor:
    [1, N, 4].  ``nms_topk`` bounds the O(K²) NMS candidate count (the
    reference's -1 "all" maps to K = min(N, 400) by default).
    """
    anchors = anchor.reshape(-1, 4)
    n = anchors.shape[0]
    k = n if nms_topk is None or nms_topk <= 0 else min(int(nms_topk), n)
    bsz = cls_prob.shape[0]
    fg = torch.cat([cls_prob[:, :background_id], cls_prob[:, background_id + 1:]], dim=1)
    score, _ = fg.max(dim=1)                               # [B, N]
    cls_id = torch.argmax(fg, dim=1).to(torch.int32)
    boxes = _decode_boxes(anchors, loc_pred.reshape(bsz, n, 4), variances, clip)
    valid = score > threshold
    order = _topk_order(score, valid, k)                   # [B, K]
    boxes_k = torch.gather(boxes, 1, order[..., None].expand(bsz, k, 4))
    score_k = torch.gather(score, 1, order)
    cls_k = torch.gather(cls_id, 1, order)
    keep = _nms_keep(boxes_k, cls_k, torch.gather(valid, 1, order), nms_threshold,
                     force_suppress)
    rows = torch.cat([cls_k[..., None].to(torch.float32), score_k[..., None].float(),
                      boxes_k.float()], dim=-1)
    out = torch.full((bsz, n, 6), -1.0, dtype=torch.float32, device=cls_prob.device)
    out[:, :k] = torch.where(keep[..., None], rows, -1.0)
    return out


@register("box_nms", differentiable=False)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Generic NMS over [..., N, K] records (parity: ``nd.contrib.box_nms``).
    Suppressed records are overwritten with -1; shape is unchanged, and the
    kept records keep their format (``out_format`` is accepted and changes
    nothing, as in the JAX op)."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    bsz, n, width = flat.shape
    k = n if topk is None or topk <= 0 else min(int(topk), n)
    score = flat[..., score_index]
    boxes = flat[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    if id_index >= 0:
        cls_id = flat[..., id_index].to(torch.int32)
        valid = (score > valid_thresh) & (cls_id != background_id)
    else:
        cls_id = torch.zeros((bsz, n), dtype=torch.int32, device=data.device)
        valid = score > valid_thresh
    order = _topk_order(score, valid, k)
    keep = _nms_keep(torch.gather(boxes, 1, order[..., None].expand(bsz, k, 4)),
                     torch.gather(cls_id, 1, order), torch.gather(valid, 1, order),
                     overlap_thresh, force_suppress or id_index < 0)
    recs = torch.gather(flat, 1, order[..., None].expand(bsz, k, width))
    out = torch.full_like(flat, -1.0)
    out[:, :k] = torch.where(keep[..., None], recs, -1.0)
    return out.reshape(shape)


alias("contrib_box_nms", "box_nms")
alias("contrib_box_iou", "box_iou")
