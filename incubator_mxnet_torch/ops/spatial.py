"""Spatial and vision operators, and the remaining legacy loss heads.

Counterpart of the JAX package's ``ops/spatial.py``, with its names,
aliases, parameters and semantics: the layout shuffles and index ops, the
masked softmaxes, ``LRN``, the bilinear samplers (``BilinearSampler``,
``GridGenerator``, ``SpatialTransformer``, ``_contrib_BilinearResize2D``)
and ``_contrib_AdaptiveAvgPooling2D``, the ROI ops, the deformable ops,
``Correlation``, ``im2col``/``col2im``, the output heads ``SVMOutput``,
``MAERegressionOutput`` and ``LogisticRegressionOutput`` (each with the
reference's gradient, whatever the head gradient), ``CTCLoss`` and
``Crop``.  Plain PyTorch on the input's device.

Kept where PyTorch would differ:

* Bilinear sampling is four gathers and a weighted sum (zero outside the
  image), as the JAX package computes it, not ``F.grid_sample``: its
  backward is a scatter-add that has a deterministic path on the card.
* ``ROIAlign`` with ``sample_ratio <= 0`` takes a fixed 2x2 grid a bin.
* ``CTCLoss`` is the log-space forward recursion, one step a frame under
  autograd, with the JAX package's -1e30 for log 0: an impossible
  alignment costs about 1e30, not ``inf``.  Its label padding of -1
  (``blank_label='last'``) wraps to the last class, as
  ``jnp.take_along_axis`` wraps it; those positions are masked.
* ``index_array`` returns int32 (the JAX package's int64 request, which it
  truncates to int32).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .registry import alias, register

__all__ = []

_F32_MIN = torch.finfo(torch.float32).min
NEG = -1e30  # the JAX package's log 0


def _div(a, b):
    """``a / b`` rounded as IEEE division on every device (PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, an ulp off,
    which moves a floor or a ceil sitting on an integer)."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def _half_away(v):
    """Round half away from zero, as the reference rounds ROI corners."""
    return torch.sign(v) * torch.floor(v.abs() + 0.5)


# -- layout shuffles ------------------------------------------------------------------


@register("depth_to_space")
def depth_to_space(data, block_size):
    """DCR-mode depth to space."""
    b, c, h, w = data.shape
    bs = int(block_size)
    x = data.reshape(b, bs, bs, c // (bs * bs), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // (bs * bs), h * bs, w * bs)


@register("space_to_depth")
def space_to_depth(data, block_size):
    b, c, h, w = data.shape
    bs = int(block_size)
    x = data.reshape(b, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, c * bs * bs, h // bs, w // bs)


@register("unravel_index")
def unravel_index(data, shape):
    """int32 coordinates, one row an axis; an index out of range is
    clipped and a negative one counts from the end, as in ``jnp``."""
    shape = tuple(int(s) for s in shape)
    total = math.prod(shape)
    idx = data.to(torch.int32).clamp(-total, total - 1)
    idx = torch.where(idx < 0, idx + total, idx)
    out = []
    for s in reversed(shape):
        out.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return torch.stack(out[::-1], dim=0).to(torch.int32)


@register("ravel_multi_index")
def ravel_multi_index(data, shape):
    shape = tuple(int(s) for s in shape)
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    st = torch.tensor(strides[::-1], dtype=data.dtype, device=data.device)
    return (data * st.reshape(-1, *([1] * (data.ndim - 1)))).sum(0)


@register("index_array", differentiable=False)
def index_array(data, axes=None):
    """Each element's coordinates: ``data.shape + (len(axes),)``."""
    axes = tuple(axes) if axes is not None else tuple(range(data.ndim))
    grids = torch.meshgrid(*[torch.arange(s, device=data.device) for s in data.shape],
                           indexing="ij")
    return torch.stack([grids[a] for a in axes], dim=-1).to(torch.int32)


@register("index_copy")
def index_copy(old, index, new):
    """``old`` with the rows at ``index`` replaced by ``new``."""
    return old.index_put((index.to(torch.long),), new.to(old.dtype))


@register("arange_like", differentiable=False)
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """float32 ramp shaped by ``data`` (all of it, or ``data.shape[axis]``),
    each value repeated ``repeat`` times."""
    repeat = max(1, int(repeat))

    def ramp(size):
        n_distinct = -(-size // repeat)
        vals = start + step * torch.arange(n_distinct, dtype=torch.float32, device=data.device)
        return vals.repeat_interleave(repeat)[:size]

    if axis is None:
        return ramp(data.numel()).reshape(data.shape)
    return ramp(data.shape[axis])


# -- masked softmax -------------------------------------------------------------------


def _masked(data, mask, temperature):
    m = mask != 0
    x = torch.where(m, data.float() / temperature, torch.full_like(data, _F32_MIN,
                                                                    dtype=torch.float32))
    return m, x


@register("masked_softmax")
def masked_softmax(data, mask, axis=-1, temperature=1.0):
    """Softmax over the positions where ``mask`` is set; a row with none
    gives 0."""
    _, x = _masked(data, mask, temperature)
    e = torch.exp(x - x.amax(axis, keepdim=True)) * mask.float()
    return (e / e.sum(axis, keepdim=True).clamp_min(1e-37)).to(data.dtype)


@register("masked_log_softmax")
def masked_log_softmax(data, mask, axis=-1, temperature=1.0):
    m, x = _masked(data, mask, temperature)
    mx = x.amax(axis, keepdim=True)
    e = torch.exp(x - mx) * mask.float()
    lse = torch.log(e.sum(axis, keepdim=True).clamp_min(1e-37)) + mx
    return torch.where(m, x - lse, torch.full_like(x, _F32_MIN)).to(data.dtype)


@register("LRN")
def lrn(data, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Cross-channel local response normalization."""
    x = data.float()
    half = int(nsize) // 2
    padded = F.pad(x * x, (0, 0, 0, 0, half, half))
    c = data.shape[1]
    ssum = padded[:, 0:c]
    for i in range(1, 2 * half + 1):
        ssum = ssum + padded[:, i:i + c]
    norm = (knorm + alpha / nsize * ssum) ** beta
    return (x / norm).to(data.dtype)


# -- bilinear sampling ----------------------------------------------------------------


def _bilinear_gather(data, x, y):
    """``data`` [B, C, H, W] sampled at fractional pixel coordinates x, y
    [B, ...], zero outside the image; [B, C, ...]."""
    B, C, H, W = data.shape
    out_shape = x.shape[1:]
    x = x.reshape(B, -1)
    y = y.reshape(B, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    flat = data.reshape(B, C, H * W)
    n = x.shape[1]

    def gather(yi, xi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.clamp(0, W - 1).to(torch.long)
        yc = yi.clamp(0, H - 1).to(torch.long)
        idx = (yc * W + xc)[:, None, :].expand(B, C, n)
        return torch.gather(flat, 2, idx) * inb[:, None, :].to(data.dtype)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    wx = wx[:, None, :].to(data.dtype)
    wy = wy[:, None, :].to(data.dtype)
    out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy + v11 * wx * wy)
    return out.reshape(B, C, *out_shape)


@register("BilinearSampler")
def bilinear_sampler(data, grid, cudnn_off=None):
    """``data`` sampled at ``grid`` [B, 2 (x, y), Ho, Wo] in [-1, 1]."""
    B, C, H, W = data.shape
    gx = (grid[:, 0].float() + 1.0) * (W - 1) / 2.0
    gy = (grid[:, 1].float() + 1.0) * (H - 1) / 2.0
    return _bilinear_gather(data, gx, gy)


@register("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """A sampling grid from affine parameters [B, 6] or a flow [B, 2, H, W]."""
    H, W = int(target_shape[0]), int(target_shape[1])
    dev = data.device
    if transform_type == "affine":
        B = data.shape[0]
        theta = data.reshape(B, 2, 3).float()
        gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, H, device=dev),
                                torch.linspace(-1.0, 1.0, W, device=dev), indexing="ij")
        coords = torch.stack([gx.reshape(-1), gy.reshape(-1), torch.ones_like(gx).reshape(-1)])
        return torch.einsum("bij,jk->bik", theta, coords).reshape(B, 2, H, W)
    B, _, Hf, Wf = data.shape
    gy, gx = torch.meshgrid(torch.arange(Hf, dtype=torch.float32, device=dev),
                            torch.arange(Wf, dtype=torch.float32, device=dev), indexing="ij")
    x = data[:, 0].float() + gx
    y = data[:, 1].float() + gy
    return torch.stack([2.0 * x / max(Wf - 1, 1) - 1.0, 2.0 * y / max(Hf - 1, 1) - 1.0], dim=1)


@register("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(0, 0), transform_type="affine",
                        sampler_type="bilinear", cudnn_off=None):
    """GridGenerator (affine) then BilinearSampler."""
    return bilinear_sampler(data, grid_generator(loc, "affine", target_shape))


@register("_contrib_BilinearResize2D")
def bilinear_resize2d(data, height=0, width=0, scale_height=None, scale_width=None,
                      mode="size", align_corners=True):
    B, C, H, W = data.shape
    if scale_height is not None:
        height = int(round(H * scale_height))
    if scale_width is not None:
        width = int(round(W * scale_width))
    Ho, Wo = int(height), int(width)
    dev = data.device

    def coords(n_out, n_in):
        if align_corners and n_out > 1:
            return torch.linspace(0.0, n_in - 1.0, n_out, device=dev)
        return (torch.arange(n_out, device=dev) + 0.5) * n_in / n_out - 0.5

    gy, gx = torch.meshgrid(coords(Ho, H), coords(Wo, W), indexing="ij")
    return _bilinear_gather(data, gx.expand(B, Ho, Wo), gy.expand(B, Ho, Wo))


def _avg_matrix(n_out, n_in, device):
    m = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        s = (i * n_in) // n_out
        e = -(-((i + 1) * n_in) // n_out)
        m[i, s:e] = 1.0 / (e - s)
    return torch.from_numpy(m).to(device)


@register("_contrib_AdaptiveAvgPooling2D")
def adaptive_avg_pooling2d(data, output_size=(1, 1)):
    """Adaptive average pooling as two averaging products (the reference's
    floor/ceil bin boundaries)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    Ho, Wo = int(output_size[0]), int(output_size[1])
    _, _, H, W = data.shape
    A = _avg_matrix(Ho, H, data.device)
    Bm = _avg_matrix(Wo, W, data.device)
    return torch.einsum("oh,bchw,pw->bcop", A, data.float(), Bm).to(data.dtype)


# -- ROI ops --------------------------------------------------------------------------


@register("ROIPooling")
def roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max over each ROI's bins (masked maxima; an empty bin gives 0)."""
    PH, PW = int(pooled_size[0]), int(pooled_size[1])
    B, C, H, W = data.shape
    batch_idx = rois[:, 0].to(torch.long)
    x1 = _half_away(rois[:, 1] * spatial_scale)
    y1 = _half_away(rois[:, 2] * spatial_scale)
    x2 = _half_away(rois[:, 3] * spatial_scale)
    y2 = _half_away(rois[:, 4] * spatial_scale)
    roi_h = (y2 - y1 + 1.0).clamp_min(1.0)
    roi_w = (x2 - x1 + 1.0).clamp_min(1.0)

    def bin_mask(start, extent, P, size):
        idx = torch.arange(P, dtype=torch.float32, device=data.device)
        bin_sz = _div(extent[:, None], float(P))
        s0 = torch.floor(start[:, None] + idx[None, :] * bin_sz).clamp(0, size)
        s1 = torch.ceil(start[:, None] + (idx[None, :] + 1) * bin_sz).clamp(0, size)
        c = torch.arange(size, dtype=torch.float32, device=data.device)
        return (c[None, None, :] >= s0[:, :, None]) & (c[None, None, :] < s1[:, :, None])

    row_m = bin_mask(y1, roi_h, PH, H)
    col_m = bin_mask(x1, roi_w, PW, W)
    f32 = data[batch_idx].float()
    neg = torch.tensor(_F32_MIN, device=data.device)
    tmp = torch.where(row_m[:, None, :, :, None], f32[:, :, None, :, :], neg).amax(3)
    out = torch.where(col_m[:, None, None, :, :], tmp[:, :, :, None, :], neg).amax(4)
    return torch.where(out == _F32_MIN, torch.zeros_like(out), out).to(data.dtype)


@register("_contrib_ROIAlign")
def roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0, sample_ratio=-1,
              position_sensitive=False, aligned=False):
    """Mean of bilinear samples a bin; ``sample_ratio <= 0`` takes 2x2."""
    if position_sensitive:
        raise NotImplementedError("position_sensitive ROIAlign is not supported")
    PH, PW = int(pooled_size[0]), int(pooled_size[1])
    S = int(sample_ratio) if int(sample_ratio) > 0 else 2
    R = rois.shape[0]
    dev = data.device
    batch_idx = rois[:, 0].to(torch.long)
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = roi_w.clamp_min(1.0)
        roi_h = roi_h.clamp_min(1.0)
    bin_h = _div(roi_h, float(PH))
    bin_w = _div(roi_w, float(PW))
    iy = _div(torch.arange(S, dtype=torch.float32, device=dev) + 0.5, float(S))
    py = torch.arange(PH, dtype=torch.float32, device=dev)
    px = torch.arange(PW, dtype=torch.float32, device=dev)
    ys = y1[:, None, None] + (py[None, :, None] + iy[None, None, :]) * bin_h[:, None, None]
    xs = x1[:, None, None] + (px[None, :, None] + iy[None, None, :]) * bin_w[:, None, None]
    gy = ys[:, :, :, None, None].expand(R, PH, S, PW, S)
    gx = xs[:, None, None, :, :].expand(R, PH, S, PW, S)
    vals = _bilinear_gather(data[batch_idx], gx, gy)
    return vals.mean((3, 5)).to(data.dtype)


alias("ROIAlign", "_contrib_ROIAlign")


# -- deformable ops -------------------------------------------------------------------


@register("_contrib_DeformableConvolution")
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=0, num_group=1, num_deformable_group=1,
                           no_bias=False, workspace=None, layout=None):
    """Deformable convolution v1: each tap samples the input at its learned
    offset (``offset`` [B, 2·DG·kh·kw, Ho, Wo], (dy, dx) pairs a tap);
    one bilinear gather builds the patches, one product contracts them."""
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    ph, pw = int(pad[0]), int(pad[1])
    B, C, H, W = data.shape
    DG, G = int(num_deformable_group), int(num_group)
    O = int(num_filter) or weight.shape[0]
    K = kh * kw
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if offset.shape[1] != 2 * DG * K:
        raise ValueError(f"offset channels {offset.shape[1]} != 2*num_deformable_group*kh*kw"
                         f" = {2 * DG * K}")
    if C % DG or C % G:
        raise ValueError(f"num_group ({G}) and num_deformable_group ({DG}) must both "
                         f"divide the input channel count ({C})")
    if O % G:
        raise ValueError(f"num_group ({G}) must divide num_filter ({O})")
    dev = data.device
    off = offset.reshape(B, DG, K, 2, Ho, Wo).float()
    ky, kx = torch.meshgrid(torch.arange(kh, dtype=torch.float32, device=dev) * dh,
                            torch.arange(kw, dtype=torch.float32, device=dev) * dw,
                            indexing="ij")
    base_y = (ky.reshape(-1)[:, None, None]
              + (torch.arange(Ho, dtype=torch.float32, device=dev) * sh - ph)[None, :, None])
    base_x = (kx.reshape(-1)[:, None, None]
              + (torch.arange(Wo, dtype=torch.float32, device=dev) * sw - pw)[None, None, :])
    y = base_y[None, None] + off[:, :, :, 0]
    x = base_x[None, None] + off[:, :, :, 1]
    vals = _bilinear_gather(data.reshape(B * DG, C // DG, H, W),
                            x.reshape(B * DG, K, Ho, Wo), y.reshape(B * DG, K, Ho, Wo))
    pg = vals.reshape(B, G, C // G, K, Ho, Wo).float()
    wg = weight.reshape(G, O // G, C // G, K).float()
    out = torch.einsum("bgckhw,gock->bgohw", pg, wg).reshape(B, O, Ho, Wo)
    if bias is not None and not no_bias:
        out = out + bias.float()[None, :, None, None]
    return out.to(data.dtype)


@register("_contrib_DeformablePSROIPooling")
def deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                             output_dim=0, group_size=1, pooled_size=1,
                             part_size=0, sample_per_part=1, trans_std=0.0,
                             no_trans=False):
    """Deformable position-sensitive ROI pooling (the R-FCN/DCN head): bin
    (ph, pw) of output channel ``ctop`` averages ``sample_per_part``²
    bilinear samples of score-map channel ``(ctop·G + gh)·G + gw`` in the
    bin shifted by ``trans``; one four-corner gather.  Returns the pooled
    [R, output_dim, P, P]."""
    B, C, H, W = data.shape
    R = rois.shape[0]
    P, G, S = int(pooled_size), int(group_size), int(sample_per_part)
    part = int(part_size) or P
    OD = int(output_dim) or C // (G * G)
    if C != OD * G * G:
        raise ValueError(f"data channels {C} != output_dim*group_size² = {OD * G * G}")
    dev = data.device
    rois = rois.float()
    batch_idx = rois[:, 0].to(torch.long)
    x1 = _half_away(rois[:, 1]) * spatial_scale - 0.5
    y1 = _half_away(rois[:, 2]) * spatial_scale - 0.5
    x2 = (_half_away(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (_half_away(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = (x2 - x1).clamp_min(0.1)
    rh = (y2 - y1).clamp_min(0.1)
    bin_h, bin_w = _div(rh, float(P)), _div(rw, float(P))
    sub_h, sub_w = _div(bin_h, float(S)), _div(bin_w, float(S))
    phs = torch.arange(P, dtype=torch.float32, device=dev)
    part_idx = torch.div(torch.arange(P, device=dev) * part, P, rounding_mode="floor")
    if no_trans or trans is None:
        ncls = 1
        tx = torch.zeros((R, 1, P, P), dtype=torch.float32, device=dev)
        ty = tx
    else:
        ncls = trans.shape[1] // 2
        t = trans.reshape(R, ncls, 2, part, part).float()
        t = t[:, :, :, part_idx][:, :, :, :, part_idx]
        tx = t[:, :, 0] * float(trans_std)
        ty = t[:, :, 1] * float(trans_std)
    ch_per_cls = OD // ncls
    hstart = (phs[None, None, :, None] * bin_h[:, None, None, None]
              + y1[:, None, None, None] + ty * rh[:, None, None, None])
    wstart = (phs[None, None, None, :] * bin_w[:, None, None, None]
              + x1[:, None, None, None] + tx * rw[:, None, None, None])
    ss = torch.arange(S, dtype=torch.float32, device=dev)
    hh = hstart[..., None, None] + ss[:, None] * sub_h[:, None, None, None, None, None]
    ww = wstart[..., None, None] + ss[None, :] * sub_w[:, None, None, None, None, None]
    valid = (ww >= -0.5) & (ww <= W - 0.5) & (hh >= -0.5) & (hh <= H - 0.5)
    hc = hh.clamp(0.0, H - 1.0)
    wc = ww.clamp(0.0, W - 1.0)
    gh = torch.div(torch.arange(P, device=dev) * G, P, rounding_mode="floor").clamp(0, G - 1)
    ch = ((torch.arange(OD, device=dev)[:, None, None] * G + gh[None, :, None]) * G
          + gh[None, None, :])
    cls_of = torch.div(torch.arange(OD, device=dev), ch_per_cls, rounding_mode="floor")
    hh_c, ww_c, val_c = hc[:, cls_of], wc[:, cls_of], valid[:, cls_of]
    y0 = torch.floor(hh_c)
    x0 = torch.floor(ww_c)
    wy = hh_c - y0
    wx = ww_c - x0
    flat = data.float().reshape(B, C * H * W)[batch_idx]
    chb = ch[None, :, :, :, None, None]

    def corner(yi, xi):
        yc = yi.clamp(0, H - 1).to(torch.long)
        xc = xi.clamp(0, W - 1).to(torch.long)
        idx = (chb * H + yc) * W + xc
        return torch.gather(flat, 1, idx.reshape(R, -1)).reshape(idx.shape)

    v = (corner(y0, x0) * (1 - wx) * (1 - wy)
         + corner(y0, x0 + 1) * wx * (1 - wy)
         + corner(y0 + 1, x0) * (1 - wx) * wy
         + corner(y0 + 1, x0 + 1) * wx * wy)
    v = v * val_c.float()
    count = val_c.sum((-1, -2)).float()
    out = v.sum((-1, -2)) / count.clamp_min(1.0)
    return out.to(data.dtype)


alias("DeformableConvolution", "_contrib_DeformableConvolution")
alias("DeformablePSROIPooling", "_contrib_DeformablePSROIPooling")


# -- Correlation (FlowNet) -------------------------------------------------------------


@register("Correlation")
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """Patch correlation of two feature maps over (2d+1)² displacements.
    A window is read at a start clamped so that it fits, as
    ``lax.dynamic_slice`` clamps it."""
    K = int(kernel_size)
    md = int(max_displacement)
    s1, s2, pad = int(stride1), int(stride2), int(pad_size)
    B, C, H, W = data1.shape
    d = md // s2
    p1 = F.pad(data1.float(), (pad, pad, pad, pad))
    p2 = F.pad(data2.float(), (pad, pad, pad, pad))
    Hp, Wp = H + 2 * pad, W + 2 * pad
    bor = md + (K - 1) // 2
    out_h = -(-(Hp - 2 * bor) // s1)
    out_w = -(-(Wp - 2 * bor) // s1)
    norm = C * K * K
    hs, ws = (out_h - 1) * s1 + K, (out_w - 1) * s1 + K

    def window(x, dy, dx):
        ys = min(max(bor + dy, 0), Hp - hs)
        xs = min(max(bor + dx, 0), Wp - ws)
        v = x[:, :, ys:ys + hs, xs:xs + ws]
        if K == 1:
            return v[:, :, ::s1, ::s1]
        return F.unfold(v, (K, K), stride=s1).reshape(B, C * K * K, out_h, out_w)

    base = window(p1, 0, 0)
    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            shifted = window(p2, dy * s2, dx * s2)
            if is_multiply:
                outs.append((base * shifted).sum(1) / norm)
            else:
                outs.append((base - shifted).abs().sum(1) / norm)
    return torch.stack(outs, dim=1).to(data1.dtype)


# -- im2col / col2im --------------------------------------------------------------------


@register("im2col")
def im2col(data, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """Convolution patches as columns: [B, C·kh·kw, out_h·out_w]."""
    return F.unfold(data, tuple(kernel), dilation=tuple(dilate), padding=tuple(pad),
                    stride=tuple(stride))


@register("col2im")
def col2im(data, output_size, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """The columns summed back into the image: the adjoint of ``im2col``."""
    return F.fold(data, (int(output_size[0]), int(output_size[1])), tuple(kernel),
                  dilation=tuple(dilate), padding=tuple(pad), stride=tuple(stride))


# -- legacy loss heads ------------------------------------------------------------------


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, lin):
        ctx.save_for_backward(data, label)
        ctx.margin, ctx.reg, ctx.lin = margin, reg, lin
        return data.view_as(data)

    @staticmethod
    def backward(ctx, _head):
        d, lab = ctx.saved_tensors
        onehot = F.one_hot(lab.to(torch.long), d.shape[-1]).to(d.dtype)
        sgn = 2 * onehot - 1
        viol = ctx.margin - sgn * d
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        if ctx.lin:
            grad = torch.where(viol > 0, -sgn, zero) * ctx.reg
        else:
            grad = torch.where(viol > 0, -2.0 * viol * sgn, zero) * ctx.reg
        return grad.to(d.dtype), None, None, None, None


@register("SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0, use_linear=False):
    """Forward the data; backward the (L1 or squared) hinge gradient of
    every class's margin, whatever the head gradient."""
    return _SVMOutput.apply(data, label, float(margin), float(regularization_coefficient),
                            bool(use_linear))


class _MAERegressionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale):
        ctx.save_for_backward(data, label)
        ctx.grad_scale = grad_scale
        return data.view_as(data)

    @staticmethod
    def backward(ctx, _head):
        d, lab = ctx.saved_tensors
        return torch.sign(d - lab) * ctx.grad_scale, None, None


@register("MAERegressionOutput")
def mae_regression_output(data, label, grad_scale=1.0):
    """Forward the data; backward sign(data − label)·grad_scale."""
    return _MAERegressionOutput.apply(data, label.reshape(data.shape), grad_scale)


class _LogisticRegressionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale):
        ctx.save_for_backward(data, label)
        ctx.grad_scale = grad_scale
        return torch.sigmoid(data)

    @staticmethod
    def backward(ctx, _head):
        d, lab = ctx.saved_tensors
        return (torch.sigmoid(d) - lab) * ctx.grad_scale, None, None


@register("LogisticRegressionOutput")
def logistic_regression_output(data, label, grad_scale=1.0):
    """Forward sigmoid(data); backward (sigmoid(data) − label)·grad_scale."""
    return _LogisticRegressionOutput.apply(data, label.reshape(data.shape), grad_scale)


# -- CTC loss -------------------------------------------------------------------------------


class _LogAddExp(torch.autograd.Function):
    """``log(exp(a) + exp(b))`` with ``jnp.logaddexp``'s gradient,
    g·exp(a − out) and g·exp(b − out): where -1e30 swallows the log 2 of
    two equal terms, each gets the whole of g, as in the JAX package."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_logaddexp = _LogAddExp.apply


def _take(x, idx):
    """``x[b, idx[b, s]]``, an index of -1 wrapped to the last column as
    ``jnp.take_along_axis`` wraps it."""
    return torch.gather(x, 1, torch.where(idx < 0, idx + x.shape[1], idx))


def _neg(rows, cols, like):
    return torch.full((rows, cols), NEG, dtype=torch.float32, device=like.device)


@register("CTCLoss")
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Connectionist temporal classification: data [T, B, C] activations
    (softmax inside), label [B, L]; with ``blank_label='first'`` the ids
    are 1..C-1 and 0 pads, with ``'last'`` 0..C-2, blank C-1 and -1 pads.
    The log-space forward recursion one frame at a time; its gradient is
    autograd's.  Returns the [B] negative log-likelihoods."""
    T, B, C = data.shape
    L = label.shape[1]
    logp = torch.log_softmax(data.float(), dim=-1)
    first = str(blank_label) == "first"
    blank = 0 if first else C - 1
    lab = label.to(torch.long)
    dev = data.device
    if label_lengths is not None and use_label_lengths:
        lab_len = label_lengths.to(torch.long)
    else:
        lab_len = (lab != (0 if first else -1)).to(torch.long).sum(1)
    if data_lengths is not None and use_data_lengths:
        dat_len = data_lengths.to(torch.long)
    else:
        dat_len = torch.full((B,), T, dtype=torch.long, device=dev)
    S = 2 * L + 1
    pos = torch.arange(S, device=dev)
    lab_at = torch.gather(lab, 1, (pos // 2).clamp_max(L - 1)[None, :].expand(B, S))
    ext = torch.where(pos[None, :] % 2 == 0, torch.full_like(lab_at, blank), lab_at)
    ext_valid = pos[None, :] < (2 * lab_len[:, None] + 1)
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=ext.dtype, device=dev), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != ext_m2)
    neg = torch.tensor(NEG, device=dev)

    a00 = _take(logp[0], ext[:, :1])
    a01 = torch.where(lab_len[:, None] > 0, _take(logp[0], ext[:, 1:2]), neg)
    alpha = torch.where(ext_valid, torch.cat([a00, a01, _neg(B, S - 2, data)], 1), neg)
    for t in range(1, T):
        prev1 = torch.cat([_neg(B, 1, data), alpha[:, :-1]], 1)
        prev2 = torch.where(can_skip, torch.cat([_neg(B, 2, data), alpha[:, :-2]], 1), neg)
        new = _logaddexp(_logaddexp(alpha, prev1), prev2) + _take(logp[t], ext)
        new = torch.where(ext_valid, new, neg)
        alpha = torch.where((t < dat_len)[:, None], new, alpha)
    last_b = torch.gather(alpha, 1, (2 * lab_len)[:, None])[:, 0]
    last_nb = torch.gather(alpha, 1, (2 * lab_len - 1).clamp_min(0)[:, None])[:, 0]
    last_nb = torch.where(lab_len > 0, last_nb, neg)
    return -_logaddexp(last_b, last_nb)


alias("ctc_loss", "CTCLoss")
alias("_contrib_CTCLoss", "CTCLoss")
alias("_contrib_ctc_loss", "CTCLoss")


@register("Crop")
def crop_op(*inputs, offset=(0, 0), h_w=(0, 0), center_crop=False, num_args=None):
    """NCHW spatial crop: to ``h_w`` at ``offset`` (or centred), or with two
    inputs to the second's H×W."""
    data = inputs[0]
    if len(inputs) == 2:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
        if th == 0 or tw == 0:
            raise ValueError("Crop: give h_w or a second (crop_like) input")
    h, w = data.shape[2], data.shape[3]
    if th > h or tw > w:
        raise ValueError(f"Crop: target {th}x{tw} exceeds input {h}x{w}")
    if center_crop:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    if oy < 0 or ox < 0:
        raise ValueError(f"Crop: negative offset ({oy},{ox})")
    if oy + th > h or ox + tw > w:
        raise ValueError(f"Crop: offset {oy},{ox} + {th}x{tw} exceeds {h}x{w}")
    return data[:, :, oy:oy + th, ox:ox + tw]
