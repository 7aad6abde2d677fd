"""INT8 post-training quantization: ``quantize_net``.

Counterpart of the JAX package's ``contrib/quantization.py`` (the
reference's Gluon ``quantize_net``):

1. every Dense and Conv2D layer gets a forward pre-hook (the Block's
   ``register_forward_pre_hook``, removed afterwards) and the calibration
   batches run through the network: each layer's input is copied to the
   host and its range recorded, min/max (``calib_mode='naive'``), or in a
   second pass a histogram of 8001 bins whose KL-optimal clipping
   threshold (:func:`optimal_threshold_from_hist`) becomes a symmetric
   range (``'entropy'``);
2. each layer's weight is quantized once to int8 (symmetric, per tensor);
3. each layer's forward becomes quantize_v2 (its calibrated range) → the
   int8 product (``ops/quantization.py``: exact int32 sums) → float32, then
   the layer's activation.

A layer in ``excluded_layers``, or one no calibration batch reached, stays
fp32.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["quantize_net", "optimal_threshold", "optimal_threshold_from_hist"]


def optimal_threshold(arr, num_bins=8001, num_quantized_bins=255):
    """The KL-optimal symmetric clipping threshold of ``arr``: over a
    symmetric histogram, each candidate threshold's clipped distribution P
    (outliers folded into its edge bins) against its 255-bin quantized
    reconstruction Q; the threshold of least KL(P‖Q)."""
    arr = _np.asarray(arr).ravel()
    if arr.size == 0:
        return 0.0
    th = float(_np.abs(arr).max())
    if th == 0.0:
        return 0.0
    hist, hist_edges = _np.histogram(arr, bins=num_bins, range=(-th, th))
    return optimal_threshold_from_hist(hist, hist_edges, num_quantized_bins)


def optimal_threshold_from_hist(hist, hist_edges, num_quantized_bins=255):
    """The KL sweep over an accumulated symmetric histogram: the JAX
    package's values, with each candidate's bin and chunk counts taken from
    exact int64 prefix sums and its arrays updated in place."""
    counts = _np.asarray(hist).astype(_np.int64)
    num_bins = counts.size
    zero_bin = num_bins // 2
    half_q = num_quantized_bins // 2
    n_sweeps = zero_bin - half_q + 1
    thresholds = _np.zeros(n_sweeps)
    divergence = _np.full(n_sweeps, _np.inf)
    csum = _np.concatenate([[0], _np.cumsum(counts)])
    nz_sum = _np.concatenate([[0], _np.cumsum(counts != 0)])
    total = int(csum[-1])
    eps = 1e-4
    chunks = _np.arange(num_quantized_bins + 1)
    for j, i in enumerate(range(half_q, zero_bin + 1)):
        start = zero_bin - i
        stop = zero_bin + i + 1
        thresholds[j] = hist_edges[stop]
        n = stop - start
        merged = n // num_quantized_bins
        if merged == 0 or total == 0:
            continue
        # P: the slice, the outliers folded into its edge bins
        p = counts[start:stop].astype(_np.float64)
        p[0] += csum[start]
        p[-1] += total - csum[stop]
        zero_p = p == 0
        # Q: each chunk's count spread evenly over its bins where P is non-zero
        bounds = chunks * merged
        bounds[-1] = n
        lo, hi = start + bounds[:-1], start + bounds[1:]
        q_bins = (csum[hi] - csum[lo]).astype(_np.float64)
        nz = nz_sum[hi] - nz_sum[lo]
        nz[0] += counts[start] == 0 and not zero_p[0]
        nz[-1] += counts[stop - 1] == 0 and not zero_p[-1]
        with _np.errstate(divide="ignore", invalid="ignore"):
            q = _np.repeat(q_bins / nz, _np.diff(bounds))
        _np.putmask(q, zero_p, 0.0)
        p /= total
        qsum = q.sum()
        if qsum == 0:
            continue
        q /= qsum
        # the reference's eps shift, so that KL is finite
        n0 = int(_np.count_nonzero(zero_p))
        if n0:
            p -= eps * n0 / max(n - n0, 1)
            _np.putmask(p, zero_p, eps)
        zero_q = q == 0
        n0q = int(_np.count_nonzero(zero_q))
        if n0q:
            q -= eps * n0q / max(n - n0q, 1)
            _np.putmask(q, zero_q, eps)
        kl = _np.maximum(p, 1e-30)
        kl /= _np.maximum(q, 1e-30, out=q)
        with _np.errstate(divide="ignore", invalid="ignore"):
            _np.log(kl, out=kl)
        kl *= p
        _np.putmask(kl, p <= 0, 0.0)
        divergence[j] = kl.sum()
    return float(thresholds[int(_np.argmin(divergence))])


def _quantizable(block):
    from ..gluon import nn as gnn

    return isinstance(block, (gnn.Dense, gnn.Conv2D))


def _iter_blocks(block, prefix=""):
    yield prefix or block.name, block
    for name, child in block._child_blocks():
        yield from _iter_blocks(child, f"{prefix}.{name}" if prefix else name)


def _host(x):
    """A layer input on the host, as numpy (float32 for 16-bit types)."""
    from ..ndarray.ndarray import NDArray

    t = x._data if isinstance(x, NDArray) else x
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype in (torch.float16, torch.bfloat16) else t).cpu().numpy()
    return _np.asarray(t)


def quantize_net(network, calib_data, quantized_dtype="int8",
                 calib_mode="naive", excluded_layers=(), num_calib_batches=None):
    """Calibrate ``network`` on ``calib_data`` (an iterable of input
    batches, each an array or a tuple) and give its Dense and Conv2D layers
    the int8 forward, in place.  Returns the network."""
    from ..ops.quantization import quantize_v2

    if quantized_dtype != "int8":
        raise NotImplementedError("quantize_net quantizes to int8")
    excluded = set(excluded_layers)
    targets = {name: blk for name, blk in _iter_blocks(network)
               if _quantizable(blk) and name not in excluded and blk.name not in excluded}
    if calib_mode not in ("naive", "entropy"):
        raise ValueError(f"calib_mode must be 'naive' or 'entropy', got {calib_mode!r}")

    def run_calibration(hook_factory, batches):
        handles = [blk.register_forward_pre_hook(hook_factory(name))
                   for name, blk in targets.items()]
        try:
            for batch in batches:
                network(*(batch if isinstance(batch, (list, tuple)) else (batch,)))
        finally:
            for h in handles:
                h.detach()

    def bounded(it):
        for i, batch in enumerate(it):
            if num_calib_batches is not None and i >= num_calib_batches:
                break
            yield batch

    # entropy takes two passes (ranges, then histograms over them)
    batches = list(bounded(calib_data)) if calib_mode == "entropy" else None
    ranges = {name: [_np.inf, -_np.inf] for name in targets}

    def range_hook(name):
        def hook(block, inputs):
            arr = _host(inputs[0])
            r = ranges[name]
            r[0] = min(r[0], float(arr.min()), 0.0)
            r[1] = max(r[1], float(arr.max()), 0.0)

        return hook

    run_calibration(range_hook, batches if batches is not None else bounded(calib_data))

    if calib_mode == "entropy":
        num_bins = 8001
        hists = {}

        def hist_hook(name):
            lo, hi = ranges[name]
            amax = max(abs(lo), abs(hi))

            def hook(block, inputs):
                if amax == 0 or not _np.isfinite(amax):
                    return
                h, edges = _np.histogram(_host(inputs[0]).ravel(), bins=num_bins,
                                         range=(-amax, amax))
                if name in hists:
                    hists[name][0] += h
                else:
                    hists[name] = [h.astype(_np.int64), edges]

            return hook

        run_calibration(hist_hook, batches)
        for name, (h, edges) in hists.items():
            th = optimal_threshold_from_hist(h, edges)
            if th > 0:
                ranges[name] = [-th, th]

    for name, blk in targets.items():
        lo, hi = ranges[name]
        if not _np.isfinite([lo, hi]).all():
            continue  # no calibration batch reached this layer: it stays fp32
        with torch.no_grad():
            wq, wmin, wmax = quantize_v2(blk.weight.data())
        _attach_int8_forward(blk, wq, wmin, wmax, float(lo), float(hi))
    return network


def _attach_int8_forward(blk, wq, wmin, wmax, in_lo, in_hi):
    """Replace ``blk``'s forward (tensors in, the Block's call does the
    rest) with quantize_v2 → the int8 product → float32 → activation."""
    from ..gluon import nn as gnn
    from ..ops import nn as nn_ops
    from ..ops.quantization import quantize_v2, quantized_conv, quantized_fully_connected

    is_dense = isinstance(blk, gnn.Dense)

    def int8_forward(x, *_ignored):
        xq, xmin, xmax = quantize_v2(x, min_calib_range=in_lo, max_calib_range=in_hi)
        bias = blk.bias.data() if getattr(blk, "bias", None) is not None else None
        if is_dense:
            out = quantized_fully_connected(xq, wq, bias, xmin, xmax, wmin, wmax,
                                            num_hidden=blk._units, no_bias=bias is None,
                                            flatten=blk._flatten)
        else:
            out = quantized_conv(xq, wq, bias, xmin, xmax, wmin, wmax, kernel=blk._kernel,
                                 stride=blk._stride, dilate=blk._dilate, pad=blk._pad,
                                 num_filter=blk._channels, num_group=blk._groups,
                                 no_bias=bias is None)
        if blk._act_type is not None:
            out = nn_ops.activation(out, act_type=blk._act_type)
        return out

    blk.forward = int8_forward
    blk._quantized = True
    blk._int8_state = (wq, wmin, wmax, in_lo, in_hi)  # what the int8 forward uses
