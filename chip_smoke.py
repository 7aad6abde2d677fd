#!/usr/bin/env python3
"""Drive the PyTorch port (``incubator_mxnet_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny BERT on the CPU plain path

Phases, each printing JSON lines; no phase's failure is caught:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: compile every kernel of the paths from ``ops/csrc`` (one nvcc
   per source, all at once) with ``-Xptxas -v`` and report registers,
   shared memory and spills; a spill fails the phase;
3. kernel_vs_plain, kernel_vs_plain_bwd: each kernel against its plain
   PyTorch version on the card, at the main paths' shapes and the edge
   cases, each against a stated bound; any miss exits non-zero after the
   phase;
4. slice: BERT-base (12 layers, 768 units, vocab 30522, bf16, random
   weights from a seed) answers inference requests through
   ``net(token_ids, token_types, masked_positions)``; the kernels' launch
   counts are read around exactly this run, and one small batch is held
   against the port's fp32 run of the same weights on the CPU;
5. train: BERT-base pretraining steps (bf16 parameters, fp32 Adam masters,
   dropout 0.1, the MLM loss of bench.py) through ``autograd.record``,
   ``autograd.backward`` and ``gluon.Trainer.step``; launch counts around
   exactly one step, finite and falling losses; then the card's bf16
   gradients against the port's fp32 gradients on the CPU, per parameter;
6. times: each kernel, its plain version and the library call at the main
   path's shape, the kernel's bound; forward and training-step time,
   samples/s and peak memory; a torch.profiler breakdown of one forward's
   and one training step's device time by kernel family.

The last line is ``{"ok": true, "device": {...}}``, printed only when every
phase passed on a CUDA card.  The rehearsal runs the slice, train and
timing phases on the CPU at a tiny size, with the kernels' plain versions,
and never prints it.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import incubator_mxnet_torch as mx  # noqa: E402
from incubator_mxnet_torch.convert import load_numpy_params  # noqa: E402
from incubator_mxnet_torch.gluon.model_zoo import bert as bert_zoo  # noqa: E402
from incubator_mxnet_torch.ops import _cuda  # noqa: E402
from incubator_mxnet_torch.ops import attention as att  # noqa: E402
from incubator_mxnet_torch.ops.nn import streaming_softmax_ce  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

# Kernel vs plain: the largest absolute difference allowed.
# 16-bit forward: p rounds to the 16-bit type unnormalized in the kernel and
# normalized in the plain version (relative errors of one unit roundoff
# that average out over the keys), and o rounds once more; so the two
# differ by about one ulp of |o|: the bound is FWD_ULPS ulps of the case's
# largest |o_ref| (causal rows near the start see few keys and reach
# |o| ~ 4-5, where one bf16 ulp is 2**-5).
# 16-bit backward: the same fp32 algebra with p and ds rounded to the
# 16-bit type at the same places on both sides; only fp32 summation order
# differs, which can flip a rounding of p or ds and moves the rounded
# gradient by about one ulp: BWD_ULPS ulps of the largest |grad_ref| of
# that gradient.  A wrong mask, tile or layout moves gradients by their own
# size.  fp32: the same fp32 arithmetic in another summation order
# (backward relative to the largest |grad_ref|, through exp and the
# dp - delta cancellation).
FWD_ULPS = 2
BWD_ULPS = 2
FP32_FWD_BOUND = 2e-5
FP32_BWD_REL = 1e-4
# End to end through fused_qkv_attention's autograd against the plain
# forward and backward: o and lse also come from different forwards, so
# delta = rowsum(do * o) moves by up to the forward's 2 ulps of o.
E2E_ULPS = 8
LSE_BOUND = 1e-4  # fp32 log-sum-exp of scores of |s| < ~10, other sum order
# BERT-base bf16 on the card vs the port's fp32 run on the CPU, as a share
# of the largest fp32 logit: bf16 roundings compounded through 12 post-LN
# layers.  A wrong layout or mask gives errors of the order of the logits.
SLICE_REL_BOUND = 1e-1
# Training gradients, bf16 on the card vs fp32 on the CPU, same weights,
# dropout off: relative L2 error per parameter.  bf16 keeps 8 significant
# bits (unit roundoff 2**-8); one step rounds each activation and each
# gradient at ~20 ops a layer through 12 post-LN layers forward and back,
# some 500 roundings on a path, which add up as a random walk to ~5 % and
# can align in the first layers and the embeddings.  A wrong mask, layout
# or gradient kernel leaves errors of order 100 %.
GRAD_REL_BOUND = 0.15

BERT_BASE = dict(vocab_size=30522, max_length=512, dropout=0.1)
TINY_BERT = dict(vocab_size=128, units=32, hidden_size=64, num_layers=2, num_heads=2,
                 max_length=64, dropout=0.1)
KERNELS = ("flash_fwd", "flash_bwd")  # sources under incubator_mxnet_torch/ops/csrc
ENTRIES = {"flash_fwd": att.flash_fwd, "flash_bwd_dq": att.flash_bwd_dq,
           "flash_bwd_dkv": att.flash_bwd_dkv}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def kernel_counts():
    return {name: fn.launches for name, fn in ENTRIES.items()}


def reset_kernel_counts():
    for fn in ENTRIES.values():
        fn.launches = 0


def set_kernel_counts(counts):
    for name, fn in ENTRIES.items():
        fn.launches = counts[name]


def ulp(x, dtype):
    """The spacing of ``dtype``'s values at |x| (x > 0)."""
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    return 2.0 ** (math.frexp(x)[1] - 1 - mant) if x > 0 else 0.0


# -- phase 1 ----------------------------------------------------------------


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return smi


# -- phase 2 ----------------------------------------------------------------


def _ptxas_report(log):
    kernels, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = {"entry": m.group(1)}
            kernels.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            current["static_smem"] = int(s.group(1)) if s else 0
    return kernels


def phase_build():
    """One nvcc per source, all started together; fails on a spill."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(_cuda.build, KERNELS)))
    spills = []
    for name, (_, log, seconds) in builds.items():
        entries = _ptxas_report(log)
        for k in entries:
            emit("build", kernel=name, **k)
            if k.get("spill_stores", 0) or k.get("spill_loads", 0):
                spills.append(k["entry"])
        emit("build", kernel=name, seconds=seconds, entries=len(entries))
    emit("build", wall_seconds=time.perf_counter() - t0, spills=spills)
    if spills:
        sys.exit(1)
    att._entry()  # load both once, outside any timing
    att._bwd_entry()


# -- phase 3 ----------------------------------------------------------------


def _randn(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)


def _case_inputs(case, gen, device):
    b, sq, sk, h, d, dtype = (case[k] for k in ("b", "sq", "sk", "h", "d", "dtype"))
    if case.get("layout") == "qkv":  # the [B, S, 3, H, Dh] projection output
        x = _randn((b, sq, 3, h, d), dtype, gen, device)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2], "bshd"
    return (_randn((b, h, sq, d), dtype, gen, device), _randn((b, h, sk, d), dtype, gen, device),
            _randn((b, h, sk, d), dtype, gen, device), "bhsd")


MAIN = dict(b=64, sq=128, sk=128, h=12, d=64, dtype=torch.bfloat16, causal=False)
KERNEL_CASES = [
    dict(MAIN, name="main"),
    dict(MAIN, name="main_causal", causal=True),
    dict(MAIN, name="fp32", dtype=torch.float32),
    dict(MAIN, name="seq512", b=8, sq=512, sk=512),
    dict(MAIN, name="unaligned_s200", b=4, sq=200, sk=200),
    dict(MAIN, name="unaligned_s200_causal", b=4, sq=200, sk=200, causal=True),
    dict(MAIN, name="cross_sq77_sk200", b=4, sq=77, sk=200),
    dict(MAIN, name="with_lse", lse=True),
    dict(MAIN, name="causal_with_lse", b=4, sq=200, sk=200, causal=True, lse=True),
    dict(MAIN, name="qkv_bshd_view", layout="qkv"),
    dict(MAIN, name="fp16", b=8, dtype=torch.float16),
    dict(MAIN, name="dh16", b=8, h=4, d=16),
    dict(MAIN, name="dh32", b=8, h=4, d=32),
    dict(MAIN, name="dh128", b=8, h=4, d=128),
    dict(MAIN, name="fp32_dh128_causal", b=2, h=4, d=128, sq=200, sk=200,
         dtype=torch.float32, causal=True),
]


def phase_kernel_vs_plain(device):
    gen = torch.Generator(device=device).manual_seed(1234)
    misses, main_err = [], None
    for case in KERNEL_CASES:
        q, k, v, layout = _case_inputs(case, gen, device)
        want_lse = case.get("lse", False)
        with torch.no_grad():
            o, lse = att.flash_fwd(q, k, v, case["causal"], None, want_lse, layout)
            torch.cuda.synchronize()
            t = (lambda x: x.transpose(1, 2)) if layout == "bshd" else (lambda x: x)
            o_ref, lse_ref = att.flash_fwd_plain(t(q), t(k), t(v), case["causal"], None, want_lse)
        err = (t(o).float() - o_ref.float()).abs().max().item()
        ref_max = o_ref.float().abs().max().item()
        bound = (FP32_FWD_BOUND if case["dtype"] == torch.float32
                 else FWD_ULPS * ulp(ref_max, case["dtype"]))
        ok = math.isfinite(err) and err <= bound
        rec = dict(case=case["name"], dtype=str(case["dtype"]).replace("torch.", ""),
                   shape=dict(b=case["b"], h=case["h"], sq=case["sq"], sk=case["sk"], d=case["d"]),
                   causal=case["causal"], layout=layout, max_abs_err=err,
                   ref_max_abs=ref_max, bound=bound)
        if want_lse:
            lerr = (lse - lse_ref).abs().max().item()
            rec.update(lse_max_abs_err=lerr, lse_bound=LSE_BOUND)
            ok = ok and math.isfinite(lerr) and lerr <= LSE_BOUND
        rec["ok"] = ok
        emit("kernel_vs_plain", **rec)
        if not ok:
            misses.append(case["name"])
        if case["name"] == "qkv_bshd_view":
            main_err = err
    if misses:
        emit("kernel_vs_plain", failed=misses)
        sys.exit(1)
    return main_err


def _bwd_bound(ref, dtype, ulps=BWD_ULPS):
    ref_max = ref.float().abs().max().item()
    if dtype == torch.float32:
        return ref_max, FP32_BWD_REL * ref_max
    return ref_max, ulps * ulp(ref_max, dtype)


BWD_CASES = KERNEL_CASES + [dict(MAIN, name="dqkv_buffer", layout="qkv", dqkv=True),
                            dict(MAIN, name="autograd_fused_qkv", layout="qkv", e2e=True)]


def _bwd_case(case, gen, device):
    """(name -> (got, ref, bound, ref_max)) for dq, dk, dv of one case."""
    b, sq, h, d, dtype, causal = (case[k] for k in ("b", "sq", "h", "d", "dtype", "causal"))
    if case.get("e2e"):  # the [B, S, 3·H·Dh] QKV projection output
        qkv = _randn((b, sq, 3 * h * d), dtype, gen, device).requires_grad_()
        x = qkv.detach().reshape(b, sq, 3, h, d)
        q, k, v, layout = x[:, :, 0], x[:, :, 1], x[:, :, 2], "bshd"
    else:
        q, k, v, layout = _case_inputs(case, gen, device)
    t = (lambda x: x.transpose(1, 2)) if layout == "bshd" else (lambda x: x)
    do = _randn((b, sq, h, d) if layout == "bshd" else (b, h, sq, d), dtype, gen, device)
    if case.get("e2e"):
        out = att.fused_qkv_attention(qkv, num_heads=h, causal=causal)
        out.backward(do.reshape(b, sq, h * d))
        got = qkv.grad.reshape(b, sq, 3, h, d)
        got = (got[:, :, 0], got[:, :, 1], got[:, :, 2])
        o_ref, lse_ref = att.flash_fwd_plain(t(q), t(k), t(v), causal, None, True)
        ref = att.flash_bwd_plain(t(q), t(k), t(v), o_ref, t(do), lse_ref, causal)
        ulps = E2E_ULPS
    else:
        with torch.no_grad():
            o, lse = att.flash_fwd(q, k, v, causal, None, True, layout)
            out = None
            if case.get("dqkv"):
                dqkv = torch.empty(b, sq, 3, h, d, dtype=dtype, device=device)
                out = (dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2])
            got = att.flash_bwd(q, k, v, o, do, lse, causal, None, layout, out=out)
            if out is not None and any(g.data_ptr() != w.data_ptr() for g, w in zip(got, out)):
                raise AssertionError("flash_bwd did not write into the given buffers")
            ref = att.flash_bwd_plain(t(q), t(k), t(v), t(o), t(do), lse, causal)
        ulps = BWD_ULPS
    torch.cuda.synchronize()
    res = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        ref_max, bound = _bwd_bound(r, dtype, ulps)
        res[name] = ((t(g).float() - r.float()).abs().max().item(), bound, ref_max)
    return res


def phase_kernel_vs_plain_bwd(device):
    """Returns the max abs error of dq and of dk/dv at the main path's
    layout (the [B, S, 3, H, Dh] gradient buffer)."""
    gen = torch.Generator(device=device).manual_seed(4321)
    misses, main_errs = [], None
    for case in BWD_CASES:
        res = _bwd_case(case, gen, device)
        ok = all(math.isfinite(e) and e <= bound for e, bound, _ in res.values())
        emit("kernel_vs_plain_bwd", case=case["name"],
             dtype=str(case["dtype"]).replace("torch.", ""),
             shape=dict(b=case["b"], h=case["h"], sq=case["sq"], sk=case["sk"], d=case["d"]),
             causal=case["causal"],
             **{f"{n}_max_abs_err": e for n, (e, _, _) in res.items()},
             **{f"{n}_ref_max_abs": m for n, (_, _, m) in res.items()},
             **{f"{n}_bound": bound for n, (_, bound, _) in res.items()}, ok=ok)
        if not ok:
            misses.append(case["name"])
        if case["name"] == "dqkv_buffer":
            main_errs = {"flash_bwd_dq": res["dq"][0],
                         "flash_bwd_dkv": max(res["dk"][0], res["dv"][0])}
    if misses:
        emit("kernel_vs_plain_bwd", failed=misses)
        sys.exit(1)
    return main_errs


# -- phase 4 ----------------------------------------------------------------


def _requests(batches, vocab, gen, device):
    out = []
    for b, s, p in batches:
        ids = torch.randint(0, vocab, (b, s), generator=gen, device=device, dtype=torch.int32)
        types = torch.randint(0, 2, (b, s), generator=gen, device=device, dtype=torch.int32)
        pos = torch.randint(0, s, (b, p), generator=gen, device=device, dtype=torch.int32)
        out.append((ids, types, pos))
    return out


def _build_net(cfg, ctx, dtype):
    mx.random.seed(0)
    if "units" in cfg:
        base = bert_zoo.BERTModel(**cfg)
    else:
        base = bert_zoo.bert_base(**cfg)
    net = bert_zoo.BERTForPretrain(base, vocab_size=cfg["vocab_size"])
    net.initialize(ctx=ctx)
    if dtype != "float32":
        net.cast(dtype)
    return net


def phase_slice(rehearsal):
    """Returns (net, main_batch, forwards) for the timing phase."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    num_layers = cfg.get("num_layers", 12)
    net = _build_net(cfg, None if not rehearsal else ctx, "bfloat16")
    gen = torch.Generator(device=device).manual_seed(7)
    batches = [(64, 128, 20)] * 3 + [(8, 512, 80)]
    if rehearsal:
        batches = [(4, 16, 3)] * 3 + [(2, 64, 8)]
    reqs = _requests(batches, cfg["vocab_size"], gen, device)

    reset_kernel_counts()
    outs = []
    with mx.autograd.predict_mode():
        for ids, types, pos in reqs:
            outs.append(net(ids, types, pos))
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = kernel_counts()

    for (b, s, p), (mlm, nsp) in zip(batches, outs):
        shapes_ok = (tuple(mlm.shape) == (b, p, cfg["vocab_size"]) and tuple(nsp.shape) == (b, 2))
        finite = bool(torch.isfinite(mlm).all().item() and torch.isfinite(nsp).all().item())
        emit("slice", request=dict(b=b, s=s, p=p), mlm_shape=list(mlm.shape),
             nsp_shape=list(nsp.shape), dtype=str(mlm.dtype).replace("torch.", ""),
             shapes_ok=shapes_ok, finite=finite)
        if not (shapes_ok and finite):
            sys.exit(1)
    want = 0 if rehearsal else num_layers * len(reqs)
    emit("slice", launches=counts, expected_flash_fwd=want, forwards=len(reqs))
    if counts != {"flash_fwd": want, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        sys.exit(1)

    # the same weights, fp32, through the port on the CPU
    arrays = {k: p.data().detach().float().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}
    ref_net = _build_net(cfg, mx.cpu(), "float32")
    load_numpy_params(ref_net, arrays)
    small = _requests([(2, 128 if not rehearsal else 16, 20 if not rehearsal else 3)],
                      cfg["vocab_size"], gen, device)[0]
    with mx.autograd.predict_mode():
        got = net(*small)
        ref = ref_net(*(x.cpu() for x in small))
    for name, g, r in zip(("mlm_logits", "nsp_logits"), got, ref):
        err = (g.float().cpu() - r).abs().max().item()
        scale = r.abs().max().item()
        rel = err / scale
        ok = math.isfinite(rel) and rel <= SLICE_REL_BOUND
        emit("slice_vs_cpu_fp32", output=name, max_abs_err=err, ref_max_abs=scale,
             rel_err=rel, bound=SLICE_REL_BOUND, ok=ok)
        if not ok:
            sys.exit(1)
    return net, reqs[0], counts


# -- phase 5 ----------------------------------------------------------------


def _train_batch(cfg, b, s, p, gen, device):
    ids, types, pos = _requests([(b, s, p)], cfg["vocab_size"], gen, device)[0]
    labels = torch.randint(0, cfg["vocab_size"], (b, p), generator=gen, device=device,
                           dtype=torch.int32)
    return ids, types, pos, labels


def train_step(net, trainer, batch, train_mode=True):
    """One pretraining step as a user writes it (the loss of bench.py's
    ``mlm_loss``); returns the per-sample loss."""
    ids, types, pos, labels = batch
    with mx.autograd.record(train_mode=train_mode):
        mlm, _ = net(ids, types, pos)
        loss = streaming_softmax_ce(mlm, labels).mean(-1)
    mx.autograd.backward(loss)
    if trainer is not None:
        trainer.step(ids.shape[0])
    return loss


def phase_train(rehearsal):
    """BERT-base pretraining steps on one fixed device-resident batch;
    returns (net, trainer, batch, counts of one step)."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    num_layers = cfg.get("num_layers", 12)
    b, s, p = (4, 16, 3) if rehearsal else (64, 128, 20)
    net = _build_net(cfg, ctx, "bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4, "multi_precision": True})
    batch = _train_batch(cfg, b, s, p, torch.Generator(device=device).manual_seed(11), device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    losses = [train_step(net, trainer, batch).mean().item() for _ in range(2)]  # warm-up
    reset_kernel_counts()
    losses.append(train_step(net, trainer, batch).mean().item())  # syncs on .item()
    counts = kernel_counts()
    losses += [train_step(net, trainer, batch).mean().item() for _ in range(9)]
    sync()
    finite = all(math.isfinite(x) for x in losses)
    falling = losses[-1] < losses[0]
    want = {n: 0 if rehearsal else num_layers for n in ENTRIES}
    emit("train", model="BERTForPretrain(bert_base) bf16, Adam multi_precision, dropout 0.1"
         if not rehearsal else "tiny BERT bf16 (CPU rehearsal)", b=b, s=s, p=p,
         losses=losses, finite=finite, falling=falling, launches_one_step=counts,
         expected=want)
    if not (finite and falling) or counts != want:
        sys.exit(1)
    return net, trainer, batch, counts


def phase_train_vs_cpu(net, rehearsal):
    """The card's bf16 gradients against the port's fp32 gradients on the
    CPU, same weights, dropout off; relative L2 error per parameter."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    device = next(iter(net.collect_params().values())).data().device
    gen = torch.Generator(device=device).manual_seed(13)
    batch = _train_batch(cfg, 2, 16 if rehearsal else 128, 3 if rehearsal else 20, gen, device)
    arrays = {k: p.data().detach().float().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}
    ref_net = _build_net(cfg, mx.cpu(), "float32")
    load_numpy_params(ref_net, arrays)
    train_step(net, None, batch, train_mode=False)
    train_step(ref_net, None, tuple(x.cpu() for x in batch), train_mode=False)
    got = net._collect_params_with_prefix()
    ref = ref_net._collect_params_with_prefix()
    worst, bad = [], []
    for key, rp in ref.items():
        r = rp.grad()
        g = got[key].grad().float().cpu()
        rn = r.norm().item()
        rel = (g - r).norm().item() / rn if rn > 0 else (0.0 if g.norm().item() == 0 else math.inf)
        worst.append((rel, key))
        if not (math.isfinite(rel) and rel <= GRAD_REL_BOUND):
            bad.append(key)
    worst.sort(reverse=True)
    emit("train_vs_cpu_fp32", b=2, params=len(worst), bound=GRAD_REL_BOUND,
         worst=[[k, rel] for rel, k in worst[:6]], median_rel=worst[len(worst) // 2][0],
         failed=bad, ok=not bad)
    if bad:
        sys.exit(1)


# -- phase 6 ----------------------------------------------------------------


def _time(fn, arg_sets, iters):
    """Per call of ``fn``, cycling through ``arg_sets`` (several input sets,
    so a call does not find the last one's inputs in the 50 MB L2):
    ``(device_ms, call_ms, kernels_us)``.  device_ms is the time of the
    kernels the calls launched (torch.profiler's CUDA trace), the kernel's
    time; call_ms is the wall time between CUDA events around the calls,
    which also holds host time where the host issues calls slower than the
    card runs them; kernels_us splits device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name[:90]] = kernels.get(ev.name[:90], 0.0) + ev.time_range.elapsed_us() / iters
    return sum(kernels.values()) * 1e-3, call_ms, kernels


def _kernel_family(name):
    for fam in ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd"):
        if fam in name:
            return fam
    if re.search(r"gemm|nvjet|xmma|cutlass|cublas", name, re.I):
        return "matmul"
    return "other"


def phase_profile(what, fn, smi):
    """Where one call of ``fn``'s device time goes, by kernel family, from
    torch.profiler's CUDA trace; 'not measured' if it shows none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    total_us = sum(kernels.values())
    if total_us == 0:
        emit("profile", what=what, device_time="not measured", card=smi)
        return
    families = {}
    for name, us in kernels.items():
        fam = _kernel_family(name)
        families[fam] = families.get(fam, 0.0) + us
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", what=what, wall_us=wall_us, device_us=total_us,
         device_busy_share=total_us / wall_us, families_us=families,
         top_kernels_us=[[n[:90], us] for n, us in top], card=smi)


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[torch.bfloat16]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _times_fwd(views, bhsd_sets, smi):
    b, s, h, d = MAIN["b"], MAIN["sq"], MAIN["h"], MAIN["d"]
    with torch.no_grad():
        kernel_ms, call_ms, _ = _time(lambda q, k, v: att.flash_fwd(q, k, v, layout="bshd"),
                                     views, 200)
        plain_ms, _, _ = _time(lambda q, k, v: att.flash_fwd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), views, 20)
        library_ms, _, lib_kernels = _time(torch.nn.functional.scaled_dot_product_attention,
                                           bhsd_sets, 200)
    nbytes = 4 * b * s * h * d * 2              # q, k, v read once, o written once
    flops = 4 * b * h * s * s * d               # q·kᵀ and p·v
    bound_ms, bound_by = _bound(nbytes, flops)
    emit("times", kernel="flash_fwd", shape=dict(b=b, s=s, h=h, d=d, dtype="bfloat16"),
         ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
         library="SDPA", library_kernels_us=lib_kernels, bound_ms=bound_ms, bound_by=bound_by,
         bytes=nbytes, flops=flops, share_of_bound=bound_ms / kernel_ms,
         achieved_bytes_per_s=nbytes / (kernel_ms * 1e-3), card=smi)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _times_bwd(views, bhsd_sets, gen, smi):
    """Both backward kernels at the main path's shape.  The plain version
    and the library's backward compute dq, dk and dv together, so both
    rows carry the same; the library's is SDPA's, the device time of SDPA
    forward+backward less that of SDPA forward, timed only."""
    b, s, h, d = MAIN["b"], MAIN["sq"], MAIN["h"], MAIN["d"]
    device = views[0][0].device
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    sets = []
    with torch.no_grad():
        for q, k, v in views:
            do = _randn((b, s, h, d), torch.bfloat16, gen, device)
            o, lse = att.flash_fwd(q, k, v, with_lse=True, layout="bshd")
            sets.append((q, k, v, o, do, lse))
        dq_ms, dq_call_ms, _ = _time(lambda *a: att.flash_bwd_dq(*a, layout="bshd"), sets, 200)
        dkv_ms, dkv_call_ms, _ = _time(lambda *a: att.flash_bwd_dkv(*a, layout="bshd"), sets,
                                       200)
        plain_ms, _, _ = _time(lambda q, k, v, o, do, lse: att.flash_bwd_plain(
            t(q), t(k), t(v), t(o), t(do), lse), sets, 20)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [tuple(x.detach().requires_grad_() for x in qkv) + (t(st[4]).contiguous(),)
                for qkv, st in zip(bhsd_sets, sets)]

    def fwd_bwd(q, k, v, do):
        torch.autograd.grad(sdpa(q, k, v), (q, k, v), do)

    lib_fb_ms, lib_fb_call_ms, lib_kernels = _time(fwd_bwd, lib_sets, 100)
    lib_f_ms, _, _ = _time(lambda q, k, v, do: sdpa(q, k, v), lib_sets, 100)
    library_ms = lib_fb_ms - lib_f_ms

    n = b * s * h * d * 2        # bytes of one [B, S, H, Dh] bf16 operand
    lse_bytes = b * h * s * 4
    out = {}
    for name, ms, call_ms, nbytes, flops in (
            ("flash_bwd_dq", dq_ms, dq_call_ms, 6 * n + lse_bytes, 6 * b * h * s * s * d),
            ("flash_bwd_dkv", dkv_ms, dkv_call_ms, 7 * n + lse_bytes, 8 * b * h * s * s * d)):
        bound_ms, bound_by = _bound(nbytes, flops)
        emit("times", kernel=name, shape=dict(b=b, s=s, h=h, d=d, dtype="bfloat16"), ms=ms,
             call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
             library="SDPA backward (fwd+bwd - fwd)", library_fwd_bwd_ms=lib_fb_ms,
             library_fwd_ms=lib_f_ms, library_fwd_bwd_call_ms=lib_fb_call_ms,
             library_kernels_us=lib_kernels, bound_ms=bound_ms, bound_by=bound_by,
             bytes=nbytes, flops=flops, share_of_bound=bound_ms / ms,
             achieved_bytes_per_s=nbytes / (ms * 1e-3), card=smi)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    return out


def _step_phases(net, trainer, batch, iters):
    """Mean wall ms of the training step's three parts (forward with the
    loss, backward, Trainer.step), each closed by a synchronize, so each
    holds its host dispatch and the device work it queued."""
    ids, types, pos, labels = batch
    spent = {"forward_and_loss": 0.0, "backward": 0.0, "trainer_step": 0.0}
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            mlm, _ = net(ids, types, pos)
            loss = streaming_softmax_ce(mlm, labels).mean(-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mx.autograd.backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(ids.shape[0])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2)):
            spent[key] += dt * 1e3 / iters
    return spent


def phase_times(net, main_req, train, counts, errs, smi):
    """``train`` = (net, trainer, batch); ``counts`` = {path: launch
    counts}; ``errs`` = {kernel: max abs error at the main path's layout}."""
    device = torch.device("cuda", 0)
    b, s, h, d = MAIN["b"], MAIN["sq"], MAIN["h"], MAIN["d"]
    gen = torch.Generator(device=device).manual_seed(99)
    qkv_sets = [_randn((b, s, 3, h, d), torch.bfloat16, gen, device) for _ in range(4)]
    views = [(x[:, :, 0], x[:, :, 1], x[:, :, 2]) for x in qkv_sets]
    bhsd_sets = [tuple(t.transpose(1, 2).contiguous() for t in v) for v in views]

    before = kernel_counts()
    rows = {"flash_fwd": _times_fwd(views, bhsd_sets, smi)}
    rows.update(_times_bwd(views, bhsd_sets, gen, smi))

    iters = 10
    torch.cuda.reset_peak_memory_stats()
    with mx.autograd.predict_mode():
        net(*main_req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            net(*main_req)
        torch.cuda.synchronize()
        fwd_s = (time.perf_counter() - t0) / iters
    emit("times", forward="BERTForPretrain(bert_base) bf16", b=b, s=s, p=main_req[2].shape[1],
         forward_ms=fwd_s * 1e3, samples_per_s=b / fwd_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), card=smi)

    tnet, trainer, batch = train
    tb = batch[0].shape[0]
    torch.cuda.reset_peak_memory_stats()
    train_step(tnet, trainer, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        train_step(tnet, trainer, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    emit("times", train_step="BERTForPretrain(bert_base) bf16, Adam multi_precision, "
         "dropout 0.1", b=tb, s=batch[0].shape[1], p=batch[2].shape[1],
         step_ms=step_s * 1e3, samples_per_s=tb / step_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), card=smi)
    emit("times", train_step_phases_ms=_step_phases(tnet, trainer, batch, 5), card=smi)

    with mx.autograd.predict_mode():
        phase_profile("forward: BERTForPretrain(bert_base) bf16 B=64 S=128 P=20",
                      lambda: net(*main_req), smi)
    phase_profile("train step: BERTForPretrain(bert_base) bf16 B=64 S=128 P=20, Adam mp",
                  lambda: train_step(tnet, trainer, batch), smi)
    set_kernel_counts(before)  # timed and profiled launches are not the main paths'

    sources = {"flash_fwd": ("flash_fwd.cu", "incubator_mxnet_tpu/ops/attention.py:85"),
               "flash_bwd_dq": ("flash_bwd.cu", "incubator_mxnet_tpu/ops/attention.py:203"),
               "flash_bwd_dkv": ("flash_bwd.cu", "incubator_mxnet_tpu/ops/attention.py:248")}
    kernels = []
    for name, (src, replaces) in sources.items():
        path = "inference" if name == "flash_fwd" else "train_step"
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"incubator_mxnet_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": counts[path][name],
            "launches_by_path": {p: c[name] for p, c in counts.items()},
            "max_abs_err": errs[name], "max_err": errs[name], "ms": row["ms"],
            "kernel_ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)


def rehearse_times(net, main_req, train):
    """CPU stand-in for phase 6: host times of the plain paths, labelled as
    CPU numbers, never as the card's."""
    t0 = time.perf_counter()
    with mx.autograd.predict_mode():
        net(*main_req)
    t1 = time.perf_counter()
    train_step(*train)
    emit("times", device="cpu", note="CPU rehearsal: host time, not a device metric",
         forward_host_ms=(t1 - t0) * 1e3, train_step_host_ms=(time.perf_counter() - t1) * 1e3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 4-6 on the CPU at a tiny size; never prints ok")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cpu_rehearsal:
        net, main_req, _ = phase_slice(rehearsal=True)
        tnet, trainer, batch, _ = phase_train(rehearsal=True)
        phase_train_vs_cpu(tnet, rehearsal=True)
        rehearse_times(net, main_req, (tnet, trainer, batch))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on the card",
              file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    device = torch.device("cuda", 0)
    errs = {"flash_fwd": phase_kernel_vs_plain(device)}
    errs.update(phase_kernel_vs_plain_bwd(device))
    net, main_req, infer_counts = phase_slice(rehearsal=False)
    tnet, trainer, batch, train_counts = phase_train(rehearsal=False)
    phase_train_vs_cpu(tnet, rehearsal=False)
    phase_times(net, main_req, (tnet, trainer, batch),
                {"inference": infer_counts, "train_step": train_counts}, errs, smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
