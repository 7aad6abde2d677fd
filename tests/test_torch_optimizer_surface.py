"""The rest of the port's training surface against the JAX package, on the
CPU: the sixteen optimizers the port added to SGD and Adam, the update ops
they use (the 25 the symbol table queued), the fused group adapters they
take, and the learning-rate schedulers.

Both packages get the same seeded numpy weights and three steps of
gradients.  fp32 is held to 1e-6 relative (the same fp32 arithmetic in the
same order, hyperparameters rounded to fp32 on both sides; pow, sqrt and a
division by a bias correction the port multiplies by its reciprocal differ
by an ulp); bf16 weights under ``multi_precision`` to one bf16 ulp (2**-7
relative), where the fp32 master sits on a rounding boundary.
"""
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.ops import optimizer_ops as jops
from incubator_mxnet_tpu.optimizer import fused as jfused
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.ops import optimizer_ops as tops
from incubator_mxnet_torch.optimizer import fused as tfused

FP32_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=2 ** -7, atol=0)

OPTIMIZERS = {
    "nag": dict(momentum=0.9),
    "nag_no_momentum": dict(),
    "adamw": dict(eta=0.5),
    "adagrad": dict(),
    "adadelta": dict(),
    "rmsprop": dict(momentum=0.9),
    "rmsprop_centered": dict(centered=True),
    "ftrl": dict(),
    "signum": dict(wd_lh=1e-3),
    "lamb": dict(lower_bound=1e-3, upper_bound=10.0),
    "lamb_no_bias_correction": dict(bias_correction=False),
    "nadam": dict(),
    "ftml": dict(),
    "dcasgd": dict(momentum=0.9),
    "adamax": dict(),
    "lbsgd": dict(momentum=0.9, batch_scale=4, warmup_strategy="sqrt", warmup_epochs=1,
                  updates_per_epoch=2),
    "lbsgd_lars": dict(warmup_strategy="lars"),
    "lars": dict(momentum=0.9),
    "groupadagrad": dict(),
}


def _kind(name):
    return {"nag_no_momentum": "nag", "rmsprop_centered": "rmsprop",
            "lamb_no_bias_correction": "lamb", "lbsgd_lars": "lbsgd"}.get(name, name)


def _hyper(name, clip):
    kw = dict(OPTIMIZERS[name], learning_rate=0.01, rescale_grad=0.5,
              wd=0.0 if name == "groupadagrad" else 1e-3)
    if clip is not None:
        kw["clip_gradient"] = clip
    return kw


def _run(name, dtype, clip, steps=3):
    """``steps`` per-tensor updates through both packages' optimizers:
    (port weight, JAX weight, port states, JAX states) as numpy."""
    rng = np.random.RandomState(zlib.crc32(f"{name}{dtype}{clip}".encode()))
    w = rng.randn(7, 9).astype(np.float32)
    mp = dtype == "bfloat16"
    topt = mx.optimizer.create(_kind(name), multi_precision=mp, **_hyper(name, clip))
    jopt = mxj.optimizer.create(_kind(name), multi_precision=mp, **_hyper(name, clip))
    tw = torch.from_numpy(w.copy()).to(getattr(torch, dtype))
    jw = mxj.nd.array(w).astype(dtype)
    ts = topt.create_state_multi_precision(0, tw)
    js = jopt.create_state_multi_precision(0, jw)
    for _ in range(steps):
        g = (rng.randn(7, 9) * 0.1).astype(np.float32)
        topt.update_multi_precision(0, tw, torch.from_numpy(g).to(tw.dtype), ts)
        jopt.update_multi_precision(0, jw, mxj.nd.array(g).astype(dtype), js)
    return tw, jw, ts, js


def _flat(st):
    if st is None:
        return []
    if isinstance(st, (tuple, list)):
        return [x for s in st for x in _flat(s)]
    return [st]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x.asnumpy(), np.float32)


@pytest.mark.parametrize("clip", [None, 0.05], ids=["no_clip", "clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax(name, dtype, clip):
    """Three updates of every new optimizer, fp32 and (its multi_precision
    path, the base class's update on the fp32 master where the class has no
    own) bf16 weights: weights and every state against the JAX class."""
    tw, jw, ts, js = _run(name, dtype, clip)
    tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
    assert tw.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(tw), _np(jw), **tol)
    tflat, jflat = _flat(ts), _flat(js)
    assert len(tflat) == len(jflat)
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(_np(a), _np(b), **FP32_TOL)


def test_sgld_draws_its_noise_from_the_device_generator():
    """SGLD's step is SGD's half step plus sqrt(lr)·N(0, 1) noise from the
    port's generator: the same seed, the same weights; the noise standard
    normal; and ``sgld_update`` given the noise matches the JAX op."""
    def run(seed):
        mx.random.seed(seed)
        opt = mx.optimizer.create("sgld", learning_rate=0.04, wd=0.0)
        w = torch.zeros(200, 200)
        opt.update(0, w, torch.zeros(200, 200), opt.create_state(0, w))
        return w
    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    noise = a / math.sqrt(0.04)
    assert abs(noise.mean().item()) < 0.02 and abs(noise.std().item() - 1) < 0.02
    rng = np.random.RandomState(5)
    w, g, n = (rng.randn(5, 6).astype(np.float32) for _ in range(3))
    tw = torch.from_numpy(w.copy())
    tops.sgld_update(tw, torch.from_numpy(g), 0.01, 1e-3, 0.5, 0.05, torch.from_numpy(n))
    jw = jops.sgld_update(jnp.asarray(w), jnp.asarray(g), *map(jnp.float32,
                          (0.01, 1e-3, 0.5, 0.05)), jnp.asarray(n))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **FP32_TOL)


# -- the update ops ----------------------------------------------------------------

# name: (state names, scalar arguments after the states; "t" is the step)
OPS = {
    "sgd_lazy_update": ((), ("lr", "wd", "rescale", "clip")),
    "sgd_mom_lazy_update": (("mom",), ("lr", "wd", "rescale", "clip", "momentum")),
    "mp_sgd_mom_lazy_update": (("mom", "w32"), ("lr", "wd", "rescale", "clip", "momentum")),
    "adam_lazy_update": (("mean", "var"), ("lr", "wd", "rescale", "clip", "beta1", "beta2",
                                          "eps", "t")),
    "nag_mom_update": (("mom",), ("lr", "wd", "rescale", "clip", "momentum")),
    "mp_nag_mom_update": (("mom", "w32"), ("lr", "wd", "rescale", "clip", "momentum")),
    "adamw_update": (("mean", "var"), ("lr", "wd", "eta", "rescale", "clip", "beta1", "beta2",
                                      "eps", "t")),
    "rmsprop_update": (("n",), ("lr", "wd", "rescale", "clip", "rho", "eps")),
    "rmspropalex_update": (("n", "g_avg", "delta"), ("lr", "wd", "rescale", "clip", "rho",
                                                    "momentum", "eps")),
    "adagrad_update": (("hist",), ("lr", "wd", "rescale", "clip", "eps")),
    "adadelta_update": (("acc_g", "acc_d"), ("wd", "rescale", "clip", "rho", "eps")),
    "ftrl_update": (("z", "n"), ("lr", "wd", "rescale", "clip", "lamda1", "beta")),
    "signum_update": (("mom",), ("lr", "wd", "rescale", "clip", "momentum", "wd_lh")),
    "nadam_update": (("mean", "var", "sched"), ("lr", "wd", "rescale", "clip", "beta1",
                                               "beta2", "eps", "t", "schedule_decay")),
    "ftml_update": (("d", "v", "z"), ("lr", "wd", "rescale", "clip", "beta1", "beta2", "eps",
                                      "t")),
    "dcasgd_update": (("mom", "prev"), ("lr", "wd", "rescale", "clip", "momentum", "lamda")),
    "adamax_update": (("mean", "inf"), ("lr", "wd", "rescale", "clip", "beta1", "beta2")),
    "group_adagrad_update": (("rowhist",), ("lr", "rescale", "clip", "eps")),
}
VALUES = dict(lr=0.01, wd=1e-3, rescale=0.5, momentum=0.9, beta1=0.9, beta2=0.999, eps=1e-6,
              eta=0.5, rho=0.9, lamda1=0.01, beta=1.0, wd_lh=1e-3, schedule_decay=0.004,
              lamda=0.04)


def _state(name, n, w, rng):
    if name in ("w32", "prev"):
        return w.copy()
    if name == "sched":
        return np.ones((), np.float32)
    if name == "rowhist":
        return np.abs(rng.randn(w.shape[0], 1)).astype(np.float32) * 1e-2
    if name in ("var", "n", "hist", "acc_g", "acc_d", "v", "inf", "d"):
        return np.abs(rng.randn(*w.shape)).astype(np.float32) * 1e-2 + (1e-2 if name in (
            "n", "d") else 0)
    return rng.randn(*w.shape).astype(np.float32) * 1e-2


@pytest.mark.parametrize("clip", [-1.0, 0.05], ids=["no_clip", "clip"])
@pytest.mark.parametrize("name", list(OPS))
def test_update_op_matches_jax(name, clip):
    """Three steps of each update op: the port's in place, the JAX op's
    returned arrays; the lazy ops with a gradient whose second row is
    zero, which they leave as it is."""
    states, scalars = OPS[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    w = rng.randn(4, 6).astype(np.float32)
    st = [_state(s, name, w, rng) for s in states]
    tw, tst = torch.from_numpy(w.copy()), [torch.from_numpy(x.copy()) for x in st]
    jw, jst = jnp.asarray(w), [jnp.asarray(x) for x in st]
    for t in range(1, 4):
        g = (rng.randn(4, 6) * 0.1).astype(np.float32)
        g[1] = 0.0
        vals = [t if s == "t" else clip if s == "clip" else VALUES[s] for s in scalars]
        getattr(tops, name)(tw, torch.from_numpy(g), *tst, *vals)
        out = getattr(jops, name)(jw, jnp.asarray(g), *jst, *map(jnp.float32, vals))
        out = out if isinstance(out, tuple) else (out,)
        jw, jst = out[0], list(out[1:])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **FP32_TOL)
    if name == "mp_sgd_mom_lazy_update" or name == "mp_nag_mom_update":
        jst = jst[:len(tst)]
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32_TOL)
    if "lazy" in name:
        np.testing.assert_array_equal(tw[1].numpy(), w[1])


def test_lamb_phases_match_jax():
    rng = np.random.RandomState(11)
    w, g, m = (rng.randn(5, 8).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(5, 8)).astype(np.float32)
    for bias in (True, False):
        tw, tm, tv = (torch.from_numpy(x.copy()) for x in (w, m, v))
        r = tops.lamb_update_phase1(tw, torch.from_numpy(g), tm, tv, 1e-3, 0.5, -1.0, 0.9,
                                    0.999, 1e-6, 3, bias)
        jr, jm, jv = jops.lamb_update_phase1(jnp.asarray(w), jnp.asarray(g), jnp.asarray(m),
                                             jnp.asarray(v), *map(jnp.float32, (
                                                 1e-3, 0.5, -1.0, 0.9, 0.999, 1e-6, 3)),
                                             jnp.bool_(bias))
        for a, b in ((r, jr), (tm, jm), (tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32_TOL)
        tops.lamb_update_phase2(tw, r, 0.01, 0.1, 2.0)
        jw = jops.lamb_update_phase2(jnp.asarray(w), jr, *map(jnp.float32, (0.01, 0.1, 2.0)))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **FP32_TOL)


def test_norm_and_finite_ops_match_jax():
    rng = np.random.RandomState(12)
    xs = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    txs, jxs = [torch.from_numpy(x) for x in xs], [jnp.asarray(x) for x in xs]
    ws, gs = tops.multi_sum_sq(*txs), jops.multi_sum_sq(*jxs)
    np.testing.assert_allclose(ws.numpy(), np.asarray(gs), **FP32_TOL)
    lrs, wds = np.array([0.1, 0.2, 0.3], np.float32), np.array([0.0, 1e-3, 1e-2], np.float32)
    gsq = ws * 4
    got = tops.multi_lars(torch.from_numpy(lrs), ws, gsq, torch.from_numpy(wds), eta=0.01,
                          eps=1e-8, rescale_grad=0.5)
    want = jops.multi_lars(jnp.asarray(lrs), jnp.asarray(ws.numpy()), jnp.asarray(gsq.numpy()),
                           jnp.asarray(wds), eta=0.01, eps=1e-8, rescale_grad=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    for bad in (None, float("nan"), float("inf")):
        ys = [x.copy() for x in xs]
        if bad is not None:
            ys[1][3] = bad
        t = bool(mx.nd.all_finite(*(torch.from_numpy(y) for y in ys)))
        m = bool(mx.nd.multi_all_finite(*(torch.from_numpy(y) for y in ys)))
        j = bool(jops.all_finite(*(jnp.asarray(y) for y in ys)))
        assert t == m == j == (bad is None)


QUEUED = ("adadelta_update", "adagrad_update", "adam_lazy_update", "adamax_update",
          "adamw_update", "all_finite", "dcasgd_update", "ftml_update", "ftrl_update",
          "group_adagrad_update", "lamb_update_phase1", "lamb_update_phase2",
          "mp_nag_mom_update", "mp_sgd_mom_lazy_update", "multi_all_finite", "multi_lars",
          "multi_sum_sq", "nadam_update", "nag_mom_update", "rmsprop_update",
          "rmspropalex_update", "sgd_lazy_update", "sgd_mom_lazy_update", "sgld_update",
          "signum_update")


@pytest.mark.parametrize("name", QUEUED)
def test_queued_op_resolves_in_nd_and_sym(name):
    """Every op the symbol table queued for this item is registered:
    ``mx.nd.<name>`` and ``mx.sym.<name>`` find it."""
    assert callable(getattr(mx.nd, name)) and callable(getattr(mx.sym, name))
    assert mx.ops.registry.get_op(name).fn is getattr(tops, name.replace("multi_all_finite",
                                                                         "all_finite"))


# -- the fused group adapters --------------------------------------------------------

SELECT_CASES = [(opt, mp, extra) for opt, extra in (
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("sgd", {"lazy_update": False}),
    ("nag", {}), ("nag", {"momentum": 0.9}), ("adam", {}), ("adam", {"lazy_update": False}),
    ("adamw", {}), ("rmsprop", {}), ("rmsprop", {"centered": True}), ("lamb", {}),
    ("adagrad", {}), ("adadelta", {}), ("ftrl", {}), ("signum", {}), ("nadam", {}),
    ("ftml", {}), ("sgld", {}), ("dcasgd", {}), ("adamax", {}), ("lbsgd", {}), ("lars", {}),
    ("groupadagrad", {})) for mp in (False, True)]


@pytest.mark.parametrize("opt,mp,extra", SELECT_CASES,
                         ids=[f"{o}-{'mp' if m else 'fp'}-{'-'.join(e) or 'default'}"
                              for o, m, e in SELECT_CASES])
def test_select_names_the_jax_adapter(opt, mp, extra):
    """For a bf16 weight (fp32 when not mp), the step adapter ``_select``
    picks, by name, and the count of its state tensors are the JAX
    package's: AdamW under mp takes mp_adam, RMSProp and LAMB under mp and
    every optimizer without a fused variant take the per-tensor path."""
    dtype = "bfloat16" if mp else "float32"
    to = mx.optimizer.create(opt, multi_precision=mp, wd=0.0, **extra)
    jo = mxj.optimizer.create(opt, multi_precision=mp, wd=0.0, **extra)
    tw = torch.zeros(3, 4, dtype=getattr(torch, dtype))
    jw = mxj.nd.zeros((3, 4), dtype=dtype)
    t = tfused._select(to, 0, tw, to.create_state_multi_precision(0, tw))
    j = jfused._select(jo, 0, jw, jo.create_state_multi_precision(0, jw))
    assert (t is None) == (j is None)
    if t is not None:
        assert (t[0].__name__, len(t[1])) == (j[0].__name__, len(j[1]))
        assert t[0].variant == t[0].__name__[:-len("_step")]
    assert tfused.supports(to) == jfused.supports(jo)


def test_adamw_under_multi_precision_takes_mp_adam():
    opt = mx.optimizer.create("adamw", multi_precision=True, eta=0.5)
    w = torch.zeros(4, dtype=torch.bfloat16)
    step, flat = tfused._select(opt, 0, w, opt.create_state_multi_precision(0, w))
    assert step is tops.mp_adam_step and len(flat) == 3
    assert tfused._scalars(opt)["eta"] == 0.5


FUSED = {"nag": ("nag", dict(momentum=0.9)), "adamw": ("adamw", dict(eta=0.5)),
         "rmsprop": ("rmsprop", dict()), "rmsprop_centered": ("rmsprop", dict(centered=True)),
         "lamb": ("lamb", dict(upper_bound=5.0))}
SHAPES = [(7, 33), (33,), (5,), (3, 4, 5)]


def _params(dtype, seed):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jp, tp = [], []
    for i, w in enumerate(ws):
        j = mxj.gluon.Parameter(f"p{i}_weight", shape=w.shape, dtype=dtype)
        j.initialize(ctx=mxj.cpu())
        j.set_data(mxj.nd.array(w).astype(dtype))
        t = mx.gluon.Parameter(f"p{i}_weight", shape=w.shape, dtype=dtype)
        t.initialize(ctx=mx.cpu())
        t.set_data(torch.from_numpy(w.copy()))
        for p in (j, t):
            p.lr_mult, p.wd_mult = 1 + i / 4, 1 - i / 8
        jp.append(j)
        tp.append(t)
    return jp, tp


def _write(jp, tp, grads):
    for j, t, g in zip(jp, tp, grads):
        if j is not None:
            j.grad()[:] = mxj.nd.array(g).astype(j.dtype)
        t.grad().copy_(torch.from_numpy(g))
        t._grad_version += 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(FUSED))
def test_fused_trainer_matches_jax_and_the_loop(name, dtype):
    """Four Trainer steps of each new fused optimizer with a lr scheduler,
    against the JAX Trainer (its fused update), and against the port's own
    per-tensor loop (``aggregate_num=0``) bit for bit; RMSProp and LAMB
    under multi_precision take the per-tensor path in both packages."""
    opt, extra = FUSED[name]
    mp = dtype == "bfloat16"
    kw = dict(extra, learning_rate=0.01, wd=1e-3, multi_precision=mp, clip_gradient=0.05)
    rng = np.random.RandomState(3)
    grads = [[(rng.randn(*s) * 0.1).astype(np.float32) for s in SHAPES] for _ in range(4)]

    def sched(pkg):
        return pkg.lr_scheduler.PolyScheduler(max_update=6, base_lr=0.01, pwr=2,
                                              warmup_steps=2)

    jp, tp = _params(dtype, 0)
    jtr = mxj.gluon.Trainer(jp, opt, dict(kw, lr_scheduler=sched(mxj)))
    ttr = mx.gluon.Trainer(tp, opt, dict(kw, lr_scheduler=sched(mx)))
    calls = tfused.fused_update.calls
    for step in grads:
        _write(jp, tp, step)
        jtr.step(4)
        ttr.step(4)
    fused = not (mp and opt in ("rmsprop", "lamb"))
    assert tfused.fused_update.calls - calls == (len(grads) if fused else 0)
    tol = BF16_TOL if mp else FP32_TOL
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(_np(t.data()), _np(j.data()), err_msg=t.name, **tol)
    for i in sorted(jtr._states):
        for a, b in zip(_flat(ttr._states[i]), _flat(jtr._states[i])):
            np.testing.assert_allclose(_np(a), _np(b), err_msg=f"state {i}", **FP32_TOL)
    _, lp = _params(dtype, 0)
    ltr = mx.gluon.Trainer(lp, opt, dict(kw, lr_scheduler=sched(mx), aggregate_num=0))
    for step in grads:
        _write([None] * len(lp), lp, step)
        ltr.step(4)
    for a, b in zip(tp, lp):
        assert torch.equal(a.data(), b.data()), a.name
    for i in sorted(ttr._states):
        for a, b in zip(_flat(ttr._states[i]), _flat(ltr._states[i])):
            assert torch.equal(a, b)


# -- the schedulers ----------------------------------------------------------------------

SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=3, factor=0.5, stop_factor_lr=1e-3)),
    "multifactor": ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.3)),
    "poly": ("PolyScheduler", dict(max_update=12, pwr=2, final_lr=1e-4)),
    "cosine": ("CosineScheduler", dict(max_update=12, final_lr=1e-4)),
}


@pytest.mark.parametrize("mode", ["linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 4])
@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_jax_exactly(name, warmup, mode):
    """Each scheduler's value at updates 0..15 (and again, in another
    order), warm-up off and on in both modes: exactly the JAX one's."""
    cls, kw = SCHEDULERS[name]
    kw = dict(kw, base_lr=0.1, warmup_steps=warmup, warmup_begin_lr=0.01, warmup_mode=mode)
    t = getattr(mx.lr_scheduler, cls)(**kw)
    j = getattr(mxj.lr_scheduler, cls)(**kw)
    order = list(range(16)) + [3, 1, 15, 7]
    assert [t(k) for k in order] == [j(k) for k in order]


def test_scheduler_base_and_the_optimizers_base_lr():
    """The base class's warm-up; and the reference's quirk: the warm-up
    ramps to the scheduler's own base_lr, fixed at construction, while the
    optimizer then overwrites base_lr with its learning rate."""
    for pkg in (mx, mxj):
        s = pkg.lr_scheduler.LRScheduler(base_lr=0.2, warmup_steps=4, warmup_begin_lr=0.0)
        assert s.get_warmup_lr(2) == 0.1
        with pytest.raises(NotImplementedError):
            s(0)
        with pytest.raises(ValueError):
            pkg.lr_scheduler.LRScheduler(base_lr=0.1, warmup_begin_lr=0.2)
    got = []
    for pkg in (mx, mxj):
        s = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5, base_lr=1.0, warmup_steps=2)
        opt = pkg.optimizer.create("sgd", learning_rate=0.1, lr_scheduler=s)
        vals = []
        for k in range(1, 7):
            opt.num_update = k
            vals.append(opt.learning_rate)
        got.append(vals)
    assert got[0] == got[1] and got[0][:3] == [0.5, 0.1, 0.05]


@pytest.mark.parametrize("name", list(FUSED))
def test_fold_runs_the_new_groups_bit_equal_to_eager(name, monkeypatch):
    """``fold_step`` and the ``MXNET_STEP_FOLD=1`` tail (``fold_update``)
    route the new groups through the fold's tail: on the CPU each runs its
    body directly, bit-equal to eager steps, with no fallback."""
    opt, extra = FUSED[name]
    rng = np.random.RandomState(13)
    data = [(torch.from_numpy(rng.randn(4, 6).astype(np.float32)),
             torch.from_numpy(rng.randn(4, 2).astype(np.float32))) for _ in range(3)]

    def make():
        mx.random.seed(1)
        net = mx.gluon.nn.Dense(2, in_units=6)
        net.initialize(ctx=mx.cpu())
        tr = mx.gluon.Trainer(net.collect_params(), opt, dict(extra, learning_rate=0.01,
                                                               wd=1e-3))
        return net, tr

    def eager(net, tr, x, y):
        with mx.autograd.record():
            loss = mx.gluon.loss.L2Loss()(net(x), y)
        mx.autograd.backward(loss)
        tr.step(4)

    runs = []
    for mode in ("eager", "fold_step", "fold_update"):
        net, tr = make()
        if mode == "fold_step":
            prog = tr.fold_step(lambda x, y: mx.gluon.loss.L2Loss()(net(x), y), block=net)
            for x, y in data:
                prog(x, y)
            assert prog.folded and prog.fallback_reason is None
        else:
            monkeypatch.setenv("MXNET_STEP_FOLD", "1" if mode == "fold_update" else "")
            calls = mx.gluon.step_fold.fold_update.calls
            for x, y in data:
                eager(net, tr, x, y)
            assert mx.gluon.step_fold.fold_update.calls - calls == (3 if mode == "fold_update"
                                                                    else 0)
        runs.append([p.data().clone() for p in net.collect_params().values()]
                    + [s.clone() for i in sorted(tr._states) for s in _flat(tr._states[i])])
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
