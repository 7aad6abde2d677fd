"""The port's fused whole-group optimizer update against the JAX package's,
on the CPU.

Both packages get the same parameters (seeded numpy weights, fp32 or bf16
with ``multi_precision``), the same optimizer settings (lr and wd
multipliers per parameter) and the same 3-5 steps of gradients, written
into the gradient buffers as a backward would write them, and each
``gluon.Trainer.step`` goes through its package's ``fused_update``.  On the
CPU the port's group update is the loop of its per-tensor ops
(``group_apply_plain``), so its fused and per-tensor paths must agree bit
for bit; the card's kernel is held to the same loop by the ``cuda`` tests
at the end of this file and by ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.ops import optimizer_ops as jops
from incubator_mxnet_tpu.optimizer import fused as jfused
from incubator_mxnet_tpu.optimizer import optimizer as jopt_mod
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.ops import multi_tensor as mt
from incubator_mxnet_torch.ops import optimizer_ops as tops
from incubator_mxnet_torch.optimizer import fused as tfused
from incubator_mxnet_torch.optimizer import optimizer as topt_mod

# The tolerances of tests/test_torch_optimizer.py: fp32, the same fp32
# arithmetic in the same order with hyperparameters rounded to fp32 on both
# sides, where only pow/sqrt/div implementations differ (an ulp) and steps
# compound it a little; bf16 weights, one bf16 ulp (2**-7 relative) where
# the fp32 master sits on a rounding boundary.
FP32_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=2 ** -7, atol=0)

SHAPES = [(7, 33), (33,), (5,), (3, 4, 5)]
OPTS = {"sgd": ("sgd", dict(learning_rate=0.1)),
        "sgd_mom": ("sgd", dict(learning_rate=0.1, momentum=0.9)),
        "adam": ("adam", dict(learning_rate=0.01))}
CLIPS = {"no_clip_none": None, "no_clip_-1": -1.0, "clip": 0.05}


def _params(shapes, dtypes, seed):
    """Seeded numpy weights and the two packages' Parameters holding them;
    parameter i gets lr_mult 1 + i/4 and wd_mult 1 − i/8."""
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    jp, tp = [], []
    for i, (w, dt) in enumerate(zip(ws, dtypes)):
        j = mxj.gluon.Parameter(f"p{i}_weight", shape=w.shape, dtype=dt)
        j.initialize(ctx=mxj.cpu())
        j.set_data(mxj.nd.array(w).astype(dt))
        t = mx.gluon.Parameter(f"p{i}_weight", shape=w.shape, dtype=dt)
        t.initialize(ctx=mx.cpu())
        t.set_data(torch.from_numpy(w.copy()))
        for p in (j, t):
            p.lr_mult, p.wd_mult = 1 + i / 4, 1 - i / 8
        jp.append(j)
        tp.append(t)
    return jp, tp


def _write_grads(jp, tp, grads, fresh=None):
    """Write each parameter's gradient as a backward does (the JAX buffer's
    version moves with the write; the port's backward hook bumps
    ``_grad_version``); ``fresh`` = the indices a backward touched, ``jp``
    None when only the port runs."""
    for i, (t, g) in enumerate(zip(tp, grads)):
        if fresh is not None and i not in fresh:
            continue
        if jp is not None:
            jp[i].grad()[:] = mxj.nd.array(g).astype(jp[i].dtype)
        t.grad().copy_(torch.from_numpy(g))
        t._grad_version += 1


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.asnumpy(), np.float32)


def _flat_state(st):
    if st is None:
        return []
    if isinstance(st, (tuple, list)):
        return [a for s in st for a in _flat_state(s)]
    return [st]


def _trainers(jp, tp, name, kw, batch=4):
    opt, base = OPTS[name]
    kw = dict(base, wd=1e-3, **kw)
    return (mxj.gluon.Trainer(jp, opt, dict(kw)), mx.gluon.Trainer(tp, opt, dict(kw)), batch)


def _steps(seed, shapes, n):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * 0.1).astype(np.float32) for s in shapes] for _ in range(n)]


def _run_port(dtypes, name, kw, grads, aggregate_num, seed=0):
    """The port alone from the same start, with ``aggregate_num`` set:
    (weights, flat states) after the steps."""
    _, tp = _params(SHAPES, dtypes, seed)
    opt, base = OPTS[name]
    tr = mx.gluon.Trainer(tp, opt, dict(base, wd=1e-3, aggregate_num=aggregate_num, **kw))
    for step in grads:
        _write_grads(None, tp, step)
        tr.step(4)
    return ([p.data().clone() for p in tp],
            [s.clone() for i in sorted(tr._states) for s in _flat_state(tr._states[i])])


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTS))
def test_fused_trainer_matches_jax(name, dtype, clip):
    dtypes = [dtype] * len(SHAPES)
    jp, tp = _params(SHAPES, dtypes, 0)
    kw = dict(clip_gradient=CLIPS[clip], multi_precision=dtype == "bfloat16")
    jtr, ttr, batch = _trainers(jp, tp, name, kw)
    grads = _steps(1, SHAPES, 4)
    calls = tfused.fused_update.calls
    for step in grads:
        _write_grads(jp, tp, step)
        jtr.step(batch)
        ttr.step(batch)
    assert tfused.fused_update.calls - calls == len(grads)  # one group, one chunk
    assert ttr._optimizer._index_update_count == jtr._optimizer._index_update_count
    tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
    for j, t in zip(jp, tp):
        assert t.data().dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_numpy(t.data()), _numpy(j.data()), err_msg=t.name, **tol)
    for i in sorted(jtr._states):
        for a, b in zip(_flat_state(ttr._states[i]), _flat_state(jtr._states[i])):
            np.testing.assert_allclose(_numpy(a), _numpy(b), err_msg=f"state {i}", **FP32_TOL)

    # the port's per-tensor loop from the same start: bit-equal
    loop_w, loop_s = _run_port(dtypes, name, kw, grads, aggregate_num=0)
    for t, w in zip(tp, loop_w):
        assert torch.equal(t.data(), w), t.name
    fused_s = [s for i in sorted(ttr._states) for s in _flat_state(ttr._states[i])]
    assert len(fused_s) == len(loop_s)
    for a, b in zip(fused_s, loop_s):
        assert torch.equal(a, b)


def test_chunks_of_aggregate_num():
    """7 parameters at aggregate_num=3: three group updates a step."""
    shapes = [(3, i + 2) for i in range(7)]
    jp, tp = _params(shapes, ["float32"] * 7, 2)
    kw = dict(aggregate_num=3, momentum=0.9)
    jtr = mxj.gluon.Trainer(jp, "sgd", dict(kw, learning_rate=0.1))
    ttr = mx.gluon.Trainer(tp, "sgd", dict(kw, learning_rate=0.1))
    assert ttr._optimizer.aggregate_num == jtr._optimizer.aggregate_num == 3
    for step in _steps(3, shapes, 3):
        _write_grads(jp, tp, step)
        calls, params = tfused.fused_update.calls, tfused.fused_update.params
        jtr.step(2)
        ttr.step(2)
        assert (tfused.fused_update.calls - calls, tfused.fused_update.params - params) == (3, 7)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(_numpy(t.data()), _numpy(j.data()), **FP32_TOL)


@pytest.mark.parametrize("value", ["", "on", "auto", "0", "off", "false", "none", "3", "1",
                                   "-2", "junk"])
def test_aggregation_env_read_as_jax_reads_it(monkeypatch, value):
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION", value)
    assert topt_mod._default_aggregate_num() == jopt_mod._default_aggregate_num()
    assert mx.optimizer.create("sgd").aggregate_num == mxj.optimizer.create("sgd").aggregate_num
    assert mx.optimizer.create("adam", aggregate_num=5).aggregate_num == 5


def test_aggregation_off_takes_the_loop(monkeypatch):
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION", "0")
    jp, tp = _params(SHAPES, ["float32"] * len(SHAPES), 4)
    jtr, ttr, batch = _trainers(jp, tp, "adam", {})
    assert ttr._optimizer.aggregate_num == 0
    before = (tfused.fused_update.calls, tfused.fused_update.fallback_params)
    for step in _steps(5, SHAPES, 3):
        _write_grads(jp, tp, step)
        jtr.step(batch)
        ttr.step(batch)
    assert (tfused.fused_update.calls, tfused.fused_update.fallback_params) == before
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(_numpy(t.data()), _numpy(j.data()), **FP32_TOL)


def test_unsupported_optimizer_falls_back():
    class MySGD(mx.optimizer.SGD):
        pass

    _, tp = _params(SHAPES, ["float32"] * len(SHAPES), 6)
    tr = mx.gluon.Trainer(tp, MySGD(learning_rate=0.1))
    before = tfused.fused_update.fallback_params
    _write_grads(None, tp, _steps(7, SHAPES, 1)[0])
    tr.step(1)
    assert tfused.fused_update.fallback_params - before == len(SHAPES)
    assert not tfused.supports(tr._optimizer) and tfused.supports(mx.optimizer.Adam())


@pytest.mark.parametrize("name", ["sgd", "sgd_mom", "adam"])
def test_plan_groups_match_jax(name):
    """fp32 and bf16 parameters under multi_precision: the same groups,
    keyed by adapter name, dtype and device, with the same members."""
    dtypes = ["float32", "bfloat16", "float32", "bfloat16", "bfloat16"]
    shapes = [(4, 3), (5,), (2, 2), (6,), (3, 3)]
    jp, tp = _params(shapes, dtypes, 8)
    opt, base = OPTS[name]
    jo = mxj.optimizer.create(opt, multi_precision=True, **base)
    to = mx.optimizer.create(opt, multi_precision=True, **base)
    jst = {i: jo.create_state_multi_precision(i, p.data()) for i, p in enumerate(jp)}
    tst = {i: to.create_state_multi_precision(i, p.data()) for i, p in enumerate(tp)}
    jg, jrest = jfused.plan_groups(jo, [(i, p.data(), p.grad()) for i, p in enumerate(jp)], jst)
    tg, trest = tfused.plan_groups(to, [(i, p.data(), p.grad()) for i, p in enumerate(tp)], tst)
    norm = lambda groups: [(k[0].__name__, k[1], [m[0] for m in v])  # noqa: E731
                           for k, v in groups.items()]
    assert norm(tg) == norm(jg)
    assert len(norm(tg)) == 2 and trest == [] and jrest == []
    # each member's flat states are those of the per-tensor state
    for (_, _, _), members in tg.items():
        for i, _, _, flat in members:
            assert all(any(s is f for f in _flat_state(tst[i])) for s in flat)


def test_ignore_stale_grad_matches_jax():
    jp, tp = _params(SHAPES, ["float32"] * len(SHAPES), 9)
    jtr, ttr, batch = _trainers(jp, tp, "adam", {})
    grads = _steps(10, SHAPES, 3)
    for k, step in enumerate(grads):
        _write_grads(jp, tp, step, fresh=None if k == 0 else {0, 2})
        jtr.step(batch, ignore_stale_grad=True)
        ttr.step(batch, ignore_stale_grad=True)
    assert ttr._optimizer._index_update_count == jtr._optimizer._index_update_count
    assert ttr._optimizer._index_update_count == {0: 3, 1: 1, 2: 3, 3: 1}
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(_numpy(t.data()), _numpy(j.data()), **FP32_TOL)


def test_save_load_states_keeps_adams_t(tmp_path):
    """Two steps, save, a new Trainer loads, two more: Adam's t per index
    resumes, bit-equal to an uninterrupted run and close to the JAX one."""
    dtypes = ["bfloat16"] * len(SHAPES)
    jp, tp = _params(SHAPES, dtypes, 11)
    kw = dict(multi_precision=True)
    jtr, ttr, batch = _trainers(jp, tp, "adam", kw)
    grads = _steps(12, SHAPES, 4)
    for step in grads[:2]:
        _write_grads(jp, tp, step)
        jtr.step(batch)
        ttr.step(batch)
    ttr.save_states(str(tmp_path / "t.states"))
    ttr = _trainers(jp, tp, "adam", kw)[1]
    ttr.load_states(str(tmp_path / "t.states"))
    assert ttr._optimizer._index_update_count == {i: 2 for i in range(len(SHAPES))}
    calls = tfused.fused_update.calls
    for step in grads[2:]:
        _write_grads(jp, tp, step)
        jtr.step(batch)
        ttr.step(batch)
    assert tfused.fused_update.calls - calls == 2
    assert ttr._optimizer._index_update_count == {i: 4 for i in range(len(SHAPES))}
    straight, _ = _run_port(dtypes, "adam", kw, grads, aggregate_num=256, seed=11)
    for j, t, w in zip(jp, tp, straight):
        assert torch.equal(t.data(), w)
        np.testing.assert_allclose(_numpy(t.data()), _numpy(j.data()), **BF16_TOL)


MULTI = {  # op: (states per weight, takes momentum, multi-precision)
    "multi_sgd_update": (0, False, False),
    "multi_sgd_mom_update": (1, True, False),
    "multi_mp_sgd_update": (1, False, True),
    "multi_mp_sgd_mom_update": (2, True, True),
}


@pytest.mark.parametrize("preloaded", [False, True], ids=["host_lrs", "preloaded"])
@pytest.mark.parametrize("clip", [-1.0, 0.05, 0.0])
@pytest.mark.parametrize("op", list(MULTI))
def test_multi_ops_match_jax(op, clip, preloaded):
    nstates, momentum, mp = MULTI[op]
    rng = np.random.RandomState(13)
    shapes = [(6, 5), (9,), (2, 3, 4)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    moms = [(rng.randn(*s) * 0.01).astype(np.float32) for s in shapes]
    lrs, wds = [0.1, 0.05, 0.2], [1e-3, 0.0, 2e-3]
    tdt, jdt = (torch.bfloat16, "bfloat16") if mp else (torch.float32, "float32")
    tw = [torch.from_numpy(w.copy()).to(tdt) for w in ws]
    jw = [mxj.nd.array(w).astype(jdt)._data for w in ws]
    tst = ([[torch.from_numpy(m.copy()) for m in moms]] if momentum else []) + (
        [[torch.from_numpy(w.copy()) for w in ws]] if mp else [])
    jst = ([[mxj.nd.array(m)._data for m in moms]] if momentum else []) + (
        [[mxj.nd.array(w)._data for w in ws]] if mp else [])
    assert len(tst) == nstates
    kw = dict(rescale_grad=0.5, clip_gradient=clip, **({"momentum": 0.9} if momentum else {}))
    name = ("preloaded_" if preloaded else "") + op
    tfn, jfn = getattr(mx.nd, name), getattr(jops, name)
    tl, tw_ = ((torch.tensor(lrs), torch.tensor(wds)) if preloaded else (lrs, wds))
    jl, jw_ = ((mxj.nd.array(lrs)._data, mxj.nd.array(wds)._data) if preloaded else (lrs, wds))
    for k in range(3):
        g = [(rng.randn(*s) * 0.1).astype(np.float32) for s in shapes]
        tout = tfn(tw, [torch.from_numpy(x).to(tdt) for x in g], *tst, tl, tw_, **kw)
        jout = jfn(jw, [mxj.nd.array(x).astype(jdt)._data for x in g], *jst, jl, jw_, **kw)
        tout = tout if isinstance(tout, tuple) else (tout,)
        jout = jout if isinstance(jout, tuple) else (jout,)
        assert tout[0] is not None and all(a is b for a, b in zip(tout[0], tw))  # in place
        jw, jst = list(jout[0]), [list(x) for x in jout[1:]]
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   **(BF16_TOL if mp else FP32_TOL))
    for ta, ja in zip(tst, jst):
        for a, b in zip(ta, ja):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32_TOL)


# -- the kernel's table, built on the host --------------------------------------


def _group(variant, dtype=torch.float32, sizes=(1, 7, 16384, 16385, 40000)):
    n_states = mt.VARIANTS[variant][1]
    ws = [torch.randn(n).to(dtype) for n in sizes]
    gs = [torch.randn(n).to(dtype) for n in sizes]
    sts = [tuple(torch.zeros(n) for _ in range(n_states)) for n in sizes]
    return ws, gs, sts


def test_table_of_an_adam_chunk():
    ws, gs, sts = _group("mp_adam", torch.bfloat16)
    lrs, wds, ts = [1e-3, 2e-3, 1e-3, 1e-3, 5e-4], [0.0, 1e-2, 0.0, 1e-2, 0.0], [1, 1, 2, 7, 7]
    S = {"rescale": 1 / 3, "clip": math.inf, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    coefs = tops._rates(tops.mp_adam_step, lrs, ts, S)  # what group_apply hands the kernel
    t = mt.table("mp_adam", ws, gs, sts, lrs, wds, *coefs, S)
    assert t["ptrs"].shape == (5, 5)
    assert list(t["ptrs"][0]) == [w.data_ptr() for w in ws]
    assert list(t["ptrs"][1]) == [g.data_ptr() for g in gs]
    for k in range(3):
        assert list(t["ptrs"][2 + k]) == [s[k].data_ptr() for s in sts]
    assert list(t["numel"]) == [1, 7, 16384, 16385, 40000]
    assert t["lr"].dtype == t["wd"].dtype == t["c1"].dtype == t["c2"].dtype == np.float32
    assert list(t["c1"]) == [np.float32(tops._adam_lr(lr, 0.9, 0.999, s))
                             for lr, s in zip(lrs, ts)]
    assert list(t["c2"]) == [0.0] * 5
    f = np.float32
    assert list(t["scalars"]) == [f(1 / 3), -1.0, 0.0, f(0.9), f(1) - f(0.9), f(0.999),
                                  f(1) - f(0.999), f(1e-8), 0.0, 1.0, 0.0, 0.0, 0.0, 0.0,
                                  0.0, 0.0]
    assert len(t["rows"]) == 4 * 5 + 16


@pytest.mark.parametrize("clip,want", [(-1.0, -1.0), (math.inf, -1.0), (0.0, 0.0),
                                       (0.25, 0.25)])
def test_table_clip_sentinels(clip, want):
    ws, gs, sts = _group("sgd_mom", sizes=(5,))
    S = {"rescale": 1.0, "clip": clip, "momentum": 0.9}
    coefs = tops._rates(tops.sgd_mom_step, [0.1], [0], S)
    t = mt.table("sgd_mom", ws, gs, sts, [0.1], [0.0], *coefs, S)
    assert t["scalars"][1] == np.float32(want) and t["c1"][0] == t["c2"][0] == 0.0
    assert list(t["ptrs"][3]) == [0] and list(t["ptrs"][4]) == [0]


def test_table_refusals():
    ws, gs, sts = _group("adam")
    args = ([1e-3] * 5, [0.0] * 5, [1e-3] * 5, [0.0] * 5,
            {"rescale": 1.0, "clip": -1.0, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
    with pytest.raises(ValueError, match="one device and one dtype"):
        mt.table("adam", ws[:-1] + [ws[-1].to(torch.bfloat16)], gs, sts, *args)
    with pytest.raises(ValueError, match="one device and one dtype"):
        mt.table("adam", ws[:-1] + [torch.empty(40000, device="meta")], gs, sts, *args)
    with pytest.raises(ValueError, match="does not match its weight"):
        mt.table("adam", ws, gs[:-1] + [torch.randn(39999)], sts, *args)
    with pytest.raises(ValueError, match="does not match its weight"):
        mt.table("adam", ws, gs[:-1] + [gs[-1].to(torch.float16)], sts, *args)
    with pytest.raises(ValueError, match="not fp32 of its weight's size"):
        mt.table("adam", ws, gs, sts[:-1] + [(sts[-1][0], sts[-1][1].double())], *args)
    with pytest.raises(ValueError, match="takes 2 states"):
        mt.table("adam", ws, gs, sts[:-1] + [sts[-1][:1]], *args)
    with pytest.raises(ValueError, match="non-contiguous"):
        mt.table("adam", [torch.randn(4, 3).t()], [torch.randn(3, 4)],
                 [(torch.zeros(12), torch.zeros(12))], *[a[:1] for a in args[:4]], args[4])
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        mt.table("adam", [torch.zeros(3, dtype=torch.float64)], [torch.zeros(3)],
                 [(torch.zeros(3), torch.zeros(3))], [0.1], [0.0], [0.1], [0.0], args[4])
    with pytest.raises(ValueError, match="unknown variant"):
        mt.table("sgld", ws, gs, sts, *args)
    with pytest.raises(ValueError, match="multi_tensor_update runs on CUDA tensors"):
        mt.multi_tensor_update("adam", ws, gs, sts, *args)
    with pytest.raises(ValueError, match="group_apply runs on CPU or CUDA"):
        tops.group_apply(tops.sgd_step, [torch.empty(3, device="meta")],
                         [torch.empty(3, device="meta")], [()], [0.1], [0.0], [0],
                         {"rescale": 1.0, "clip": -1.0})


# -- the kernel on the card -------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


STEPS = {"sgd": (tops.sgd_step, {}), "sgd_mom": (tops.sgd_mom_step, {"momentum": 0.9}),
         "mp_sgd": (tops.mp_sgd_step, {}), "mp_sgd_mom": (tops.mp_sgd_mom_step,
                                                          {"momentum": 0.9}),
         "adam": (tops.adam_step, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
         "mp_adam": (tops.mp_adam_step, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
         "nag_mom": (tops.nag_mom_step, {"momentum": 0.9}),
         "mp_nag_mom": (tops.mp_nag_mom_step, {"momentum": 0.9}),
         "adamw": (tops.adamw_step, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "eta": 0.5}),
         "rmsprop": (tops.rmsprop_step, {"rho": 0.9, "epsilon": 1e-8}),
         "rmspropalex": (tops.rmspropalex_step, {"rho": 0.9, "momentum": 0.9, "epsilon": 1e-8})}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("variant", list(STEPS))
def test_kernel_is_bit_equal_to_the_loop_on_card(cuda_device, variant, dtype):
    """Three steps of one group of mixed sizes (a tensor past one block, a
    view at an element's offset from a 16-byte boundary) through the kernel
    and through the loop of per-tensor ops, on the card: bit-equal."""
    step, extra = STEPS[variant]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    sizes = (1, 7, 768, 3072 * 5, 40001)
    n_states = mt.VARIANTS[variant][1]
    start = [torch.randn(n + 1, generator=gen, device=cuda_device) for n in sizes]
    # rmspropalex's n above its g_avg squared, as from zeros: no sqrt of < 0
    floor = [1e-4 if variant == "rmspropalex" and k == 0 else 0.0 for k in range(n_states)]
    states = [[torch.rand(n, generator=gen, device=cuda_device) * 1e-2 + floor[k]
               for k in range(n_states)] for n in sizes]

    def group():  # the last weight is a view one element into its buffer
        ws = ([x[:-1].to(dtype, copy=True) for x in start[:-1]]
              + [start[-1].to(dtype, copy=True)[1:]])
        return ws, [tuple(s.clone() for s in st) for st in states]

    wk, sk = group()
    wp, sp = group()
    assert wk[-1].data_ptr() % 16 != 0
    S = {"rescale": 0.5, "clip": 0.05, **extra}
    lrs, wds = [1e-2] * len(sizes), [1e-3] * len(sizes)
    for t in range(1, 4):
        gs = [torch.randn(n, generator=gen, device=cuda_device).to(dtype) for n in sizes]
        tops.group_apply(step, wk, gs, sk, lrs, wds, [t] * len(sizes), S)
        tops.group_apply_plain(step, wp, gs, sp, lrs, wds, [t] * len(sizes), S)
    torch.cuda.synchronize()
    for a, b in zip(wk + [s for st in sk for s in st], wp + [s for st in sp for s in st]):
        assert torch.equal(a, b)


LAMB_S = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6, "lower_bound": 0.0, "upper_bound": 10.0,
          "bias_correction": 1.0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_lamb_kernels_against_the_loop_on_card(cuda_device, dtype):
    """LAMB's two launches against the per-tensor phase 1 and 2, one update
    at a time: moments bit-equal (the same operations), each weight within
    1e-4 of its step plus 2 ulp (the norms are summed in another order);
    a second launch pair from the same inputs gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    sizes = (1, 7, 768, 3072 * 5, 40001)
    ws = [torch.randn(n, generator=gen, device=cuda_device).to(dtype) for n in sizes]
    ws[1].zero_()  # a zero norm: the trust ratio is 1
    sts = [tuple(torch.rand(n, generator=gen, device=cuda_device) * 1e-2 for _ in range(2))
           for n in sizes]
    lrs, wds = [1e-2] * len(sizes), [1e-2 * (i % 2) for i in range(len(sizes))]
    for t in range(1, 4):
        S = {"rescale": 0.5, "clip": (math.inf, 0.05, -1.0)[t - 1], **LAMB_S}
        gs = [torch.randn(n, generator=gen, device=cuda_device).to(dtype) for n in sizes]
        copies = [([w.clone() for w in ws], [tuple(x.clone() for x in st) for st in sts])
                  for _ in range(3)]
        (wk, sk), (wk2, sk2), (wp, sp) = copies
        tops.group_apply(tops.lamb_step, wk, gs, sk, lrs, wds, [t] * len(sizes), S)
        tops.group_apply(tops.lamb_step, wk2, gs, sk2, lrs, wds, [t] * len(sizes), S)
        tops.group_apply_plain(tops.lamb_step, wp, gs, sp, lrs, wds, [t] * len(sizes), S)
        torch.cuda.synchronize()
        for a, b in zip(wk + [x for st in sk for x in st], wk2 + [x for st in sk2 for x in st]):
            assert torch.equal(a, b)
        for a, b in zip([x for st in sk for x in st], [x for st in sp for x in st]):
            assert torch.equal(a, b)
        mant = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}[dtype]
        for a, b, w0 in zip(wk, wp, ws):
            a, b, w0 = a.float(), b.float(), w0.float()
            ulp = torch.where(b == 0, torch.zeros_like(b),
                              torch.exp2(torch.floor(torch.log2(b.abs())) - mant))
            assert bool(((a - b).abs() <= 1e-4 * (b - w0).abs() + 2 * ulp).all())
        ws, sts = wp, sp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_finite_pass_against_its_plain_version_on_card(cuda_device, dtype):
    """Per tensor the sum of squares and the non-finite count, in one launch:
    counts exact with NaN, +inf and -inf elements, sums within 1e-5 of the
    plain fp32 ones, non-finite where they are; a finite value whose square
    overflows gives an infinite sum and a count of 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    sizes = (1, 7, 768, 3072 * 5, 40001, 0)
    xs = [torch.randn(n, generator=gen, device=cuda_device).to(dtype) for n in sizes]
    xs[0][0] = float("nan")
    xs[3][5], xs[3][77] = float("inf"), float("-inf")
    if dtype != torch.float16:
        xs[2][3] = 1e20
    launches = mt.sum_sq_finite.launches
    sq, bad = mt.sum_sq_finite(xs)
    psq, pbad = tops.sum_sq_finite_plain(xs)
    assert mt.sum_sq_finite.launches - launches == 1
    assert bad.tolist() == pbad.tolist()
    a, b = sq.cpu().double(), psq.cpu().double()
    assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a.isinf(), b.isinf())
    fin = b.isfinite()
    assert bool(((a[fin] - b[fin]).abs() <= 1e-5 * b[fin].abs()).all())
    if dtype != torch.float16:
        assert bad[2].item() == 0 and math.isinf(sq[2].item())
    assert not bool(mx.nd.all_finite(*xs).item())
    assert bool(mx.nd.multi_all_finite(*xs[1:3], xs[4]).item())
