"""The PyTorch port's optimizer updates against the JAX package, on the CPU.

Each op of ``incubator_mxnet_torch/ops/optimizer_ops.py`` updates its
weight and state in place; its JAX twin returns new arrays.  Both get the
same weights, states and three steps of gradients from a seeded numpy
generator, in fp32 and with bf16 weights (and an fp32 master copy for the
``mp_*`` ops), under each clipping mode.
"""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.ops import optimizer_ops as jops
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.ops import optimizer_ops as tops

# fp32: the same fp32 arithmetic in the same order, hyperparameters rounded
# to fp32 on both sides; only pow/sqrt/div implementations differ (an ulp).
FP32_TOL = dict(rtol=1e-6, atol=1e-7)
# bf16 weights: the fp32 results agree as above, and their rounding to bf16
# can differ by one bf16 ulp (2**-7 relative) where the fp32 value sits on a
# rounding boundary.
BF16_TOL = dict(rtol=2 ** -7, atol=0)

# clip: -1 = the public ops' "no clip"; inf = the optimizers' "no clip";
# 0.05 clips most of the N(0, 0.1) gradient; 0 clamps it to zero.
CLIPS = [-1.0, float("inf"), 0.05, 0.0]
HYPER = dict(lr=0.01, wd=1e-3, rescale=0.5)
OPS = {  # name: (state names, extra hyperparameters)
    "sgd_update": ((), {}),
    "sgd_mom_update": (("mom",), dict(momentum=0.9)),
    "adam_update": (("mean", "var"), dict(beta1=0.9, beta2=0.999, eps=1e-8)),
    "mp_sgd_update": (("weight32",), {}),
    "mp_sgd_mom_update": (("mom", "weight32"), dict(momentum=0.9)),
    "mp_adam_update": (("mean", "var", "weight32"), dict(beta1=0.9, beta2=0.999, eps=1e-8)),
}


def _start(rng, shape, states):
    w = rng.randn(*shape).astype(np.float32)
    st = {n: (w.copy() if n == "weight32" else
              np.abs(rng.randn(*shape)).astype(np.float32) * 1e-3 if n == "var" else
              rng.randn(*shape).astype(np.float32) * 1e-2) for n in states}
    return w, st


def _run(name, clip, wdtype):
    """Three steps through both packages; returns (port, jax) numpy dicts."""
    states, extra = OPS[name]
    rng = np.random.RandomState(zlib.crc32(f"{name}{clip}".encode()))
    w, st = _start(rng, (7, 33), states)
    grads = [(rng.randn(7, 33) * 0.1).astype(np.float32) for _ in range(3)]
    hyper = dict(HYPER, clip=clip, **extra)
    tdt = torch.bfloat16 if wdtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if wdtype == "bfloat16" else jnp.float32

    tw = torch.from_numpy(w.copy()).to(tdt)  # updated in place: never numpy's buffer
    tst = {n: torch.from_numpy(a.copy()) for n, a in st.items()}
    jw = jnp.asarray(w).astype(jdt)
    jst = {n: jnp.asarray(a) for n, a in st.items()}
    for step, g in enumerate(grads, 1):
        targs = [tw, torch.from_numpy(g).to(tdt)] + [tst[n] for n in states]
        jargs = [jw, jnp.asarray(g).astype(jdt)] + [jst[n] for n in states]
        scal = [hyper[k] for k in ("lr", "wd", "rescale", "clip")]
        if "momentum" in hyper:
            scal.append(hyper["momentum"])
        if "beta1" in hyper:
            scal += [hyper["beta1"], hyper["beta2"], hyper["eps"], step]
        getattr(tops, name)(*targs, *scal)
        out = getattr(jops, name)(*jargs, *[jnp.float32(x) for x in scal])
        out = out if isinstance(out, tuple) else (out,)
        jw = out[0]
        # the JAX ops return (weight, *states) in argument order
        for n, a in zip(states, out[1:]):
            jst[n] = a
    port = {"weight": tw.float().numpy(), **{n: t.numpy() for n, t in tst.items()}}
    ref = {"weight": np.asarray(jw, np.float32), **{n: np.asarray(a) for n, a in jst.items()}}
    return port, ref


@pytest.mark.parametrize("clip", CLIPS, ids=["no_clip_-1", "no_clip_inf", "clip", "clip_0"])
@pytest.mark.parametrize("name", [n for n in OPS if not n.startswith("mp_")])  # mp_: 16-bit
def test_op_matches_jax_fp32(name, clip):
    port, ref = _run(name, clip, "float32")
    for key in port:
        np.testing.assert_allclose(port[key], ref[key], err_msg=key, **FP32_TOL)


@pytest.mark.parametrize("clip", CLIPS, ids=["no_clip_-1", "no_clip_inf", "clip", "clip_0"])
@pytest.mark.parametrize("name", list(OPS))
def test_op_matches_jax_bf16_weights(name, clip):
    port, ref = _run(name, clip, "bfloat16")
    for key in port:
        tol = BF16_TOL if key == "weight" else FP32_TOL
        np.testing.assert_allclose(port[key], ref[key], err_msg=key, **tol)


def test_clip_sentinels():
    g = torch.tensor([-3.0, 0.5, 2.0])
    assert torch.equal(tops._gclip(g, -1.0), g)
    assert torch.equal(tops._gclip(g, float("inf")), g)
    assert torch.equal(tops._gclip(g, 1.0), torch.tensor([-1.0, 0.5, 1.0]))
    assert not tops._gclip(g, 0.0).any()


@pytest.mark.parametrize("clip_gradient", [None, 0.05])
def test_adam_multi_precision_matches_jax(clip_gradient):
    """The optimizer objects: create_state_multi_precision and
    update_multi_precision on a bf16 weight, three updates, lr and wd
    multipliers by index."""
    rng = np.random.RandomState(7)
    w = rng.randn(5, 12).astype(np.float32)
    grads = [(rng.randn(5, 12) * 0.1).astype(np.float32) for _ in range(3)]
    kw = dict(learning_rate=0.01, wd=1e-3, rescale_grad=0.5, multi_precision=True,
              clip_gradient=clip_gradient)
    topt = mx.optimizer.create("adam", **kw)
    jopt = mxj.optimizer.create("adam", **kw)
    for o in (topt, jopt):
        o.set_lr_mult({0: 0.5})
        o.set_wd_mult({0: 2.0})
    tw = torch.from_numpy(w).to(torch.bfloat16)
    jw = mxj.nd.array(w).astype("bfloat16")
    tstate = topt.create_state_multi_precision(0, tw)
    jstate = jopt.create_state_multi_precision(0, jw)
    assert tstate[1].dtype == torch.float32 and tstate[1] is not tw
    for g in grads:
        topt.update_multi_precision(0, tw, torch.from_numpy(g).to(torch.bfloat16), tstate)
        jopt.update_multi_precision(0, jw, mxj.nd.array(g).astype("bfloat16"), jstate)
    assert topt._index_update_count == jopt._index_update_count == {0: 3}
    (tm, tv), tw32 = tstate
    (jm, jv), jw32 = jstate
    for got, ref in ((tm, jm), (tv, jv), (tw32, jw32)):
        np.testing.assert_allclose(got.numpy(), ref.asnumpy(), **FP32_TOL)
    np.testing.assert_allclose(tw.float().numpy(), jw.asnumpy().astype(np.float32), **BF16_TOL)
    assert tw.dtype == torch.bfloat16


def test_sgd_momentum_and_updater_match_jax():
    rng = np.random.RandomState(8)
    w = rng.randn(4, 6).astype(np.float32)
    grads = [rng.randn(4, 6).astype(np.float32) for _ in range(3)]
    tupd = mx.optimizer.get_updater(mx.optimizer.create("sgd", learning_rate=0.1,
                                                        momentum=0.9))
    jupd = mxj.optimizer.get_updater(mxj.optimizer.create("sgd", learning_rate=0.1,
                                                          momentum=0.9))
    tw, jw = torch.from_numpy(w.copy()), mxj.nd.array(w)
    for g in grads:
        tupd(3, torch.from_numpy(g), tw)
        jupd(3, mxj.nd.array(g), jw)
    np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), **FP32_TOL)
    restored = mx.optimizer.get_updater(mx.optimizer.create("sgd"))
    restored.set_states(tupd.get_states())
    torch.testing.assert_close(restored.states[3], tupd.states[3])


def test_create_unknown_optimizer_says_so():
    with pytest.raises(ValueError, match="unknown optimizer"):
        mx.optimizer.create("nosuch")
