"""The port's data-parallel tier across processes: cohorts of 2 ranks over
``torch.distributed``'s gloo backend on the CPU, launched through
``tools/launch_local.py`` (the ``DMLC_*`` contract) as ``tests/test_dist.py``
launches the JAX package's workers, each cohort with its own timeout.

The worker (``tests/torch_dist_worker.py``) asserts in each rank:
``kv``, the ``dist_sync`` store's exact values (``tests/dist_worker.py``'s
assertions; compression raises, naming its ROADMAP item); ``overlap``,
``Trainer.backward``'s overlapped buckets bit-equal to a plain backward and
``allreduce_grads``; ``spmd``, ``SPMDTrainer`` at 2 ranks on half-batches
against 1 rank on the whole batch, with the ranks bitwise equal.  Here the
2-rank parameters are also held to the JAX ``SPMDTrainer`` on its 8-device
mesh at the same global batch, from the same starting parameters.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu import profiler as jprofiler
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jvision

import torch_dist_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
# 2 ranks against 1 rank, and against the JAX trainer on 8 devices: fp32,
# the same arithmetic summed in another order.  The MLP over 3
# SGD-momentum steps: 1e-5 (test_torch_parallel.py's TOL); the small ResNet
# over one step (chaotic in training; the BatchNorm statistics of the
# global batch summed over the ranks): 1e-4 (its RESNET_TOL).
TOL = {"mlp": 1e-5, "resnet": 1e-4}
STEPS = {"mlp": 3, "resnet": 1}


def _cohort(args, n=2, env=None):
    """Run ``n`` ranks of the worker; every rank must report success."""
    full = dict(os.environ)
    full.pop("XLA_FLAGS", None)  # the workers import no JAX
    full["JAX_PLATFORMS"] = "cpu"
    full.update(env or {})
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "launch_local.py"), "-n", str(n),
         sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"), *args],
        env=full, capture_output=True, text=True, timeout=TIMEOUT_S)
    sys.stdout.write(proc.stdout[-4000:])
    sys.stderr.write(proc.stderr[-4000:])
    assert proc.returncode == 0, f"the cohort failed (rc={proc.returncode})"
    assert proc.stdout.count(f"{args[0]} assertions passed") == n
    return proc.stdout


def test_dist_sync_kvstore_two_workers():
    _cohort(["kv"])


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_trainer_backward_overlap_two_workers(model):
    out = _cohort(["overlap", "--model", model], env={"MXNET_KVSTORE_BUCKET_BYTES": "2048"})
    assert "overlap bit-equal over 2 steps" in out


def _jax_net(model):
    mxj.random.seed(11)
    if model == "mlp":
        net = mxj.gluon.nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(mxj.gluon.nn.Dense(32, activation="relu"),
                    mxj.gluon.nn.Dense(16, activation="relu"), mxj.gluon.nn.Dense(4))
        net.initialize()
        net(mxj.nd.zeros((2, 12)))
    else:
        net = jvision.ResNetV1(jvision.BottleneckV1, thumbnail=True, prefix="res_",
                               **W.SMALL_RESNET)
        net.initialize()
        net(mxj.nd.zeros((1, 3, 32, 32)))
    return net


def _params(net):
    return {k: np.array(p.data().asnumpy()) for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_spmd_two_ranks_match_one_rank_and_jax(model, tmp_path):
    """The cohort checks 2 ranks against 1 (and the ranks bitwise); here its
    parameters and losses against the JAX SPMDTrainer on 8 devices."""
    jprofiler.disarm_compile_guard()
    net = _jax_net(model)
    start = _params(net)
    np.savez(tmp_path / "start.npz", **start)
    import torch

    data, label = W.batch(model, torch.device("cpu"), 0, W.GLOBAL_B[model])
    opt = ({"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4} if model == "resnet"
           else {"learning_rate": 0.1, "momentum": 0.9})
    tr = jpar.SPMDTrainer(net, mxj.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", opt,
                          mesh=jpar.make_mesh())
    x = [mxj.nd.array(d.numpy()) for d in data]
    y = mxj.nd.array(label.numpy(), dtype=label.numpy().dtype.name)
    losses = [float(tr.step(x, y).asnumpy()) for _ in range(STEPS[model])]
    tr.sync_to_block()
    want = _params(net)
    jprofiler.disarm_compile_guard()
    _cohort(["spmd", "--model", model, "--params", str(tmp_path / "start.npz"),
             "--out", str(tmp_path), "--steps", str(STEPS[model]), "--tol", str(TOL[model])])
    got = dict(np.load(tmp_path / f"spmd_{model}.npz"))
    np.testing.assert_allclose(got.pop("__losses__"), losses, rtol=TOL[model], atol=TOL[model])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL[model], atol=TOL[model], err_msg=k)
