"""Package rules of the PyTorch port, checked on the CPU.

The port imports torch and numpy and nothing of JAX or of the JAX package;
its entry points run on the card unless the caller asks for the CPU, and
on a machine without a card they raise rather than fall back.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import initializer
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.ops import _cuda

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "incubator_mxnet_torch"


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=env)


def test_port_builds_tiny_bert_without_jax():
    """Build, run and train one step, with no JAX module ever imported."""
    code = """
import sys
import torch
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.gluon.model_zoo import bert
from incubator_mxnet_torch.ops.nn import streaming_softmax_ce
net = bert.BERTForPretrain(bert.BERTModel(vocab_size=128, units=32, hidden_size=64,
    num_layers=2, num_heads=2, max_length=64, dropout=0.1), vocab_size=128)
net.initialize(ctx=mx.cpu())
trainer = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
with mx.autograd.record():
    mlm, nsp = net(torch.zeros(2, 8, dtype=torch.int32), None, torch.zeros(2, 3, dtype=torch.int32))
    loss = streaming_softmax_ce(mlm, torch.ones(2, 3, dtype=torch.int32)).mean(-1)
mx.autograd.backward(loss)
trainer.step(2)
assert tuple(mlm.shape) == (2, 3, 128) and tuple(nsp.shape) == (2, 2)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "incubator_mxnet_tpu")))
assert not bad, bad
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_sources_name_neither_jax_nor_the_jax_package():
    """Module names only: prose may say "the JAX package"."""
    pattern = re.compile(r"incubator_mxnet_tpu|\bjax\b")
    sources = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    names = {str(p.relative_to(PKG)) for p in sources}
    assert {"ops/csrc/flash_fwd.cu", "ops/csrc/flash_bwd.cu", "ops/optimizer_ops.py",
            "optimizer/optimizer.py", "gluon/trainer.py", "gluon/loss.py",
            "autograd.py"} <= names
    offenders = [f"{p.relative_to(ROOT)}:{i}" for p in sources
                 for i, line in enumerate(p.read_text().splitlines(), 1) if pattern.search(line)]
    assert not offenders, offenders


def test_attention_imports_without_nvcc():
    """No toolkit on PATH: the module imports, CPU attention runs, and no
    kernel build is attempted."""
    code = """
import torch
from incubator_mxnet_torch.ops import attention, _cuda
q = torch.randn(1, 2, 8, 16)
attention.flash_attention(q, q, q)
assert _cuda._libs == {} and attention.flash_fwd.launches == 0
print("OK")
"""
    env = dict(os.environ, PATH="/usr/bin:/bin")
    proc = _run(code, env=env)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_build_without_nvcc_says_so(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_cuda.shutil, "which", lambda _: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build("flash_fwd")
    assert not (tmp_path / "kernels").exists()


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


def test_default_context_is_the_card():
    assert mx.current_context() == mx.gpu(0)
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
    assert mx.cpu().device == torch.device("cpu")


def test_initialize_without_ctx_raises_without_a_card(no_card):
    net = nn.Dense(4, in_units=3)
    with pytest.raises(mx.MXNetError, match="CUDA device"):
        net.initialize()
    deferred = nn.Dense(4)  # in_units unknown: the device is checked all the same
    with pytest.raises(mx.MXNetError, match="ctx=mx.cpu"):
        deferred.initialize()
    assert mx.num_gpus() == 0


def test_seed_makes_initialization_reproducible():
    def weights(seed):
        mx.random.seed(seed)
        net = nn.Dense(8, in_units=5)
        net.initialize(ctx=mx.cpu())
        return net.weight.data().detach().clone()

    a, b, c = weights(3), weights(3), weights(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.abs().max().item() <= 0.07  # Uniform(0.07), the default


def test_generator_is_per_device():
    mx.random.seed(11)
    g = mx.random.get_generator(mx.cpu())
    assert g is mx.random.get_generator("cpu")
    assert g.initial_seed() == 11


@pytest.mark.parametrize("name,check", [
    ("zeros", lambda w: not w.any()),
    ("ones", lambda w: bool((w == 1).all())),
    ("normal", lambda w: 0 < w.std().item() < 0.02),
    ("xavier", lambda w: w.abs().max().item() <= (3.0 / ((16 + 32) / 2)) ** 0.5),
])
def test_initializers(name, check):
    mx.random.seed(0)
    w = torch.empty(32, 16)
    initializer.create(name)(initializer.InitDesc("dense0_weight"), w)
    assert check(w)


def test_initializer_routes_by_name_suffix():
    init = initializer.Uniform()
    for suffix, want in (("bias", 0.0), ("beta", 0.0), ("gamma", 1.0)):
        t = torch.full((4,), 5.0)
        init(initializer.InitDesc(f"ln0_{suffix}"), t)
        assert torch.equal(t, torch.full((4,), want))


def test_parameter_set_data_and_deferred_shape():
    p = mx.gluon.Parameter("w", shape=(2, 0), allow_deferred_init=True)
    p.initialize(ctx=mx.cpu())
    with pytest.raises(mx.DeferredInitializationError):
        p.data()
    p.set_data(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert p.shape == (2, 3) and p.data().tolist() == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError, match="shape mismatch"):
        p.set_data(np.zeros((3, 2), np.float32))


def test_block_names_and_hybridize_is_a_flag():
    net = nn.Dense(3, in_units=2, prefix="fc_")
    assert net.prefix == "fc_" and sorted(net.collect_params()) == ["fc_bias", "fc_weight"]
    assert net.hybridize() is net and net._active
    assert isinstance(net, torch.nn.Module)
