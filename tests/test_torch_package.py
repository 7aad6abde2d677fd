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


def test_port_trains_small_resnet_under_amp_without_jax():
    """Build a small ResNetV1, train one SGD-momentum step under AMP bf16,
    with no JAX module ever imported."""
    code = """
import sys
import torch
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.gluon.model_zoo import vision
from incubator_mxnet_torch.ops.nn import streaming_softmax_ce
mx.amp.init("bfloat16")
net = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128], classes=10,
                      thumbnail=True)
net.initialize(ctx=mx.cpu())
trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
with mx.autograd.record():
    logits = net(torch.rand(2, 3, 32, 32))
    loss = streaming_softmax_ce(logits, torch.tensor([1, 7]))
mx.autograd.backward(loss)
trainer.step(2)
assert logits.dtype == torch.bfloat16 and tuple(logits.shape) == (2, 10)
assert net.features[0].weight.data().dtype == torch.float32
assert bool(torch.isfinite(loss).all())
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "incubator_mxnet_tpu")))
assert not bad, bad
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_nd_surface_saves_and_loads_without_jax(tmp_path):
    """``mx.nd``: NDArrays, an op, a save and a load in both containers
    (bf16 included), with no JAX module ever imported."""
    code = f"""
import sys
import numpy as np
import incubator_mxnet_torch as mx
with mx.cpu():
    a = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    b = mx.nd.relu(a - 2).astype("bfloat16")
    for ext in ("params", "npz"):
        f = {str(tmp_path)!r} + "/x." + ext
        mx.nd.save(f, {{"a": a, "b": b}})
        got = mx.nd.load(f)
        assert sorted(got) == ["a", "b"] and np.array_equal(got["a"].asnumpy(), a.asnumpy())
        assert np.array_equal(got["b"].asnumpy(), b.asnumpy())
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "incubator_mxnet_tpu")))
assert not bad, bad
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_port_serves_a_tiny_bert_symbol_without_jax(tmp_path):
    """``mx.sym``, ``mx.predictor`` and ``mx.serving``: a tiny BERT symbol
    saved, loaded and served on the CPU in both tiers, with no JAX module
    ever imported."""
    code = f"""
import sys
sys.path.insert(0, "tests")
import numpy as np
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.predictor import Predictor
from incubator_mxnet_torch.serving import InferenceServer
from sym_bert import bert_symbol
sym = bert_symbol(mx.sym, num_layers=1, units=32, hidden_size=64, num_heads=2, vocab_size=50,
                  seq_len=8, num_masked=2, max_length=16)
spec = {{"token_ids": (8,), "token_types": (8,), "masked_positions": (2,)}}
shapes, _, _ = sym.infer_shape(**{{k: (1,) + v for k, v in spec.items()}})
rng = np.random.RandomState(0)
params = {{"arg:" + n: mx.nd.array(rng.randn(*s).astype(np.float32) * 0.1, ctx=mx.cpu())
          for n, s in zip(sym.list_arguments(), shapes) if n not in spec}}
sym.save({str(tmp_path)!r} + "/bert-symbol.json")
mx.nd.save({str(tmp_path)!r} + "/bert-0000.params", params)
req = {{"token_ids": rng.randint(0, 50, 8), "token_types": np.zeros(8),
       "masked_positions": np.array([1, 5])}}
outs = {{}}
for amp in (None, "bfloat16"):
    with InferenceServer({str(tmp_path)!r} + "/bert-symbol.json",
                         {str(tmp_path)!r} + "/bert-0000.params", spec,
                         input_dtypes={{k: "int32" for k in spec}}, max_batch_size=2,
                         max_queue_ms=2.0, amp_dtype=amp, dev_type="cpu", name=str(amp)) as srv:
        outs[amp] = srv.infer(req, timeout=30.0)
        assert srv.stats()["bucket_miss_after_warmup"] == 0
pred = Predictor({str(tmp_path)!r} + "/bert-symbol.json", {str(tmp_path)!r} + "/bert-0000.params",
                 {{k: (1,) + v for k, v in spec.items()}}, dev_type="cpu")
want = [pred.predict(**{{k: np.asarray(v)[None] for k, v in req.items()}})[0]]
assert np.array_equal(outs[None][0], want[0])
assert [o.shape for o in outs["bfloat16"]] == [(2, 50), (2,)]
assert np.abs(outs["bfloat16"][0] - outs[None][0]).max() < 0.05
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "incubator_mxnet_tpu")))
assert not bad, bad
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_port_generates_with_a_tiny_transformer_without_jax():
    """``gluon.model_zoo.transformer`` and ``mx.serving.GenerationServer``:
    a tiny seq2seq Transformer decoded greedily and served on the CPU, with
    no JAX module ever imported."""
    code = """
import sys
import numpy as np
import torch
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.gluon.model_zoo.transformer import Transformer, greedy_search
mx.random.seed(0)
net = Transformer(17, units=16, hidden_size=32, num_heads=2, num_encoder_layers=1,
                  num_decoder_layers=1, dropout=0.0, max_length=32)
net.initialize(ctx=mx.cpu())
net(torch.ones((1, 4), dtype=torch.int32), torch.ones((1, 1), dtype=torch.int32))
prompt = np.array([3, 5, 7, 9], np.int32)
toks, lens = greedy_search(net, torch.from_numpy(prompt[None]), 1, 2, max_length=7)
with mx.serving.GenerationServer(net, bos=1, eos=2, max_prompt_length=8, max_new_tokens=8,
                                 slots_per_bucket=2, name="pkg") as srv:
    got = srv.submit(prompt, max_new_tokens=6).result(timeout=30.0)
assert np.array_equal(got, toks[0, 1:1 + len(got)]), (got, toks)
assert isinstance(srv.stats()["pools"], dict) and mx.predictor.StatefulExecutor
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "incubator_mxnet_tpu")))
assert not bad, bad
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_input_pipeline_runs_without_jax(tmp_path):
    """``mx.recordio`` -> ``ImageRecordIter`` (the native decode pool) ->
    ``DataPipeline``, and a ``DataLoader`` with transforms, in a fresh
    process on the CPU, with no JAX module ever imported."""
    code = f"""
import sys
import numpy as np
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.gluon.data import ArrayDataset, DataLoader
from incubator_mxnet_torch.gluon.data.vision import transforms as T
rec = {str(tmp_path / "t.rec")!r}
w = mx.recordio.MXRecordIO(rec, "w")
for i in range(6):
    img = np.random.RandomState(i).randint(0, 255, (20, 24, 3)).astype(np.uint8)
    w.write(mx.recordio.pack_img(mx.recordio.IRHeader(0, float(i), i, 0), img))
w.close()
it = mx.io.ImageRecordIter(rec, (3, 16, 16), 4, shuffle=True, rand_crop=True)
with mx.io.DataPipeline(it, device=mx.cpu(), num_workers=2) as pipe:
    window = pipe.stage_window(2)
assert it.native and tuple(window.data[0].shape) == (2, 4, 3, 16, 16)
ds = ArrayDataset(np.ones((4, 8, 8, 3), np.uint8), np.arange(4)).transform_first(T.ToTensor())
batches = list(DataLoader(ds, batch_size=2, num_workers=2, thread_pool=True))
assert len(batches) == 2 and tuple(batches[0][0].shape) == (2, 3, 8, 8)
img = mx.image.imresize(mx.nd.array(np.zeros((8, 8, 3)), ctx=mx.cpu(), dtype="uint8"), 4, 4)
assert img.shape == (4, 4, 3)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "incubator_mxnet_tpu")))
assert not bad, bad
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_sources_name_neither_jax_nor_the_jax_package():
    """Module names only: prose may say "the JAX package"."""
    pattern = re.compile(r"incubator_mxnet_tpu|\bjax\b")
    sources = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    names = {str(p.relative_to(PKG)) for p in sources}
    assert {"ops/csrc/flash_fwd.cu", "ops/csrc/flash_bwd.cu", "ops/csrc/bn.cu", "ops/bn.py",
            "ops/optimizer_ops.py", "optimizer/optimizer.py", "gluon/trainer.py",
            "gluon/loss.py", "autograd.py", "amp/amp.py", "amp/lists.py",
            "gluon/model_zoo/vision/resnet.py", "rtc.py", "operator.py",
            "ops/_driver.py", "ops/random_ops.py", "ndarray/ndarray.py",
            "ndarray/__init__.py", "ndarray/utils.py", "random.py", "symbol/symbol.py",
            "symbol/infer.py", "executor.py", "predictor.py", "profiler.py",
            "serving/server.py", "serving/bucketing.py", "attribute.py", "name.py",
            "io/io.py", "io/pipeline.py", "io/record_iter.py", "io/csrc/mxnet_io.cpp",
            "recordio.py", "gluon/data/dataloader.py", "image/image.py"} <= names
    offenders = [f"{p.relative_to(ROOT)}:{i}" for p in sources
                 for i, line in enumerate(p.read_text().splitlines(), 1) if pattern.search(line)]
    assert not offenders, offenders


def test_user_kernel_modules_are_exported_and_import_no_driver():
    """``mx.rtc`` and ``mx.operator`` come with the package; ``nd.Custom``
    resolves to the custom-op entry; importing binds no CUDA library."""
    from incubator_mxnet_torch.ops import _driver

    assert mx.rtc.CudaModule and mx.operator.CustomOp
    assert {"rtc", "operator"} <= set(mx.__all__)
    assert mx.nd.Custom is mx.operator.nd_custom
    assert _driver._lib is None and _driver._contexts == {}


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


def test_kv_cache_without_a_device_raises_without_a_card(no_card):
    """The slot KV cache lives on the card unless the caller names another
    device."""
    with pytest.raises(mx.MXNetError, match="CUDA device"):
        mx.serving.SlotKVCache(1, 2, 8, 8, 2, 4)
    assert mx.serving.SlotKVCache(1, 2, 8, 8, 2, 4, device="cpu").state["self_k"].device.type \
        == "cpu"


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
