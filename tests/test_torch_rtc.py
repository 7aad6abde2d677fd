"""``mx.rtc`` of the PyTorch port: a user's CUDA source, scanned on the CPU,
compiled by nvcc and launched on the card.

The cases of ``tests/test_rtc.py`` that have a CUDA counterpart, written
for CUDA source (string source and dedent, exports and unknown names, the
output declarations, the refusal of Pallas BlockSpecs, compile-once), and
what only the CUDA module has: the parse of C parameter lists, argument
marshalling, and the refusals before any launch.  This machine has no card
and no nvcc, so the host half of a launch (``Kernel._marshal``) is tested
on CPU tensors; the ``cuda`` tests launch on the card, as ``chip_smoke.py``
does at the path's shapes.
"""
import ctypes
import subprocess

import numpy as np
import pytest
import torch

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import rtc
from incubator_mxnet_torch.ops import _cuda

SRC = r'''
#include <cuda_bf16.h>

extern "C" __global__ void scale_add(const float* __restrict__ x, const float* y,
                                     long long n, float* out) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = 2.0f * x[i] + y[i];
}

// one (8, 128) tile per block; a comment naming __global__ void fake(int)
extern "C" __global__ void saxpy_block(const float* x, const float* y, float* out) {
    long long base = (long long)blockIdx.x * 1024;
    for (int i = threadIdx.x; i < 1024; i += blockDim.x)
        out[base + i] = 0.5f * x[base + i] + y[base + i];
}

extern "C" {
__global__ void __launch_bounds__(256) minmax(const float* x, int n, float* lo, float* hi) {}
__global__ void cast_bf16(const float* x, unsigned int n, float s, __nv_bfloat16* y) {}
}

__global__ void mangled(float* out) { *out = 1.0f; }
template <typename T> __global__ void templated(const T* x, T* y) {}
#define DEFINE_FILL(name) extern "C" __global__ void name(int v, int* out) { *out = v; }
DEFINE_FILL(fill)
'''


def _cpu(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(*shape).astype(np.float32))


def test_string_source_is_scanned_for_extern_c_kernels():
    mod = mx.rtc.CudaModule(SRC)
    assert sorted(mod._kernels) == ["cast_bf16", "minmax", "saxpy_block", "scale_add"]
    assert mod._mangled == {"mangled", "templated"}
    k = mod.get_kernel("scale_add", out_shapes=[(16, 128)])
    assert [p.pointer for p in k.params] == [True, True, False, True]
    assert [p.dtype for p in k.params if p.pointer] == [torch.float32] * 3
    assert k.params[2].ctype is ctypes.c_longlong


def test_indented_source_dedents():
    src = '''
        extern "C" __global__ void twice(const float* x, long long n, float* out) {
            out[0] = 2.0f * x[0];
        }
    '''
    mod = mx.rtc.CudaModule(src)
    assert mod.source.startswith('\nextern "C"')
    assert mod.get_kernel("twice", out_shapes=[(4, 8)]).name == "twice"


def test_unknown_kernel_and_missing_export():
    mod = mx.rtc.CudaModule(SRC)
    with pytest.raises(ValueError, match="not in module"):
        mod.get_kernel("nope", out_shapes=[(2, 2)])
    with pytest.raises(ValueError, match="exports not found"):
        mx.rtc.CudaModule(SRC, exports=["not_there"])
    only = mx.rtc.CudaModule(SRC, exports=["scale_add"])
    with pytest.raises(ValueError, match="not in module"):
        only.get_kernel("saxpy_block", out_shapes=[(2, 2)])
    with pytest.raises(ValueError, match='not extern "C"'):
        mod.get_kernel("mangled", out_shapes=[(1,)])


def test_callable_source_has_no_cuda_counterpart():
    def minmax(x_ref, lo_ref, hi_ref):
        lo_ref[...] = x_ref[...].min(keepdims=True)

    with pytest.raises(TypeError, match="no CUDA counterpart"):
        mx.rtc.CudaModule(minmax)


def test_out_dtypes_and_out_shapes_are_validated():
    mod = mx.rtc.CudaModule(SRC)
    with pytest.raises(ValueError, match="out_dtypes has 1 entries for 2 out_shapes"):
        mod.get_kernel("minmax", out_shapes=[(1, 1), (1, 1)], out_dtypes=["float32"])
    with pytest.raises(ValueError, match="does not take the declared torch.float16"):
        mod.get_kernel("scale_add", out_shapes=[(2, 2)], out_dtypes="float16")
    with pytest.raises(ValueError, match="3 parameters for 4 outputs"):
        mod.get_kernel("saxpy_block", out_shapes=[(1,)] * 4)
    k = mod.get_kernel("cast_bf16", out_shapes=(3, 5), out_dtypes=torch.bfloat16)
    assert k._out_shapes == ((3, 5),) and k._out_dtypes == (torch.bfloat16,)


@pytest.mark.parametrize("which", ["in_specs", "out_specs", "bare_out_spec"])
def test_block_specs_are_refused(which):
    mod = mx.rtc.CudaModule(SRC)
    spec = object()  # a Pallas BlockSpec has no meaning for a CUDA kernel
    kw = {"in_specs": dict(in_specs=[spec, spec]), "out_specs": dict(out_specs=[spec]),
          "bare_out_spec": dict(out_specs=spec)}[which]
    with pytest.raises(ValueError, match="tiles by blockIdx"):
        mod.get_kernel("saxpy_block", out_shapes=[(16, 128)], grid=(2,), **kw)


@pytest.mark.parametrize("text,want", [
    ("const float* __restrict__ x", (True, torch.float32, ctypes.c_void_p)),
    ("__nv_bfloat16 *y", (True, torch.bfloat16, ctypes.c_void_p)),
    ("const __half* h", (True, torch.float16, ctypes.c_void_p)),
    ("int64_t* idx", (True, torch.int64, ctypes.c_void_p)),
    ("long long n", (False, None, ctypes.c_longlong)),
    ("unsigned int n", (False, None, ctypes.c_uint)),
    ("float alpha", (False, None, ctypes.c_float)),
    ("double", (False, None, ctypes.c_double)),
    ("size_t bytes", (False, None, ctypes.c_size_t)),
])
def test_parameter_parse(text, want):
    (p,) = rtc.parse_signature(text)
    assert (p.pointer, p.dtype, p.ctype) == want


@pytest.mark.parametrize("text", ["float** x", "Params p", "T* x", "const std::vector<int>& v"])
def test_parameters_the_launcher_cannot_pass(text):
    assert rtc.parse_signature(f"int n, {text}") is None


def test_signature_overrides_and_stands_in_for_the_scan():
    mod = mx.rtc.CudaModule(SRC)
    assert "fill" not in mod._kernels  # defined by a macro
    with pytest.raises(ValueError, match="not in module"):
        mod.get_kernel("fill", out_shapes=[(1,)], out_dtypes="int32")
    k = mod.get_kernel("fill", out_shapes=[(1,)], out_dtypes="int32", signature="int v, int* out")
    assert [p.text for p in k.params] == ["int v", "int* out"]
    k = mod.get_kernel("scale_add", out_shapes=[(4,)], signature="const float* x, float* out")
    assert len(k.params) == 2
    with pytest.raises(ValueError, match="cannot parse signature"):
        mod.get_kernel("fill", out_shapes=[(1,)], signature="T v, int* out")


def test_marshalling_puts_inputs_then_allocated_outputs():
    mod = mx.rtc.CudaModule(SRC)
    k = mod.get_kernel("minmax", out_shapes=[(1, 1), (1, 1)], grid=(1,), block=(256,))
    x = _cpu(32, 32)
    device, outs, pairs = k._marshal([x, x.numel()])
    assert device == torch.device("cpu")
    assert [tuple(o.shape) for o in outs] == [(1, 1), (1, 1)]
    assert all(o.dtype == torch.float32 and o.device == x.device for o in outs)
    assert pairs == [(ctypes.c_void_p, x.data_ptr()), (ctypes.c_int, 1024),
                     (ctypes.c_void_p, outs[0].data_ptr()), (ctypes.c_void_p, outs[1].data_ptr())]
    k = mod.get_kernel("cast_bf16", out_shapes=[(6,)], out_dtypes="bfloat16")
    device, (y,), pairs = k._marshal([_cpu(6), 6, 0.5])
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (6,)
    assert [ct for ct, _ in pairs] == [ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
                                      ctypes.c_void_p]


@pytest.mark.parametrize("args,match", [
    (lambda x: [x.double(), x, 4], "takes torch.float32, got torch.float64"),
    (lambda x: [x.t(), x, 4], "contiguous"),
    (lambda x: [x, x], "takes 3 arguments before its 1 outputs, got 2"),
    (lambda x: [x, x, 4.5], "takes a Python int"),
    (lambda x: [x, x, 2 ** 70], "does not fit"),
    (lambda x: [x, 3.0, 4], "takes a tensor"),
])
def test_mismatches_raise_before_any_launch(args, match, monkeypatch):
    monkeypatch.setattr(rtc._driver, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(_cuda, "build_cubin", lambda *a: pytest.fail("compiled"))
    k = mx.rtc.CudaModule(SRC).get_kernel("scale_add", out_shapes=[(4, 4)], grid=(1,),
                                          block=(32,))
    with pytest.raises(ValueError, match=match):
        k.launch(args(_cpu(4, 4)))
    assert k.launches == 0


def test_ctx_other_than_the_inputs_device_raises():
    k = mx.rtc.CudaModule(SRC).get_kernel("scale_add", out_shapes=[(4,)], grid=1, block=32)
    x = _cpu(4)
    with pytest.raises(ValueError, match="is not the inputs' device"):
        k._marshal([x, x, 4], ctx=mx.gpu(0))
    assert k._marshal([x, x, 4], ctx=mx.cpu())[0] == torch.device("cpu")


def test_grid_and_block_are_required():
    k = mx.rtc.CudaModule(SRC).get_kernel("scale_add", out_shapes=[(4,)])
    x = _cpu(4)
    with pytest.raises(ValueError, match="grid and block"):
        k.launch([x, x, 4])
    with pytest.raises(ValueError, match="positive ints"):
        k.launch([x, x, 4], grid_dims=(0,), block_dims=(32,))


def test_cpu_tensor_raises_with_no_fallback(monkeypatch):
    monkeypatch.setattr(_cuda, "build_cubin", lambda *a: pytest.fail("compiled"))
    k = mx.rtc.CudaModule(SRC).get_kernel("scale_add", out_shapes=[(4,)], grid=1, block=32)
    x = _cpu(4)
    with pytest.raises(RuntimeError, match="CUDA tensors only.*no plain version"):
        k.launch([x, x, 4])
    assert k.launches == 0


def test_missing_nvcc_says_so(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "RTC_DIR", tmp_path / "rtc")
    monkeypatch.setattr(_cuda.shutil, "which", lambda _: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build_cubin(SRC)
    assert not (tmp_path / "rtc").exists()


def test_cubin_is_compiled_once_per_source_flags_and_compiler(monkeypatch, tmp_path):
    """A stand-in nvcc: one compile per distinct (source, options); the same
    again is found on disk under build/kernels/rtc/."""
    compiles = []

    def fake_run(cmd, **kw):
        if cmd[1] == "--version":
            return subprocess.CompletedProcess(cmd, 0, "Cuda compilation tools, 12.x\n", "")
        assert "-cubin" in cmd and "arch=compute_90a,code=sm_90a" in cmd
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"cubin")
        compiles.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "ptxas info : Used 8 registers\n", "")

    monkeypatch.setattr(_cuda, "RTC_DIR", tmp_path / "rtc")
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(_cuda, "_nvcc_versions", {})
    monkeypatch.setattr(_cuda.subprocess, "run", fake_run)
    path, log, seconds = _cuda.build_cubin(SRC)
    again = _cuda.build_cubin(SRC)
    assert again == (path, log, 0.0) and len(compiles) == 1
    assert path.parent == tmp_path / "rtc" and path.suffix == ".cubin"
    assert "Used 8 registers" in log and seconds >= 0
    other, _, _ = _cuda.build_cubin(SRC, options=("-lineinfo",))
    assert other != path and len(compiles) == 2 and "-lineinfo" in compiles[1]
    assert sorted(p.suffix for p in (tmp_path / "rtc").iterdir()) == [".cubin", ".cubin",
                                                                       ".log", ".log"]


def test_a_failed_compile_raises_and_leaves_no_cubin(monkeypatch, tmp_path):
    def fake_run(cmd, **kw):
        if cmd[1] == "--version":
            return subprocess.CompletedProcess(cmd, 0, "12.x", "")
        return subprocess.CompletedProcess(cmd, 1, "", "error: identifier undefined")

    monkeypatch.setattr(_cuda, "RTC_DIR", tmp_path / "rtc")
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(_cuda, "_nvcc_versions", {})
    monkeypatch.setattr(_cuda.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="identifier undefined"):
        _cuda.build_cubin("garbage")
    assert list((tmp_path / "rtc").iterdir()) == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_launch_on_card_and_function_cache(cuda_device):
    mod = mx.rtc.CudaModule(SRC)
    x = torch.rand(16, 128, device=cuda_device)
    y = torch.rand(16, 128, device=cuda_device)
    k = mod.get_kernel("scale_add", out_shapes=[(16, 128)], grid=(8,), block=(256,))
    z = k.launch([x, y, x.numel()])
    k.launch([x, y, x.numel()])
    torch.cuda.synchronize()
    assert torch.equal(z, 2 * x + y) and k.launches == 2
    assert list(mod._functions) == [("scale_add", 0)]  # compiled and loaded once
    b = mod.get_kernel("saxpy_block", out_shapes=[(32, 128)], grid=(4,), block=(128,))
    xb, yb = torch.rand(32, 128, device=cuda_device), torch.rand(32, 128, device=cuda_device)
    assert torch.equal(b.launch([xb, yb]), 0.5 * xb + yb)


@pytest.mark.cuda
def test_missing_extern_c_name_raises_on_card(cuda_device):
    mod = mx.rtc.CudaModule(SRC)
    k = mod.get_kernel("mangled", out_shapes=[(1,)], signature="float* out", grid=1, block=1)
    with pytest.raises(RuntimeError, match='extern "C"'):
        k.launch([], ctx=mx.gpu(0))
    assert k.launches == 0
