"""AMP op lists (parity: [U:python/mxnet/contrib/amp/lists/symbol_fp16.py]).

A copy of the JAX package's ``amp/lists.py``: the same three tiers, read by
the cast hook of ``ops/registry.py``:
* TARGET_OPS  — run in the low-precision target dtype (the products and
  convolutions where the FLOPs are); float inputs are cast down.
* FP32_OPS    — numerically sensitive; float inputs are cast UP to fp32.
* WIDEST_OPS  — multi-input ops that must agree on a dtype; inputs are
  cast to the widest float dtype present.
Everything else passes through untouched.
"""

TARGET_OPS = {
    "FullyConnected", "fully_connected",
    "Convolution", "Deconvolution",
    "dot", "batch_dot", "linalg_gemm2",
    "fused_attention", "fused_qkv_attention", "fused_kv_attention",
    "RNN",
    # Embedding output feeds the transformer residual stream; emitting it
    # in the target dtype keeps that stream bf16 end to end (the norms
    # preserve the input dtype), with no cast copy per sublayer.
    "Embedding",
}

# softmax/log_softmax/softmin and the norms are NOT fp32-listed: the ops
# themselves compute exp/statistics in fp32 and return the input dtype
# (ops/nn.py), which is numerically equivalent to hook-casting without
# materializing an fp32 copy of the input.
FP32_OPS = {
    "SoftmaxOutput", "Softmax", "softmax_cross_entropy",
    "LinearRegressionOutput", "MAERegressionOutput", "LogisticRegressionOutput",
    "L2Normalization", "norm",
    "exp", "log", "log2", "log10", "log1p", "expm1",
    "sum", "mean", "prod", "nansum", "nanprod",
    "erf", "erfinv", "gamma", "gammaln",
    "smooth_l1", "MakeLoss",
    "power", "broadcast_power", "_power_scalar", "sqrt", "rsqrt", "square",
}

WIDEST_OPS = {
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "concat", "Concat", "stack", "add_n", "where",
}
