"""ResNet V1 as an ``mx.sym`` graph, for either package.

``resnet_v1_symbol(S, ...)`` builds, from the symbol module ``S`` it is
given (``incubator_mxnet_torch.symbol`` or the JAX package's), the graph of
the Gluon model zoo's ``ResNetV1`` forward with a ``SoftmaxOutput`` head:
the stem (a 7x7 stride-2 convolution, BatchNorm, ReLU and a 3x3 max pool,
or with ``thumbnail`` one 3x3 convolution), the stages of ``BottleneckV1``
(or ``BasicBlockV1``) blocks, global average pooling and the ``Dense``
classifier.  Every BatchNorm is ``fix_gamma=False`` with the Gluon layer's
``eps=1e-5`` and ``momentum=0.9``.

Every variable carries the Gluon parameter's name: the convolutions and
BatchNorms of a stage are numbered by one counter over the stage, as the
Gluon blocks create them in the stage's name scope
(``resnetv10_stage1_conv2d3_weight``, ``..._batchnorm3_running_mean``), and
the bottleneck's 1x1 body convolutions have a bias, as Gluon's ``Conv2D``
default gives them.  So ``{name: p.data()}`` of ``ResNetV1.collect_params()``
is this graph's ``arg_params`` and ``aux_params``.  The inputs are ``data``
``[B, 3, H, W]`` and ``softmax_label`` ``[B]``.

Imports neither package: tests and ``chip_smoke.py`` pass ``S`` in.
"""

RESNET50_LAYERS = (3, 4, 6, 3)
RESNET50_CHANNELS = (64, 256, 512, 1024, 2048)


def resnet_v1_symbol(S, layers=RESNET50_LAYERS, channels=RESNET50_CHANNELS, classes=1000,
                     thumbnail=False, bottleneck=True, prefix="resnetv10_"):
    """The graph; ``prefix`` is the Gluon net's prefix."""
    count = {}

    def name(scope, kind):
        i = count.get((scope, kind), 0)
        count[(scope, kind)] = i + 1
        return f"{prefix}{scope}{kind}{i}_"

    def conv(x, scope, n_out, kernel, stride, pad, bias):
        p = name(scope, "conv2d")
        kw = {"bias": S.var(p + "bias")} if bias else {"no_bias": True}
        return S.Convolution(x, S.var(p + "weight"), kernel=(kernel, kernel),
                             stride=(stride, stride), pad=(pad, pad), num_filter=n_out,
                             name=p + "fwd", **kw)

    def bn(x, scope):
        p = name(scope, "batchnorm")
        return S.BatchNorm(x, S.var(p + "gamma"), S.var(p + "beta"),
                           S.var(p + "running_mean"), S.var(p + "running_var"),
                           fix_gamma=False, eps=1e-5, momentum=0.9, name=p + "fwd")

    def relu(x):
        return S.Activation(x, act_type="relu")

    def block(x, scope, n_out, stride, downsample):
        if bottleneck:
            y = relu(bn(conv(x, scope, n_out // 4, 1, stride, 0, True), scope))
            y = relu(bn(conv(y, scope, n_out // 4, 3, 1, 1, False), scope))
            y = bn(conv(y, scope, n_out, 1, 1, 0, True), scope)
        else:
            y = relu(bn(conv(x, scope, n_out, 3, stride, 1, False), scope))
            y = bn(conv(y, scope, n_out, 3, 1, 1, False), scope)
        if downsample:
            x = bn(conv(x, scope, n_out, 1, stride, 0, False), scope)
        return relu(y + x)

    x = S.var("data")
    if thumbnail:
        x = conv(x, "", channels[0], 3, 1, 1, False)
    else:
        x = relu(bn(conv(x, "", channels[0], 7, 2, 3, False), ""))
        x = S.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")
    for i, n_blocks in enumerate(layers):
        scope = f"stage{i + 1}_"
        stride = 1 if i == 0 else 2
        x = block(x, scope, channels[i + 1], stride, channels[i + 1] != channels[i])
        for _ in range(n_blocks - 1):
            x = block(x, scope, channels[i + 1], 1, False)
    x = S.Pooling(x, kernel=(1, 1), global_pool=True, pool_type="avg")
    p = name("", "dense")
    x = S.FullyConnected(x, S.var(p + "weight"), S.var(p + "bias"), num_hidden=classes,
                         name=p + "fwd")
    return S.SoftmaxOutput(x, S.var("softmax_label"), name="softmax")
