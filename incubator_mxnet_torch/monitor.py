"""``mx.monitor`` — training-time tensor monitor.

Counterpart of the JAX package's ``monitor.py`` (parity:
[U:python/mxnet/monitor.py]: ``Monitor`` with interval/stat_func/pattern,
``tic``/``toc``/``toc_print``, ``install``).  As there, the observable
boundary is the block: ``install(block)`` registers a forward hook (the
port's MXNet-semantics ``Block.register_forward_hook``) on the block and
every nested child whose name matches ``pattern``, and records
``stat_func`` of each output, plus parameters and gradients when
``monitor_all`` is set.  Each recorded value is copied to the host.
"""
from __future__ import annotations

import re

import numpy as _np
import torch

__all__ = ["Monitor"]


def _default_stat(arr):
    return float(_np.abs(arr).mean())


def _host(x):
    """A numpy copy of an NDArray, tensor or array-like."""
    x = getattr(x, "_data", x)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return _np.asarray(x)


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        self.interval = int(interval)
        self.stat_func = stat_func or _default_stat
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all
        self.step = 0
        self.activated = False
        self.queue = []
        self._installed = []  # hook handles

    # -- installation ----------------------------------------------------
    def install(self, block):
        """Attach to a Gluon block tree (analog of passing the monitor to
        ``Module.bind``/``executor.set_monitor_callback``).  Blocks are
        matched and labeled by their NAME (``dense0`` style), and the root
        block itself is hooked too."""
        from .gluon.block import Block

        def make_hook(name):
            def hook(blk, inputs, output):
                if not self.activated:
                    return
                outs = output if isinstance(output, (list, tuple)) else [output]
                for i, o in enumerate(outs):
                    suffix = f"_output{i}" if len(outs) > 1 else "_output"
                    self.queue.append((self.step, name + suffix, self.stat_func(_host(o))))

            return hook

        def attach(blk):
            if self.re_pattern.match(blk.name):
                self._installed.append(blk.register_forward_hook(make_hook(blk.name)))

        def walk(blk):
            for _, child in blk._child_blocks():
                attach(child)
                walk(child)

        if isinstance(block, Block):
            attach(block)
            walk(block)
        self._block = block
        return self

    def uninstall(self):
        for handle in self._installed:
            handle.detach()
        self._installed = []
        self._block = None

    # -- reference control surface ---------------------------------------
    def tic(self):
        """Start collecting for this step if the interval has elapsed."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting; returns [(step, name, stat_string)]."""
        if not self.activated:
            return []
        self.activated = False
        if self.monitor_all and getattr(self, "_block", None) is not None:
            for name, p in self._block.collect_params().items():
                if not self.re_pattern.match(name) or p._data is None:
                    continue
                self.queue.append((self.step, name, self.stat_func(_host(p.data()))))
                g = p.grad() if p.grad_req != "null" else None
                if g is not None:
                    self.queue.append((self.step, name + "_grad", self.stat_func(_host(g))))
        res = [(s, n, str(v)) for s, n, v in
               (sorted(self.queue, key=lambda q: q[1]) if self.sort else self.queue)]
        self.queue = []
        return res

    def toc_print(self):
        for step, name, val in self.toc():
            print(f"Batch: {step:7d} {name:30s} {val}")
