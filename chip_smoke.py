#!/usr/bin/env python3
"""Drive the PyTorch port (``incubator_mxnet_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny BERT and ResNet on the CPU plain path
    python3 chip_smoke.py --inference-turns ROOT_A ROOT_B  # two checkouts' BERT forward
    python3 chip_smoke.py --decode-load    # the decode pool's batch on an idle and a loaded card

Phases, each printing JSON lines; no phase's failure is caught:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: compile every kernel of the paths from ``ops/csrc`` and the
   user source ``RTC_SOURCE`` (one nvcc per source, all at once) with
   ``-Xptxas -v`` and report registers, shared memory and spills, and the
   user kernels' registers and local memory as the driver loaded them; a
   spill fails the phase;
3. kernel_vs_plain, kernel_vs_plain_bwd, kernel_vs_plain_bn,
   kernel_vs_plain_rtc, kernel_vs_plain_multi_tensor: each kernel against
   its plain PyTorch version on the card, at the main paths' shapes and the
   edge cases (for the attention kernels also their persistent schedules'
   and the operand domain the wrappers take: scales, expanded k/v, a
   sequence of stride 0, padded head dims, head dims 160-256 through the
   column-slab launches, head dims 300-1024 through flash_wide.cu: its
   16-bit forward, dq and dk/dv passes on TMA and wgmma, streamed above
   512, fp32 in split TF32 on the tensor cores; and every fp32 backward,
   at every head dim, through flash_wide.cu's delta launch and split-TF32
   dq and dk/dv kernels, with the narrow cases' edges and one key; the
   generation path's forward shapes in bf16 and fp32: one query row against
   1-129 keys cut as strided views from a cache, a prefill's 64 rows
   against 40 keys, causal at 16 heads), each
   against a stated bound (and
   flash_fwd, flash_bwd, the flash_wide
   kernels and bn_stats against themselves: two runs must be
   bit-identical), and the refusals of the rtc launcher; the multi-tensor
   optimizer kernel in every elementwise variant and weight dtype over one
   group of mixed sizes, whole and in chunks of 3, bit-equal to the plain
   loop; LAMB's two launches in every weight dtype, whole and in chunks
   (bit-equal to each other), its moments bit-equal to the plain per-tensor
   LAMB and each weight within LAMB_STEP_REL of its step; the finite pass
   in every dtype with NaN, ±inf and an overflowing square, counts exact
   and sums within FINITE_SQ_REL; any miss exits non-zero after the phase;
4. slice: BERT-base (12 layers, 768 units, vocab 30522, bf16, random
   weights from a seed) answers inference requests through
   ``net(token_ids, token_types, masked_positions)``; the kernels' launch
   counts are read around exactly this run, and one small batch is held
   against the port's fp32 run of the same weights on the CPU;
5. train: BERT-base pretraining steps (bf16 parameters, fp32 Adam masters,
   dropout 0.1, the MLM loss of bench.py) through ``autograd.record``,
   ``autograd.backward`` and ``gluon.Trainer.step``; launch counts around
   exactly one step, finite and falling losses; then the card's bf16
   gradients against the port's fp32 gradients on the CPU, per parameter;
   the step's optimizer update is exactly one fused group update of all 159
   parameters, one mp_adam launch of the multi-tensor kernel, none left to
   the per-tensor loop;
   rtc_train: the same net, weights and Trainer with every FFN activation
   the user's ``rtc_gelu`` CustomOp (user kernels compiled by ``mx.rtc``):
   its gradients against the same CPU ones and beside the built-in GELU's,
   then steps with the launches counted around exactly one (12 gelu_fwd,
   12 gelu_bwd);
5b. nd_surface: the ``mx.nd`` surface on BERT-base: the slice phase's net
   saved with ``save_parameters`` as ``.params`` and ``.npz`` (sizes and
   seconds printed), each file loaded into a fresh ``BERTForPretrain`` with
   ``load_parameters(..., ctx=mx.gpu())`` and cast to bf16, its NDArray
   answers to the slice phase's three requests (inputs from
   ``mx.nd.array(..., ctx=mx.gpu(), dtype="int32")``, read with
   ``asnumpy`` after ``mx.nd.waitall``) bit-equal to the saved net's, 12
   flash_fwd launches around one request; two fresh dropout-free copies
   with the same weights, two steps each in deterministic mode, copy A on
   tensors (``train_step``), copy B in the MXNet idiom (NDArray inputs,
   the loss on NDArrays, ``loss.backward()``, ``trainer.step``):
   parameters, Adam states and losses bit-equal, 12/12/12/1 launches of
   flash_fwd/flash_bwd_dq/flash_bwd_dkv/multi_tensor (mp_adam over 159
   tensors, none left to the loop) around one NDArray step, then both eager
   steps timed in turns (tensor, NDArray, NDArray, tensor; reported, not
   gated); every op case of ``tests/nd_op_cases.py`` (the PR 14 table and
   LIBRARY_CASES: ops/spatial, ops/linalg, ops/quantization, the
   interleaved attention ops) once on card NDArrays, an NDArray on the
   card of the CPU result's shape and dtype, held to it exactly, within 8
   ulps (arithmetic) or 4·n ulps (reductions) of the case's largest
   |value| (``gelqf``/``syevd`` by reconstruction and up to sign), and
   10^6 draws of every sampler from the card's generator to its
   distribution's mean and variance within 5 standard errors; one line per
   source file; the nets freed;
5c. symbol_block: the slice phase's weights in a fp32 Gluon copy,
   hybridized, one forward and ``export`` under ``build/``; that file
   through ``predictor.load_checkpoint`` (a ``Predictor``) and a
   ``gluon.SymbolBlock`` over ``tests/sym_bert.py``'s graph, each bit-equal
   to the Gluon forward (deterministic mode), one plan and 12 ``flash_fwd``
   launches a forward; in bf16 through ``amp.convert_model`` within
   SLICE_REL_BOUND of the fp32 tier; the graph with every FFN activation
   ``sym.Custom(op_type="rtc_gelu")`` in bf16 through a ``Predictor`` (12
   ``flash_fwd`` and 12 ``rtc_gelu_fwd`` launches a forward, within
   GRAD_REL_BOUND relative L2 of the bf16 Gluon net under ``rtc_gelu_ffn``)
   and an ``InferenceServer`` burst (a full batch bit-equal to the
   ``Predictor``, the same launches, no plan built after warm-up);
6. resnet_train: ResNet-50 v1 training steps as bench.py's bench_resnet50
   takes them (B=256, 224x224 synthetic images, AMP bf16 with fp32
   parameters, SGD lr 0.1 momentum 0.9 wd 1e-4, the streaming softmax
   cross-entropy) through ``autograd.record``, ``autograd.backward`` and
   ``gluon.Trainer.step``; launch counts around exactly one step (53
   bn_stats, 53 bn_apply, 0 bn_apply_res, no BatchNorm reference call, one
   sgd_mom launch of the multi-tensor kernel for all 193 parameters),
   finite losses, moved running statistics; then, at B=16, the card's fp32
   and AMP gradients against the port's fp32 gradients on the CPU, per
   parameter, beside the CPU's own sensitivity;
   kernel_vs_plain_multi_tensor again, on the main paths' own groups: each
   training step's one fused group (mp_adam over 159 tensors, fp32 sgd_mom
   over 193) with its real gradients and states, two steps through the
   kernel and through the plain loop, bit-equal;
6b. fold: both training steps through ``Trainer.fold_step`` (one
   CUDA-graph replay a step after a warm-up and a capture): on fresh
   dropout-free copies, 3 eager steps against 3 folded calls and 3
   windows of ``fold_steps(k=4)`` against 12 eager steps, parameters,
   optimizer states, losses and running statistics bit-equal (in
   deterministic mode; a default-mode eager-vs-eager control beside it),
   and ``fold_eval`` against the eager sums; two replays of the dropout-0.1
   BERT step draw different masks at the dropout rate; then the main path
   on the training phases' own nets: launch counts around warm-up,
   capture and replay, the kernels of one replay counted by name in a
   torch.profiler trace (12+12+12+1 BERT, 53+53+1 ResNet-50), each call
   one replay, no fallback;
6c. train_surface: BERT-base (fp32 parameters) under fp16 AMP with LAMB
   (lr 1e-3, wd 0.01, a PolyScheduler warm-up and decay) and dynamic loss
   scaling (``amp.init_trainer``, ``amp.scale_loss``): six steps, then the
   loss scale set to 2^40 and steps until one is finite; every skipped step
   leaves each weight and state bit-equal, halves the scale and keeps the
   update counts, every finite step reads the schedule's lr exactly and
   launches 12/12/12 attention kernels, one finite pass and two LAMB
   launches (counted; one step also traced by kernel name); the fp16
   gradients against the card's fp32 ones (b=2, dropout off, GRAD_REL_BOUND);
   the LAMB group through the kernels against the per-tensor LAMB, one
   update at a time; ``fold_update`` of a LAMB trainer bit-equal to the
   eager fused update (deterministic mode); ``autograd.grad`` bit-equal to
   the gradients ``backward`` writes, and refused with ``create_graph``
   through the attention kernels; ResNet-50 v1 (B=256, AMP bf16) with NAG
   (momentum 0.9, wd 1e-4, a CosineScheduler warm-up): three steps of 53
   bn_stats, 53 bn_apply and one nag_mom launch over 193 tensors, the lr
   exact, and its group bit-equal to the per-tensor loop;
6d. observe (after the timing phase, before generation: its long trace
   makes kineto drop records of every later trace, as the serving phases
   do): ``mx.profiler`` over the train phase's BERT-base trainer: a
   fold program captured before the recorder arms, then under
   ``profiler.start()`` 20 eager ``Trainer.step``s and 20 folded calls
   (replays), one 200 ms host stall injected among them: one
   ``step_stats`` entry a call with consecutive ids (each beside the
   step's CUDA-event time), ``trainer.update`` and ``fused.group_apply``
   inside their steps in the dump, which ``tools/trace_merge.py --check``
   passes, one ``gluon.step_fold`` compile record and none once the guard
   is armed in raise mode, the goodput buckets summing to the wall, the
   JSONL log's strictly increasing ``seq``, exactly one slow step, and the
   device trace's kernel table counting 12 ``flash_*_tma`` of each kind
   and one ``multi_tensor_update`` a step; then the folded step with the
   recorder unarmed and armed, in turns (reported);
6e. spmd (after the timing phase: its traces of replays put kineto in the
   mode that drops the first records of every later session, which the
   timing phase's short traces cannot take; the fold phase's graphs freed):
   bench.py's BERT-base (B=64, S=128, P=20, bf16 parameters, fp32 Adam
   masters, dropout 0.1, the streaming MLM loss) and ResNet-50 v1 (B=256,
   AMP bf16, SGD lr 0.1 momentum 0.9 wd 1e-4) through
   ``parallel.SPMDTrainer(..., mesh=make_mesh())`` at world 1: on fresh
   dropout-free copies two SPMD steps bit-equal to two ``Trainer.fold_step``
   calls (parameters, states, losses, running statistics; deterministic
   mode), and for BERT ``step_bulk(4)`` and ``step_window`` over a [4, B,
   ...] window bit-equal to 4 ``step`` calls each; then the main path:
   six steps, finite and falling, the launch counts and the port's
   collectives set to 0 before the first step (the eager warm-up) and read
   after it (12/12/12 attention kernels and one mp_adam launch; 53 bn_stats,
   53 bn_apply and one sgd_mom launch; no collective), one replay's kernels
   by name in a profiler trace, and the SPMD step against the fold step on
   the same net in turns (reported); its launches are the kernels line's
   ``spmd`` path;
   dist: a 1-rank NCCL group in this process (``init_distributed``, exact
   ``dist_sync`` values on the card, one NCCL all-reduce through the
   store), then a 2-rank gloo cohort on the one card
   (``tools/launch_local.py`` and ``tests/torch_dist_worker.py``): the exact
   ``dist_sync`` assertions on CUDA tensors, ``Trainer.backward``'s overlap
   bit-equal to a plain backward, ``SPMDTrainer`` at 2 ranks against 1,
   at BERT-base's width cut to 2 layers;
6f. io (after dist, before observe): first a probe line (Pillow's
   version, where libjpeg's header and library are, nvJPEG under the CUDA
   toolkit, the cores); then ResNet-50 v1 as bench.py builds it (B=256,
   AMP bf16, SGD momentum 0.9, wd 1e-4) through ``SPMDTrainer`` on
   ``make_mesh()``, fed from a record file of 2048 seeded 500x375 JPEGs
   (quality 90, written with ``recordio.pack_img`` into a temporary
   directory the phase deletes) by ``ImageRecordIter`` (shuffle, random
   crop and mirror, ImageNet mean and std, a decode thread a core up to
   16) inside a ``DataPipeline`` with the autotuner on: the native path and
   its decoder, the decode against the source pixels within JPEG's loss,
   the iterator's decode img/s alone, two epochs of 8 steps, every
   delivered batch (cloned on the consumer's stream at delivery) bit-equal
   to the host batch that produced it, each epoch's labels a permutation
   of the records', finite losses, 53/53/1 launches at the first step, the
   pipeline's tensors passed straight through (no ``spmd.shard_batch``
   span); epoch 2 timed between two runs of the same steps on a resident
   batch (img/s), with the goodput ``data_wait`` share, the stalls and the
   autotuned depth (reported); BERT-base (B=64, S=128, P=20, bf16, Adam
   multi_precision, dropout 0, deterministic mode) from an ``NDArrayIter``
   of 32 seeded batches through ``DataPipeline.stage_window(4)`` into
   ``Trainer.fold_steps(k=4)`` and ``SPMDTrainer.step_window``: two windows
   each bit-equal (parameters, states, losses) to the same windows stacked
   by the caller, the epoch 8 full windows, 48/48/48/4 kernels in a
   replay's trace; a ``gluon.data.DataLoader`` over
   ``SyntheticImageDataset`` with ``ToTensor`` and ``Normalize``, 4
   process workers and ``pin_memory``: two batches of 256 pinned, equal on
   the card and to the main process's own transform; its launches are the
   kernels line's ``io`` path;
6g. detect (after io, before observe): bench.py's config 5, SSD-512 on
   ResNet-18 (B=32, 512x512, SGD lr 0.01) and YOLOv3-Darknet-53 (B=16,
   416x416, SGD lr 1e-3), momentum 0.9, wd 5e-4, AMP bf16, through
   ``SPMDTrainer`` on ``make_mesh()`` on bench.py's seeded images and label
   rows: first each net's fp32 forward at B=2 (train-mode BatchNorm)
   against the port's CPU forward of the same weights (SSD VGG-16 atrous
   too), ``multibox_target`` (mining off and on), ``multibox_detection``,
   ``box_nms`` and ``yolo3_decode`` on the card against the CPU; then in
   deterministic mode two SPMD steps bit-equal to two eager steps
   (parameters, momenta, running statistics, losses) for SSD and YOLOv3;
   then each main path: the launches of the warm-up step (25/25/1 and
   72/72/1 bn_stats/bn_apply/multi_tensor), one replay's kernels by name,
   20 timed replays (step ms and img/s, reported), losses finite and
   falling; the BN kernels against their plain versions at every
   BatchNorm shape the two paths gave; 64 seeded images through
   ``ImageDetIter`` with ``rand_mirror`` into two SSD steps, each batch
   bit-equal on the card to its host batch; one SPMD step of
   ``ssd_512_vgg16_atrous`` (10/10/1: BatchNorm only in the
   downsamplers); alexnet, vgg16_bn, mobilenet1.0, mobilenetv2_1.0,
   squeezenet1.1, densenet121 (224x224) and inceptionv3 (299x299), B=8,
   AMP bf16: one train-mode forward and backward each, finite gradients,
   BN launches equal to the BatchNorm count; its launches are the kernels
   line's ``detect`` path;
6h. fit (after detect, before observe; fp32 with AMP off and TF32 off,
   as the reference's ``fit.py`` trains): ResNet-50 v1 as
   ``tests/sym_resnet.py``'s symbol graph with a ``SoftmaxOutput`` head
   (the Gluon ``resnet50_v1``'s parameter names) under ``mx.mod.Module``
   (B=256, 224x224, SGD lr 0.1 momentum 0.9 wd 1e-4, ``rescale_grad``
   1/256): one ``forward_backward`` + ``update`` against one eager Gluon
   step from the same weights and batch (deterministic cuDNN), weights and
   momenta within FIT_STEP_REL of their step and moving statistics within
   FIT_STATS_REL, 53 ``bn_stats``, 53 ``bn_apply`` and no ``multi_tensor``
   launch (counted and traced; the per-tensor update), the BN kernels in
   fp32 against their plain versions at B=256 on all nine BatchNorm
   shapes the step gives them, the steps timed
   (batch on the host and on the card, the update alone, the Gluon step
   and ``Trainer.step``; reported) and profiled; ``Module.fit`` for 2
   epochs of 8 batches from an ``NDArrayIter`` of seeded images (a class's
   mean colour) with acc, top-5 and ce, ``Speedometer(256, 4)`` and
   ``do_checkpoint``: the training cross-entropy falls from epoch 0 to 1,
   the checkpoint equals ``get_params``, ``Module.load(..., 2,
   load_optimizer_states=True)`` takes a step bit-equal to the module that
   was not interrupted, ``score`` and ``predict`` on the card agree; the
   reference's bucketing LSTM language model (vocabulary 10,000, embed and
   hidden 200, 2 layers, B=32, buckets 10-60, SGD lr 0.01, Xavier) as a
   ``BucketingModule`` over ``sym.RNN`` (``FusedRNNCell``) fed by
   ``BucketSentenceIter`` from a seeded Zipfian corpus with bigram
   structure: ``fit`` 3 epochs with ``Perplexity(0)``, which falls each
   epoch, one shared parameter set after every bucket trained, a training
   step's tokens/s in each bucket and a profile of the largest, the fused
   graph against the unrolled ``LSTMCell``s (``unpack_weights``) within
   LM_FUSED_REL in outputs and gradients; the RNN op at the LM's widths
   (T=60) on the card against the CPU in the four modes, bidirectional and
   bf16, and ``gluon.rnn.LSTM``, ``GRU`` (bidirectional) and ``RNN``
   forward and backward against the CPU, ``LSTMCell.unroll`` against
   ``LSTM``, within RNN_CARD_REL (bf16 RNN_BF16_REL); the LSTM op's time
   with the packed views against ``torch.nn.LSTM``'s flat weights
   (reported); its launches are the kernels line's ``fit`` path;
6i. op_library (after fit, before observe; fp32 with AMP off and TF32 off
   unless a part says bf16): ROIAlign (Mask R-CNN C4), ROIPooling (Fast R-CNN
   VGG-16), a deformable convolution (DCN res5), deformable PS-ROI pooling
   (R-FCN) and Correlation (FlowNetC) at those models' widths, each timed;
   ``ctc``: example/ctc_ocr.py's OCRNet (hidden 64, bidirectional LSTM, 11
   classes) trained with ``mx.nd.CTCLoss`` and Adam (lr 3e-3, B=32, 10
   epochs of 25 batches of the example's seeded batches), each epoch's loss
   and greedy-decoded accuracy, the first step's loss and gradients against
   the CPU within CTC_CARD_REL, the loss falling, the step's wall and
   kernel ms and the CTC forward's kernels, ``gluon.loss.CTCLoss`` against
   the CPU in both layouts with and without lengths; ``interleaved``:
   BERT-base layer 0's QKV weights interleaved a head at B=64, S=128,
   H=12, Dh=64 (and the enc-dec pair at transformer-big's d=1024, H=16),
   forward and backward in bf16 and fp32 against the same attention through
   the flash kernels (counted), within the stated bounds, both timed;
   ``int8``: ResNet-50 v1 (seeded weights) at B=64 through ``quantize_net``
   (naive over two batches; entropy over one, all 54 layers), every
   quantized layer's int32 sums and float output bit-equal to the float64
   plain version on the card, every entropy threshold in (0, the naive
   range's max|x|], the int8 forward's ms beside fp32's and bf16's (wall
   and kernel), the logits' relative L2 from fp32, the calibrations' wall;
   ``control_flow``: the fit phase's LM cell (embed and hidden 200) over a 35-step bucket at B=32 by
   ``nd.contrib.foreach`` bit-equal to ``LSTMCell.unroll`` (outputs,
   states, input and weight gradients; deterministic mode), ``while_loop``
   with an early stop captured in a CUDA graph (no host sync a step: a
   sync fails the capture), rows past the stop zero, ``cond`` both ways;
   ``sparse``: example/sparse_linear_classification.py's model at
   1,000,000 features, B=8192, 32 ids, SGD lr 0.5 momentum 0.9, 20 steps,
   each step's weight and momentum bit-equal to the per-tensor lazy op's
   plain version on the CPU (untouched rows bit-unchanged), no
   ``multi_tensor`` launch, ``fold_step`` refused with the JAX package's
   message, ``cast_storage``/``tostype`` of card arrays (the gradient to
   row_sparse, a batch's dense rows to csr, each to the other) on the card
   and bit-equal back, csr · dense [1,000,000, 64] both ways against the
   dense product within REDUCE_ULPS·terms ulps, the step's and the
   product's ms;
   the interleaved part's flash launches are the kernels line's
   ``op_library`` path;
7. times: each kernel, its plain version and the library call at the main
   paths' shapes (the attention kernels also at the S=512 request, in fp32
   at the main shape, and by CUDA-graph replay), the kernel's bound; BERT
   forward and training-step time,
   the ResNet-50 step's time, img/s, peak memory and its split; the
   BERT step with the user's GELU beside the built-in one; a
   torch.profiler breakdown of device time by kernel family for one BERT
   forward, one BERT training step and one ResNet-50 step; the
   multi-tensor kernel on each step's fused group beside its plain loop,
   torch._fused_adam_ / torch._fused_sgd_ and its bound; both training
   steps with the per-tensor loop and the fused update in turns
   (Trainer.step ms, step ms, a breakdown of each); the flash_wide
   kernels at [B, S, H, Dh] = [4, 512, 8, 512], [4, 512, 8, 320] and
   [4, 512, 8, 1024] in bf16 and at Dh 512 in fp32; both training steps
   eager and folded in turns
   (step ms, samples/s or img/s, peak and reserved memory, capture time,
   a breakdown of one folded step with its device busy share); LAMB and
   the finite pass on the train_surface BERT step's group and gradients,
   NAG on its ResNet-50 group, each beside its plain version (and
   torch._fused_sgd_(nesterov=True) for NAG) and its bound;
8. generation, after the timing phase (after the serving phases kineto
   drops a few kernel records of every later profiler trace as out of its
   window, ROADMAP §3 "Not faults"):
   transformer-big (bench.py's widths and vocabulary, random weights from
   ``--seed``) in fp32 and in bf16: the teacher-forced forward at B=2,
   S=64, fp32 logits against the port's fp32 CPU run and bf16 within 0.1
   of the fp32 tier's largest |logit|, 18 ``flash_fwd`` launches a forward
   (6 encoder, 6 causal, 6 cross; counted and traced); ``greedy_search``
   with the KV cache against ``use_cache=False`` (bf16, B=4, 32 tokens):
   step logits within GEN_STEP_REL, tokens equal wherever the margin rule
   applies, 12 launches a cached step (counted and traced);
   ``GenerationServer`` (prompts to 128, 128 new tokens, power-of-two
   ladders, 8 slots a pool, the compile guard in raise mode): its prefill
   and decode programs called and traced from this thread (6 launches and
   none), one request counted (6 launches: one prefill, no decode launch),
   then 64 requests from 4 threads (``make_workload``'s draws) in
   continuous mode (tokens/s, TTFT/TPOT p50/p99, mean decode batch), each
   equal to itself decoded alone, one held to ``greedy_search`` by the
   margin rule, the static mode's tokens the same (the first 16 requests:
   it admits 2 a wave), no build and no failed
   request after warm-up; the decode step's wall and kernel ms, the logits'
   copy and the KV-cache bytes a pool printed;
9. serve, last: the serving path on the slice phase's
   weights, BERT-base as an ``mx.sym`` graph (``tests/sym_bert.py``) saved as ``bert-symbol.json``
   and ``bert-0000.params`` (fp32); ``Predictor`` with no ``dev_type`` (the
   card) at B=64: logits bit-equal to the Gluon fp32 forward of the same
   weights in deterministic mode, 12 ``flash_wide_fwd_f32_rows`` launches a
   forward (counted and traced), a rebind to B=8 and back adding under 1 %
   of the parameters' bytes with every executor holding the one parameter
   store; ``InferenceServer(..., amp_dtype="bfloat16")`` warmed on every
   batch bucket 1-64: a full batch of 64 and 40 samples padded to 64
   bit-equal to a ``Predictor`` over ``amp.convert_model`` of the checkpoint
   on the same rows, 12 ``flash_fwd_tma`` and no ``flash_wide`` launch a
   served batch, every answer within 0.1 of the fp32 tier's largest |logit|;
   a burst of 4 threads x 160 requests (samples/s, p50/p99 latency,
   batches; reported), ``Predictor.forward`` ms at buckets 1, 8, 64 in both
   tiers beside the Gluon bf16 forward; gated: no bucket miss and no plan
   built after warm-up, no failed request, the metrics provider and its
   Prometheus lines; the server closed with drain, the files deleted; its
   launches join the kernels line's ``launches_by_path``.

The last line is ``{"ok": true, "device": {...}}``, printed only when every
phase passed on a CUDA card.  The rehearsal runs the slice, train, rtc_train,
nd_surface, symbol_block, ResNet, fold, spmd, io, detect, fit, op_library,
train_surface, timing, observe, serve and generation phases on the CPU at a tiny size, with the
kernels' plain versions, and never prints it.  ``--inference-turns`` times only the
BERT-base inference forward of two checkouts, each turn a fresh process
(A, B, B, A per round), and never prints it either.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import incubator_mxnet_torch as mx  # noqa: E402
from incubator_mxnet_torch.convert import load_numpy_params  # noqa: E402
from incubator_mxnet_torch.gluon.model_zoo import bert as bert_zoo  # noqa: E402
from incubator_mxnet_torch.gluon import step_fold  # noqa: E402
from incubator_mxnet_torch.gluon.model_zoo import ssd as ssd_zoo  # noqa: E402
from incubator_mxnet_torch.gluon.model_zoo import vision  # noqa: E402
from incubator_mxnet_torch.gluon.model_zoo import yolo as yolo_zoo  # noqa: E402
from incubator_mxnet_torch.gluon.nn.transformer import PositionwiseFFN  # noqa: E402
from incubator_mxnet_torch.ops import _cuda  # noqa: E402
from incubator_mxnet_torch.ops import attention as att  # noqa: E402
from incubator_mxnet_torch.ops import bn  # noqa: E402
from incubator_mxnet_torch.ops import detection as detection_ops  # noqa: E402
from incubator_mxnet_torch.ops import multi_tensor as mt  # noqa: E402
from incubator_mxnet_torch.ops import nn as ops_nn  # noqa: E402
from incubator_mxnet_torch.ops import optimizer_ops as opt_ops  # noqa: E402
from incubator_mxnet_torch.ops.nn import streaming_softmax_ce  # noqa: E402
from incubator_mxnet_torch.optimizer import fused  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
# fp32 on the CUDA cores (67 TFLOP/s); "split_tf32": an fp32 product as three
# TF32 products on the tensor cores (495 TFLOP/s), 165 TFLOP/s of the
# function's own operations.
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12,
                  "split_tf32": 495e12 / 3}

# Kernel vs plain: the largest absolute difference allowed.
# 16-bit forward: p rounds to the 16-bit type unnormalized in the kernel and
# normalized in the plain version (relative errors of one unit roundoff
# that average out over the keys), and o rounds once more; so the two
# differ by about one ulp of |o|: the bound is FWD_ULPS ulps of the case's
# largest |o_ref| (causal rows near the start see few keys and reach
# |o| ~ 4-5, where one bf16 ulp is 2**-5).
# 16-bit backward: the same fp32 algebra with p and ds rounded to the
# 16-bit type at the same places on both sides; only fp32 summation order
# differs, which can flip a rounding of p or ds and moves the rounded
# gradient by about one ulp: BWD_ULPS ulps of the largest |grad_ref| of
# that gradient.  A wrong mask, tile or layout moves gradients by their own
# size.  fp32: the same fp32 arithmetic in another summation order
# (backward relative to the largest |grad_ref|, through exp and the
# dp - delta cancellation).
FWD_ULPS = 2
BWD_ULPS = 2
FP32_FWD_BOUND = 2e-5
FP32_BWD_REL = 1e-4
# End to end through fused_qkv_attention's autograd against the plain
# forward and backward: o and lse also come from different forwards, so
# delta = rowsum(do * o) moves by up to the forward's 2 ulps of o.
E2E_ULPS = 8
LSE_BOUND = 1e-4  # fp32 log-sum-exp of scores of |s| < ~10, other sum order
# One visible key a row (Sk = 1): p = 1, o = v exactly, and the exact dq and
# dk are 0, since o does not depend on q or k.  What both sides compute is
# the rounding of dp − delta, two fp32 sums of the same Dh products do∘v
# (in orders that differ), so a bound in ulps of the largest |dq| or |dk|
# has no scale: each is held to 0 within what that rounding allows.  Each
# of the Dh additions of a sum errs by at most one fp32 ulp (2^-23 of a
# partial sum, truncation included) of at most S_i = Σ|do_i∘v|, so |dp_i −
# delta_i| <= E_i = 2·Dh·2^-23·S_i; ds_i = p_i·(dp_i − delta_i) with p_i
# within 2^-16 of 1 (exp of s − lse, both fp32), rounded to 16 bits (2^-8),
# and the gradient rounded once more:
# |dq_ic| <= ONE_KEY_SLACK·scale·E_i·|k_c| and |dk_c| <=
# ONE_KEY_SLACK·scale·Σ_i E_i·|q_ic|.  A wrong delta, mask or row makes
# dp − delta of the size of dp itself, hundreds of times E.
# fp32 runs the backward in split TF32 (flash_wide.cu): dp_i is a sum of
# exact products of TF32 operands, three a column (hi·lo′, lo·hi′, hi·hi′
# with x = hi + lo), which drops lo·lo′ and the truncation of lo to TF32,
# each below 2^-20·|do_ic·v_c|: at most 3·2^-20·S_i = 24·2^-23·S_i in all.
# An mma.sync adds its 8 exact products to the accumulator as one fused sum,
# rounded once (an ulp at most, truncation included), so dp_i takes 3·Dh/8
# roundings and delta_i (the delta launch's fp32 fmas) at most Dh:
# |dp_i − delta_i| <= (24 + 11·Dh/8)·2^-23·S_i, inside E_i for Dh >= 39 (the
# fp32 one-key case runs Dh 64; zero-padded columns add exact zeros).  p_i
# = exp(s_i − lse_i) with s_i the dq pass's split-TF32 q·kᵀ and lse_i the
# forward's fp32 one differs from 1 by a few 2^-20 of scale·Σ_c|q_ic·k_c|
# (about 1e-5 there), ds is not rounded, and the split-TF32 products ds·k
# and dsᵀ·q err by a few 2^-20: inside the slack's 2 %.
ONE_KEY_SLACK = 1.02
# BERT-base bf16 on the card vs the port's fp32 run on the CPU, as a share
# of the largest fp32 logit: bf16 roundings compounded through 12 post-LN
# layers.  A wrong layout or mask gives errors of the order of the logits.
SLICE_REL_BOUND = 1e-1
# BERT-base fp32 on the card vs the same fp32 weights on the CPU, as a share
# of the largest fp32 logit: both compute in fp32 (matmuls with TF32 off),
# the card's attention in split TF32, whose products err by a few 2^-20 of
# each; so the two differ by summation order, about one fp32 rounding an
# op, compounded through 12 post-LN layers: some 1e-5 of the logits.  A
# wrong layout, mask or kernel moves them by their own order.
FP32_SLICE_REL_BOUND = 1e-3
# Training gradients, bf16 on the card vs fp32 on the CPU, same weights,
# dropout off: relative L2 error per parameter.  bf16 keeps 8 significant
# bits (unit roundoff 2**-8); one step rounds each activation and each
# gradient at ~20 ops a layer through 12 post-LN layers forward and back,
# some 500 roundings on a path, which add up as a random walk to ~5 % and
# can align in the first layers and the embeddings.  A wrong mask, layout
# or gradient kernel leaves errors of order 100 %.
GRAD_REL_BOUND = 0.15

BERT_BASE = dict(vocab_size=30522, max_length=512, dropout=0.1)
# nd_surface: eager steps a timed turn, and the samplers' moments are held to
# the distribution's mean and variance within this many standard errors.
ND_TIMED_STEPS = 5
ND_MOMENT_SE = 5.0
TINY_BERT = dict(vocab_size=128, units=32, hidden_size=64, num_layers=2, num_heads=2,
                 max_length=64, dropout=0.1)
# BatchNorm kernels against their plain versions.  bn_stats: both sides sum
# in fp32 in different orders; the kernel's longest sequential run is one
# lane's share of a row, L ~ 400 terms at the stem, so the difference walks
# like sqrt(L)·u ~ 1.2e-6 of Σ|x| (u = 2**-24), and the worst case
# (L + log2 M)·u is 2.4e-5: the bound is STATS_REL of Σ|x| for Σx and of
# Σx² for Σx², per channel.  bn_apply(_res): the same fp32 arithmetic,
# rounded once to the output type; the kernel fuses x·scale + shift into one
# fma and the plain version rounds the product first, so the fp32 values
# differ by up to two fp32 roundings of the largest term, which can move the
# rounded output by one ulp: the bound per element is one ulp of the output
# type at the plain result plus two fp32 ulps of |x·scale| + |shift| + |res|.
STATS_REL = 1e-5
# ResNet-50 gradients on the card against fp32 on the CPU, same weights,
# B=16, BatchNorm in training.  A batch-normalized ReLU network in training
# is chaotic: its gradients, and their sensitivity to any perturbation,
# grow with depth (the mean-field result for BatchNorm networks).  The
# phase measures that sensitivity on the CPU in the same run, as two
# yardsticks: the change of the fp32 gradients when every weight moves by
# 1e-6 relative (some ten fp32 roundings), and when the weights are rounded
# to bf16.  So:
# * fp32 on the card (AMP off, TF32 off) differs from the CPU by summation
#   order and algorithm, about one fp32 rounding per op: less than the 1e-6
#   yardstick, which moves gradients by a few percent.  The bound is 0.3,
#   several times that; a wrong BN kernel moves the batch statistics by
#   their own size and the gradients by order 1 (100 %).  The logits: 1e-3,
#   against 1e-4 or less from such a perturbation.
# * AMP bf16 rounds every activation and weight (u = 2**-8), a perturbation
#   the bf16 yardstick shows to decorrelate the gradients (order 1).  No
#   bound below that can hold, so the AMP run is held only to finite
#   gradients within 2 of the reference's norm (what two unrelated vectors
#   of equal norm give at most) and reported beside its yardstick.
RESNET_FP32_GRAD_REL_BOUND = 0.3
RESNET_FP32_LOGIT_REL_BOUND = 1e-3
RESNET_AMP_GRAD_REL_BOUND = 2.0

RESNET_B = 256
TINY_RESNET = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128], classes=10,
                   thumbnail=True)
# sources under incubator_mxnet_torch/ops/csrc
KERNELS = ("flash_fwd", "flash_bwd", "flash_wide", "bn", "multi_tensor")

# -- user kernels (mx.rtc + mx.operator.CustomOp) -----------------------------
# What a user of the framework writes: CUDA source handed to mx.rtc at
# runtime (the kernels of tests/test_rtc.py, and an erf GELU pair), and a
# CustomOp that puts the GELU pair under autograd.  The rtc_train phase
# swaps it into every PositionwiseFFN of the slice-2 BERT-base.
RTC_SOURCE = r"""
#include <cuda_bf16.h>
#include <stdint.h>

// Parameters: the inputs, then one pointer per declared output.
extern "C" __global__ void scale_add(const float* x, const float* y, long long n, float* out) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        out[i] = 2.0f * x[i] + y[i];
}

// One (8, 128) tile per block, as the Pallas version's grid of blocks.
extern "C" __global__ void saxpy_block(const float* x, const float* y, float* out) {
    const long long base = (long long)blockIdx.x * 8 * 128;
    for (int i = threadIdx.x; i < 8 * 128; i += blockDim.x)
        out[base + i] = 0.5f * x[base + i] + y[base + i];
}

// Min and max of n values in one block of 256 threads: a shared-memory tree.
extern "C" __global__ void minmax(const float* x, int n, float* lo, float* hi) {
    __shared__ float smin[256], smax[256];
    const int t = threadIdx.x;
    float a = __int_as_float(0x7f800000), b = -a;
    for (int i = t; i < n; i += blockDim.x) {
        a = fminf(a, x[i]);
        b = fmaxf(b, x[i]);
    }
    smin[t] = a;
    smax[t] = b;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (t < s) {
            smin[t] = fminf(smin[t], smin[t + s]);
            smax[t] = fmaxf(smax[t], smax[t + s]);
        }
        __syncthreads();
    }
    if (t == 0) {
        *lo = smin[0];
        *hi = smax[0];
    }
}

extern "C" __global__ void twice(const float* x, long long n, float* out) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        out[i] = 2.0f * x[i];
}

// Not extern "C": C++ mangles the name, and a lookup of "not_extern_c" fails.
__global__ void not_extern_c(float* out) { *out = 1.0f; }

// erf GELU and its gradient times dy, in fp32 as PyTorch's own CUDA GELU
// computes them, rounded once to the I/O type.  A grid-stride loop of
// 16-byte packs where x and the output are 16-byte aligned, then scalars.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float v, float& o) { o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16& o) { o = __float2bfloat16(v); }

__device__ __forceinline__ float gelu(float x) {
    return x * 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float x, float dy) {
    const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
    const float pdf = expf(-0.5f * x * x) * 0.39894228040143268f;
    return dy * (cdf + x * pdf);
}

template <typename T, int V>
struct alignas(16) Pack { T v[V]; };

template <typename T>
__device__ void gelu_fwd_impl(const T* __restrict__ x, long long n, T* __restrict__ y) {
    constexpr int V = 16 / sizeof(T);
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
    const long long packs = aligned ? n / V : 0;
    for (long long i = tid; i < packs; i += stride) {
        const Pack<T, V> a = reinterpret_cast<const Pack<T, V>*>(x)[i];
        Pack<T, V> b;
#pragma unroll
        for (int j = 0; j < V; ++j) store(gelu(to_f32(a.v[j])), b.v[j]);
        reinterpret_cast<Pack<T, V>*>(y)[i] = b;
    }
    for (long long i = packs * V + tid; i < n; i += stride) store(gelu(to_f32(x[i])), y[i]);
}

template <typename T>
__device__ void gelu_bwd_impl(const T* __restrict__ x, const T* __restrict__ dy, long long n,
                              T* __restrict__ dx) {
    constexpr int V = 16 / sizeof(T);
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                           reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
    const long long packs = aligned ? n / V : 0;
    for (long long i = tid; i < packs; i += stride) {
        const Pack<T, V> a = reinterpret_cast<const Pack<T, V>*>(x)[i];
        const Pack<T, V> g = reinterpret_cast<const Pack<T, V>*>(dy)[i];
        Pack<T, V> b;
#pragma unroll
        for (int j = 0; j < V; ++j) store(gelu_grad(to_f32(a.v[j]), to_f32(g.v[j])), b.v[j]);
        reinterpret_cast<Pack<T, V>*>(dx)[i] = b;
    }
    for (long long i = packs * V + tid; i < n; i += stride)
        store(gelu_grad(to_f32(x[i]), to_f32(dy[i])), dx[i]);
}

extern "C" __global__ void gelu_fwd_bf16(const __nv_bfloat16* x, long long n, __nv_bfloat16* y) {
    gelu_fwd_impl(x, n, y);
}
extern "C" __global__ void gelu_fwd_f32(const float* x, long long n, float* y) {
    gelu_fwd_impl(x, n, y);
}
extern "C" __global__ void gelu_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                                         long long n, __nv_bfloat16* dx) {
    gelu_bwd_impl(x, dy, n, dx);
}
extern "C" __global__ void gelu_bwd_f32(const float* x, const float* dy, long long n, float* dx) {
    gelu_bwd_impl(x, dy, n, dx);
}
"""
RTC = mx.rtc.CudaModule(RTC_SOURCE)
GELU_THREADS = 256
GELU_MAX_BLOCKS = 132 * 16  # a grid-stride loop: 16 blocks of 256 threads per SM


def gelu_plain(x):
    """The plain version of gelu_fwd: fp32 erf GELU, rounded once."""
    x32 = x.float()
    return (x32 * 0.5 * (1.0 + torch.erf(x32 * 0.7071067811865476))).to(x.dtype)


def gelu_bwd_plain(x, dy):
    """The plain version of gelu_bwd: dy · GELU'(x) in fp32, rounded once."""
    x32 = x.float()
    cdf = 0.5 * (1.0 + torch.erf(x32 * 0.7071067811865476))
    pdf = torch.exp(-0.5 * x32 * x32) * 0.3989422804014327
    return (dy.float() * (cdf + x32 * pdf)).to(x.dtype)


class UserKernel:
    """A GELU kernel of RTC_SOURCE as the user's op launches it: the bf16 or
    fp32 instance by the input's dtype, over the input's element count.
    ``get_kernel`` declares the output's shape, so there is one ``Kernel``
    per shape and dtype; ``launches`` sums theirs."""

    SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

    def __init__(self, stem):
        self.stem, self.kernels, self._base = stem, {}, 0

    def __call__(self, *tensors):
        x = tensors[0]
        key = (tuple(x.shape), x.dtype)
        k = self.kernels.get(key)
        if k is None:
            blocks = max(1, min(-(-x.numel() // (8 * GELU_THREADS)), GELU_MAX_BLOCKS))
            k = self.kernels[key] = RTC.get_kernel(
                f"{self.stem}_{self.SUFFIX[x.dtype]}", out_shapes=[key[0]], out_dtypes=[x.dtype],
                grid=(blocks,), block=(GELU_THREADS,))
        return k.launch([*tensors, x.numel()])

    @property
    def launches(self):
        return self._base + sum(k.launches for k in self.kernels.values())

    @launches.setter
    def launches(self, n):
        for k in self.kernels.values():
            k.launches = 0
        self._base = n


GELU_FWD, GELU_BWD = UserKernel("gelu_fwd"), UserKernel("gelu_bwd")


@mx.operator.register("rtc_gelu")
class RtcGeluProp(mx.operator.CustomOpProp):
    def create_operator(self, ctx, in_shapes, in_dtypes):
        return RtcGelu()


class RtcGelu(mx.operator.CustomOp):
    """erf GELU: the user's kernels on CUDA tensors, the plain version on
    CPU tensors (``plain_calls`` counts those)."""

    plain_calls = 0

    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0]
        if x.is_cuda:
            y = GELU_FWD(x)
        else:
            RtcGelu.plain_calls += 1
            y = gelu_plain(x)
        self.assign(out_data[0], req[0], y)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        x, dy = in_data[0], out_grad[0]
        if x.is_cuda:
            dx = GELU_BWD(x, dy.contiguous())
        else:
            RtcGelu.plain_calls += 1
            dx = gelu_bwd_plain(x, dy)
        self.assign(in_grad[0], req[0], dx)


class RtcGeluFFN(PositionwiseFFN):
    """PositionwiseFFN whose activation is the user's ``rtc_gelu`` op."""

    def forward(self, x):
        h = mx.nd.Custom(self.ffn_1(x), op_type="rtc_gelu")
        if self._dropout is not None:
            h = self._dropout(h)
        return self.ffn_2(h)


@contextlib.contextmanager
def rtc_gelu_ffn(net):
    """Inside the scope every PositionwiseFFN of ``net`` runs RtcGeluFFN's
    forward, with its own parameters; yields their number."""
    cells = [m for m in net.modules() if type(m) is PositionwiseFFN]
    for m in cells:
        m.__class__ = RtcGeluFFN
    try:
        yield len(cells)
    finally:
        for m in cells:
            m.__class__ = PositionwiseFFN


ENTRIES = {"flash_fwd": att.flash_fwd, "flash_bwd_dq": att.flash_bwd_dq,
           "flash_bwd_dkv": att.flash_bwd_dkv, "flash_wide_fwd": att.flash_wide_fwd,
           "flash_wide_bwd_dq": att.flash_wide_bwd_dq,
           "flash_wide_bwd_dkv": att.flash_wide_bwd_dkv, "bn_stats": bn.bn_stats,
           "bn_apply": bn.bn_apply, "bn_apply_res": bn.bn_apply_res,
           "rtc_gelu_fwd": GELU_FWD, "rtc_gelu_bwd": GELU_BWD,
           "multi_tensor": mt.multi_tensor_update, "multi_tensor_lamb": mt.multi_tensor_lamb,
           "multi_tensor_finite": mt.sum_sq_finite}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def kernel_counts():
    return {name: fn.launches for name, fn in ENTRIES.items()}


def reset_kernel_counts():
    for fn in ENTRIES.values():
        fn.launches = 0
    mt.multi_tensor_update.launches_by_variant = {}


def fused_counts():
    """The fused optimizer step's host counters: group updates, parameters
    they updated, parameters left to the per-tensor loop."""
    f = fused.fused_update
    return {"calls": f.calls, "params": f.params, "fallback_params": f.fallback_params}


def _trainable(net):
    return sum(p.grad_req != "null" for p in net.collect_params().values())


def _optimizer_check(phase, net, before, variant, rehearsal):
    """The fused update of one counted step: exactly one group update of
    every trainable parameter, none left to the loop, and on the card
    exactly one launch of the multi-tensor kernel, of ``variant``."""
    after = fused_counts()
    got = {k: after[k] - before[k] for k in after}
    want = {"calls": 1, "params": _trainable(net), "fallback_params": 0}
    variants = dict(mt.multi_tensor_update.launches_by_variant)
    want_variants = {} if rehearsal else {variant: 1}
    ok = got == want and variants == want_variants
    emit(phase, fused_update_one_step=got, expected_fused_update=want,
         multi_tensor_launches_by_variant=variants, expected_by_variant=want_variants, ok=ok)
    return ok


def set_kernel_counts(counts):
    for name, fn in ENTRIES.items():
        fn.launches = counts[name]


def ulp(x, dtype):
    """The spacing of ``dtype``'s values at |x| (x > 0)."""
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    return 2.0 ** (math.frexp(x)[1] - 1 - mant) if x > 0 else 0.0


# -- phase 1 ----------------------------------------------------------------


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return smi


# -- phase 2 ----------------------------------------------------------------


def _ptxas_report(log):
    kernels, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = {"entry": m.group(1)}
            kernels.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            current["static_smem"] = int(s.group(1)) if s else 0
    return kernels


def phase_build():
    """One nvcc per source, all started together; fails on a spill."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        rtc = pool.submit(_cuda.build_cubin, RTC_SOURCE)
        builds = dict(zip(KERNELS, pool.map(_cuda.build, KERNELS)))
        builds["rtc"] = rtc.result()
    spills = []
    for name, (_, log, seconds) in builds.items():
        entries = _ptxas_report(log)
        for k in entries:
            emit("build", kernel=name, **k)
            if k.get("spill_stores", 0) or k.get("spill_loads", 0):
                spills.append(k["entry"])
        emit("build", kernel=name, seconds=seconds, entries=len(entries))
    emit("build", wall_seconds=time.perf_counter() - t0, spills=spills)
    if spills:
        sys.exit(1)
    att._entry()  # load every library once, outside any timing
    att._bwd_entry()
    att._entry(512)
    att._bwd_entry(512)
    bn._lib()
    emit("build", kernel="multi_tensor", tensors_per_launch=mt._lib().mx_multi_tensor_capacity())
    for name in sorted(RTC._kernels):  # the user's kernels, as the driver loaded them
        emit("build", kernel="rtc", function=name, **RTC.attributes(name, 0))


# -- phase 3 ----------------------------------------------------------------


def _randn(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)


def _case_inputs(case, gen, device):
    b, sq, sk, h, d, dtype = (case[k] for k in ("b", "sq", "sk", "h", "d", "dtype"))
    if case.get("layout") == "qkv":  # the [B, S, 3, H, Dh] projection output
        x = _randn((b, sq, 3, h, d), dtype, gen, device)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2], "bshd"
    if case.get("layout") == "cache":  # k, v: views [:, :sk] of a [B, T, H, Dh] cache
        t = case["cache_len"]
        ck, cv = (_randn((b, t, h, d), dtype, gen, device) for _ in range(2))
        return _randn((b, sq, h, d), dtype, gen, device), ck[:, :sk], cv[:, :sk], "bshd"
    # k and v of one batch entry or one head expanded (stride 0) over the
    # rest; or q of one row expanded over the sequence
    expand = case.get("expand")
    kv = (1 if expand == "b" else b, 1 if expand == "h" else h, sk, d)
    return (_randn((b, h, 1 if expand == "s" else sq, d), dtype, gen, device).expand(b, h, sq, d),
            _randn(kv, dtype, gen, device).expand(b, h, sk, d),
            _randn(kv, dtype, gen, device).expand(b, h, sk, d), "bhsd")


MAIN = dict(b=64, sq=128, sk=128, h=12, d=64, dtype=torch.bfloat16, causal=False)
KERNEL_CASES = [
    dict(MAIN, name="main"),
    dict(MAIN, name="main_causal", causal=True),
    dict(MAIN, name="fp32", dtype=torch.float32),
    dict(MAIN, name="seq512", b=8, sq=512, sk=512),
    dict(MAIN, name="unaligned_s200", b=4, sq=200, sk=200),
    dict(MAIN, name="unaligned_s200_causal", b=4, sq=200, sk=200, causal=True),
    dict(MAIN, name="cross_sq77_sk200", b=4, sq=77, sk=200),
    dict(MAIN, name="with_lse", lse=True),
    dict(MAIN, name="causal_with_lse", b=4, sq=200, sk=200, causal=True, lse=True),
    dict(MAIN, name="qkv_bshd_view", layout="qkv"),
    dict(MAIN, name="fp16", b=8, dtype=torch.float16),
    dict(MAIN, name="dh16", b=8, h=4, d=16),
    dict(MAIN, name="dh32", b=8, h=4, d=32),
    dict(MAIN, name="dh128", b=8, h=4, d=128),
    dict(MAIN, name="fp32_dh128_causal", b=2, h=4, d=128, sq=200, sk=200,
         dtype=torch.float32, causal=True),
]
# The 16-bit kernel's persistent schedule (128-row work items walked with a
# static stride over a grid of one block per SM, K/V through a ring of TMA
# stages): cases that exercise its bookkeeping.
SCHEDULE_CASES = [
    # 804 items over the grid: several rounds per block and a remainder, so
    # the ring's stages and parities wrap across work items
    dict(MAIN, name="items_over_grid_b67", b=67),
    # one work item: one block, the others of a grid never launched
    dict(MAIN, name="single_item", b=1, h=1),
    # fewer query rows than one consumer warpgroup's 64: the second
    # consumer's rows are all TMA zero fill and its store is skipped
    dict(MAIN, name="sq40", b=4, sq=40, sk=40),
    # eight K/V tiles an item, the last a 104-key tail, causal: many ring
    # stages per item, the masked diagonal and tail tiles, lse
    dict(MAIN, name="sk1000_causal_with_lse", b=2, h=4, sq=1000, sk=1000, causal=True,
         lse=True),
    # the inference request shape: four K/V stages per item, lse
    dict(MAIN, name="seq512_with_lse", b=8, sq=512, sk=512, lse=True),
]
# Options and operands the 16-bit path takes beyond the main paths'.
OPERAND_CASES = [
    # a scale other than 1/sqrt(Dh) over a causal tail, with lse
    dict(MAIN, name="scale_0.3_causal_tail", b=4, sq=200, sk=200, causal=True, lse=True,
         scale=0.3),
    # a negative scale turns the order of the scores around: the row max
    # must be taken of the scaled scores, and masked keys stay at -inf
    dict(MAIN, name="scale_-0.3_causal_tail", b=4, sq=200, sk=200, causal=True, lse=True,
         scale=-0.3),
    # scale 0: equal weights over the visible keys, masked keys still none
    dict(MAIN, name="scale_0_causal_tail", b=4, sq=200, sk=200, causal=True, lse=True,
         scale=0.0),
    # k and v expanded over the batch and over the heads (stride 0): the
    # tensor maps hold extent 1 there and the producer reads coordinate 0
    dict(MAIN, name="kv_expanded_over_batch", b=4, sq=200, sk=200, expand="b"),
    dict(MAIN, name="kv_expanded_over_heads_causal", b=4, sq=200, sk=200, causal=True,
         expand="h"),
]
# The operand domain the wrappers take beyond the kernels' own: q repeating
# one row along the sequence (stride 0; the wrapper hands it to the 16-bit
# kernels contiguous), and head dims with no kernel instance (zero-padded
# to the next one, sliced back).  (Repeated keys would make every visible
# key score alike, and dq = scale·Σ ds·k exactly 0: a bound in ulps of the
# largest |dq| says nothing there.)
DOMAIN_CASES = [
    dict(MAIN, name="q_seq_stride0_causal", b=4, sq=200, sk=200, causal=True, expand="s"),
    dict(MAIN, name="dh48", b=4, h=4, sq=200, sk=200, d=48),
    dict(MAIN, name="dh80_causal", b=4, h=4, sq=200, sk=200, d=80, causal=True),
]
# Head dims 129-256: in 16 bits padded to the widest instance, 256, which
# runs each kernel as two launches of a 128-column output slab (ragged S,
# causal and not, the QKV view, lse); fp32 runs flash_wide.cu, one launch.
WIDE_CASES = [
    dict(MAIN, name="dh160", b=2, h=4, sq=200, sk=200, d=160),
    dict(MAIN, name="dh192_causal", b=2, h=4, sq=200, sk=200, d=192, causal=True),
    dict(MAIN, name="dh256", b=2, h=4, sq=200, sk=200, d=256),
    dict(MAIN, name="dh256_causal_with_lse", b=2, h=4, sq=333, sk=333, d=256, causal=True,
         lse=True),
    dict(MAIN, name="dh256_qkv_view", b=3, h=2, sq=130, sk=130, d=256, layout="qkv"),
    dict(MAIN, name="dh256_cross_sq77_sk200", b=2, h=2, sq=77, sk=200, d=256),
    dict(MAIN, name="fp32_dh256_causal", b=1, h=2, sq=200, sk=200, d=256,
         dtype=torch.float32, causal=True),
]
# Head dims above 256: flash_wide.cu (in bf16 and fp16 its forward, dq and
# dk/dv passes on TMA rings and wgmma, all streamed above 512; in fp32 all
# three on TMA rings and split-TF32 mma.sync; the backward after one delta
# launch in every dtype), at 320, 384, 448
# (256 + 192 columns), 512, 576, 640 and 1024 and a padded 300, ragged S,
# causal and not, causal with Sk < Sq, a causal S=1024 (sixteen key tiles
# an item), the QKV view, a cross shape, lse, fp16 and fp32.  With one key
# (Sk = 1) every row's softmax is 1 whatever q and k: o = v, and the exact
# dq and dk are 0 (``one_key``, held by ONE_KEY_SLACK's rule).
WIDE_HEAD_CASES = [
    dict(MAIN, name="dh320", b=2, h=4, sq=200, sk=200, d=320),
    dict(MAIN, name="dh320_causal_with_lse", b=2, h=4, sq=200, sk=200, d=320, causal=True,
         lse=True),
    dict(MAIN, name="dh512", b=2, h=4, sq=200, sk=200, d=512),
    dict(MAIN, name="dh512_causal_with_lse", b=1, h=4, sq=333, sk=333, d=512, causal=True,
         lse=True),
    dict(MAIN, name="dh512_qkv_view", b=2, h=2, sq=130, sk=130, d=512, layout="qkv"),
    dict(MAIN, name="dh512_cross_sq77_sk200", b=2, h=2, sq=77, sk=200, d=512),
    dict(MAIN, name="fp16_dh300_causal", b=2, h=2, sq=150, sk=150, d=300, causal=True,
         dtype=torch.float16),
    dict(MAIN, name="dh384", b=2, h=4, sq=200, sk=200, d=384),
    dict(MAIN, name="dh512_causal_s1024_with_lse", b=1, h=4, sq=1024, sk=1024, d=512,
         causal=True, lse=True),
    dict(MAIN, name="fp32_dh512_causal", b=1, h=2, sq=200, sk=200, d=512,
         dtype=torch.float32, causal=True),
    dict(MAIN, name="dh448_causal_sq130_sk65", b=2, h=2, sq=130, sk=65, d=448, causal=True),
    dict(MAIN, name="dh448_causal_sq130_sk1", b=2, h=2, sq=130, sk=1, d=448, causal=True,
         one_key=True),
    dict(MAIN, name="dh576", b=2, h=2, sq=200, sk=200, d=576),
    dict(MAIN, name="dh640_causal_with_lse", b=2, h=2, sq=333, sk=333, d=640, causal=True,
         lse=True),
    dict(MAIN, name="dh1024_qkv_view_causal", b=2, h=2, sq=130, sk=130, d=1024, layout="qkv",
         causal=True),
    # fp32 (split TF32 on the tensor cores): P odd, above 512, a cross shape
    # and the QKV view
    dict(MAIN, name="fp32_dh320_causal_with_lse", b=2, h=2, sq=200, sk=200, d=320,
         dtype=torch.float32, causal=True, lse=True),
    dict(MAIN, name="fp32_dh640", b=1, h=2, sq=150, sk=150, d=640, dtype=torch.float32),
    dict(MAIN, name="fp32_dh512_cross_sq77_sk200", b=2, h=2, sq=77, sk=200, d=512,
         dtype=torch.float32),
    dict(MAIN, name="fp32_dh512_qkv_view", b=2, h=2, sq=130, sk=130, d=512, layout="qkv",
         dtype=torch.float32),
]
# Every fp32 call runs flash_wide.cu's split-TF32 kernels at every head dim
# (padded to a multiple of 64: 16, 32 and 48 to 64, 80 to 128): the forward
# one launch (flash_wide_fwd_f32_rows up to 256: 128-row items, Q resident,
# k and v through one ring both consumers read), the backward one delta
# launch and the dq and dk/dv kernels.  The narrow 16-bit cases' edges in
# fp32 (a cross shape, the QKV view, k and v expanded over the batch, q of
# one row expanded over the sequence, padded heads, more items than the grid
# holds), the forward's instances (P = 1-4 column boxes: Dh 32, 80 with lse,
# 192, 256 with lse), S=512 (eight key tiles an item), causal with Sk < Sq
# and one key (Sk = 1, where the exact dq and dk are 0: ``one_key``, held
# by ONE_KEY_SLACK's rule, whose derivation covers split TF32 at this head
# dim).
FP32_CASES = [
    dict(MAIN, name="fp32_cross_sq77_sk200", b=4, sq=77, sk=200, dtype=torch.float32),
    dict(MAIN, name="fp32_qkv_bshd_view", layout="qkv", dtype=torch.float32),
    dict(MAIN, name="fp32_kv_expanded_over_batch", b=4, sq=200, sk=200, expand="b",
         dtype=torch.float32),
    dict(MAIN, name="fp32_q_seq_stride0_causal", b=4, sq=200, sk=200, causal=True, expand="s",
         dtype=torch.float32),
    dict(MAIN, name="fp32_dh16", b=8, h=4, d=16, dtype=torch.float32),
    dict(MAIN, name="fp32_dh48", b=4, h=4, sq=200, sk=200, d=48, dtype=torch.float32),
    dict(MAIN, name="fp32_items_over_grid_b67", b=67, dtype=torch.float32),
    dict(MAIN, name="fp32_causal_sq130_sk1", b=2, h=4, sq=130, sk=1, causal=True, one_key=True,
         dtype=torch.float32),
    dict(MAIN, name="fp32_dh32", b=8, h=4, d=32, dtype=torch.float32),
    dict(MAIN, name="fp32_dh192_causal", b=2, h=4, sq=200, sk=200, d=192, causal=True,
         dtype=torch.float32),
    dict(MAIN, name="fp32_dh256_causal_with_lse", b=2, h=4, sq=333, sk=333, d=256, causal=True,
         lse=True, dtype=torch.float32),
    dict(MAIN, name="fp32_seq512", b=8, sq=512, sk=512, dtype=torch.float32),
    dict(MAIN, name="fp32_causal_sq130_sk65", b=2, h=4, sq=130, sk=65, causal=True,
         dtype=torch.float32),
    dict(MAIN, name="fp32_dh80_with_lse", b=4, h=4, sq=200, sk=200, d=80, lse=True,
         dtype=torch.float32),
]
# The generation path's shapes (transformer-big: H = 16, Dh = 64), in bf16
# and fp32: a decode step's one query row against k and v cut as strided
# views [:, :Sk] from a [B, T, H, Dh] cache (T = 160, Sk from one key to
# past a key tile), the server's prefill (every one of the bucket's 64
# query rows against the prompt's 40 keys: Sk < Sq, not causal), and the
# decoder's causal self-attention at Sq = Sk = 128.
GEN = dict(b=4, h=16, d=64, causal=False)
GEN_CASES = [
    dict(GEN, name=f"{tag}decode_sq1_sk{sk}", sq=1, sk=sk, layout="cache", cache_len=160,
         dtype=dtype)
    for tag, dtype in (("", torch.bfloat16), ("fp32_", torch.float32)) for sk in (1, 7, 64, 129)
] + [
    dict(GEN, name=f"{tag}{name}", dtype=dtype, **shape)
    for tag, dtype in (("", torch.bfloat16), ("fp32_", torch.float32))
    for name, shape in (("prefill_sq64_sk40", dict(b=1, sq=64, sk=40, layout="cache",
                                                   cache_len=64)),
                        ("causal_sq128_h16", dict(b=2, sq=128, sk=128, causal=True)))
]
# Two runs bit-identical (static schedules, no atomics): flash_wide.cu at
# 320, 512 and streamed, and its fp32 kernels at the main shape and Dh 256
# (flash_wide_fwd_f32_rows at P = 1 and 4).
WIDE_REPEAT_CASES = [c for c in WIDE_HEAD_CASES + KERNEL_CASES + FP32_CASES
                     if c["name"] in ("dh320_causal_with_lse", "dh512_causal_with_lse",
                                      "dh640_causal_with_lse", "fp32_dh512_causal",
                                      "fp32_dh320_causal_with_lse", "fp32",
                                      "fp32_dh256_causal_with_lse")]


def _slab_launches(d, dtype=None):
    """Launches of one attention kernel pass at head dim ``d`` in ``dtype``
    (no dtype: the 16-bit count): one a 128-column output slab of the
    instance it runs; one on flash_wide.cu, which makes each slab a block of
    one launch: above 256, and in fp32, forward and backward, at every head
    dim."""
    return 2 if 128 < d <= 256 and dtype != torch.float32 else 1


def _bwd_launches(d, dtype):
    """Launches counted on the dq and the dk/dv pass of one backward call
    that runs both, at head dim ``d`` in ``dtype``: on flash_wide.cu (above
    256 in every dtype, fp32 at every head dim) the call launches its delta
    pass once, before both, and it counts on the dq pass (three launches in
    all)."""
    delta = int(d > 256 or dtype == torch.float32)
    return _slab_launches(d, dtype) + delta, _slab_launches(d, dtype)


def phase_kernel_vs_plain(device):
    gen = torch.Generator(device=device).manual_seed(1234)
    misses, main_err, wide_err = [], None, None
    for case in (KERNEL_CASES + SCHEDULE_CASES + OPERAND_CASES + DOMAIN_CASES + WIDE_CASES
                 + WIDE_HEAD_CASES + FP32_CASES + GEN_CASES):
        q, k, v, layout = _case_inputs(case, gen, device)
        want_lse, scale = case.get("lse", False), case.get("scale")
        counter = att._fwd_counter(case["d"])
        before = counter.launches
        with torch.no_grad():
            o, lse = att.flash_fwd(q, k, v, case["causal"], scale, want_lse, layout)
            torch.cuda.synchronize()
            launched = counter.launches - before
            t = (lambda x: x.transpose(1, 2)) if layout == "bshd" else (lambda x: x)
            o_ref, lse_ref = att.flash_fwd_plain(t(q), t(k), t(v), case["causal"], scale,
                                                 want_lse)
        err = (t(o).float() - o_ref.float()).abs().max().item()
        ref_max = o_ref.float().abs().max().item()
        bound = (FP32_FWD_BOUND if case["dtype"] == torch.float32
                 else FWD_ULPS * ulp(ref_max, case["dtype"]))
        want_launches = _slab_launches(case["d"], case["dtype"])
        ok = math.isfinite(err) and err <= bound and launched == want_launches
        rec = dict(case=case["name"], kernel=counter.__name__,
                   dtype=str(case["dtype"]).replace("torch.", ""),
                   shape=dict(b=case["b"], h=case["h"], sq=case["sq"], sk=case["sk"], d=case["d"]),
                   causal=case["causal"], layout=layout, launches=launched,
                   expected_launches=want_launches, max_abs_err=err,
                   ref_max_abs=ref_max, bound=bound,
                   **{key: case[key] for key in ("scale", "expand") if key in case})
        if want_lse:
            lerr = (lse - lse_ref).abs().max().item()
            rec.update(lse_max_abs_err=lerr, lse_bound=LSE_BOUND)
            ok = ok and math.isfinite(lerr) and lerr <= LSE_BOUND
        rec["ok"] = ok
        emit("kernel_vs_plain", **rec)
        if not ok:
            misses.append(case["name"])
        if case["name"] == "qkv_bshd_view":
            main_err = err
        if case["name"] == "dh512":
            wide_err = err
    # The schedule is static (no atomics, fixed item order): two runs of the
    # main case give the same bits, o and lse.
    # flash_wide.cu's schedules are static too (no atomics): at Dh 320, 512
    # and 640, and in fp32 at the main shape and Dh 256.
    for name, case in (("main", MAIN), *((c["name"], c) for c in WIDE_REPEAT_CASES)):
        q, k, v, layout = _case_inputs(case, gen, device)
        with torch.no_grad():
            runs = [att.flash_fwd(q, k, v, case["causal"], None, True, layout)
                    for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        emit("kernel_vs_plain", case=f"{name}_repeat_bitwise", identical=same, ok=same)
        if not same:
            misses.append(f"{name}_repeat_bitwise")
    if misses:
        emit("kernel_vs_plain", failed=misses)
        sys.exit(1)
    return {"flash_fwd": main_err, "flash_wide_fwd": wide_err}


def _bwd_bound(ref, dtype, ulps=BWD_ULPS):
    ref_max = ref.float().abs().max().item()
    if dtype == torch.float32:
        return ref_max, FP32_BWD_REL * ref_max
    return ref_max, ulps * ulp(ref_max, dtype)


BWD_CASES = (KERNEL_CASES + SCHEDULE_CASES + OPERAND_CASES + DOMAIN_CASES + WIDE_CASES
             + WIDE_HEAD_CASES + FP32_CASES
             + [dict(MAIN, name="dqkv_buffer", layout="qkv", dqkv=True),
                dict(MAIN, name="autograd_fused_qkv", layout="qkv", e2e=True),
                dict(MAIN, name="dh256_autograd_fused_qkv", b=2, h=2, sq=130, sk=130, d=256,
                     layout="qkv", e2e=True),
                dict(MAIN, name="dh320_autograd_fused_qkv", b=2, h=2, sq=130, sk=130, d=320,
                     layout="qkv", e2e=True),
                dict(MAIN, name="dh512_autograd_fused_qkv_causal", b=2, h=2, sq=130, sk=130,
                     d=512, layout="qkv", e2e=True, causal=True)])


def _bwd_case(case, gen, device):
    """(name -> (err, bound, ref_max)) for dq, dk, dv of one case, and the
    launches of the dq and the dk/dv kernels it counted."""
    b, sq, h, d, dtype, causal = (case[k] for k in ("b", "sq", "h", "d", "dtype", "causal"))
    if case.get("e2e"):  # the [B, S, 3·H·Dh] QKV projection output
        qkv = _randn((b, sq, 3 * h * d), dtype, gen, device).requires_grad_()
        x = qkv.detach().reshape(b, sq, 3, h, d)
        q, k, v, layout = x[:, :, 0], x[:, :, 1], x[:, :, 2], "bshd"
    else:
        q, k, v, layout = _case_inputs(case, gen, device)
    t = (lambda x: x.transpose(1, 2)) if layout == "bshd" else (lambda x: x)
    do = _randn((b, sq, h, d) if layout == "bshd" else (b, h, sq, d), dtype, gen, device)
    counters = att._bwd_counters(d)
    before = tuple(c.launches for c in counters)
    if case.get("e2e"):
        out = att.fused_qkv_attention(qkv, num_heads=h, causal=causal)
        out.backward(do.reshape(b, sq, h * d))
        got = qkv.grad.reshape(b, sq, 3, h, d)
        got = (got[:, :, 0], got[:, :, 1], got[:, :, 2])
        o_ref, lse_ref = att.flash_fwd_plain(t(q), t(k), t(v), causal, None, True)
        ref = att.flash_bwd_plain(t(q), t(k), t(v), o_ref, t(do), lse_ref, causal)
        ulps = E2E_ULPS
    else:
        scale = case.get("scale")
        with torch.no_grad():
            o, lse = att.flash_fwd(q, k, v, causal, scale, True, layout)
            out = None
            if case.get("dqkv"):
                dqkv = torch.empty(b, sq, 3, h, d, dtype=dtype, device=device)
                out = (dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2])
            got = att.flash_bwd(q, k, v, o, do, lse, causal, scale, layout, out=out)
            if out is not None and any(g.data_ptr() != w.data_ptr() for g, w in zip(got, out)):
                raise AssertionError("flash_bwd did not write into the given buffers")
            ref = att.flash_bwd_plain(t(q), t(k), t(v), t(o), t(do), lse, causal, scale)
        ulps = BWD_ULPS
    torch.cuda.synchronize()
    launched = tuple(c.launches - n for c, n in zip(counters, before))
    res = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        ref_max, bound = _bwd_bound(r, dtype, ulps)
        res[name] = ((t(g).float() - r.float()).abs().max().item(), bound, ref_max)
    if case.get("one_key"):  # dq and dk: distance from the exact 0
        bounds = one_key_bounds(t(q), t(k), t(v), t(do), case.get("scale"))
        for name, g, r, bound in zip(("dq", "dk"), got, ref, bounds):
            res[name] = (g.float().abs().max().item(), bound, r.float().abs().max().item())
    return res, launched


def one_key_bounds(q, k, v, do, scale=None):
    """ONE_KEY_SLACK's bounds on max|dq| and max|dk| of attention over one
    key ([..., S, Dh] operands, k and v of one row)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else abs(scale)
    e = 2 * d * 2.0 ** -23 * (do.double() * v.double()).abs().sum(-1, keepdim=True)
    dq = ONE_KEY_SLACK * scale * (e * k.double().abs()).amax().item()
    dk = ONE_KEY_SLACK * scale * (e * q.double().abs()).sum(-2).amax().item()
    return dq, dk


def phase_kernel_vs_plain_bwd(device):
    """Returns the max abs error of dq and of dk/dv at the main path's
    layout (the [B, S, 3, H, Dh] gradient buffer)."""
    gen = torch.Generator(device=device).manual_seed(4321)
    misses, main_errs = [], {}
    for case in BWD_CASES:
        res, launched = _bwd_case(case, gen, device)
        want_launches = _bwd_launches(case["d"], case["dtype"])
        ok = (all(math.isfinite(e) and e <= bound for e, bound, _ in res.values())
              and launched == want_launches)
        emit("kernel_vs_plain_bwd", case=case["name"],
             kernels=[c.__name__ for c in att._bwd_counters(case["d"])], launches=list(launched),
             expected_launches=list(want_launches),
             dtype=str(case["dtype"]).replace("torch.", ""),
             shape=dict(b=case["b"], h=case["h"], sq=case["sq"], sk=case["sk"], d=case["d"]),
             causal=case["causal"],
             **{key: case[key] for key in ("scale", "expand") if key in case},
             **{f"{n}_max_abs_err": e for n, (e, _, _) in res.items()},
             **{f"{n}_ref_max_abs": m for n, (_, _, m) in res.items()},
             **{f"{n}_bound": bound for n, (_, bound, _) in res.items()}, ok=ok)
        if not ok:
            misses.append(case["name"])
        if case["name"] == "dqkv_buffer":
            main_errs.update(flash_bwd_dq=res["dq"][0],
                             flash_bwd_dkv=max(res["dk"][0], res["dv"][0]))
        if case["name"] == "dh512":
            main_errs.update(flash_wide_bwd_dq=res["dq"][0],
                             flash_wide_bwd_dkv=max(res["dk"][0], res["dv"][0]))
    # The schedule is static (no atomics, fixed item order): two runs of the
    # main case give the same bits, dq, dk and dv.
    # So are flash_wide.cu's delta, dq and dk/dv kernels, at Dh 320, 512 and
    # 640, and in fp32 at the main shape and Dh 256.
    for name, case in (*((c["name"], c) for c in WIDE_REPEAT_CASES),
                       ("main", dict(MAIN, layout="qkv"))):
        q, k, v, layout = _case_inputs(case, gen, device)
        do = _randn(q.shape, case["dtype"], gen, device)
        with torch.no_grad():
            o, lse = att.flash_fwd(q, k, v, case["causal"], None, True, layout)
            runs = [att.flash_bwd(q, k, v, o, do, lse, case["causal"], None, layout)
                    for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        emit("kernel_vs_plain_bwd", case=f"{name}_repeat_bitwise", identical=same, ok=same)
        if not same:
            misses.append(f"{name}_repeat_bitwise")
    # A thread that has made no CUDA call yet (as autograd's backward thread
    # or a server's worker) gets the same bits from both kernels, at the main
    # shape and at Dh=256 (the column-slab launches).
    wq, wk, wv, wl = _case_inputs(WIDE_CASES[3], gen, device)
    wdo = _randn(wq.shape, MAIN["dtype"], gen, device)
    with torch.no_grad():
        wo, wlse = att.flash_fwd(wq, wk, wv, True, None, True, wl)
        wide = att.flash_bwd(wq, wk, wv, wo, wdo, wlse, True, None, wl)
    got = {}

    def fresh_thread():
        with torch.no_grad():
            got["fwd"] = att.flash_fwd(q, k, v, False, None, True, layout)
            got["bwd"] = att.flash_bwd(q, k, v, o, do, lse, False, None, layout)
            got["wide_fwd"] = att.flash_fwd(wq, wk, wv, True, None, True, wl)
            got["wide_bwd"] = att.flash_bwd(wq, wk, wv, wo, wdo, wlse, True, None, wl)
        torch.cuda.synchronize()

    worker = threading.Thread(target=fresh_thread)
    worker.start()
    worker.join()
    same = ("wide_bwd" in got and all(torch.equal(a, b) for a, b in zip(got["bwd"], runs[0]))
            and torch.equal(got["fwd"][0], o) and torch.equal(got["fwd"][1], lse)
            and all(torch.equal(a, b) for a, b in zip(got["wide_bwd"], wide))
            and torch.equal(got["wide_fwd"][0], wo) and torch.equal(got["wide_fwd"][1], wlse))
    emit("kernel_vs_plain_bwd", case="fresh_thread_bitwise", with_dh256=True, identical=same,
         ok=same)
    if not same:
        misses.append("fresh_thread_bitwise")
    if misses:
        emit("kernel_vs_plain_bwd", failed=misses)
        sys.exit(1)
    return main_errs


# BatchNorm inputs of ResNet-50 v1 at 224x224: (C, H·W) of the 53 layers.
RESNET_BN_SHAPES = ((64, 12544), (64, 3136), (256, 3136), (128, 784), (512, 784), (256, 196),
                    (1024, 196), (512, 49), (2048, 49))
BN_MAIN = [dict(name=f"c{c}_hw{hw}", n=RESNET_B, c=c, hw=hw, dtype=torch.bfloat16, main=True)
           for c, hw in RESNET_BN_SHAPES]
BN_CASES = BN_MAIN + [
    dict(name="fp32_c256_hw3136", n=RESNET_B, c=256, hw=3136, dtype=torch.float32),
    dict(name="fp32_c2048_hw49", n=RESNET_B, c=2048, hw=49, dtype=torch.float32),
    dict(name="fp16_c64_hw3136", n=32, c=64, hw=3136, dtype=torch.float16),
    dict(name="n1", n=1, c=64, hw=3136, dtype=torch.bfloat16),
    dict(name="c1", n=RESNET_B, c=1, hw=196, dtype=torch.bfloat16),
    dict(name="hw1", n=RESNET_B, c=2048, hw=1, dtype=torch.bfloat16),
    dict(name="odd_hw33", n=8, c=12, hw=33, dtype=torch.bfloat16),
    dict(name="odd_hw45_fp32", n=3, c=12, hw=45, dtype=torch.float32),
    dict(name="view_c_stride", n=16, c=64, hw=49, dtype=torch.bfloat16, view="c"),
    dict(name="view_n_stride", n=16, c=256, hw=196, dtype=torch.bfloat16, view="n"),
]


def _bn_input(case, gen, device):
    """x of the case, with a non-zero mean as conv output has; ``view``
    "c" takes every other channel of a wider tensor (C stride 2·HW), "n"
    channels 1..C of a wider one (N stride (C+3)·HW)."""
    n, c, hw, dtype = case["n"], case["c"], case["hw"], case["dtype"]
    view = case.get("view")
    wide = {"c": 2 * c, "n": c + 3}.get(view, c)
    x = (2 * torch.randn((n, wide, hw), generator=gen, device=device) + 0.5).to(dtype)
    return {"c": x[:, ::2], "n": x[:, 1:c + 1]}.get(view, x)


def _ulps(t, dtype):
    """Elementwise spacing of ``dtype``'s values at |t|."""
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 1 - mant)


def _bn_case(case, gen, device):
    x = _bn_input(case, gen, device)
    res = _bn_input(case, gen, device)
    c = case["c"]
    scale = torch.rand(c, generator=gen, device=device) + 0.5
    shift = torch.randn(c, generator=gen, device=device)
    got, again = bn.bn_stats(x), bn.bn_stats(x)
    torch.cuda.synchronize()
    ref = bn.bn_stats_plain(x)
    x32 = x.float()
    abs_sum = x32.abs().sum(dim=(0, 2))
    rec = dict(case=case["name"], dtype=str(case["dtype"]).replace("torch.", ""),
               shape=dict(n=case["n"], c=c, hw=case["hw"]), strides=list(x.stride()),
               stats_deterministic=torch.equal(got, again),
               stats_max_abs_err=(got - ref).abs().max().item(),
               sum_err_over_bound=((got[:, 0] - ref[:, 0]).abs()
                                   / (STATS_REL * abs_sum)).max().item(),
               sumsq_err_over_bound=((got[:, 1] - ref[:, 1]).abs()
                                     / (STATS_REL * ref[:, 1])).max().item())
    prod = (x32 * scale[None, :, None]).abs() + shift.abs()[None, :, None]
    errs = {}
    for relu in (False, True):
        for r in (None, res):
            out = bn.bn_apply(x, scale, shift, residual=r, relu=relu)
            torch.cuda.synchronize()
            want = bn.bn_apply_plain(x, scale, shift, r, relu)
            terms = prod if r is None else prod + r.float().abs()
            bound = _ulps(want, x.dtype) + 2 * _ulps(terms, torch.float32)
            diff = (out.float() - want.float()).abs()
            key = ("bn_apply_res" if r is not None else "bn_apply") + ("_relu" if relu else "")
            errs[key] = (diff.max().item(), (diff / bound).max().item())
    rec.update({f"{k}_max_abs_err": e for k, (e, _) in errs.items()})
    rec.update({f"{k}_err_over_bound": q for k, (_, q) in errs.items()})
    ok = (rec["stats_deterministic"] and rec["sum_err_over_bound"] <= 1
          and rec["sumsq_err_over_bound"] <= 1 and all(q <= 1 for _, q in errs.values()))
    for v in rec.values():
        ok = ok and (not isinstance(v, float) or math.isfinite(v))
    rec["ok"] = ok
    return rec, errs


def phase_kernel_vs_plain_bn(device):
    """Returns the max abs error of each BN kernel over the nine ResNet-50
    shapes (bn_apply without ReLU, as the path calls it)."""
    gen = torch.Generator(device=device).manual_seed(2468)
    misses, main = [], {"bn_stats": 0.0, "bn_apply": 0.0, "bn_apply_res": 0.0}
    with torch.no_grad():
        for case in BN_CASES:
            rec, errs = _bn_case(case, gen, device)
            emit("kernel_vs_plain_bn", stats_bound_rel=STATS_REL, **rec)
            if not rec["ok"]:
                misses.append(case["name"])
            if case.get("main"):
                main["bn_stats"] = max(main["bn_stats"], rec["stats_max_abs_err"])
                main["bn_apply"] = max(main["bn_apply"], errs["bn_apply"][0])
                main["bn_apply_res"] = max(main["bn_apply_res"], errs["bn_apply_res"][0],
                                           errs["bn_apply_res_relu"][0])
    if misses:
        emit("kernel_vs_plain_bn", failed=misses)
        sys.exit(1)
    return main


# The user's kernels against their plain versions.  scale_add, saxpy_block
# and twice: 2x and 0.5x are exact in fp32, so the result is one rounding of
# the exact value on both sides (nvcc contracts 2x + y into an fma, PyTorch
# rounds the exact 2x + y once); the bound is one fp32 ulp of the plain
# result.  minmax: exact.  GELU: both sides compute in fp32 and round once
# to the output type, so they differ by at most one output ulp of the plain
# result, plus what the fp32 arithmetic can move before the rounding: a few
# fp32 roundings of the terms, and erff's error (2 fp32 ulps of erf's value
# near ±1) where 1 + erf cancels in the negative tail.  GELU_FP32_TERM · |x|
# (forward) and GELU_FP32_TERM · |dy|·(1 + |x|) (backward) hold those, with
# GELU_FP32_TERM = 2**-21, four fp32 ulps at 1.  A wrong index, pack or
# rounding moves values by their own size.
GELU_FP32_TERM = 2.0 ** -21
GELU_MAIN = (64, 128, 3072)  # the FFN activation of the BERT-base step: [B, S, 4·768]
GELU_CASES = [
    dict(name="main", shape=GELU_MAIN, dtype=torch.bfloat16, main=True),
    dict(name="ragged_1000003", shape=(1_000_003,), dtype=torch.bfloat16),
    dict(name="fp32_main", shape=GELU_MAIN, dtype=torch.float32),
    dict(name="fp32_ragged_1000003", shape=(1_000_003,), dtype=torch.float32),
    dict(name="offset_2_bytes", shape=(1_000_004,), dtype=torch.bfloat16, offset=1),
]


def _gelu_case(case, gen, device):
    x = 2 * torch.randn(case["shape"], generator=gen, device=device)
    dy = torch.randn(case["shape"], generator=gen, device=device)
    x, dy = x.to(case["dtype"]), dy.to(case["dtype"])
    if case.get("offset"):  # contiguous, not 16-byte aligned: the scalar loop
        x, dy = x[case["offset"]:], dy[case["offset"]:]
    y, dx = GELU_FWD(x), GELU_BWD(x, dy)
    torch.cuda.synchronize()
    x32, dy32 = x.float(), dy.float()
    rec, errs = dict(case=case["name"], shape=list(x.shape),
                     dtype=str(case["dtype"]).replace("torch.", "")), {}
    for name, got, want, term in (
            ("gelu_fwd", y, gelu_plain(x), GELU_FP32_TERM * x32.abs()),
            ("gelu_bwd", dx, gelu_bwd_plain(x, dy),
             GELU_FP32_TERM * dy32.abs() * (1 + x32.abs()))):
        diff = (got.float() - want.float()).abs()
        out_ulp = _ulps(want, case["dtype"])
        errs[name] = diff.max().item()
        rec.update({f"{name}_max_abs_err": errs[name],
                    f"{name}_max_err_ulps": (diff / out_ulp).max().item(),
                    f"{name}_err_over_bound": (diff / (out_ulp + term)).max().item()})
    rec["ok"] = all(math.isfinite(rec[f"{n}_max_abs_err"]) and rec[f"{n}_err_over_bound"] <= 1
                    for n in ("gelu_fwd", "gelu_bwd"))
    return rec, errs


def _raises(fn, exc, match):
    """Whether ``fn()`` raises ``exc`` with ``match`` in its message."""
    try:
        fn()
    except exc as e:
        return match in str(e)
    return False


def phase_kernel_vs_plain_rtc(device):
    """The user's kernels of RTC_SOURCE against their plain versions on the
    card, and the launcher's refusals; returns the GELU kernels' max abs
    error at the path's shape."""
    gen = torch.Generator(device=device).manual_seed(1357)
    misses, main = [], {}

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x, y = rand(16, 128), rand(16, 128)
    xb, yb = rand(32, 128), rand(32, 128)
    x4 = rand(4, 8)
    elementwise = (
        ("scale_add", RTC.get_kernel("scale_add", out_shapes=[(16, 128)], grid=(4,),
                                     block=(256,)).launch([x, y, x.numel()]), 2 * x + y),
        ("saxpy_block", RTC.get_kernel("saxpy_block", out_shapes=[(8 * 4, 128)], grid=(4,),
                                       block=(128,)).launch([xb, yb]), 0.5 * xb + yb),
        ("twice", RTC.get_kernel("twice", out_shapes=[(4, 8)], grid=(1,),
                                 block=(32,)).launch([x4, x4.numel()]), 2 * x4))
    torch.cuda.synchronize()
    for name, got, want in elementwise:
        diff = (got - want).abs()
        ok = bool((diff <= _ulps(want, torch.float32)).all().item())
        emit("kernel_vs_plain_rtc", case=name, shape=list(got.shape), dtype="float32",
             max_abs_err=diff.max().item(), bound="1 fp32 ulp of the plain result", ok=ok)
        if not ok:
            misses.append(name)
    xm = rand(32, 32)
    lo, hi = RTC.get_kernel("minmax", out_shapes=[(1, 1), (1, 1)], grid=(1,),
                            block=(256,)).launch([xm, xm.numel()])
    torch.cuda.synchronize()
    ok = lo.item() == xm.min().item() and hi.item() == xm.max().item()
    emit("kernel_vs_plain_rtc", case="minmax", shape=[32, 32], lo=lo.item(), hi=hi.item(),
         bound="exact", ok=ok)
    if not ok:
        misses.append("minmax")

    for case in GELU_CASES:
        rec, errs = _gelu_case(case, gen, device)
        emit("kernel_vs_plain_rtc", fp32_term=GELU_FP32_TERM, **rec)
        if not rec["ok"]:
            misses.append(case["name"])
        if case.get("main"):
            main = {"rtc_gelu_fwd": errs["gelu_fwd"], "rtc_gelu_bwd": errs["gelu_bwd"]}

    # refusals, each before any launch
    k = RTC.get_kernel("gelu_fwd_bf16", out_shapes=[(64,)], out_dtypes=["bfloat16"], grid=(1,),
                       block=(32,))
    xg = rand(64).bfloat16()
    wide = rand(8, 16).bfloat16()
    lost = RTC.get_kernel("not_extern_c", out_shapes=[(1,)], signature="float* out",
                          grid=(1,), block=(1,))
    refusals = {
        "dtype_mismatch": _raises(lambda: k.launch([xg.float(), 64]), ValueError, "bfloat16"),
        "wrong_arg_count": _raises(lambda: k.launch([xg]), ValueError, "takes 2 arguments"),
        "non_contiguous": _raises(lambda: GELU_FWD(wide[:, ::2]), ValueError, "contiguous"),
        "cpu_tensor": _raises(lambda: k.launch([xg.cpu(), 64]), RuntimeError, "CUDA tensors"),
        "missing_extern_c": _raises(lambda: lost.launch([], ctx=mx.gpu(0)), RuntimeError,
                                    'extern "C"'),
    }
    torch.cuda.synchronize()
    ok = all(refusals.values()) and k.launches == 0 and lost.launches == 0
    emit("kernel_vs_plain_rtc", case="refusals", raised=refusals, launches=k.launches + lost.launches,
         ok=ok)
    if not ok:
        misses.append("refusals")
    if misses:
        emit("kernel_vs_plain_rtc", failed=misses)
        sys.exit(1)
    return main


# The fused optimizer update: one group of mixed sizes (one element, a
# 7-element tail, a bias, a BERT-base FFN weight, its word embedding, and a
# view one element into its buffer: a 2-byte offset for 16-bit weights),
# every variant and weight dtype, three steps (no clip as +inf, a clip, no
# clip as -1).  The kernel computes the plain loop's arithmetic operation
# by operation with no fma contraction: the bound is 0, bit-equal.
MT_SIZES = (1, 7, 768, 3072 * 768, 30522 * 768, 3072)
MT_STEPS = {"sgd": (opt_ops.sgd_step, {}),
            "sgd_mom": (opt_ops.sgd_mom_step, {"momentum": 0.9}),
            "mp_sgd": (opt_ops.mp_sgd_step, {}),
            "mp_sgd_mom": (opt_ops.mp_sgd_mom_step, {"momentum": 0.9}),
            "adam": (opt_ops.adam_step, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
            "mp_adam": (opt_ops.mp_adam_step, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
            "nag_mom": (opt_ops.nag_mom_step, {"momentum": 0.9}),
            "mp_nag_mom": (opt_ops.mp_nag_mom_step, {"momentum": 0.9}),
            "adamw": (opt_ops.adamw_step, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                                           "eta": 0.5}),
            "rmsprop": (opt_ops.rmsprop_step, {"rho": 0.9, "epsilon": 1e-8}),
            "rmspropalex": (opt_ops.rmspropalex_step, {"rho": 0.9, "momentum": 0.9,
                                                       "epsilon": 1e-8})}
# LAMB against its plain version (lamb_update_phase1/2 per tensor): the
# moments are the same operations (bit-equal); the trust ratio's norms are
# summed in another order (torch.linalg.vector_norm against fixed-order
# block partials) and m/(1 - beta1^t) divides where PyTorch may multiply by
# the reciprocal, so each weight element is held to
# |w_kernel - w_plain| <= LAMB_STEP_REL * |w_plain - w_before| + 2 ulp(w_plain).
LAMB_S = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6, "lower_bound": 0.0,
          "upper_bound": 10.0, "bias_correction": 1.0}
LAMB_STEP_REL = 1e-4
# The finite pass against its plain version (torch's fp32 square-sum and
# isfinite count): counts exact, each finite sum within FINITE_SQ_REL of the
# plain one (fp32 within a block, fp64 across blocks, against torch's order).
FINITE_SQ_REL = 1e-5
MT_CLIPS = (math.inf, 0.05, -1.0)


def _mt_group(start, states, dtype):
    """A fresh copy of the group: weights in ``dtype`` (the last one a view
    one element into its buffer) and their fp32 states."""
    ws = [x.to(dtype, copy=True)[1:] if i == len(start) - 1 else x.to(dtype, copy=True)
          for i, x in enumerate(start)]
    return ws, [tuple(t.clone() for t in st) for st in states]


def phase_kernel_vs_plain_multi_tensor(device):
    """Every variant x weight dtype: the group through one launch, through
    launches of 3 tensors (aggregate_num=3), and through the plain loop, on
    the card; all three must agree bit for bit.  Returns the largest
    absolute difference seen."""
    gen = torch.Generator(device=device).manual_seed(77)
    misses, worst = [], 0.0
    n = len(MT_SIZES)
    for variant, (step, extra) in MT_STEPS.items():
        n_states = mt.VARIANTS[variant][1]
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            start = [_randn((m + (i == n - 1),), torch.float32, gen, device)
                     for i, m in enumerate(MT_SIZES)]
            # rmspropalex's n above its g_avg squared, as from zeros: no sqrt of < 0
            floor = [1e-4 if variant == "rmspropalex" and k == 0 else 0.0
                     for k in range(n_states)]
            states = [tuple(torch.rand(m, generator=gen, device=device) * 1e-2 + floor[k]
                            for k in range(n_states)) for m in MT_SIZES]
            one, chunked, plain = (_mt_group(start, states, dtype) for _ in range(3))
            lrs = [1e-2 * (1 + i / 8) for i in range(n)]
            wds = [1e-3 * (i % 2) for i in range(n)]
            launches = mt.multi_tensor_update.launches
            for t, clip in enumerate(MT_CLIPS, 1):
                gbuf = [_randn((m + (i == n - 1),), dtype, gen, device) * 0.1
                        for i, m in enumerate(MT_SIZES)]
                gs = [g[1:] if i == n - 1 else g for i, g in enumerate(gbuf)]
                S = {"rescale": 0.5, "clip": clip, **extra}
                args = (lrs, wds, [t] * n, S)
                opt_ops.group_apply(step, one[0], gs, one[1], *args)
                for a in range(0, n, 3):
                    z = slice(a, a + 3)
                    opt_ops.group_apply(step, chunked[0][z], gs[z], chunked[1][z],
                                        lrs[z], wds[z], [t] * len(chunked[0][z]), S)
                opt_ops.group_apply_plain(step, plain[0], gs, plain[1], *args)
            torch.cuda.synchronize()
            launched = mt.multi_tensor_update.launches - launches
            errs, equal = [], True
            for got in (one, chunked):
                for a, b in zip(got[0] + [x for st in got[1] for x in st],
                                plain[0] + [x for st in plain[1] for x in st]):
                    equal = equal and torch.equal(a, b)
                    errs.append((a.float() - b.float()).abs().max().item())
            err = max(errs)
            worst = max(worst, err)
            ok = equal and launched == 3 * (1 + 2)
            emit("kernel_vs_plain_multi_tensor", variant=variant,
                 dtype=str(dtype).replace("torch.", ""), sizes=list(MT_SIZES),
                 view_offset_bytes=torch.finfo(dtype).bits // 8, steps=len(MT_CLIPS),
                 clips=list(MT_CLIPS), launches=launched, expected_launches=9,
                 bit_equal=equal, max_abs_err=err, bound=0.0, ok=ok)
            if not ok:
                misses.append(f"{variant}_{dtype}")
            del start, states, one, chunked, plain
    if misses:
        emit("kernel_vs_plain_multi_tensor", failed=misses)
        sys.exit(1)
    return worst


def _lamb_bound_ok(got, plain, before):
    """LAMB's element bound (LAMB_STEP_REL): ``(ok, max_abs_err,
    worst ratio of error to bound)``."""
    dtype = plain.dtype
    p, g, b = plain.float(), got.float(), before.float()
    spacing = torch.where(p == 0, torch.zeros_like(p),
                          torch.exp2(torch.floor(torch.log2(p.abs())) -
                                     {torch.bfloat16: 7, torch.float16: 10,
                                      torch.float32: 23}[dtype]))
    bound = LAMB_STEP_REL * (p - b).abs() + 2 * spacing
    err = (g - p).abs()
    ratio = (err / bound.clamp_min(1e-45)).max().item()
    return bool((err <= bound).all().item()), err.max().item(), ratio


def phase_kernel_vs_plain_lamb(device):
    """LAMB (multi_tensor_lamb: two launches a chunk) against the plain
    per-tensor phase 1 and 2, in every weight dtype, on the multi-tensor
    group of mixed sizes (one weight all zeros: ratio 1 at the first step),
    three steps (clip +inf, 0.05, -1): one launch pair for the group and
    launch pairs of 3 tensors must be bit-equal to each other, their
    moments bit-equal to the plain ones and each weight within
    LAMB_STEP_REL.  Returns the largest absolute weight difference."""
    gen = torch.Generator(device=device).manual_seed(78)
    misses, worst = [], 0.0
    n = len(MT_SIZES)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        start = [_randn((m + (i == n - 1),), torch.float32, gen, device)
                 for i, m in enumerate(MT_SIZES)]
        start[1].zero_()
        states = [tuple(torch.rand(m, generator=gen, device=device) * 1e-2 for _ in range(2))
                  for m in MT_SIZES]
        one, chunked, plain = (_mt_group(start, states, dtype) for _ in range(3))
        lrs = [1e-2 * (1 + i / 8) for i in range(n)]
        wds = [1e-2 * (i % 2) for i in range(n)]
        launches = mt.multi_tensor_lamb.launches
        ok, err, ratio = True, 0.0, 0.0
        for t, clip in enumerate(MT_CLIPS, 1):
            gbuf = [_randn((m + (i == n - 1),), dtype, gen, device) * 0.1
                    for i, m in enumerate(MT_SIZES)]
            gs = [g[1:] if i == n - 1 else g for i, g in enumerate(gbuf)]
            S = {"rescale": 0.5, "clip": clip, **LAMB_S}
            args = (lrs, wds, [t] * n, S)
            before = [w.clone() for w in plain[0]]
            opt_ops.group_apply(opt_ops.lamb_step, one[0], gs, one[1], *args)
            for a in range(0, n, 3):
                z = slice(a, a + 3)
                opt_ops.group_apply(opt_ops.lamb_step, chunked[0][z], gs[z], chunked[1][z],
                                    lrs[z], wds[z], [t] * len(chunked[0][z]), S)
            opt_ops.group_apply_plain(opt_ops.lamb_step, plain[0], gs, plain[1], *args)
            torch.cuda.synchronize()
            for got, want, b in zip(one[0], plain[0], before):
                good, e, r = _lamb_bound_ok(got, want, b)
                ok, err, ratio = ok and good, max(err, e), max(ratio, r)
            # restart every copy from the plain weights: one update at a time
            for w, pw in zip(one[0] + chunked[0], plain[0] + plain[0]):
                w.copy_(pw)
        launched = mt.multi_tensor_lamb.launches - launches
        chunks_equal = all(torch.equal(a, b) for a, b in zip(
            [x for st in one[1] for x in st], [x for st in chunked[1] for x in st]))
        moments_equal = all(torch.equal(a, b) for a, b in zip(
            [x for st in one[1] for x in st], [x for st in plain[1] for x in st]))
        good = ok and chunks_equal and moments_equal and launched == 3 * 2 * (1 + 2)
        worst = max(worst, err)
        emit("kernel_vs_plain_multi_tensor", variant="lamb", dtype=str(dtype).replace(
            "torch.", ""), sizes=list(MT_SIZES), steps=len(MT_CLIPS), clips=list(MT_CLIPS),
             launches=launched, expected_launches=18, moments_bit_equal=moments_equal,
             chunked_bit_equal=chunks_equal, max_abs_err=err, worst_err_over_bound=ratio,
             bound=f"|dw| <= {LAMB_STEP_REL} * |step| + 2 ulp", ok=good)
        if not good:
            misses.append(f"lamb_{dtype}")
        del start, states, one, chunked, plain
    if misses:
        emit("kernel_vs_plain_multi_tensor", failed=misses)
        sys.exit(1)
    return worst


def phase_kernel_vs_plain_finite(device):
    """The finite pass (sum_sq_finite: one launch a chunk) against its plain
    version on the group of mixed sizes in every dtype, with NaN and inf
    elements in some tensors and, in fp32 and bf16, a finite value whose
    square overflows: counts exact, sums within FINITE_SQ_REL (NaN and inf
    where the plain sum is); then ``all_finite`` and ``multi_sum_sq``
    through ``mx.nd``.  Returns the largest relative sum difference."""
    gen = torch.Generator(device=device).manual_seed(79)
    misses, worst = [], 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xs = [_randn((m,), dtype, gen, device) for m in MT_SIZES]
        cases = {"finite": [x.clone() for x in xs]}
        bad = [x.clone() for x in xs]
        bad[0][0] = float("nan")
        bad[3][5] = float("inf")
        bad[3][77] = float("-inf")
        bad[4][123456] = float("nan")
        if dtype != torch.float16:
            bad[2][3] = 1e20  # finite; its fp32 square is inf
        cases["nan_inf"] = bad
        for label, ts in cases.items():
            launches = mt.sum_sq_finite.launches
            sq, cnt = mt.sum_sq_finite(ts)
            psq, pcnt = opt_ops.sum_sq_finite_plain(ts)
            torch.cuda.synchronize()
            launched = mt.sum_sq_finite.launches - launches
            counts_equal = torch.equal(cnt.cpu(), pcnt.cpu())
            a, b = sq.cpu().double(), psq.cpu().double()
            fin = torch.isfinite(b)
            same_nonfinite = torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
                torch.isinf(a), torch.isinf(b))
            rel = ((a[fin] - b[fin]).abs() / b[fin].abs().clamp_min(1e-30)).max().item()
            worst = max(worst, rel)
            via_nd = (bool(mx.nd.all_finite(*ts).item()) == (label == "finite")
                      and torch.equal(mx.nd.multi_sum_sq(*ts).cpu().isnan(), a.isnan()))
            ok = (counts_equal and same_nonfinite and rel <= FINITE_SQ_REL and launched == 1
                  and via_nd)
            emit("kernel_vs_plain_multi_tensor", variant="finite", case=label,
                 dtype=str(dtype).replace("torch.", ""), sizes=list(MT_SIZES),
                 nonfinite_counts=cnt.tolist(), plain_counts=pcnt.tolist(),
                 counts_equal=counts_equal, nonfinite_sums_agree=same_nonfinite,
                 max_rel_err=rel, bound=FINITE_SQ_REL, launches=launched, expected_launches=1,
                 nd_ops_agree=via_nd, ok=ok)
            if not ok:
                misses.append(f"finite_{label}_{dtype}")
    if misses:
        emit("kernel_vs_plain_multi_tensor", failed=misses)
        sys.exit(1)
    return worst


# -- phase 4 ----------------------------------------------------------------


def _requests(batches, vocab, gen, device):
    out = []
    for b, s, p in batches:
        ids = torch.randint(0, vocab, (b, s), generator=gen, device=device, dtype=torch.int32)
        types = torch.randint(0, 2, (b, s), generator=gen, device=device, dtype=torch.int32)
        pos = torch.randint(0, s, (b, p), generator=gen, device=device, dtype=torch.int32)
        out.append((ids, types, pos))
    return out


def _build_net(cfg, ctx, dtype):
    mx.random.seed(0)
    if "units" in cfg:
        base = bert_zoo.BERTModel(**cfg)
    else:
        base = bert_zoo.bert_base(**cfg)
    net = bert_zoo.BERTForPretrain(base, vocab_size=cfg["vocab_size"])
    net.initialize(ctx=ctx)
    if dtype != "float32":
        net.cast(dtype)
    return net


def phase_slice(rehearsal):
    """Returns (net, main_batch, forwards) for the timing phase."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    num_layers = cfg.get("num_layers", 12)
    net = _build_net(cfg, None if not rehearsal else ctx, "bfloat16")
    gen = torch.Generator(device=device).manual_seed(7)
    batches = [(64, 128, 20)] * 3 + [(8, 512, 80)]
    if rehearsal:
        batches = [(4, 16, 3)] * 3 + [(2, 64, 8)]
    reqs = _requests(batches, cfg["vocab_size"], gen, device)

    reset_kernel_counts()
    outs = []
    with mx.autograd.predict_mode():
        for ids, types, pos in reqs:
            outs.append(net(ids, types, pos))
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = kernel_counts()

    for (b, s, p), (mlm, nsp) in zip(batches, outs):
        shapes_ok = (tuple(mlm.shape) == (b, p, cfg["vocab_size"]) and tuple(nsp.shape) == (b, 2))
        finite = bool(torch.isfinite(mlm).all().item() and torch.isfinite(nsp).all().item())
        emit("slice", request=dict(b=b, s=s, p=p), mlm_shape=list(mlm.shape),
             nsp_shape=list(nsp.shape), dtype=str(mlm.dtype).replace("torch.", ""),
             shapes_ok=shapes_ok, finite=finite)
        if not (shapes_ok and finite):
            sys.exit(1)
    want = 0 if rehearsal else num_layers * len(reqs)
    emit("slice", launches=counts, expected_flash_fwd=want, forwards=len(reqs))
    if counts != {n: want if n == "flash_fwd" else 0 for n in ENTRIES}:
        sys.exit(1)

    # the same weights, fp32, through the port on the CPU
    arrays = {k: p.data().detach().float().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}
    ref_net = _build_net(cfg, mx.cpu(), "float32")
    load_numpy_params(ref_net, arrays)
    small = _requests([(2, 128 if not rehearsal else 16, 20 if not rehearsal else 3)],
                      cfg["vocab_size"], gen, device)[0]
    with mx.autograd.predict_mode():
        got = net(*small)
        ref = ref_net(*(x.cpu() for x in small))
    for name, g, r in zip(("mlm_logits", "nsp_logits"), got, ref):
        err = (g.float().cpu() - r).abs().max().item()
        scale = r.abs().max().item()
        rel = err / scale
        ok = math.isfinite(rel) and rel <= SLICE_REL_BOUND
        emit("slice_vs_cpu_fp32", output=name, max_abs_err=err, ref_max_abs=scale,
             rel_err=rel, bound=SLICE_REL_BOUND, ok=ok)
        if not ok:
            sys.exit(1)
    return net, reqs[0], counts


# -- phase 5 ----------------------------------------------------------------


def _train_batch(cfg, b, s, p, gen, device):
    ids, types, pos = _requests([(b, s, p)], cfg["vocab_size"], gen, device)[0]
    labels = torch.randint(0, cfg["vocab_size"], (b, p), generator=gen, device=device,
                           dtype=torch.int32)
    return ids, types, pos, labels


def train_step(net, trainer, batch, train_mode=True):
    """One pretraining step as a user writes it (the loss of bench.py's
    ``mlm_loss``); returns the per-sample loss."""
    ids, types, pos, labels = batch
    with mx.autograd.record(train_mode=train_mode):
        mlm, _ = net(ids, types, pos)
        loss = streaming_softmax_ce(mlm, labels).mean(-1)
    mx.autograd.backward(loss)
    if trainer is not None:
        trainer.step(ids.shape[0])
    return loss


def phase_train(rehearsal):
    """BERT-base pretraining steps on one fixed device-resident batch;
    returns (net, trainer, batch, counts of one step)."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    num_layers = cfg.get("num_layers", 12)
    b, s, p = (4, 16, 3) if rehearsal else (64, 128, 20)
    net = _build_net(cfg, ctx, "bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4, "multi_precision": True})
    batch = _train_batch(cfg, b, s, p, torch.Generator(device=device).manual_seed(11), device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    losses = [train_step(net, trainer, batch).mean().item() for _ in range(2)]  # warm-up
    reset_kernel_counts()
    before = fused_counts()
    losses.append(train_step(net, trainer, batch).mean().item())  # syncs on .item()
    counts = kernel_counts()
    fused_ok = _optimizer_check("train", net, before, "mp_adam", rehearsal)
    losses += [train_step(net, trainer, batch).mean().item() for _ in range(9)]
    sync()
    finite = all(math.isfinite(x) for x in losses)
    falling = losses[-1] < losses[0]
    want = {n: num_layers if n in FLASH and not rehearsal else 0 for n in ENTRIES}
    want["multi_tensor"] = 0 if rehearsal else 1
    emit("train", model="BERTForPretrain(bert_base) bf16, Adam multi_precision, dropout 0.1"
         if not rehearsal else "tiny BERT bf16 (CPU rehearsal)", b=b, s=s, p=p,
         losses=losses, finite=finite, falling=falling, launches_one_step=counts,
         expected=want)
    if not (finite and falling and fused_ok) or counts != want:
        sys.exit(1)
    return net, trainer, batch, counts


def _rel_l2(grads, ref):
    """{key: |g − r| / |r|} per parameter."""
    out = {}
    for key, r in ref.items():
        rn, dn = r.norm().item(), (grads[key] - r).norm().item()
        out[key] = dn / rn if rn > 0 else (0.0 if dn == 0 else math.inf)
    return out


def _card_grads(net):
    return {k: p.grad().detach().float().cpu().clone()
            for k, p in net._collect_params_with_prefix().items()}


def phase_train_vs_cpu(net, rehearsal):
    """The card's bf16 gradients against the port's fp32 gradients on the
    CPU, same weights, dropout off; relative L2 error per parameter.
    Returns (batch, the CPU's gradients, the card's gradients)."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    device = next(iter(net.collect_params().values())).data().device
    gen = torch.Generator(device=device).manual_seed(13)
    batch = _train_batch(cfg, 2, 16 if rehearsal else 128, 3 if rehearsal else 20, gen, device)
    arrays = {k: p.data().detach().float().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}
    ref_net = _build_net(cfg, mx.cpu(), "float32")
    load_numpy_params(ref_net, arrays)
    train_step(net, None, batch, train_mode=False)
    train_step(ref_net, None, tuple(x.cpu() for x in batch), train_mode=False)
    got = _card_grads(net)
    ref = {k: p.grad() for k, p in ref_net._collect_params_with_prefix().items()}
    if not _grad_check("train_vs_cpu_fp32", got, ref):
        sys.exit(1)
    return batch, ref, got


def _grad_check(phase, got, ref, **extra):
    """Emit the per-parameter relative L2 errors of ``got`` against ``ref``
    and whether each is within GRAD_REL_BOUND."""
    rels = _rel_l2(got, ref)
    worst = sorted(((rel, k) for k, rel in rels.items()), reverse=True)
    bad = [k for k, rel in rels.items() if not (math.isfinite(rel) and rel <= GRAD_REL_BOUND)]
    emit(phase, b=2, params=len(worst), bound=GRAD_REL_BOUND,
         worst=[[k, rel] for rel, k in worst[:6]], median_rel=worst[len(worst) // 2][0],
         failed=bad, ok=not bad, **extra)
    return not bad


def phase_rtc_train(net, trainer, train_batch, vs_cpu, rehearsal):
    """The slice-2 BERT-base step with each FFN activation the user's
    ``rtc_gelu`` CustomOp (``gelu_fwd`` forward, ``gelu_bwd`` backward, on
    the net's own weights and Trainer).  First the gradients of the batch
    and weights of ``train_vs_cpu`` (``vs_cpu`` = (batch, CPU fp32
    gradients, the card's built-in-GELU gradients)) against the CPU's,
    within GRAD_REL_BOUND, and beside the built-in step's; then training
    steps, with the launches counted around exactly one.  Returns those
    counts."""
    batch, ref, builtin = vs_cpu
    num_layers = (TINY_BERT if rehearsal else BERT_BASE).get("num_layers", 12)
    with rtc_gelu_ffn(net) as n_ffn:
        train_step(net, None, batch, train_mode=False)
        got = _card_grads(net)
        vs_builtin = _rel_l2(got, builtin)
        ok = _grad_check("rtc_train_vs_cpu_fp32", got, ref, ffn_swapped=n_ffn,
                         vs_card_builtin_gelu_median_rel=sorted(vs_builtin.values())[
                             len(vs_builtin) // 2],
                         vs_card_builtin_gelu_max_rel=max(vs_builtin.values()))
        if not ok or n_ffn != num_layers:
            sys.exit(1)
        losses = [train_step(net, trainer, train_batch).mean().item() for _ in range(2)]
        reset_kernel_counts()
        RtcGelu.plain_calls = 0
        before = fused_counts()
        losses.append(train_step(net, trainer, train_batch).mean().item())  # syncs on .item()
        counts, plain_calls = kernel_counts(), RtcGelu.plain_calls
        fused_ok = _optimizer_check("rtc_train", net, before, "mp_adam", rehearsal)
        losses += [train_step(net, trainer, train_batch).mean().item() for _ in range(3)]
    finite = all(math.isfinite(x) for x in losses)
    falling = losses[-1] < losses[0]
    on_card = {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rtc_gelu_fwd", "rtc_gelu_bwd"}
    want = {n: num_layers if n in on_card and not rehearsal else 0 for n in ENTRIES}
    want["multi_tensor"] = 0 if rehearsal else 1
    want_plain = 2 * num_layers if rehearsal else 0
    b, s, p = train_batch[0].shape[0], train_batch[0].shape[1], train_batch[2].shape[1]
    emit("rtc_train", model="BERTForPretrain(bert_base) bf16, Adam multi_precision, dropout "
         "0.1, FFN activation = the user's rtc_gelu CustomOp" if not rehearsal
         else "tiny BERT bf16 (CPU rehearsal), FFN activation = rtc_gelu", b=b, s=s, p=p,
         losses=losses, finite=finite, falling=falling, launches_one_step=counts,
         expected=want, plain_gelu_calls_one_step=plain_calls, expected_plain=want_plain)
    if not (finite and falling and fused_ok) or counts != want or plain_calls != want_plain:
        sys.exit(1)
    return counts


# -- phase 5b ---------------------------------------------------------------


def _tests_module(name):
    """A helper module of ``tests/`` that imports neither package."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    return importlib.import_module(name)


def _nd_cases():
    """The op table of ``tests/nd_op_cases.py`` (numpy only)."""
    return _tests_module("nd_op_cases")


def _fresh_bert(cfg):
    """An uninitialized BERTForPretrain of ``cfg``'s configuration."""
    base = bert_zoo.BERTModel(**cfg) if "units" in cfg else bert_zoo.bert_base(**cfg)
    return bert_zoo.BERTForPretrain(base, vocab_size=cfg["vocab_size"])


def _nd_request(req, ctx):
    """A request's token ids, types and positions as a user makes them:
    host arrays through ``mx.nd.array(..., ctx=, dtype="int32")``."""
    return [mx.nd.array(x.cpu().numpy(), ctx=ctx, dtype="int32") for x in req]


def _nd_save_load(net, cfg, ctx, rehearsal):
    """The slice phase's net saved with ``save_parameters`` (``.params`` and
    ``.npz``), loaded into a fresh net on the card and cast to bf16; its
    NDArray answers to the slice phase's three requests bit-equal to the
    saved net's tensors, and 12 flash_fwd launches around one request."""
    device = ctx.device
    num_layers = cfg.get("num_layers", 12)
    batches = [(4, 16, 3)] * 3 if rehearsal else [(64, 128, 20)] * 3
    reqs = _requests(batches, cfg["vocab_size"], torch.Generator(device=device).manual_seed(7),
                     device)
    with mx.autograd.predict_mode():
        want = [[o.float().cpu().numpy() for o in net(*req)] for req in reqs]
    nd_reqs = [_nd_request(req, ctx) for req in reqs]
    out_dir = Path(__file__).resolve().parent / "build" / "nd_surface"
    out_dir.mkdir(parents=True, exist_ok=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ok = True
    for ext in ("params", "npz"):
        path = out_dir / f"bert.{ext}"
        t0 = time.perf_counter()
        net.save_parameters(str(path))
        write_s = time.perf_counter() - t0
        fresh = _fresh_bert(cfg)
        sync()
        t0 = time.perf_counter()
        fresh.load_parameters(str(path), ctx=ctx)
        fresh.cast("bfloat16")
        sync()
        load_s = time.perf_counter() - t0
        equal, outputs_nd = True, True
        with mx.autograd.predict_mode():
            for req, ref in zip(nd_reqs, want):
                outs = fresh(*req)
                mx.nd.waitall()
                outputs_nd &= all(isinstance(o, mx.nd.NDArray) and o.context == ctx for o in outs)
                equal &= all(o.shape == r.shape and (o.asnumpy() == r).all()
                             for o, r in zip(outs, ref))
            reset_kernel_counts()
            fresh(*nd_reqs[0])
            mx.nd.waitall()
        launches = kernel_counts()["flash_fwd"]
        want_launches = 0 if rehearsal else num_layers
        case_ok = equal and outputs_nd and launches == want_launches
        emit("nd_surface", part="save_load", file=path.name, bytes=path.stat().st_size,
             write_s=write_s, load_and_cast_s=load_s, requests=len(reqs),
             logits_bit_equal=equal, outputs_ndarray_on_ctx=outputs_nd,
             flash_fwd_one_request=launches, expected_flash_fwd=want_launches, ok=case_ok)
        ok &= case_ok
        del fresh
        path.unlink()
    return ok


def _nd_step(net, trainer, batch):
    """One pretraining step as an MXNet user writes it: NDArrays in, the
    loss on NDArrays, ``loss.backward()``, ``trainer.step``."""
    ids, types, pos, labels = batch
    with mx.autograd.record():
        mlm, _ = net(ids, types, pos)
        loss = mx.nd.invoke(streaming_softmax_ce, (mlm, labels), {}).mean(axis=-1)
    loss.backward()
    trainer.step(ids.shape[0])
    return loss


def _nd_training(cfg, ctx, rehearsal):
    """Two dropout-free copies with the same weights: copy A takes two steps
    on tensors (``train_step``), copy B two in the MXNet idiom on NDArrays;
    parameters, Adam states and losses bit-equal (deterministic mode), the
    kernels' launches counted around exactly one NDArray step.  Then the
    eager step of each in turns (A, B, B, A)."""
    device = ctx.device
    num_layers = cfg.get("num_layers", 12)
    b, s, p = (4, 16, 3) if rehearsal else (64, 128, 20)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    copy_cfg = dict(cfg, dropout=0.0)

    def make():
        net = _build_net(copy_cfg, ctx, "bfloat16")
        return net, mx.gluon.Trainer(net.collect_params(), "adam",
                                     {"learning_rate": 1e-4, "multi_precision": True})

    batch = _train_batch(cfg, b, s, p, torch.Generator(device=device).manual_seed(11), device)
    nd_batch = _nd_request(batch, ctx)
    with _deterministic(True):
        (net_a, tr_a), (net_b, tr_b) = make(), make()
        with mx.autograd.predict_mode():  # materialize the deferred shapes
            net_a(*batch[:3])
            net_b(*batch[:3])
        for pa, pb in zip(net_a.collect_params().values(), net_b.collect_params().values()):
            pb.set_data(pa.data())
        loss_a = [train_step(net_a, tr_a, batch).detach() for _ in range(2)]
        loss_b = [_nd_step(net_b, tr_b, nd_batch)._data.detach()]
        reset_kernel_counts()
        before = fused_counts()
        loss_b.append(_nd_step(net_b, tr_b, nd_batch)._data.detach())
        sync()
        counts = kernel_counts()
        fused_ok = _optimizer_check("nd_surface", net_b, before, "mp_adam", rehearsal)
    params = [[p.data().detach() for p in n.collect_params().values()] for n in (net_a, net_b)]
    p_eq, p_err = _compare(*params)
    s_eq, s_err = _compare(_flat_states(tr_a), _flat_states(tr_b))
    l_eq, l_err = _compare(loss_a, loss_b)
    want = {n: num_layers if n in FLASH and not rehearsal else 0 for n in ENTRIES}
    want["multi_tensor"] = 0 if rehearsal else 1
    ok = p_eq and s_eq and l_eq and fused_ok and counts == want
    emit("nd_surface", part="training_idiom", b=b, s=s, p=p, steps=2,
         params_bit_equal=p_eq, params_max_abs_diff=p_err, adam_states_bit_equal=s_eq,
         states_max_abs_diff=s_err, losses_bit_equal=l_eq, losses_max_abs_diff=l_err,
         losses_tensor=[x.mean().item() for x in loss_a],
         losses_ndarray=[x.mean().item() for x in loss_b],
         launches_one_ndarray_step=counts, expected=want, ok=ok)

    def timed(step):
        sync()
        t0 = time.perf_counter()
        for _ in range(ND_TIMED_STEPS):
            step()
        sync()
        return (time.perf_counter() - t0) / ND_TIMED_STEPS * 1e3

    turns = {"tensor": [], "ndarray": []}
    steps = {"tensor": lambda: train_step(net_a, tr_a, batch),
             "ndarray": lambda: _nd_step(net_b, tr_b, nd_batch)}
    for which in steps.values():
        which()  # leave deterministic mode's kernels behind
    for which in ("tensor", "ndarray", "ndarray", "tensor"):
        turns[which].append(timed(steps[which]))
    emit("nd_surface", part="eager_step_turns", device=str(device),
         note=None if device.type == "cuda" else "CPU rehearsal: host time, not a device metric",
         steps_a_turn=ND_TIMED_STEPS, order="tensor, ndarray, ndarray, tensor",
         tensor_step_ms=turns["tensor"], ndarray_step_ms=turns["ndarray"],
         ndarray_over_tensor=sum(turns["ndarray"]) / sum(turns["tensor"]))
    del net_a, net_b, tr_a, tr_b
    return ok


def _nd_outputs(case, C, ctx):
    """The case's outputs through ``mx.nd`` on ``ctx`` (a list) and the
    number of input elements."""
    r = C.rng_for(case.id)
    arrays = case.inputs(r)
    kwarrays = {k: v.maker(r) for k, v in case.kwargs.items() if isinstance(v, C.A)}
    with ctx:
        xs = [mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
        if case.dtypes:
            xs = [x.astype(d) if d else x for x, d in zip(xs, case.dtypes)]
        kw = dict(case.kwargs)
        kw.update({k: mx.nd.array(v, ctx=ctx, dtype=v.dtype) for k, v in kwarrays.items()})
        out = getattr(mx.nd, case.op)(*xs, **kw)
    n = sum(a.size for a in arrays) + sum(a.size for a in kwarrays.values())
    return (list(out) if isinstance(out, (list, tuple)) else [out]), bool(arrays), n


def _held_ratio(case, C, got, ref, n):
    """|card − CPU| over the case's bound (0 when equal, inf on a shape,
    dtype or non-finite mismatch)."""
    if tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype:
        return math.inf
    g, r = got.detach().cpu().double(), ref.detach().double()
    same_nan = torch.isnan(g) == torch.isnan(r)
    finite = torch.isfinite(r)
    if not (bool(same_nan.all()) and bool((g[~finite & ~torch.isnan(r)] ==
                                          r[~finite & ~torch.isnan(r)]).all())):
        return math.inf
    err = (g[finite] - r[finite]).abs().max().item() if bool(finite.any()) else 0.0
    if err == 0.0:
        return 0.0
    if case.card == "exact" or not got.is_floating_point():
        return math.inf
    scale = r[finite].abs().max().item()
    units = C.ULPS if case.card == "ulp" else C.REDUCE_ULPS * n
    return err / (units * torch.finfo(got.dtype).eps * scale)


def _nd_op_table(ctx, rehearsal):
    """Every case of the CPU parity table and of the op library's table
    (``LIBRARY_CASES``) once on ``ctx``'s NDArrays, held to the port's CPU
    result (a ``decomp`` case by reconstruction and up to sign); every
    sampler's 10^6 draws (10^5 in the rehearsal) to its distribution's mean
    and variance within ND_MOMENT_SE standard errors."""
    C = _nd_cases()
    by_src, failed = {}, []
    for case in C.CASES + C.LIBRARY_CASES:
        ref, _, n = _nd_outputs(case, C, mx.cpu())
        got, has_inputs, _ = _nd_outputs(case, C, ctx)
        placed = [(isinstance(g, mx.nd.NDArray) and g.context == ctx) if has_inputs else
                  (g._data if isinstance(g, mx.nd.NDArray) else g).device.type == ctx.device.type
                  for g in got]
        if case.card == "decomp":
            as64 = lambda outs: [o._data.detach().double().cpu().numpy() for o in outs]  # noqa
            ratio = (C.decomp_ratio(case, case.inputs(C.rng_for(case.id)), as64(got), as64(ref),
                                    C.REDUCE_ULPS * n) if all(placed) else math.inf)
        else:
            ratio = 0.0
            for g, r, ok in zip(got, ref, placed):
                gt = g._data if isinstance(g, mx.nd.NDArray) else g
                rt = r._data if isinstance(r, mx.nd.NDArray) else r
                ratio = max(ratio, _held_ratio(case, C, gt, rt, n) if ok else math.inf)
        rec = by_src.setdefault(case.src, {"cases": 0, "held": 0, "worst": 0.0, "worst_case": None})
        rec["cases"] += 1
        if len(got) == len(ref) and ratio <= 1.0:
            rec["held"] += 1
        else:
            failed.append([case.id, ratio])
        if ratio >= rec["worst"]:
            rec["worst"], rec["worst_case"] = ratio, case.id
    n_draw = 100_000 if rehearsal else 1_000_000
    rec = by_src.setdefault("random_ops", {"cases": 0, "held": 0, "worst": 0.0,
                                           "worst_case": None})
    for s in C.SAMPLERS:
        with ctx:
            args = [mx.nd.array(a, ctx=ctx) for a in s.args(n_draw)]
            out = getattr(mx.nd, s.op)(*args, **s.kwargs(n_draw))
        t = out._data if isinstance(out, mx.nd.NDArray) else out
        worst = 0.0 if t.device.type == ctx.device.type else math.inf
        if s.moments is None:  # shuffle: a permutation of arange(n)
            worst = worst if torch.equal(t.sort().values, torch.arange(
                n_draw, dtype=t.dtype, device=t.device)) else math.inf
        else:
            rows = t.double().reshape(len(s.moments), -1)
            for row, (mu, var) in zip(rows, s.moments):
                m = row.mean()
                v = row.var()
                m4 = ((row - m) ** 4).mean()
                k = row.numel()
                se_m, se_v = math.sqrt(var / k), math.sqrt(max((m4 - v * v).item(), 0.0) / k)
                worst = max(worst, abs(m.item() - mu) / (ND_MOMENT_SE * se_m),
                            abs(v.item() - var) / (ND_MOMENT_SE * se_v))
        rec["cases"] += 1
        if worst <= 1.0:
            rec["held"] += 1
        else:
            failed.append([s.id, worst])
        if worst >= rec["worst"]:
            rec["worst"], rec["worst_case"] = worst, s.id
    bound = ("exact, %d ulps (arithmetic), %d·n ulps (reductions) of the case's largest "
             "|value|" % (C.ULPS, C.REDUCE_ULPS))
    bounds = {"random_ops": f"mean and variance of {n_draw} draws within {ND_MOMENT_SE} "
                            "standard errors",
              "linalg": bound + "; decompositions: L·Q and Uᵀ·diag(λ)·U against A, Q's rows "
                                "orthonormal, U's rows up to sign, within %d·n ulps"
                                % C.REDUCE_ULPS}
    for src, r in by_src.items():
        emit("nd_surface", part="op_table", source=("ops/attention.py (interleaved)"
                                                    if src == "interleaved" else f"ops/{src}.py"),
             cases=r["cases"], held=r["held"], worst_err_over_bound=r["worst"],
             worst_case=r["worst_case"], bound=bounds.get(src, bound),
             ok=r["held"] == r["cases"])
    emit("nd_surface", part="op_table", failed=failed, ok=not failed)
    return not failed


def phase_nd_surface(net, rehearsal):
    """Phase 5b: the ``mx.nd`` surface on the slice phase's net (save and
    load), two fresh copies (the MXNet training idiom against the tensor
    path) and the op table; exits non-zero on any miss.  Frees its nets."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    t0 = time.perf_counter()
    ok = _nd_save_load(net, cfg, ctx, rehearsal)
    ok &= _nd_training(cfg, ctx, rehearsal)
    ok &= _nd_op_table(ctx, rehearsal)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    emit("nd_surface", phase_s=time.perf_counter() - t0, ok=ok)
    if not ok:
        sys.exit(1)


# -- phase 5c: serving ------------------------------------------------------

# serve: the served model's bf16 answers against the fp32 tier's, in the
# slice phase's units (0.1 of the largest |logit|, SLICE_REL_BOUND).
SERVE_BUCKETS_TIMED = (1, 8, 64)
SERVE_QUEUE_MS = 200.0  # long enough for one dispatch of 64 submissions
SERVE_BURST = (4, 160)  # submitter threads, requests each
SERVE_TIMED = 10        # forwards a bucket's time averages


def _sym_bert():
    return _tests_module("sym_bert")


def _serve_inputs(req):
    """A request batch as the serving tier takes it: host int32 arrays."""
    return dict(zip(("token_ids", "token_types", "masked_positions"),
                    (x.cpu().numpy() for x in req)))


def _predict(pred, inputs):
    """``pred``'s outputs on the batch ``inputs`` (rebinding as needed)."""
    pred.reshape({k: v.shape for k, v in inputs.items()})
    for k, v in inputs.items():
        pred.set_input(k, v)
    return pred.forward().get_outputs()


def _padded(inputs, n, bucket):
    """The first ``n`` rows of ``inputs`` padded with zero rows to ``bucket``,
    as the server pads a partial batch."""
    out = {}
    for k, v in inputs.items():
        buf = np.zeros((bucket,) + v.shape[1:], v.dtype)
        buf[:n] = v[:n]
        out[k] = buf
    return out


def _rows_equal(answers, outs, rows):
    """Every answer (a list of per-sample outputs) equal to row i of the
    batch outputs."""
    return all(np.array_equal(a, o[i]) for ans, i in zip(answers, rows)
               for a, o in zip(ans, outs))


def _served(srv, samples):
    return [p.result(timeout=120.0) for p in [srv.submit(s) for s in samples]]


def _forward_ms(fn, iters, sync):
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


# In some processes on the card kineto leaves the first record of a kind
# of kernel out of every CUDA trace from late in the run on (ROADMAP §3 "Not
# faults"): a trace that counts kernels runs one call of its work first,
# then this sentinel kernel, and counts what follows the sentinel only.
SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel
SENTINEL_CYCLES = 1000
# (what, {kernel: records the warm-up call lacked against a counted call}):
# the traces whose warm-up call came back short
WARM_SHORT = []


# Sentinel kernels a counting trace launches first, each a record of its
# own: in some processes kineto leaves the first records of every session
# out of its window (ROADMAP §3 "Not faults"; PR 19 saw more than one lost
# a session), and these take that loss instead of the counted work.
LEAD_KERNELS = 8


def _lead():
    for _ in range(LEAD_KERNELS):
        torch.cuda._sleep(SENTINEL_CYCLES)
    torch.cuda.synchronize()


def _split_at_sentinel(prof):
    """(records up to the last sentinel, records after it) of ``prof``'s
    CUDA activity in start order; (None, None) if the trace lost every
    sentinel."""
    recs = sorted((ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda ev: ev.time_range.start)
    at = max((i for i, ev in enumerate(recs) if SENTINEL in ev.name), default=None)
    return (None, None) if at is None else (recs[:at], recs[at + 1:])


def _note_warm_short(what, warm, per_call):
    """Record the kernels the warm-up call's records lack against
    ``per_call`` ({name: records a counted call holds})."""
    have = {}
    for ev in warm:
        have[ev.name[:90]] = have.get(ev.name[:90], 0) + 1
    short = {n: c - have.get(n, 0) for n, c in per_call.items() if have.get(n, 0) < c}
    if short:
        WARM_SHORT.append((what, short))


def _busy_share(fn, warm=False, lead=False):
    """One call of ``fn`` under torch.profiler: (wall ms, kernel ms, copy ms,
    kernel busy share, kernel records by name); the work of every thread
    counts, and memory copies are kept apart from kernels.  CUDA activity
    only: a session that also traced the CPU over the server's threads made
    every later CUDA-only trace of the process drop 3-5 kernel records (so
    each ``_time`` row fell back to CUDA events), on the card.  With
    ``warm`` the session first runs ``fn`` once and the sentinel, and counts
    the call after them (an empty count if the sentinel's record is lost);
    with ``lead`` it first launches the lead sentinels (``_lead``) and
    counts what follows the last one that survived."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if lead:
            _lead()
        if warm:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(SENTINEL_CYCLES)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if warm or lead:
        before, events = _split_at_sentinel(prof)
        if not warm:  # the lead alone: no warm-up call to compare
            before = None
            events = list(prof.events()) if events is None else events
    else:
        before, events = None, list(prof.events())
    names = {}
    kernel_us = copy_us = 0.0
    for ev in events or ():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name.startswith("mx."):
            continue
        if ev.name.startswith(("Memcpy", "Memset")):
            copy_us += ev.time_range.elapsed_us()
            continue
        kernel_us += ev.time_range.elapsed_us()
        names[ev.name] = names.get(ev.name, 0) + 1
    if before is not None:
        per_call = {}
        for n, c in names.items():
            per_call[n[:90]] = per_call.get(n[:90], 0) + c
        _note_warm_short(getattr(fn, "__qualname__", repr(fn)), before, per_call)
    return (wall_us * 1e-3, kernel_us * 1e-3, copy_us * 1e-3,
            kernel_us / wall_us if kernel_us else None, names)


def _count_named(names, sub):
    return sum(n for name, n in names.items() if sub in name)


def phase_serve(net, main_req, rehearsal, smi=None):
    """Phase 8: the serving path — ``mx.sym`` BERT saved as ``-symbol.json``
    and ``.params``, ``Predictor`` in fp32, ``InferenceServer`` in bf16, on
    the slice phase's weights.  Returns the launch counts of one fp32
    forward and one served bf16 batch.  Exits non-zero on any miss."""
    from incubator_mxnet_torch import amp, profiler
    from incubator_mxnet_torch.predictor import Predictor, load_checkpoint
    from incubator_mxnet_torch.serving import InferenceServer

    cfg = TINY_BERT if rehearsal else BERT_BASE
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    # on the card the entry points get no dev_type: the card is their default
    device_kw = {"dev_type": "cpu"} if rehearsal else {}
    cuda = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    layers = cfg.get("num_layers", 12)
    t_phase = time.perf_counter()
    ok = True
    b, s = main_req[0].shape
    p = main_req[2].shape[1]
    inputs = _serve_inputs(main_req)
    spec = {k: v.shape[1:] for k, v in inputs.items()}
    sym = _sym_bert().bert_symbol(
        mx.sym, cfg.get("num_layers", 12), cfg.get("units", 768), cfg.get("hidden_size", 3072),
        cfg.get("num_heads", 12), cfg["vocab_size"], s, p, names=(net.bert.prefix, net.prefix),
        max_length=cfg["max_length"])

    # 1. the checkpoint: the slice phase's weights in fp32
    out_dir = Path(__file__).resolve().parent / "build" / "serve"
    out_dir.mkdir(parents=True, exist_ok=True)
    json_path, params_path = out_dir / "bert-symbol.json", out_dir / "bert-0000.params"
    t0 = time.perf_counter()
    sym.save(str(json_path))
    weights = {"arg:" + k: mx.nd.array(v.data().detach().float(), ctx=ctx)
               for k, v in net.collect_params().items()}
    mx.nd.save(str(params_path), weights)
    write_s = time.perf_counter() - t0
    param_bytes = sum(v._data.numel() * 4 for v in weights.values())
    emit("serve", part="checkpoint", symbol_bytes=json_path.stat().st_size,
         params_bytes=params_path.stat().st_size, fp32_param_bytes=param_bytes,
         nodes=len(sym._topo()), write_s=write_s)

    # 2. fp32 tier: Predictor with no dev_type (the card; the CPU in the
    # rehearsal) against the Gluon fp32 forward of the same weights.  The
    # process's first op on meta tensors (shape inference) imports
    # torch._dynamo: timed apart from the load.
    t0 = time.perf_counter()
    (torch.empty(2, 2, device="meta") ** 2).mean(-1)
    first_meta_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred32 = Predictor(str(json_path), str(params_path),
                       {k: v.shape for k, v in inputs.items()}, **device_kw)
    load_s = time.perf_counter() - t0
    gluon32 = _build_net(cfg, ctx, "float32")
    load_numpy_params(gluon32, {k: v.data().detach().float().cpu().numpy()
                                for k, v in net._collect_params_with_prefix().items()})
    with _deterministic(True):
        for k, v in inputs.items():
            pred32.set_input(k, v)
        sync()
        reset_kernel_counts()
        pred32.forward()
        sync()
        fp32_counts = kernel_counts()
        got32 = pred32.get_outputs()
        with mx.autograd.predict_mode():
            ref32 = [o.float().cpu().numpy() for o in gluon32(*main_req)]
    del gluon32
    bit_equal = all(np.array_equal(g, r) for g, r in zip(got32, ref32))
    want_counts = {n: (layers if n == "flash_fwd" and cuda else 0) for n in ENTRIES}
    # the kernels one forward ran, by name, from a trace (the forward after
    # a warm-up forward and the sentinel); a trace that holds another call's
    # records is taken again, three times at most
    traced = None
    want_traced = {"flash_wide_fwd_f32_rows": layers, "flash_fwd_tma": 0}
    t0 = time.perf_counter()
    warm_short = len(WARM_SHORT)
    if cuda:
        traced = []
        for _ in range(3):
            *_, names = _busy_share(lambda: pred32.forward(), warm=True)
            traced.append({k: _count_named(names, k) for k in want_traced})
            if traced[-1] == want_traced:
                break
    trace_ok = traced is None or traced[-1] == want_traced
    trace_s = time.perf_counter() - t0
    # one weight copy: rebinding B=8 and back allocates the input
    # placeholders only, and every executor holds the store's tensors
    mem = torch.cuda.memory_allocated if cuda else (lambda: 0)
    stats0 = pred32.compile_stats()
    m0 = mem()
    small = {k: v[:8 if b > 8 else b // 2] for k, v in inputs.items()}
    pred32.reshape({k: v.shape for k, v in small.items()})
    m1 = mem()
    for k, v in small.items():
        pred32.set_input(k, v)
    pred32.forward()
    sync()
    exe8 = pred32._exe
    m2 = mem()  # the B=8 forward's own outputs are not a bind's
    pred32.reshape({k: v.shape for k, v in inputs.items()})
    m3 = mem()
    stats1 = pred32.compile_stats()
    shared = all(exe8.arg_dict[n] is pred32._exe.arg_dict[n] is pred32._arg_store[n]
                 for n in pred32._arg_store)
    bind_bytes = (m1 - m0) + (m3 - m2)
    one_copy = shared and bind_bytes < 0.01 * param_bytes
    binds_ok = (stats0 == {"executors": 1, "fwd_entries": 1}
                and stats1 == {"executors": 2, "fwd_entries": 2})
    fp32_ok = bit_equal and fp32_counts == want_counts and trace_ok and one_copy and binds_ok
    emit("serve", part="fp32_predictor", b=b, s=s, p=p, first_meta_op_s=first_meta_s,
         load_s=load_s,
         logits_bit_equal_gluon_fp32=bit_equal,
         max_abs_diff=[float(np.abs(g - r).max()) for g, r in zip(got32, ref32)],
         launches_one_forward=fp32_counts, expected=want_counts, traced_kernels=traced,
         warm_up_forward_short=[short for _, short in WARM_SHORT[warm_short:]], trace_s=trace_s,
         bind_bytes_b8=m1 - m0, bind_bytes_back=m3 - m2, param_bytes=param_bytes,
         params_shared_by_object=shared, compile_stats_before=stats0, compile_stats_after=stats1,
         ok=fp32_ok)
    ok &= fp32_ok

    # 3. bf16 tier: the server against a Predictor over amp.convert_model
    # of the same checkpoint at bucket 64, on the same rows
    t0 = time.perf_counter()
    srv = InferenceServer(str(json_path), str(params_path), spec,
                          input_dtypes={k: "int32" for k in spec}, max_batch_size=b,
                          max_queue_ms=SERVE_QUEUE_MS, amp_dtype="bfloat16", name="bert",
                          **device_kw)
    start_s = time.perf_counter() - t0
    warm_stats = srv.compile_stats()
    csym, cargs, cauxs = amp.convert_model(*load_checkpoint(str(json_path), str(params_path)),
                                           target_dtype="bfloat16")
    pred16 = Predictor(csym, {**{"arg:" + k: v for k, v in cargs.items()},
                              **{"aux:" + k: v for k, v in cauxs.items()}},
                       {k: v.shape for k, v in inputs.items()}, **device_kw)
    ref16 = _predict(pred16, inputs)
    samples = [{k: v[i] for k, v in inputs.items()} for i in range(b)]
    reset_kernel_counts()
    full = _served(srv, samples)
    sync()
    bf16_counts = kernel_counts()
    full_equal = _rows_equal(full, ref16, range(b))
    part_n = min(40, b - 1) if not rehearsal else 3
    bucket = srv._batch_bucketer.bucket_for(part_n)
    batches0 = srv.stats()["batches"]
    partial = _served(srv, samples[:part_n])
    ref_pad = _predict(pred16, _padded(inputs, part_n, bucket))
    partial_equal = _rows_equal(partial, ref_pad, range(part_n))
    one_batch = srv.stats()["batches"] - batches0 == 1
    rel = []
    for i, ans in enumerate(full):
        for a, o32 in zip(ans, got32):
            rel.append(float(np.abs(a - o32[i]).max() / np.abs(o32[i]).max()))
    want16 = {n: (layers if n == "flash_fwd" and cuda else 0) for n in ENTRIES}
    # the kernels of one served batch, from a trace of the batch after a
    # warm-up batch and the sentinel ("batches": the two calls')
    traced16, busy = None, None
    want_traced16 = {"flash_fwd_tma": layers, "flash_wide": 0, "batches": 2}
    t0 = time.perf_counter()
    if cuda:
        traced16 = []
        for _ in range(3):
            batches = srv.stats()["batches"]
            wall_ms, kernel_ms, copy_ms, share, names = _busy_share(lambda: _served(srv, samples),
                                                                    warm=True, lead=True)
            traced16.append({"flash_fwd_tma": _count_named(names, "flash_fwd_tma"),
                             "flash_wide": _count_named(names, "flash_wide"),
                             "batches": srv.stats()["batches"] - batches})
            busy = {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "copy_ms": copy_ms,
                    "kernel_busy_share": share}
            if traced16[-1] == want_traced16:
                break
    trace16_ok = traced16 is None or traced16[-1] == want_traced16
    trace16_s = time.perf_counter() - t0
    bf16_ok = (full_equal and partial_equal and one_batch and bf16_counts == want16
               and trace16_ok and max(rel) <= SLICE_REL_BOUND)
    emit("serve", part="bf16_server", start_and_warmup_s=start_s, warm_buckets=len(srv._warm),
         warm_compile_stats=warm_stats, full_batch_bit_equal_predictor=full_equal,
         partial=part_n, padded_to=bucket, partial_one_batch=one_batch,
         partial_bit_equal_padded_predictor=partial_equal, launches_one_batch=bf16_counts,
         expected=want16, traced_kernels=traced16, trace_s=trace16_s, one_batch_profile=busy,
         max_rel_err_vs_fp32=max(rel), bound=SLICE_REL_BOUND, ok=bf16_ok)
    ok &= bf16_ok

    # 4. a burst (reported), and the steady-state gates
    threads_n, per = SERVE_BURST if not rehearsal else (2, 8)
    lat0 = len(srv._latencies)
    st0 = srv.stats()
    errors = []

    def submitter(t):
        try:
            pend = [srv.submit(samples[(t * per + j) % b]) for j in range(per)]
            for q in pend:
                q.result(timeout=120.0)
        except Exception as e:  # noqa: BLE001 — counted and gated below
            errors.append(repr(e))

    workers = [threading.Thread(target=submitter, args=(t,)) for t in range(threads_n)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    burst_s = time.perf_counter() - t0
    st1 = srv.stats()
    lats = list(srv._latencies)[lat0:]
    n_batches = st1["batches"] - st0["batches"]
    emit("serve", part="burst", threads=threads_n, requests=threads_n * per,
         started_s_into_phase=t0 - t_phase,
         samples_per_s=threads_n * per / burst_s, seconds=burst_s, batches=n_batches,
         mean_batch=(st1["batch_requests"] - st0["batch_requests"]) / max(1, n_batches),
         latency_ms_p50=profiler.percentile(lats, 0.50),
         latency_ms_p99=profiler.percentile(lats, 0.99), card=smi)
    timed = {}
    for name, pr in (("fp32", pred32), ("bf16", pred16)):
        for bb in SERVE_BUCKETS_TIMED if not rehearsal else (1, b):
            rows = {k: v[:bb] for k, v in inputs.items()}
            pr.reshape({k: v.shape for k, v in rows.items()})
            for k, v in rows.items():
                pr.set_input(k, v)
            timed[f"{name}_b{bb}_ms"] = _forward_ms(pr.forward, SERVE_TIMED, sync)
    with mx.autograd.predict_mode():
        timed[f"gluon_bf16_b{b}_ms"] = _forward_ms(lambda: net(*main_req), SERVE_TIMED, sync)
    emit("serve", part="forward_ms", per="one Predictor.forward (host walk and device work, "
         "closed by a synchronize); the Gluon net's forward beside it", **timed, card=smi)
    final = srv.stats()
    gates = {"bucket_miss_after_warmup": final["bucket_miss_after_warmup"],
             "failed": final["failed"], "submit_errors": len(errors),
             "compile_stats_unchanged": srv.compile_stats() == warm_stats}
    gates_ok = gates == {"bucket_miss_after_warmup": 0, "failed": 0, "submit_errors": 0,
                         "compile_stats_unchanged": True}
    prov = profiler.metrics_snapshot()["providers"].get("bert", {})
    prom = profiler.render_prometheus()
    metrics_ok = (prov.get("latency_ms_p99") is not None
                  and prov.get("latency_ms_p50") is not None and "mxnet_bert_" in prom)
    srv.close(drain=True)
    gone = "bert" not in profiler.metrics_snapshot()["providers"]
    emit("serve", part="steady_state", gates=gates, errors=errors[:3],
         provider_latency_ms_p50=prov.get("latency_ms_p50"),
         provider_latency_ms_p99=prov.get("latency_ms_p99"),
         prometheus_bert_lines=sum(line.startswith("mxnet_bert_") for line in prom.splitlines()),
         provider_gone_after_close=gone, ok=gates_ok and metrics_ok and gone)
    ok &= gates_ok and metrics_ok and gone

    # 5. free the nets and the files
    pred32.close()
    pred16.close()
    del pred32, pred16, srv, weights, cargs, cauxs
    json_path.unlink()
    params_path.unlink()
    if cuda:
        torch.cuda.empty_cache()
    emit("serve", phase_s=time.perf_counter() - t_phase, ok=ok)
    if not ok:
        sys.exit(1)
    return {"serve_fp32_forward": fp32_counts, "serve_bf16_batch": bf16_counts}


# -- phase 9: generation serving ------------------------------------------------

# transformer-big at bench.py:400-421's widths and vocabulary (units 1024, 16
# heads, FFN 4096, 6+6 layers, vocabulary 32768, max_length 512), random
# weights from --seed, dropout off; the bf16 tier cast as bench.py:429-432
# casts.  Nothing is cut.
GEN_CFG = dict(vocab_size=32768, max_length=512, dropout=0.0)
TINY_GEN = dict(vocab_size=64, units=32, hidden_size=64, num_heads=2, num_encoder_layers=2,
                num_decoder_layers=2, max_length=256, dropout=0.0)
GEN_BOS, GEN_EOS = 1, 2
GEN_FWD = (2, 64)         # the teacher-forced forward: B, S (source and target)
GEN_GREEDY = (4, 32, 32)  # greedy_search: B, source length, new tokens
GEN_SERVER = dict(max_prompt_length=128, max_new_tokens=128, slots_per_bucket=8)
GEN_TRAFFIC = (64, 4)     # requests, submitter threads
GEN_STATIC = 16           # of those requests, the first this many again in static mode
GEN_PROMPTS = (4, 128)    # prompt lengths, uniform, inclusive
GEN_BUDGETS = (8, 128)    # max_new_tokens, uniform, inclusive
GEN_PREFILL_PROBE = 100   # the prompt length of the counted and traced prefill
# A cached greedy step against the uncached re-run of the prefix, both bf16,
# as a share of the step's largest |logit| (per row).  The two compute the
# same function through other shapes (a [B, 1] step against a [B, Tb]
# causal forward: other GEMM shapes, one query row against a causal tile),
# so their fp32 sums run in other orders and each bf16 rounding (unit
# roundoff 2**-8) can fall either way; the encoder's memory is the same
# tensor in both, so only the 6 decoder layers differ, half the 12 layers
# whose compounded bf16 error SLICE_REL_BOUND (0.1) bounds against fp32.
# A wrong cache position, view or mask moves the logits by their own order.
GEN_STEP_REL = 5e-2
# The margin rule: where two logit vectors differ by at most e per entry,
# their argmaxes agree wherever the top-two margin of either exceeds 2·e.  So
# tokens must be equal at every step where the reference's top-two margin
# exceeds GEN_MARGIN_FACTOR times the step bound.
GEN_MARGIN_FACTOR = 2.0


def gen_workload(n, prompts, budgets, vocab, seed):
    """``benchmark/opperf/generation.py``'s ``make_workload`` draws, at
    this phase's ranges: prompt lengths, then each prompt's tokens, then
    the budgets, from one ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    ps = [rng.randint(3, vocab, int(n_)).astype(np.int32)
          for n_ in rng.randint(prompts[0], prompts[1] + 1, size=n)]
    return ps, rng.randint(budgets[0], budgets[1] + 1, size=n).tolist()


def _top2_margin(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _margin_check(ref_logits, got_next, bound):
    """One step's margin rule over rows: (rows checked, rows whose next
    token differs from the reference's argmax where the reference's
    top-two margin exceeds GEN_MARGIN_FACTOR·bound)."""
    ref = np.asarray(ref_logits, np.float64)
    sure = _top2_margin(ref) > GEN_MARGIN_FACTOR * bound
    bad = sure & (ref.argmax(-1) != np.asarray(got_next))
    return int(sure.sum()), int(bad.sum())


def _gen_net(cfg, ctx, seed, dtype="float32", arrays=None):
    from incubator_mxnet_torch.gluon.model_zoo import transformer as tzoo

    mx.random.seed(seed)
    net = (tzoo.Transformer(**cfg) if "units" in cfg else tzoo.transformer_big(**cfg))
    if arrays is None:
        net.initialize(ctx=ctx)
        one = torch.ones((1, 8), dtype=torch.int32, device=ctx.device)
        net(one, one[:, :1])  # materialize the deferred shapes
    else:
        load_numpy_params(net, arrays, ctx=ctx)
    if dtype != "float32":
        net.cast(dtype)
    return net


def _traced_count(fn, name, want, tries=3):
    """The records of kernels named ``name`` in a CUDA trace of ``fn``, the
    call after a warm-up call and the sentinel (taken again while short of
    ``want``, three times at most)."""
    got = []
    for _ in range(tries):
        *_, names = _busy_share(fn, warm=True, lead=True)
        got.append(_count_named(names, name))
        if got[-1] == want:
            break
    return got


def phase_generation(rehearsal, seed=0, smi=None):
    """Phase 9: generation serving — transformer-big in bf16 (fp32 for the
    reference forward) through the teacher-forced forward, ``greedy_search``
    with and without the KV cache, and ``GenerationServer`` (continuous and
    static).  Returns the launch counts of its paths.  Exits non-zero on
    any miss."""
    from incubator_mxnet_torch import profiler
    from incubator_mxnet_torch.gluon.model_zoo import transformer as tzoo
    from incubator_mxnet_torch.serving import GenerationServer

    cfg = TINY_GEN if rehearsal else GEN_CFG
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    layers = cfg.get("num_decoder_layers", 6)
    vocab = cfg["vocab_size"]
    t_phase = time.perf_counter()
    ok = True
    paths = {}
    rng = np.random.RandomState(seed)

    def ids(shape):
        return torch.from_numpy(rng.randint(3, vocab, shape).astype(np.int32)).to(device)

    # 1. the nets: fp32 from the seed, a bf16 copy of its weights, and (for
    # the reference forward) a CPU fp32 copy
    t0 = time.perf_counter()
    net32 = _gen_net(cfg, ctx, seed)
    arrays = {k: p.data().detach().cpu().numpy()
              for k, p in net32._collect_params_with_prefix().items()}
    net16 = _gen_net(cfg, ctx, seed, "bfloat16", arrays)
    n_params = sum(a.size for a in arrays.values())
    emit("generation", part="nets", params=n_params, bf16_param_bytes=2 * n_params,
         build_s=time.perf_counter() - t0)

    # 2. the teacher-forced forward: 6 encoder, 6 causal, 6 cross launches
    b, s = (2, 8) if rehearsal else GEN_FWD
    src, tgt = ids((b, s)), ids((b, s))
    want = {n: (3 * layers if n == "flash_fwd" and cuda else 0) for n in ENTRIES}
    with mx.autograd.predict_mode():
        sync()
        reset_kernel_counts()
        y32 = net32(src, tgt)
        sync()
        c32 = kernel_counts()
        reset_kernel_counts()
        y16 = net16(src, tgt)
        sync()
        paths["generation_forward"] = c16 = kernel_counts()
        yc = _gen_net(cfg, mx.cpu(), seed, arrays=arrays)(src.cpu(), tgt.cpu())
    y32, y16 = y32.float().cpu(), y16.float().cpu()
    ref_max = float(yc.abs().max())
    err32 = float((y32 - yc).abs().max()) / ref_max
    err16 = float((y16 - y32).abs().max()) / float(y32.abs().max())
    traced = (_traced_count(lambda: net16(src, tgt), "flash_fwd_tma", 3 * layers)
              if cuda else None)
    fwd_ok = (math.isfinite(err32) and err32 <= FP32_SLICE_REL_BOUND and math.isfinite(err16)
              and err16 <= SLICE_REL_BOUND and c32 == want and c16 == want
              and tuple(y16.shape) == (b, s, vocab)
              and (traced is None or traced[-1] == 3 * layers))
    emit("generation", part="forward", b=b, s=s, rel_err_fp32_card_vs_cpu=err32,
         fp32_bound=FP32_SLICE_REL_BOUND, rel_err_bf16_vs_fp32=err16, bf16_bound=SLICE_REL_BOUND,
         launches_fp32=c32, launches_bf16=c16, expected=want, traced_flash_fwd_tma=traced,
         ok=fwd_ok)
    ok &= fwd_ok
    del net32, y32, y16, yc

    # 3. greedy_search with the cache against the re-run of the prefix
    gb, gs, new = (2, 6, 6) if rehearsal else GEN_GREEDY
    gsrc = ids((gb, gs))
    tok_c, len_c = tzoo.greedy_search(net16, gsrc, GEN_BOS, GEN_EOS, max_length=new + 1)
    tok_u, len_u = tzoo.greedy_search(net16, gsrc, GEN_BOS, GEN_EOS, max_length=new + 1,
                                      use_cache=False)
    mem = net16.encode(gsrc)
    cache = tzoo._KVCacheDecoder(net16, mem, gb, new + 2)
    worst, checked, flips, free_run_ok = 0.0, 0, 0, True
    diverged = np.zeros(gb, bool)
    for t in range(new):
        if t == 0:
            sync()
            reset_kernel_counts()
        lc = cache.step(tok_u[:, t], t)
        if t == 0:
            sync()
            paths["generation_cached_step"] = step_counts = kernel_counts()
        with torch.no_grad():
            lu = tzoo._host_logits(tzoo._step_logits(
                net16, tzoo._tokens(tok_u[:, :tzoo._bucket(t + 1, new + 1)], device), mem, t))
        live = tok_u[:, t] != GEN_EOS if t else np.ones(gb, bool)
        bound = GEN_STEP_REL * np.abs(lu).max(-1)
        err = np.abs(lc - lu).max(-1) / np.abs(lu).max(-1)
        worst = max(worst, float(err[live].max()) if live.any() else 0.0)
        n, bad = _margin_check(lu[live], lc[live].argmax(-1), bound[live])
        checked, flips = checked + n, flips + bad
        # the free-running cached run equals the uncached one up to each
        # row's first step whose margin is within the rule
        diverged |= ~(_top2_margin(lu) > GEN_MARGIN_FACTOR * bound) & live
        free_run_ok &= bool(((tok_c[:, t + 1] == tok_u[:, t + 1]) | diverged | ~live).all())
    step_want = {n: (2 * layers if n == "flash_fwd" and cuda else 0) for n in ENTRIES}
    traced_step = (_traced_count(lambda: cache.step(tok_u[:, new - 1], new), "flash_fwd_tma",
                                 2 * layers) if cuda else None)
    greedy_ok = (worst <= GEN_STEP_REL and flips == 0 and free_run_ok
                 and step_counts == step_want
                 and (traced_step is None or traced_step[-1] == 2 * layers))
    emit("generation", part="greedy_cache_vs_rerun", b=gb, src_len=gs, new_tokens=new,
         max_rel_step_err=worst, step_bound=GEN_STEP_REL, margin_rule_factor=GEN_MARGIN_FACTOR,
         steps_checked_by_margin=checked, token_flips_where_sure=flips,
         free_run_equal_until_unsure=free_run_ok, tokens_equal=bool((tok_c == tok_u).all()),
         lengths_equal=bool((len_c == len_u).all()), launches_one_step=step_counts,
         expected=step_want, traced_flash_fwd_tma=traced_step, ok=greedy_ok)
    ok &= greedy_ok
    del cache, mem

    # 4. GenerationServer: warm-up, the programs traced from this thread,
    # then traffic from submitter threads (each scheduler thread's launches
    # come after every trace of this phase)
    srv_kw = (dict(max_prompt_length=16, max_new_tokens=16, slots_per_bucket=2) if rehearsal
              else GEN_SERVER)
    n_req, n_thr = (8, 2) if rehearsal else GEN_TRAFFIC
    lo_p = min(GEN_PROMPTS[0], srv_kw["max_prompt_length"])
    prompts, budgets = gen_workload(n_req, (lo_p, srv_kw["max_prompt_length"]),
                                    (min(GEN_BUDGETS[0], srv_kw["max_new_tokens"]),
                                     srv_kw["max_new_tokens"]), vocab, seed)
    profiler.set_config(compile_guard="raise")
    c_start = profiler.counters()
    t0 = time.perf_counter()
    srv = GenerationServer(net16, bos=GEN_BOS, eos=GEN_EOS, name="gen_smoke", **srv_kw)
    start_s = time.perf_counter() - t0
    warm = srv.compile_stats()
    pools = srv.stats()["pools"]
    top = max(pools)
    probe = np.resize(prompts[0], min(GEN_PREFILL_PROBE, srv_kw["max_prompt_length"]))
    probe_len, lb = len(probe), srv._prompt_bucketer.bucket_for(len(probe))
    probe_src = np.zeros((1, lb), np.int32)
    probe_src[0, :probe_len] = probe
    dec_in = dict(tok=np.full(pools[top]["slots"], 3, np.int32),
                  pos=np.arange(pools[top]["slots"], dtype=np.int32),
                  mem_len=np.full(pools[top]["slots"], probe_len, np.int32))

    def prefill():
        return srv._prefill_exe.run(f"prefill_{lb}", src=probe_src, src_len=np.int32(probe_len))

    def decode():
        return srv._exes[top].run("decode", **dec_in)

    traced_prefill = _traced_count(prefill, "flash_fwd", layers) if cuda else None
    traced_decode = _traced_count(decode, "flash", 0) if cuda else None
    step = {}
    if cuda:
        wall_ms, kernel_ms, copy_ms, share, _ = _busy_share(decode)
        logits = decode()
        sync()
        t0 = time.perf_counter()
        host = logits.float().cpu().numpy()
        copy_host_ms = (time.perf_counter() - t0) * 1e3
        step = dict(pool=top, slots=pools[top]["slots"], decode_wall_ms=wall_ms,
                    decode_kernel_ms=kernel_ms, decode_copy_ms=copy_ms,
                    decode_kernel_busy_share=share, logits_copy_ms=copy_host_ms,
                    logits_bytes=host.nbytes)
    emit("generation", part="server_programs", start_and_warmup_s=start_s,
         warm_compile_stats={k: v for k, v in warm.items() if k == "compiles"},
         prompt_buckets=list(srv._prompt_bucketer.buckets),
         kv_cache_bytes_by_pool={bk: p["nbytes"] for bk, p in pools.items()},
         slots_by_pool={bk: p["slots"] for bk, p in pools.items()},
         traced_prefill_flash_fwd=traced_prefill, prefill_shape=dict(bucket=lb, src_len=probe_len),
         traced_decode_flash=traced_decode, **step, card=smi)
    programs_ok = (traced_prefill is None or (traced_prefill[-1] == layers
                                               and traced_decode[-1] == 0))

    # one request through the server, counted: one prefill and its decode
    # steps, which launch no kernel
    sync()
    reset_kernel_counts()
    c0 = profiler.counters()
    one = srv.submit(probe, max_new_tokens=8).result(timeout=300.0)
    sync()
    paths["generation_server_request"] = req_counts = kernel_counts()
    c1 = profiler.counters()
    n_prefill = c1["generation_prefill"] - c0["generation_prefill"]
    n_steps = c1["generation_decode_iter"] - c0["generation_decode_iter"]
    req_want = {n: (layers if n == "flash_fwd" and cuda else 0) for n in ENTRIES}
    counted_ok = n_prefill == 1 and n_steps == len(one) and req_counts == req_want
    emit("generation", part="server_launches", prompt_len=probe_len, tokens=len(one),
         prefills=n_prefill, decode_steps=n_steps, launches_one_request=req_counts,
         expected=req_want, per="one prefill (a launch an encoder layer) and its decode "
         "steps (plain PyTorch, no launch)", ok=counted_ok and programs_ok)
    ok &= counted_ok and programs_ok

    # 5. the traffic: n_req requests from n_thr threads, continuous batching
    # (the first n of them from n_thr threads into ``server``)
    def burst(server, n):
        out, errors = [None] * n, []

        def submitter(k):
            try:
                pend = [(i, server.submit(prompts[i], max_new_tokens=int(budgets[i])))
                        for i in range(k, n, n_thr)]
                for i, r in pend:
                    out[i] = (r.result(timeout=600.0), r)
            except Exception as e:  # noqa: BLE001 — counted and gated below
                errors.append(repr(e))

        workers = [threading.Thread(target=submitter, args=(k,)) for k in range(n_thr)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        return out, errors, time.perf_counter() - t0

    # the server's default mode: PyTorch's deterministic algorithms off, as a
    # user runs it (every pool computes at the ladder top's width, so a
    # request's bits do not depend on its pool or its batch)
    c0 = profiler.counters()
    served, errors, burst_s = burst(srv, n_req)
    c1 = profiler.counters()
    ok_served = [x for x in served if x is not None]
    toks = sum(len(t) for t, _ in ok_served)
    ttft = [r.ttft_ms for _, r in ok_served if r.ttft_ms is not None]
    tpot = [r.tpot_ms for _, r in ok_served if r.tpot_ms is not None]
    d_iter = c1["generation_decode_iter"] - c0["generation_decode_iter"]
    emit("generation", part="burst", mode="continuous", requests=n_req, threads=n_thr,
         seconds=burst_s, tokens=toks, tokens_per_s=toks / burst_s,
         ttft_ms_p50=profiler.percentile(ttft, 0.50),
         ttft_ms_p99=profiler.percentile(ttft, 0.99),
         tpot_ms_p50=profiler.percentile(tpot, 0.50),
         tpot_ms_p99=profiler.percentile(tpot, 0.99), decode_steps=d_iter,
         mean_decode_batch=(c1["generation_token"] - c0["generation_token"]) / max(1, d_iter),
         joins_by_pool={bk: p["joins"] for bk, p in srv.stats()["pools"].items()},
         deterministic_algorithms=torch.are_deterministic_algorithms_enabled(),
         errors=errors[:3], card=smi)
    # every request against itself decoded alone
    t0 = time.perf_counter()
    alone = [srv.submit(p, max_new_tokens=int(n_)).result(timeout=600.0)
             for p, n_ in zip(prompts, budgets)]
    alone_s = time.perf_counter() - t0
    equal = [x is not None and np.array_equal(x[0], a) for x, a in zip(served, alone)]
    # one request against greedy_search under the margin rule, teacher-
    # forced along the server's tokens
    p0 = prompts[0]
    gt, gl = tzoo.greedy_search(net16, torch.from_numpy(p0[None]).to(device), GEN_BOS,
                                GEN_EOS, max_length=int(budgets[0]) + 1)
    ref_cache = tzoo._KVCacheDecoder(net16, net16.encode(torch.from_numpy(p0[None])
                                                         .to(device)), 1,
                                     int(budgets[0]) + 1)
    seq = np.concatenate([[GEN_BOS], alone[0]]).astype(np.int32)
    g_checked = g_flips = 0
    for t in range(len(alone[0])):
        lr = ref_cache.step(seq[t:t + 1], t)
        n, bad = _margin_check(lr, seq[t + 1:t + 2],
                               GEN_STEP_REL * np.abs(lr).max(-1))
        g_checked, g_flips = g_checked + n, g_flips + bad
    static = GenerationServer(net16, bos=GEN_BOS, eos=GEN_EOS, name="gen_smoke_static",
                              batching="static", **srv_kw)
    st_warm = static.compile_stats()
    c0 = profiler.counters()
    n_static = min(GEN_STATIC, n_req)
    st_served, st_errors, st_s = burst(static, n_static)
    c1 = profiler.counters()
    st_equal = [x is not None and np.array_equal(x[0], a) for x, a in zip(st_served, alone)]
    st_iter = c1["generation_decode_iter"] - c0["generation_decode_iter"]
    st_toks = sum(len(t) for t, _ in st_served if t is not None) if st_served else 0
    emit("generation", part="burst", mode="static", requests=n_static, threads=n_thr,
         seconds=st_s, tokens=st_toks, tokens_per_s=st_toks / st_s, decode_steps=st_iter,
         mean_decode_batch=(c1["generation_token"] - c0["generation_token"]) / max(1, st_iter),
         errors=st_errors[:3], card=smi)
    final = srv.compile_stats()
    st_final = static.compile_stats()
    failed = sum(t["failed"] for sv in (srv, static) for t in sv.stats()["tenants"].values())
    c_end = profiler.counters()
    gates = {"served_equal_alone": sum(equal), "static_equal_alone": sum(st_equal),
             "greedy_margin_flips": g_flips, "builds_after_warmup":
                 final["compiles"] - warm["compiles"],
             "static_builds_after_warmup": st_final["compiles"] - st_warm["compiles"],
             "recompile_steady_state": c_end["recompile_steady_state"]
                 - c_start["recompile_steady_state"],
             "failed": failed, "submit_errors": len(errors) + len(st_errors)}
    want_gates = {"served_equal_alone": n_req, "static_equal_alone": n_static,
                  "greedy_margin_flips": 0, "builds_after_warmup": 0,
                  "static_builds_after_warmup": 0, "recompile_steady_state": 0, "failed": 0,
                  "submit_errors": 0}
    prov = profiler.metrics_snapshot()["providers"].get("gen_smoke", {})
    srv.close(drain=True)
    static.close(drain=True)
    profiler.disarm_compile_guard()
    profiler.set_config(compile_guard=None)
    gone = "gen_smoke" not in profiler.metrics_snapshot()["providers"]
    gates_ok = gates == want_gates and gone and prov.get("tenant_default_completed", 0) > 0
    emit("generation", part="steady_state", gates=gates, expected=want_gates,
         alone_s=alone_s, greedy_steps_checked_by_margin=g_checked,
         greedy_tokens_equal=bool(np.array_equal(gt[0, 1:int(gl[0])], alone[0])),
         provider_completed=prov.get("tenant_default_completed"),
         provider_gone_after_close=gone, ok=gates_ok)
    ok &= gates_ok
    del srv, static, net16
    emit("generation", phase_s=time.perf_counter() - t_phase, ok=ok)
    if not ok:
        sys.exit(1)
    return paths


# -- phase 6 ----------------------------------------------------------------


def _build_resnet(rehearsal, ctx, seed):
    mx.random.seed(seed)
    if rehearsal:
        cfg = dict(TINY_RESNET)
        net = vision.ResNetV1(vision.BottleneckV1, cfg.pop("layers"), cfg.pop("channels"), **cfg)
    else:
        net = vision.resnet50_v1(classes=1000)
    net.initialize(ctx=ctx)
    size = 32 if rehearsal else 224
    with mx.autograd.predict_mode():  # finish the deferred shapes, as bench.py does
        net(torch.zeros(2, 3, size, size, device=ctx.device))
    return net


def _image_batch(rehearsal, b, gen, device):
    size, classes = (32, TINY_RESNET["classes"]) if rehearsal else (224, 1000)
    img = torch.rand((b, 3, size, size), generator=gen, device=device)
    labels = torch.randint(0, classes, (b,), generator=gen, device=device, dtype=torch.int32)
    return img, labels


def resnet_step(net, trainer, batch, train_mode=True):
    """One step as bench.py's bench_resnet50 takes it: the per-sample
    streaming softmax cross-entropy, backward, SGD; returns the loss."""
    img, labels = batch
    with mx.autograd.record(train_mode=train_mode):
        loss = streaming_softmax_ce(net(img), labels)
    mx.autograd.backward(loss)
    if trainer is not None:
        trainer.step(img.shape[0])
    return loss


def phase_resnet_train(rehearsal):
    """ResNet-50 v1 training steps (AMP bf16, fp32 parameters, SGD-momentum)
    on one device-resident synthetic batch; returns (net, trainer, batch,
    launch counts of one step, the step's BatchNorm input shapes)."""
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    b = 2 if rehearsal else RESNET_B
    mx.amp.init("bfloat16")
    net = _build_resnet(rehearsal, ctx, 0)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    batch = _image_batch(rehearsal, b, torch.Generator(device=device).manual_seed(21), device)
    blocks = [m for m in net.modules() if isinstance(m, mx.gluon.nn.BatchNorm)]
    before = [(m.running_mean.data().clone(), m.running_var.data().clone()) for m in blocks]

    losses = [resnet_step(net, trainer, batch).mean().item() for _ in range(2)]  # warm-up
    shapes = {}

    def record_shape(_, args):
        key = (args[0].shape[1], args[0].shape[2] * args[0].shape[3])
        shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(record_shape) for m in blocks]
    reset_kernel_counts()
    ops_nn.batch_norm.reference_calls = 0
    before_fused = fused_counts()
    losses.append(resnet_step(net, trainer, batch).mean().item())  # syncs on .item()
    counts = kernel_counts()
    fused_ok = _optimizer_check("resnet_train", net, before_fused, "sgd_mom", rehearsal)
    reference_calls = ops_nn.batch_norm.reference_calls
    for h in hooks:
        h.remove()
    losses += [resnet_step(net, trainer, batch).mean().item() for _ in range(9)]
    if device.type == "cuda":
        torch.cuda.synchronize()
    moved = sum(not (torch.equal(m.running_mean.data(), m0) and torch.equal(m.running_var.data(), v0))
                for m, (m0, v0) in zip(blocks, before))
    finite = all(math.isfinite(x) for x in losses)
    n_bn = len(blocks)
    want = {n: n_bn if n in ("bn_stats", "bn_apply") and not rehearsal else 0 for n in ENTRIES}
    want["multi_tensor"] = 0 if rehearsal else 1
    emit("resnet_train", model="resnet50_v1(classes=1000), AMP bf16, fp32 parameters, SGD "
         "lr 0.1 momentum 0.9 wd 1e-4" if not rehearsal else "tiny ResNetV1 (CPU rehearsal)",
         b=b, batchnorm_layers=n_bn, losses=losses, finite=finite,
         running_stats_moved=f"{moved}/{n_bn}", launches_one_step=counts, expected=want,
         batchnorm_reference_calls=reference_calls,
         bn_shapes_one_step=[[c, hw, k] for (c, hw), k in sorted(shapes.items())])
    if not (finite and fused_ok) or counts != want or reference_calls != 0 or moved != n_bn:
        sys.exit(1)
    mx.amp.disable()
    return net, trainer, batch, counts, shapes


def _resnet_grads(net, batch, amp):
    """Logits and per-parameter fp32 gradients of one training-mode
    forward and backward (no update), with or without AMP bf16."""
    if amp:
        mx.amp.init("bfloat16")
    img, labels = batch
    with mx.autograd.record():
        logits = net(img)
        loss = streaming_softmax_ce(logits, labels)
    mx.autograd.backward(loss)
    mx.amp.disable()
    grads = {k: p.grad().detach().float().cpu().clone()
             for k, p in net._collect_params_with_prefix().items() if p.grad_req != "null"}
    return logits.detach().float().cpu(), grads


def _feeds_batchnorm(key, params):
    """A convolution bias followed by BatchNorm in the same container
    (BottleneckV1's body.0 and body.6): in training the BN subtracts each
    channel's batch mean, so the bias's exact gradient is zero and what
    either side computes is rounding noise, with no relative error."""
    *path, idx, leaf = key.split(".")
    return leaf == "bias" and idx.isdigit() and ".".join(path + [str(int(idx) + 1), "beta"]) in params


def _rel_errors(grads, ref):
    return _rel_l2(grads, {k: r for k, r in ref.items() if not _feeds_batchnorm(k, ref)})


def _grad_report(name, logits, grads, ref_logits, ref, bound, logit_bound, **extra):
    rels = _rel_errors(grads, ref)
    extra["zero_gradient_biases_max_abs"] = max(
        [grads[k].abs().max().item() for k in ref if _feeds_batchnorm(k, ref)], default=0.0)
    logit_rel = ((logits - ref_logits).norm() / ref_logits.norm()).item()
    bad = [k for k, rel in rels.items() if not (math.isfinite(rel) and rel <= bound)]
    ok = not bad and math.isfinite(logit_rel) and logit_rel <= logit_bound
    worst = sorted(((rel, k) for k, rel in rels.items()), reverse=True)
    emit("resnet_train_vs_cpu_fp32", compare=name, params=len(rels), bound=bound,
         logits_rel_err=logit_rel, logits_bound=logit_bound,
         worst=[[k, rel] for rel, k in worst[:6]], median_rel=worst[len(worst) // 2][0],
         failed=bad, ok=ok, **extra)
    return ok, worst[len(worst) // 2][0]


def phase_resnet_train_vs_cpu(rehearsal):
    """The card's gradients against the port's fp32 gradients on the CPU:
    the same ResNet-50 weights (a fresh net from seed 1), B=16 at 224x224,
    BatchNorm in training; relative L2 error per parameter and of the
    logits.  Held to its bound: the card's fp32 run (AMP off, TF32 off).
    Held only to order 1: the card's AMP bf16 run.  Each is reported beside
    a yardstick, the CPU's own fp32 gradients with the weights moved by
    1e-6 relative or rounded to bf16 (see RESNET_FP32_GRAD_REL_BOUND)."""
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    b = 2 if rehearsal else 16
    net = _build_resnet(rehearsal, ctx, 1)
    batch = _image_batch(rehearsal, b, torch.Generator(device=ctx.device).manual_seed(23),
                         ctx.device)
    arrays = {k: p.data().detach().float().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}
    amp_logits, amp_grads = _resnet_grads(net, batch, amp=True)
    card_logits, card_grads = _resnet_grads(net, batch, amp=False)
    ref_net = _build_resnet(rehearsal, mx.cpu(), 1)
    cpu_batch = tuple(x.cpu() for x in batch)
    load_numpy_params(ref_net, arrays)
    ref_logits, ref = _resnet_grads(ref_net, cpu_batch, amp=False)
    noise = torch.Generator().manual_seed(29)
    yardsticks = {}
    for name, moved in (
            ("cpu_fp32_perturbed_1e-6", lambda w: w * (1 + 1e-6 * torch.randn(
                w.shape, generator=noise, dtype=torch.float64).numpy()).astype(w.dtype)),
            ("cpu_fp32_bf16_weights", lambda w: torch.from_numpy(w).bfloat16().float().numpy())):
        load_numpy_params(ref_net, {k: moved(a) for k, a in arrays.items()})
        y_logits, y_grads = _resnet_grads(ref_net, cpu_batch, amp=False)
        _, yardsticks[name] = _grad_report(name, y_logits, y_grads, ref_logits, ref, math.inf,
                                           math.inf, note="yardstick: the CPU's fp32 run "
                                           "with moved weights")
    ok32, _ = _grad_report("card_fp32", card_logits, card_grads, ref_logits, ref,
                           RESNET_FP32_GRAD_REL_BOUND, RESNET_FP32_LOGIT_REL_BOUND, b=b,
                           yardstick_median_rel=yardsticks["cpu_fp32_perturbed_1e-6"])
    ok_amp, _ = _grad_report("card_amp_bf16", amp_logits, amp_grads, ref_logits, ref,
                             RESNET_AMP_GRAD_REL_BOUND, RESNET_AMP_GRAD_REL_BOUND, b=b,
                             yardstick_median_rel=yardsticks["cpu_fp32_bf16_weights"])
    if not (ok32 and ok_amp):
        sys.exit(1)


# -- phase 6b: the step fold --------------------------------------------------
# The slice's main path: each BERT-base and ResNet-50 training step as one
# CUDA-graph replay (gluon/step_fold.py).  Exact steps: eager and folded
# runs from identical weights and states must agree bit for bit: the same
# kernels on the same inputs.  Two eager runs agree only where the
# backward is deterministic, so the exact runs take PyTorch's
# deterministic algorithms (BERT: the MLM gather's backward otherwise adds
# the gradients of repeated masked positions with atomics, in an order
# that changes from run to run) and deterministic cuDNN (ResNet-50: the
# default backward convolutions may accumulate with atomics).  A control
# in the default mode, one eager step on each of two more copies, reports
# what the default mode gives.  Eval: the register's fp32 sum of B·P (or B)
# losses a call, three calls, against the same sums taken eagerly: the same
# kernels, so the bound is 0 as well.
FOLD_K = 4
FOLD_DROPOUT = 0.1
FOLD_DROPOUT_BAND = 0.005  # the dropped share of a probe: 0.1 ± 0.005
# Kernels one replay of each main-path step launches, read from the
# profiler's kernel names (substring -> family).
REPLAY_FAMILIES = (("flash_bwd_dkv", "flash_bwd_dkv"), ("flash_bwd_dq", "flash_bwd_dq"),
                   ("flash_fwd", "flash_fwd"), ("bn_stats_kernel", "bn_stats"),
                   ("bn_apply_kernel", "bn_apply"), ("multi_tensor_update", "multi_tensor"))


def bert_loss(net):
    """The pretraining loss of ``train_step`` as a fold's loss_fn."""
    def loss_fn(ids, types, pos, labels):
        mlm, _ = net(ids, types, pos)
        return streaming_softmax_ce(mlm, labels).mean(-1)
    return loss_fn


def resnet_loss(net):
    """The loss of ``resnet_step`` as a fold's loss_fn."""
    def loss_fn(img, labels):
        return streaming_softmax_ce(net(img), labels)
    return loss_fn


def _eager_step(trainer, loss_fn, batch):
    with mx.autograd.record():
        loss = loss_fn(*batch)
    mx.autograd.backward(loss)
    trainer.step(batch[0].shape[0])
    return loss.detach()


def _flat_states(trainer):
    out = []

    def walk(st):
        if isinstance(st, torch.Tensor):
            out.append(st)
        elif st is not None:
            for s in st:
                walk(s)

    for i in sorted(trainer._states):
        walk(trainer._states[i])
    return out


def _compare(a, b):
    """(bit-equal, largest absolute difference) of two lists of tensors."""
    equal, err = len(a) == len(b), 0.0
    for x, y in zip(a, b):
        equal = equal and torch.equal(x, y)
        err = max(err, (x.float() - y.float()).abs().max().item())
    return equal, err


def _fold_counters():
    sp, ev = step_fold.StepProgram, step_fold.EvalProgram
    return {"calls": sp.calls, "replays": sp.replays, "captures": sp.captures,
            "fallbacks": sum(sp.fallbacks.values()), "eval_calls": ev.calls,
            "eval_replays": ev.replays}


def _delta(before):
    after = _fold_counters()
    return {k: after[k] - before[k] for k in after}


def _replay_kernels(fn, want):
    """Kernels one call of ``fn`` (a replay) launches, by family, from
    torch.profiler's CUDA trace, and the Python launch counts it moved
    (none: a replay runs no wrapper).  Each trace first runs ``fn`` once and
    a sentinel, and counts the call after them (``_busy_share(warm=True)``):
    late in a whole run, every lead-only trace of YOLOv3's 78 ms replay
    lacked one ``bn_stats`` record, where the phase alone counted all 72.
    A trace that lost a record is taken again, three times at most; each
    try calls ``fn`` twice."""
    py_before = kernel_counts()
    tries = []
    for _ in range(3):
        got = {}
        for name, c in _busy_share(fn, warm=True, lead=True)[4].items():
            fam = next((f for sub, f in REPLAY_FAMILIES if sub in name), None)
            if fam is not None:
                got[fam] = got.get(fam, 0) + c
        tries.append(got)
        if got == want:
            break
    return tries, {k: v - py_before[k] for k, v in kernel_counts().items()
                   if v != py_before[k]}


@contextlib.contextmanager
def _deterministic(bert):
    """The exact runs' mode: PyTorch's deterministic algorithms (BERT) or
    deterministic cuDNN (ResNet-50), restored on exit."""
    if bert:
        before = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(before)
    else:
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = before


def _eager_repeat(make, loss_of, batch):
    """The control: one eager step on each of two identical copies in the
    default mode; (bit-equal, largest difference) of their parameters."""
    params = []
    for _ in range(2):
        net, tr = make()
        _eager_step(tr, loss_of(net), batch)
        params.append([p.data().detach().clone() for p in net.collect_params().values()])
        del net, tr
    return _compare(*params)


def _fold_exact(label, make, loss_of, batches, rehearsal):
    """Eager against folded steps on two copies of one model: 3 steps
    (warm-up, capture + replay, replay), then 3 windows of FOLD_K steps
    through ``fold_steps``, then the folded eval against the eager sums.
    Returns the record and whether it passed."""
    sync = (lambda: None) if rehearsal else torch.cuda.synchronize
    (net_a, tr_a), (net_b, tr_b) = make(), make()
    start = _fold_counters()
    loss_a = [_eager_step(tr_a, loss_of(net_a), batches[0]) for _ in range(3)]
    prog = tr_b.fold_step(loss_of(net_b), block=net_b)
    loss_b, captured, call_s = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        loss_b.append(prog(*batches[0]))
        sync()
        call_s.append(time.perf_counter() - t0)
        captured.append(prog.captured)
    steps = _delta(start)
    snap = lambda net, tr: ([p.data() for p in net.collect_params().values()],  # noqa: E731
                            _flat_states(tr))
    (pa, sa), (pb, sb) = snap(net_a, tr_a), snap(net_b, tr_b)
    exact = {"params": _compare(pa, pb), "states": _compare(sa, sb),
             "losses": _compare(loss_a, loss_b)}
    folded = prog.folded
    del prog  # its graph and pool: ResNet-50's B=256 step holds tens of GB
    if not rehearsal:
        torch.cuda.empty_cache()
    window = [torch.stack([b[i] for b in batches]) for i in range(len(batches[0]))]
    prog_k = tr_b.fold_steps(loss_of(net_b), k=FOLD_K, block=net_b)
    win_a, win_b = [], []
    for _ in range(3):
        win_a.append(torch.stack([_eager_step(tr_a, loss_of(net_a), b) for b in batches]))
        win_b.append(prog_k(*window))
    sync()
    (pa, sa), (pb, sb) = snap(net_a, tr_a), snap(net_b, tr_b)
    windows = {"params": _compare(pa, pb), "states": _compare(sa, sb),
               "losses": _compare(win_a, win_b)}
    folded = folded and prog_k.folded
    del prog_k
    if not rehearsal:
        torch.cuda.empty_cache()
    ev = tr_b.fold_eval(loss_of(net_b), block=net_b)
    for _ in range(3):
        ev(*batches[0])
    got = ev.result()
    with mx.autograd.predict_mode():
        acc, count = torch.zeros((), dtype=torch.float32, device=batches[0][0].device), 0
        for _ in range(3):
            loss = loss_of(net_b)(*batches[0])
            acc += loss.float().sum()
            count += loss.numel()
    ref = acc.item() / count
    counters = _delta(start)
    status = {"folded": folded and ev.folded,
              "captured_by_call": captured, "fallbacks": counters["fallbacks"]}
    want_captured = [False] * 3 if rehearsal else [False, True, True]
    ok = (all(eq for eq, _ in exact.values()) and all(eq for eq, _ in windows.values())
          and got == ref and status["folded"] and captured == want_captured
          and counters["fallbacks"] == 0
          and (rehearsal or (steps["replays"], steps["captures"]) == (2, 1)))
    rec = dict(model=label, exact_steps={k: dict(bit_equal=e, max_abs_err=x)
                                         for k, (e, x) in exact.items()},
               windows=dict(k=FOLD_K, windows=3, **{k: dict(bit_equal=e, max_abs_err=x)
                                                     for k, (e, x) in windows.items()}),
               eval=dict(fold_mean_loss=got, eager_mean_loss=ref, abs_err=abs(got - ref),
                         bound=0.0),
               call_s=call_s, counters=counters, **status, ok=ok)
    del ev, net_a, net_b, tr_a, tr_b
    if not rehearsal:
        torch.cuda.empty_cache()
    return rec, ok


def _fold_update_check(make, loss_of, batch, rehearsal):
    """``MXNET_STEP_FOLD=1``: three ``Trainer.step`` calls whose optimizer
    tail is ``fold_update`` (eager, capture + replay, replay) against three
    with the fused update, on two copies, bit for bit (deterministic mode,
    as the exact steps)."""
    params, before = [], dict(vars(step_fold.fold_update))
    for env in ("", "1"):
        prev = os.environ.get("MXNET_STEP_FOLD")
        os.environ["MXNET_STEP_FOLD"] = env
        try:
            net, tr = make()
            for _ in range(3):
                _eager_step(tr, loss_of(net), batch)
            params.append([p.data() for p in net.collect_params().values()]
                          + _flat_states(tr))
        finally:
            if prev is None:
                del os.environ["MXNET_STEP_FOLD"]
            else:
                os.environ["MXNET_STEP_FOLD"] = prev
        del net, tr
    counts = {k: v - before[k] for k, v in vars(step_fold.fold_update).items()}
    equal, err = _compare(*params)
    want = ({"calls": 3, "captures": 0, "replays": 0} if rehearsal
            else {"calls": 3, "captures": 1, "replays": 2})
    ok = equal and {k: counts[k] for k in want} == want
    emit("fold", check="fold_update", bit_equal=equal, max_abs_err=err, counters=counts,
         expected=want, ok=ok)
    return ok


def _fold_dropout(net, trainer, batch):
    """Two replays of the dropout-0.1 step draw different masks: a probe
    (a forward hook on the first Dropout, captured with the step) records
    which elements it dropped, and each replay's dropped share lies within
    FOLD_DROPOUT ± FOLD_DROPOUT_BAND."""
    drop = next(m for m in net.modules() if isinstance(m, mx.gluon.nn.Dropout))
    probe = {}

    def hook(_, args, out):
        if "dropped" not in probe:
            probe["dropped"] = torch.empty(out.shape, dtype=torch.bool, device=out.device)
        probe["dropped"].copy_((out == 0) & (args[0] != 0))

    handle = drop.register_forward_hook(hook)
    try:
        prog = trainer.fold_step(bert_loss(net), block=net)
        prog(*batch)
        prog(*batch)
        masks = [probe["dropped"].clone()]
        prog(*batch)
        masks.append(probe["dropped"].clone())
        captured = prog.captured
    finally:
        handle.remove()
    shares = [m.float().mean().item() for m in masks]
    fresh = not torch.equal(masks[0], masks[1])
    ok = (captured and fresh
          and all(abs(s - FOLD_DROPOUT) <= FOLD_DROPOUT_BAND for s in shares))
    emit("fold", check="dropout", probe_elements=masks[0].numel(), dropped_share=shares,
         expected=FOLD_DROPOUT, band=FOLD_DROPOUT_BAND, masks_differ=fresh,
         replayed=captured, ok=ok)
    return ok


def _fold_main(label, net, trainer, loss_fn, batch, want_replay, rehearsal):
    """The main path: ``trainer.fold_step(loss_fn, block=net)`` and three
    calls (warm-up, capture + replay, replay) with the launch counts set to
    0 just before and read just after; then one more replay under the
    profiler, whose kernels are counted by name.  Returns (program, counts,
    record, ok)."""
    prog = trainer.fold_step(loss_fn, block=net)
    start = _fold_counters()
    reset_kernel_counts()
    call_s, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(prog(*batch))
        if not rehearsal:
            torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    counts = kernel_counts()
    tries, moved = ([], {}) if rehearsal else _replay_kernels(lambda: prog(*batch),
                                                               want_replay)
    counters = _delta(start)
    finite = all(bool(torch.isfinite(x).all()) for x in losses)
    # every call after the warm-up is one replay (the profiled ones too:
    # two a try)
    want_counters = ({"calls": 3, "replays": 0, "captures": 0} if rehearsal
                     else {"calls": 3 + 2 * len(tries), "replays": 2 + 2 * len(tries),
                           "captures": 1})
    ok = (finite and prog.folded and counters["fallbacks"] == 0
          and {k: counters[k] for k in want_counters} == want_counters
          and (rehearsal or (tries[-1] == want_replay and not moved)))
    rec = dict(path=label, launches_main_path=counts, call_s=call_s,
               warm_up_s=call_s[0], capture_and_replay_s=call_s[1], replay_s=call_s[2],
               replay_kernels=tries[-1] if tries else None, replay_kernel_tries=len(tries),
               expected_replay_kernels=want_replay, python_counts_moved_by_replay=moved,
               counters=counters, expected_counters=want_counters, folded=prog.folded,
               captured=prog.captured, losses=[x.float().mean().item() for x in losses],
               finite=finite, ok=ok)
    return prog, counts, rec, ok


def phase_fold(train, resnet, rehearsal):
    """The step fold on BERT-base and ResNet-50 at the training phases'
    shapes: exact steps, windows and eval on fresh dropout-free copies; the
    dropout masks of replays; then the main path on the training phases'
    own nets and trainers.  Returns ({path: launch counts}, {path: the
    main-path program}, {path: record})."""
    cfg = dict(TINY_BERT if rehearsal else BERT_BASE)
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    b, s, p = (4, 16, 3) if rehearsal else (64, 128, 20)
    gen = torch.Generator(device=device).manual_seed(31)
    bert_batches = [_train_batch(cfg, b, s, p, gen, device) for _ in range(FOLD_K)]

    def make_bert():
        net = _build_net(dict(cfg, dropout=0.0), ctx, "bfloat16")
        with mx.autograd.predict_mode():  # finish the deferred shapes from the same seed
            net(*bert_batches[0][:3])
        return net, mx.gluon.Trainer(net.collect_params(), "adam",
                                     {"learning_rate": 1e-4, "multi_precision": True})

    def make_resnet():
        net = _build_resnet(rehearsal, ctx, 0)
        return net, mx.gluon.Trainer(net.collect_params(), "sgd",
                                     {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})

    misses, records = [], {}
    with _deterministic(bert=True):
        rec, ok = _fold_exact("BERTForPretrain(bert_base) bf16, Adam mp, dropout 0 "
                              "(deterministic algorithms)", make_bert, bert_loss, bert_batches,
                              rehearsal)
        if not _fold_update_check(make_bert, bert_loss, bert_batches[0], rehearsal):
            misses.append("fold_update")
    control = _eager_repeat(make_bert, bert_loss, bert_batches[0])
    emit("fold", check="exact", **rec, control_default_mode_eager_vs_eager=dict(
        bit_equal=control[0], max_abs_err=control[1]))
    if not ok:
        misses.append("bert_exact")
    rb = 2 if rehearsal else RESNET_B
    resnet_batches = [_image_batch(rehearsal, rb, gen, device) for _ in range(FOLD_K)]
    mx.amp.init("bfloat16")
    try:
        with _deterministic(bert=False):
            rec, ok = _fold_exact("resnet50_v1 AMP bf16, SGD momentum (cuDNN deterministic)",
                                  make_resnet, resnet_loss, resnet_batches, rehearsal)
        control = _eager_repeat(make_resnet, resnet_loss, resnet_batches[0])
    finally:
        mx.amp.disable()
    emit("fold", check="exact", **rec, control_default_mode_eager_vs_eager=dict(
        bit_equal=control[0], max_abs_err=control[1]))
    if not ok:
        misses.append("resnet_exact")
    del bert_batches, resnet_batches
    if not rehearsal:
        torch.cuda.empty_cache()
        tnet, trainer, batch = train
        if not _fold_dropout(tnet, trainer, batch):
            misses.append("dropout")
        torch.cuda.empty_cache()

    tnet, trainer, batch = train
    num_layers = cfg.get("num_layers", 12)
    bert_prog, bert_counts, rec, ok = _fold_main(
        "fold_bert_step", tnet, trainer, bert_loss(tnet), batch,
        {"flash_fwd": num_layers, "flash_bwd_dq": num_layers, "flash_bwd_dkv": num_layers,
         "multi_tensor": 1}, rehearsal)
    emit("fold", check="main_path", model="BERTForPretrain(bert_base) bf16, Adam mp, "
         "dropout 0.1" if not rehearsal else "tiny BERT (CPU rehearsal)", **rec)
    records["fold_bert_step"] = rec
    if not ok:
        misses.append("bert_main_path")
    rnet, rtrainer, rbatch = resnet
    n_bn = sum(isinstance(m, mx.gluon.nn.BatchNorm) for m in rnet.modules())
    mx.amp.init("bfloat16")
    try:
        resnet_prog, resnet_counts, rec, ok = _fold_main(
            "fold_resnet_step", rnet, rtrainer, resnet_loss(rnet), rbatch,
            {"bn_stats": n_bn, "bn_apply": n_bn, "multi_tensor": 1}, rehearsal)
    finally:
        mx.amp.disable()
    emit("fold", check="main_path", model="resnet50_v1 AMP bf16, SGD momentum"
         if not rehearsal else "tiny ResNetV1 (CPU rehearsal)", **rec)
    records["fold_resnet_step"] = rec
    if not ok:
        misses.append("resnet_main_path")
    if misses:
        emit("fold", failed=misses)
        sys.exit(1)
    return ({"fold_bert_step": bert_counts, "fold_resnet_step": resnet_counts},
            {"fold_bert_step": bert_prog, "fold_resnet_step": resnet_prog}, records)


# -- phase 6a: SPMDTrainer and the distributed tier -----------------------------
# bench.py's training configurations through parallel.SPMDTrainer on
# make_mesh() (world 1: one process, one card), then the kvstore and the
# trainers across processes: a 1-rank NCCL group in this process and a
# 2-rank gloo cohort on the one card (tests/torch_dist_worker.py).
SPMD_STEPS = 10          # main-path steps: warm-up, capture + replay, replays
SPMD_BULK_K = 4          # step_bulk's k and step_window's K
SPMD_TURN_CALLS = 10     # timed calls a turn (SPMD, fold, fold, SPMD)
DIST_TIMEOUT_S = 420     # the 2-rank cohort, both processes
# The cohort's SPMDTrainer at 2 ranks on half-batches against 1 rank on the
# whole batch, BERT at 2 layers in fp32, one SGD-momentum step: the same
# arithmetic summed in another order (two gradient halves added by gloo,
# matmuls over 4 rows instead of 8), ~1e-6 relative; the parameters and
# the loss within 1e-4 relative or absolute.
DIST_SPMD_TOL = 1e-4


def mlm_loss(out, label):
    """bench.py's ``mlm_loss`` as SPMDTrainer's ``loss_fn(outputs, label)``."""
    return streaming_softmax_ce(out[0], label).mean(-1)


def ce_loss(out, label):
    """bench.py's ``ce_loss`` (ResNet-50) as SPMDTrainer's ``loss_fn``."""
    return streaming_softmax_ce(out, label)


def _keyed(net, trainer):
    """``(parameters, optimizer states)`` by the net's structural keys (the
    two trainers index their states differently)."""
    params = net._collect_params_with_prefix()
    key_of = {id(p): k for k, p in params.items()}
    states = {}
    for i, st in trainer._states.items():
        flat = []

        def walk(s):
            if isinstance(s, torch.Tensor):
                flat.append(s.detach().clone())
            elif s is not None:
                for x in s:
                    walk(x)
        walk(st)
        states[key_of[id(trainer._params[i])]] = flat
    return ({k: p.data().detach().clone() for k, p in params.items()},
            [t for k in sorted(states) for t in states[k]])


def _keyed_compare(a, b):
    """(bit-equal, largest |difference|) of two ``_keyed`` snapshots."""
    (pa, sa), (pb, sb) = a, b
    keys = sorted(pa)
    if keys != sorted(pb):
        return False, math.inf
    eq_p, err_p = _compare([pa[k] for k in keys], [pb[k] for k in keys])
    eq_s, err_s = _compare(sa, sb)
    return eq_p and eq_s, max(err_p, err_s)


def _spmd_mesh(ctx):
    from incubator_mxnet_torch import parallel

    # make_mesh() is bench.py's call: the card of this rank; the rehearsal
    # asks for the CPU
    return parallel.make_mesh(devices=[ctx.device]) if ctx.device.type == "cpu" \
        else parallel.make_mesh()


def _spmd_vs_fold(label, make, loss_fn, batch, ctx, rehearsal):
    """Two SPMDTrainer steps against two ``Trainer.fold_step`` calls on
    copies of one model (dropout 0, deterministic mode): parameters, states
    (running statistics among the parameters) and losses bit-equal."""
    from incubator_mxnet_torch import parallel

    data, lab = list(batch[:-1]), batch[-1]
    net, opt = make()
    tr = parallel.SPMDTrainer(net, loss_fn, *opt, mesh=_spmd_mesh(ctx))
    loss_a = [tr.step(data, lab)._data for _ in range(2)]
    snap_a = _keyed(net, tr._trainer)
    captured = tr._programs["step"].captured
    del net, tr
    mx.profiler.disarm_compile_guard()
    if not rehearsal:
        torch.cuda.empty_cache()
    net, opt = make()
    trainer = mx.gluon.Trainer(net.collect_params(), *opt)
    prog = trainer.fold_step(lambda *b: loss_fn(net(*b[:-1]), b[-1]), block=net)
    loss_b = [prog(*batch).float().mean() for _ in range(2)]
    equal, err = _keyed_compare(snap_a, _keyed(net, trainer))
    loss_eq, loss_err = _compare(loss_a, loss_b)
    ok = equal and loss_eq and captured == (not rehearsal) and prog.captured == (not rehearsal)
    emit("spmd", check="spmd_vs_fold_step", model=label, steps=2,
         params_and_states=dict(bit_equal=equal, max_abs_err=err),
         losses=dict(bit_equal=loss_eq, max_abs_err=loss_err, spmd=[x.item() for x in loss_a]),
         spmd_captured=captured, fold_captured=prog.captured, ok=ok)
    del net, trainer, prog
    mx.profiler.disarm_compile_guard()
    if not rehearsal:
        torch.cuda.empty_cache()
    return ok


def _spmd_bulk_window(label, make, loss_fn, batches, ctx, rehearsal):
    """``step_bulk(K)`` on one batch and ``step_window`` over a ``[K, B, ...]``
    window of K batches against K ``step`` calls each, on two copies:
    parameters, states and the last loss bit-equal after each."""
    from incubator_mxnet_torch import parallel

    k = len(batches)
    window = [torch.stack([b[i] for b in batches]) for i in range(len(batches[0]))]
    snaps = []
    for bulk in (False, True):
        net, opt = make()
        tr = parallel.SPMDTrainer(net, loss_fn, *opt, mesh=_spmd_mesh(ctx))
        b0 = batches[0]
        if bulk:
            after_bulk = tr.step_bulk(list(b0[:-1]), b0[-1], k)._data
            snap_bulk = _keyed(net, tr._trainer)
            after_window = tr.step_window(window[:-1], window[-1])._data
        else:
            for _ in range(k):
                after_bulk = tr.step(list(b0[:-1]), b0[-1])._data
            snap_bulk = _keyed(net, tr._trainer)
            for b in batches:
                after_window = tr.step(list(b[:-1]), b[-1])._data
        snaps.append((snap_bulk, after_bulk, _keyed(net, tr._trainer), after_window,
                      tr.num_update))
        del net, tr
        mx.profiler.disarm_compile_guard()
        if not rehearsal:
            torch.cuda.empty_cache()
    (s_b, l_b, s_w, l_w, n_seq), (b_b, bl_b, b_w, bl_w, n_blk) = snaps
    bulk_eq, bulk_err = _keyed_compare(s_b, b_b)
    win_eq, win_err = _keyed_compare(s_w, b_w)
    ok = (bulk_eq and win_eq and torch.equal(l_b, bl_b) and torch.equal(l_w, bl_w)
          and n_seq == n_blk == 2 * k)
    emit("spmd", check="step_bulk_and_step_window", model=label, k=k,
         step_bulk_vs_steps=dict(bit_equal=bulk_eq, max_abs_err=bulk_err,
                                 last_loss_equal=bool(torch.equal(l_b, bl_b))),
         step_window_vs_steps=dict(bit_equal=win_eq, max_abs_err=win_err,
                                   last_loss_equal=bool(torch.equal(l_w, bl_w))),
         num_update=[n_seq, n_blk], ok=ok)
    return ok


def _spmd_main(label, net, opt, loss_fn, batch, want_replay, variant, ctx, rehearsal, smi):
    """The main path: ``SPMDTrainer(net, loss_fn, ..., mesh=make_mesh())``,
    SPMD_STEPS steps on one device-resident batch, the launch counts and
    the collectives set to 0 just before the first step (the warm-up, run
    eagerly) and read just after it; one replay's kernels by name in a
    profiler trace; then the SPMD step and ``Trainer.fold_step`` on the
    same net timed in turns (reported).  Returns (counts, ok)."""
    from incubator_mxnet_torch import parallel
    from incubator_mxnet_torch.parallel import mesh as pmesh

    sync = (lambda: None) if rehearsal else torch.cuda.synchronize
    data, lab = list(batch[:-1]), batch[-1]
    tr = parallel.SPMDTrainer(net, loss_fn, *opt, mesh=_spmd_mesh(ctx))
    tr.shard_batch(*data, lab)  # device-resident already: returned as they are
    pmesh.reset_collective_counts()
    reset_kernel_counts()
    losses = [tr.step(data, lab).asscalar()]
    counts = kernel_counts()
    variants = dict(mt.multi_tensor_update.launches_by_variant)
    losses += [tr.step(data, lab).asscalar() for _ in range(SPMD_STEPS - 1)]
    sync()
    prog = tr._programs["step"]
    tries, moved = ([], {}) if rehearsal else _replay_kernels(lambda: tr.step(data, lab),
                                                               want_replay)
    collectives = pmesh.collective_counts()
    finite = all(math.isfinite(x) for x in losses)
    want = {n: 0 for n in ENTRIES}
    if not rehearsal:
        want.update(want_replay)
    ok = (finite and losses[-1] < losses[0] and counts == want
          and variants == ({} if rehearsal else {variant: 1})
          and sum(collectives.values()) == 0 and prog.folded
          and prog.captured == (not rehearsal) and tr.fallback_reason is None
          and (rehearsal or (tries[-1] == want_replay and not moved)))
    turns = {}
    if not rehearsal:
        trainer = mx.gluon.Trainer(net.collect_params(), *opt)
        fold = trainer.fold_step(lambda *b: loss_fn(net(*b[:-1]), b[-1]), block=net)
        fold(*batch)
        fold(*batch)  # warm-up, capture
        calls = {"spmd": lambda: tr.step(data, lab), "fold": lambda: fold(*batch)}
        for name in ("spmd", "fold", "fold", "spmd"):
            sync()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(SPMD_TURN_CALLS):
                calls[name]()
            end.record()
            sync()
            turns.setdefault(name, []).append(
                dict(event_ms=start.elapsed_time(end) / SPMD_TURN_CALLS,
                     wall_ms=(time.perf_counter() - t0) * 1e3 / SPMD_TURN_CALLS))
        del trainer, fold
    emit("spmd", check="main_path", model=label, mesh=repr(tr.mesh), losses=losses,
         finite=finite, falling=losses[-1] < losses[0], launches_one_step=counts,
         expected=want, multi_tensor_by_variant=variants, collectives=collectives,
         replay_kernels=tries[-1] if tries else None, replay_kernel_tries=len(tries),
         expected_replay_kernels=None if rehearsal else want_replay,
         python_counts_moved_by_replay=moved, captured=prog.captured, folded=prog.folded,
         turns_ms=turns, turn_calls=SPMD_TURN_CALLS, card=smi, ok=ok)
    mx.profiler.disarm_compile_guard()
    return counts, ok


def phase_spmd(rehearsal, smi=None):
    """bench.py's BERT-base (B=64, S=128, P=20, bf16 parameters, fp32 Adam
    masters, dropout 0.1, the streaming MLM loss) and ResNet-50 v1 (B=256,
    AMP bf16, SGD lr 0.1 momentum 0.9 wd 1e-4) through ``SPMDTrainer`` on
    ``make_mesh()`` at world 1: two SPMD steps bit-equal to two folded
    steps (dropout 0, deterministic mode), ``step_bulk`` and
    ``step_window`` bit-equal to sequential steps (BERT), then the main
    path.  Returns the launch counts of one BERT and one ResNet-50 SPMD
    step together (the kernels line's ``spmd`` path)."""
    cfg = dict(TINY_BERT if rehearsal else BERT_BASE)
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    b, s, p = (4, 16, 3) if rehearsal else (64, 128, 20)
    gen = torch.Generator(device=device).manual_seed(41)
    batches = [_train_batch(cfg, b, s, p, gen, device) for _ in range(SPMD_BULK_K)]
    adam = ("adam", {"learning_rate": 1e-4, "multi_precision": True})
    num_layers = cfg.get("num_layers", 12)

    def make_bert(dropout=0.0):
        net = _build_net(dict(cfg, dropout=dropout), ctx, "bfloat16")
        with mx.autograd.predict_mode():  # finish the deferred shapes from the same seed
            net(*batches[0][:3])
        return net, adam

    bert_label = ("BERTForPretrain(bert_base) bf16, Adam mp" if not rehearsal
                  else "tiny BERT (CPU rehearsal)")
    misses = []
    with _deterministic(bert=True):
        if not _spmd_vs_fold(bert_label + ", dropout 0 (deterministic algorithms)", make_bert,
                             mlm_loss, batches[0], ctx, rehearsal):
            misses.append("bert_vs_fold")
        if not _spmd_bulk_window(bert_label + ", dropout 0 (deterministic algorithms)",
                                 make_bert, mlm_loss, batches, ctx, rehearsal):
            misses.append("bert_bulk_window")
    net, _ = make_bert(dropout=cfg["dropout"])
    bert_counts, ok = _spmd_main(
        bert_label + f", dropout {cfg['dropout']}", net, adam, mlm_loss, batches[0],
        {"flash_fwd": num_layers, "flash_bwd_dq": num_layers, "flash_bwd_dkv": num_layers,
         "multi_tensor": 1}, "mp_adam", ctx, rehearsal, smi)
    if not ok:
        misses.append("bert_main_path")
    del net, batches
    if not rehearsal:
        torch.cuda.empty_cache()

    sgd = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    rb = 2 if rehearsal else RESNET_B
    rbatch = _image_batch(rehearsal, rb, gen, device)

    def make_resnet():
        return _build_resnet(rehearsal, ctx, 0), sgd

    resnet_label = ("resnet50_v1 AMP bf16, SGD momentum" if not rehearsal
                    else "tiny ResNetV1 (CPU rehearsal)")
    mx.amp.init("bfloat16")
    try:
        with _deterministic(bert=False):
            if not _spmd_vs_fold(resnet_label + " (cuDNN deterministic)", make_resnet, ce_loss,
                                 rbatch, ctx, rehearsal):
                misses.append("resnet_vs_fold")
        net, _ = make_resnet()
        n_bn = sum(isinstance(m, mx.gluon.nn.BatchNorm) for m in net.modules())
        resnet_counts, ok = _spmd_main(resnet_label, net, sgd, ce_loss, rbatch,
                                       {"bn_stats": n_bn, "bn_apply": n_bn, "multi_tensor": 1},
                                       "sgd_mom", ctx, rehearsal, smi)
        if not ok:
            misses.append("resnet_main_path")
        del net
    finally:
        mx.amp.disable()
    if not rehearsal:
        torch.cuda.empty_cache()
    if misses:
        emit("spmd", failed=misses)
        sys.exit(1)
    return {"spmd": {k: bert_counts[k] + resnet_counts[k] for k in bert_counts}}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_dist(smi):
    """The distributed tier on the one card: a 1-rank NCCL group in this
    process (``init_distributed``, exact ``dist_sync`` values on the card,
    one NCCL all-reduce through the store's wire), then a 2-rank gloo
    cohort on the card spawned through ``tools/launch_local.py``
    (``tests/torch_dist_worker.py``: the exact ``dist_sync`` assertions on
    CUDA tensors, ``Trainer.backward``'s overlap against a plain backward,
    ``SPMDTrainer`` at 2 ranks against 1), at BERT-base's width (768 units,
    12 heads, vocab 30522) cut to 2 layers."""
    import torch.distributed as dist

    from incubator_mxnet_torch import parallel
    from incubator_mxnet_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    pmesh.reset_collective_counts()
    parallel.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl")
    try:
        ctx = mx.gpu(0)
        kv = mx.kv.create("dist_sync")
        mesh = parallel.make_mesh()
        kv.init(3, mx.nd.ones((4, 5), ctx=ctx))
        kv.push(3, [mx.nd.ones((4, 5), ctx=ctx), mx.nd.ones((4, 5), ctx=ctx) * 2])
        out = mx.nd.zeros((4, 5), ctx=ctx)
        kv.pull(3, out=out)
        g = mx.nd.array([0.6, -0.7, 0.1, 0.0], ctx=ctx)
        outp = mx.nd.zeros((4,), ctx=ctx)
        kv.pushpull(9, g, out=outp)
        wire = torch.arange(4096, dtype=torch.float32, device=ctx.device)
        kv._allreduce(wire)  # the store's NCCL all-reduce, over one rank
        torch.cuda.synchronize()
        values_ok = (np.array_equal(out.asnumpy(), np.full((4, 5), 3.0, np.float32))
                     and np.array_equal(outp.asnumpy(), g.asnumpy())
                     and torch.equal(wire, torch.arange(4096, dtype=torch.float32,
                                                        device=ctx.device)))
        counts = pmesh.collective_counts()
        ok = (values_ok and kv.num_workers == 1 and kv.rank == 0 and mesh.world == 1
              and dist.get_backend() == "nccl" and counts.get("nccl") == 1)
        emit("dist", check="nccl_one_rank", backend=dist.get_backend(), world=kv.num_workers,
             mesh=repr(mesh), values_exact=values_ok, collectives=counts, ok=ok)
    finally:
        dist.destroy_process_group()
    if not ok:
        sys.exit(1)
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, str(root / "tools" / "launch_local.py"), "-n", "2", sys.executable,
           str(root / "tests" / "torch_dist_worker.py"), "kv,overlap,spmd", "--device",
           "cuda:0", "--backend", "gloo", "--model", "bert", "--steps", "1", "--tol",
           str(DIST_SPMD_TOL)]
    t1 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DIST_TIMEOUT_S,
                          cwd=root)
    log = root / "chiprun_out" / "dist_cohort.log"
    log.parent.mkdir(exist_ok=True)
    log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("rank", "torch_dist"))]
    passed = {name: proc.stdout.count(f"{name} assertions passed")
              for name in ("kv", "overlap", "spmd")}
    ok = proc.returncode == 0 and all(n == 2 for n in passed.values())
    emit("dist", check="gloo_two_ranks_one_card", ranks=2, device="cuda:0", backend="gloo",
         model="BERTForPretrain at BERT-base width (768 units, 12 heads, vocab 30522), cut to "
               "2 layers; overlap: bf16, Adam mp; spmd: fp32, SGD momentum, one step",
         spmd_tol=DIST_SPMD_TOL, rc=proc.returncode, passed=passed, lines=lines,
         stderr_tail=proc.stderr[-1500:] if not ok else "", log=str(log),
         cohort_s=time.perf_counter() - t1, phase_s=time.perf_counter() - t0, card=smi, ok=ok)
    if not ok:
        sys.exit(1)


# -- phase 6f: the input pipeline ----------------------------------------------
# ResNet-50 trained from a record file: seeded synthetic JPEGs packed with
# mx.recordio, read by ImageRecordIter on the native decode pool inside a
# DataPipeline (pinned staging, its own copy stream) into SPMDTrainer;
# BERT-base windows staged by DataPipeline.stage_window into
# Trainer.fold_steps and SPMDTrainer.step_window; a DataLoader with process
# workers and pinned batches.
IO_RECORDS = 2048        # JPEGs in the record file: 8 batches of 256 an epoch
IO_IMAGE = (375, 500)    # their height and width (an ImageNet photo's usual size)
IO_QUALITY = 90
IO_MEAN = (123.68, 116.28, 103.53)  # ImageNet's, as CreateAugmenter's mean=True
IO_STD = (58.395, 57.12, 57.375)
IO_EPOCHS = 2            # epoch 1 checked (warm-up, capture, replays), epoch 2 timed
IO_DECODE_BATCHES = 4    # batches the iterator's decode alone is timed over
IO_WINDOW = 4            # stage_window's K
IO_BERT_BATCHES = 32     # the NDArrayIter's batches: 8 windows an epoch
IO_LOADER = (512, 256, 4)  # DataLoader samples, batch, process workers
# A decode of one of these JPEGs against the pixels it was encoded from, in
# [0, 255] units over a batch's center crops: quality 90 of the smooth
# fields io_image makes loses a mean of 0.95 and at most 13 with libjpeg
# (64 images at 500x375 and at 48x40, tests/test_torch_recordio.py holds
# it); twice that leaves another decoder's IDCT and chroma upsampling room
# to differ, and a wrong crop, channel order or scale exceeds it by far.
IO_JPEG_MEAN_ERR = 2.0
IO_JPEG_MAX_ERR = 26.0


def io_image(i, hw, classes, seed=0):
    """Record ``i``'s source pixels and label: a smooth random field at two
    scales (a photo's low frequencies), the same for a seed and index on
    every machine."""
    from PIL import Image

    rng = np.random.RandomState([seed, i])
    h, w = hw
    coarse = rng.randint(0, 256, (max(2, h // 60), max(2, w // 60), 3)).astype(np.uint8)
    fine = rng.randint(0, 256, (max(2, h // 15), max(2, w // 15), 3)).astype(np.uint8)
    a = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.uint16)
    b = np.asarray(Image.fromarray(fine).resize((w, h), Image.BILINEAR), np.uint16)
    return ((3 * a + b) // 4).astype(np.uint8), int(rng.randint(0, classes))


def io_record_file(path, n, hw, classes, seed=0):
    """Write ``n`` seeded JPEG records with ``recordio.pack_img`` (encoded on
    a thread a core); returns (labels, bytes)."""
    from incubator_mxnet_torch import recordio

    def one(i):
        img, label = io_image(i, hw, classes, seed)
        return recordio.pack_img(recordio.IRHeader(0, float(label), i, 0), img,
                                 quality=IO_QUALITY), label

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        packed = list(pool.map(one, range(n)))
    w = recordio.MXRecordIO(path, "w")
    for rec, _ in packed:
        w.write(rec)
    w.close()
    return [lab for _, lab in packed], sum(len(rec) for rec, _ in packed)


def _io_probe():
    """Pillow's version, where the compiler would find libjpeg, nvJPEG under
    the CUDA toolkit, the cores: printed before the phase."""
    import ctypes.util
    import glob

    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = "absent"
    heads = [p for d in ("/usr/include", "/usr/local/include")
             for p in glob.glob(f"{d}/jpeglib.h") + glob.glob(f"{d}/*/jpeglib.h")]
    libs = [p for d in ("/usr/lib", "/usr/lib64", "/usr/local/lib", "/usr/lib/x86_64-linux-gnu")
            for p in glob.glob(f"{d}/libjpeg.so*")]
    from incubator_mxnet_torch.io import _native

    cuda = _native.CUDA_HOME
    return dict(pillow=pillow, jpeglib_h=heads or "absent",
                libjpeg_so=libs or ctypes.util.find_library("jpeg") or "absent",
                nvjpeg_h=str(cuda / "include" / "nvjpeg.h")
                if (cuda / "include" / "nvjpeg.h").exists() else "absent",
                cpu_count=os.cpu_count())


@contextlib.contextmanager
def _span_names():
    """Count the profiler spans recorded inside the scope, by name."""
    from incubator_mxnet_torch import profiler

    names, orig = {}, profiler.record_span

    def counting(name, *args, **kwargs):
        names[name] = names.get(name, 0) + 1
        return orig(name, *args, **kwargs)

    profiler.record_span = counting
    try:
        yield names
    finally:
        profiler.record_span = orig


def _io_epoch(pipe, tr, snaps, first=None):
    """One epoch of SPMD steps on the pipeline's batches: each delivered
    batch cloned on the consumer's stream at delivery (what the step
    reads) beside its host batch; returns the losses (device tensors)."""
    losses = []
    for batch in pipe:
        data, label = batch.data[0], batch.label[0]
        snaps.append((data._data.clone(), label._data.clone(), batch.index))
        losses.append(tr.step(data, label)._data)
        if first is not None and not first:
            first.update(kernels=kernel_counts(),
                         variants=dict(mt.multi_tensor_update.launches_by_variant),
                         passthrough=all(a is b._data for a, b in zip(
                             tr.shard_batch(data, label), (data, label))))
    return losses


def _io_held(snaps):
    """(every delivered batch bit-equal to its host batch, the epoch's
    labels from the host batches)."""
    equal = all(torch.equal(d.cpu(), h[0]) and torch.equal(lab.cpu(), h[1])
                for d, lab, h in snaps)
    labels = sorted(int(x) for _, _, h in snaps for x in h[1].tolist())
    return equal, labels


def _io_record_leg(rehearsal, ctx, smi, tmp):
    """ResNet-50 v1 (bench.py's: B=256, AMP bf16, SGD momentum) through
    SPMDTrainer on make_mesh(), fed from a record file of IO_RECORDS seeded
    JPEGs by ImageRecordIter in a DataPipeline.  Returns (counts, ok)."""
    from incubator_mxnet_torch import parallel, profiler
    from incubator_mxnet_torch.io import DataPipeline, ImageRecordIter

    n, hw, crop, b = ((64, (40, 48), 32, 16) if rehearsal
                      else (IO_RECORDS, IO_IMAGE, 224, RESNET_B))
    classes = TINY_RESNET["classes"] if rehearsal else 1000
    threads = min(os.cpu_count() or 1, 16)
    sync = (lambda: None) if rehearsal else torch.cuda.synchronize
    rec = os.path.join(tmp, "train.rec")
    t0 = time.perf_counter()
    labels, nbytes = io_record_file(rec, n, hw, classes)
    write_s = time.perf_counter() - t0
    base = dict(data_shape=(3, crop, crop), batch_size=b, preprocess_threads=threads)

    # the decoder against the source pixels: unaugmented, unnormalised, in order
    fid = ImageRecordIter(rec, **base)
    got = fid.next().data[0].asnumpy()
    y0, x0 = (hw[0] - crop) // 2, (hw[1] - crop) // 2
    ref = np.stack([io_image(i, hw, classes)[0][y0:y0 + crop, x0:x0 + crop].transpose(2, 0, 1)
                    for i in range(b)]).astype(np.float32)
    err = np.abs(got - ref)
    fidelity = dict(mean_abs_err=float(err.mean()), max_abs_err=float(err.max()),
                    bounds=[IO_JPEG_MEAN_ERR, IO_JPEG_MAX_ERR],
                    ok=bool(err.mean() <= IO_JPEG_MEAN_ERR and err.max() <= IO_JPEG_MAX_ERR))
    del fid

    aug = dict(base, shuffle=True, rand_crop=True, rand_mirror=True, seed=0,
               mean_r=IO_MEAN[0], mean_g=IO_MEAN[1], mean_b=IO_MEAN[2],
               std_r=IO_STD[0], std_g=IO_STD[1], std_b=IO_STD[2])
    alone = ImageRecordIter(rec, **aug)
    t1 = time.perf_counter()
    for _ in range(IO_DECODE_BATCHES):
        alone.next()
    decode_img_s = IO_DECODE_BATCHES * b / (time.perf_counter() - t1)
    del alone

    it = ImageRecordIter(rec, **aug)

    def keep(batch):  # the host batch, held for the check after the steps
        batch.index = [a._data for a in batch.data + batch.label]
        return batch

    mesh = _spmd_mesh(ctx)
    pipe = DataPipeline(it, prep_fn=keep, mesh=mesh, name="io_record")
    mx.amp.init("bfloat16")
    profiler.set_config(slow_step_ms=1e9)  # telemetry: step_stats for the autotuner, goodput
    try:
        net = _build_resnet(rehearsal, ctx, 0)
        n_bn = sum(isinstance(m, mx.gluon.nn.BatchNorm) for m in net.modules())
        tr = parallel.SPMDTrainer(net, ce_loss, "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}, mesh=mesh)
        first = {}
        snaps = []
        reset_kernel_counts()
        with _span_names() as spans:
            losses = _io_epoch(pipe, tr, snaps, first)
            sync()
            held = [_io_held(snaps)]
            resident = snaps[-1][:2]
            snaps = []

            def resident_turn():
                for _ in range(n // b):
                    tr.step(*resident)

            def pipeline_turn():
                losses.extend(_io_epoch(pipe, tr, snaps))

            turns = []
            for name, fn in (("resident", resident_turn), ("pipeline", pipeline_turn),
                             ("resident", resident_turn)):
                if name == "pipeline":
                    profiler.reset_goodput()
                sync()
                t2 = time.perf_counter()
                fn()
                sync()
                turns.append(dict(turn=name, img_s=n / (time.perf_counter() - t2)))
                if name == "pipeline":
                    goodput = profiler.goodput_snapshot()
            held.append(_io_held(snaps))
        stats = pipe.stats()
        prog = tr._programs["step"]
        loss_values = [float(x) for x in losses]
    finally:
        pipe.close()
        profiler.set_config(slow_step_ms=None)
        mx.amp.disable()
    want = {k: 0 for k in ENTRIES}
    if not rehearsal:
        want.update(bn_stats=n_bn, bn_apply=n_bn, multi_tensor=1)
    finite = all(math.isfinite(x) for x in loss_values)
    perm = [lab == sorted(labels) for _, lab in held]
    wall = goodput["wall_s"] or float("nan")
    checks = dict(native=it.native, decoder_fidelity=fidelity["ok"],
                  bit_equal=[eq for eq, _ in held], labels_permutation=perm,
                  finite=finite, launches=first.get("kernels") == want,
                  variants=first.get("variants") == ({} if rehearsal else {"sgd_mom": 1}),
                  passthrough=bool(first.get("passthrough")),
                  no_shard_batch_span=spans.get("spmd.shard_batch", 0) == 0,
                  steps=len(loss_values) == IO_EPOCHS * n // b,
                  captured=prog.captured == (not rehearsal) and tr.fallback_reason is None)
    ok = all(all(v) if isinstance(v, list) else bool(v) for v in checks.values())
    emit("io", leg="record", model=("resnet50_v1 AMP bf16, SGD momentum" if not rehearsal
                                    else "tiny ResNetV1 (CPU rehearsal)"),
         records=n, image_hw=list(hw), jpeg_quality=IO_QUALITY, record_bytes=nbytes,
         write_s=write_s, batch=b, preprocess_threads=threads, cpu_count=os.cpu_count(),
         native=it.native, decoder=it.decoder, decoder_vs_source=fidelity,
         decode_alone_img_s=decode_img_s, epochs=IO_EPOCHS, steps=len(loss_values),
         losses=loss_values, launches_first_step=first.get("kernels"), expected=want,
         multi_tensor_by_variant=first.get("variants"), spans=dict(spans), turns=turns,
         data_wait_share=goodput["buckets_s"]["data_wait"] / wall,
         goodput=goodput["buckets_s"], goodput_wall_s=goodput["wall_s"],
         io_pipeline_stalls=stats["stalls"], stalls_warm=stats["stalls_warm"],
         autotuned_depth=stats["depth"], depth_changes=stats["depth_changes"],
         stall_ms_p50=stats["stall_ms_p50"], stall_ms_p99=stats["stall_ms_p99"],
         checks=checks, card=smi, ok=ok)
    del net, tr, pipe, it, snaps, resident, prog
    profiler.disarm_compile_guard()
    if not rehearsal:
        torch.cuda.empty_cache()
    return first.get("kernels") or {}, ok


def _io_window_leg(rehearsal, ctx, smi):
    """BERT-base (bench.py's: B=64, S=128, P=20, bf16, fp32 Adam masters)
    windows of IO_WINDOW batches staged by ``DataPipeline.stage_window``
    from an ``NDArrayIter`` into ``Trainer.fold_steps`` and
    ``SPMDTrainer.step_window``, each against the same windows stacked by
    the caller (dropout 0, deterministic mode); then one replay's kernels
    by name.  Returns (counts of one window, ok)."""
    from incubator_mxnet_torch import parallel
    from incubator_mxnet_torch.io import DataPipeline, NDArrayIter

    cfg = dict(TINY_BERT if rehearsal else BERT_BASE, dropout=0.0)
    b, s, p = (4, 16, 3) if rehearsal else (64, 128, 20)
    k, nb = IO_WINDOW, IO_BERT_BATCHES
    device = ctx.device
    rng = np.random.RandomState(43)
    arrays = [rng.randint(0, cfg["vocab_size"], (nb * b, s)), rng.randint(0, 2, (nb * b, s)),
              rng.randint(0, s, (nb * b, p)), rng.randint(0, cfg["vocab_size"], (nb * b, p))]
    arrays = [a.astype(np.int32) for a in arrays]
    mesh = _spmd_mesh(ctx)
    adam = ("adam", {"learning_rate": 1e-4, "multi_precision": True})
    layers = cfg.get("num_layers", 12)
    want = {"flash_fwd": k * layers, "flash_bwd_dq": k * layers, "flash_bwd_dkv": k * layers,
            "multi_tensor": k}

    def pipeline():
        return DataPipeline(NDArrayIter(arrays[:3], arrays[3], batch_size=b), mesh=mesh,
                            name="io_window")

    def caller(w):  # batches w*k .. w*k+k-1 as the caller stacks them
        rows = slice(w * k * b, (w + 1) * k * b)
        return [torch.from_numpy(a[rows].reshape(k, b, *a.shape[1:])).to(device)
                for a in arrays]

    def delivered(window):
        return [x._data for x in window.data + window.label]

    def make():
        net = _build_net(cfg, ctx, "bfloat16")
        with mx.autograd.predict_mode():  # finish the deferred shapes
            net(*(x[0] for x in caller(0)[:3]))
        return net

    def fold_run(windows):
        net = make()
        trainer = mx.gluon.Trainer(net.collect_params(), *adam)
        prog = trainer.fold_steps(bert_loss(net), k=k)
        losses = [prog(*w) for w in windows]
        return net, trainer, prog, losses

    def spmd_run(windows):
        net = make()
        tr = parallel.SPMDTrainer(net, mlm_loss, *adam, mesh=mesh)
        losses = [tr.step_window(w[:3], w[3])._data for w in windows]
        return net, tr, tr._programs["window"], losses

    results = {}
    with _deterministic(bert=True):
        for name, run in (("fold_steps", fold_run), ("step_window", spmd_run)):
            pipe = pipeline()
            try:
                windows = [delivered(pipe.stage_window(k)) for _ in range(2)]
                stacked_equal = all(torch.equal(x, y) for w in range(2)
                                    for x, y in zip(windows[w], caller(w)))
                net, tr, prog, losses_a = run(windows)
                snap_a = _keyed(net, getattr(tr, "_trainer", tr))
                if name == "fold_steps":  # the rest of the epoch; one replay traced
                    rest = []
                    while True:
                        try:
                            rest.append(delivered(pipe.stage_window()))
                        except StopIteration:
                            break
                    tries, moved = (([], {}) if rehearsal else
                                    _replay_kernels(lambda: prog(*rest[0]), want))
                    shapes = [int(w[0].shape[0]) for w in windows + rest]
                    results["epoch_windows"] = shapes
                    results["replay"] = (tries, moved)
                captured = prog.captured
            finally:
                pipe.close()
            del net, tr, prog, windows
            mx.profiler.disarm_compile_guard()
            if not rehearsal:
                torch.cuda.empty_cache()
            net, tr, prog, losses_b = run([caller(0), caller(1)])
            equal, err = _keyed_compare(snap_a, _keyed(net, getattr(tr, "_trainer", tr)))
            loss_eq, loss_err = _compare(losses_a, losses_b)
            results[name] = dict(windows_equal_caller_stacked=stacked_equal,
                                 params_and_states=dict(bit_equal=equal, max_abs_err=err),
                                 losses=dict(bit_equal=loss_eq, max_abs_err=loss_err),
                                 captured=captured,
                                 ok=stacked_equal and equal and loss_eq
                                 and captured == (not rehearsal))
            del net, tr, prog, snap_a
            mx.profiler.disarm_compile_guard()
            if not rehearsal:
                torch.cuda.empty_cache()
    tries, moved = results["replay"]
    replay_ok = rehearsal or (tries[-1] == want and not moved)
    shapes = results["epoch_windows"]
    tail_ok = shapes == [k] * (nb // k)
    ok = results["fold_steps"]["ok"] and results["step_window"]["ok"] and replay_ok and tail_ok
    emit("io", leg="window", model=("BERTForPretrain(bert_base) bf16, Adam mp, dropout 0 "
                                    "(deterministic algorithms)" if not rehearsal
                                    else "tiny BERT (CPU rehearsal)"),
         batch=[b, s, p], k=k, source_batches=nb, epoch_window_sizes=shapes,
         fold_steps=results["fold_steps"], step_window=results["step_window"],
         replay_kernels=tries[-1] if tries else None, replay_kernel_tries=len(tries),
         expected_replay_kernels=None if rehearsal else want,
         python_counts_moved_by_replay=moved, card=smi, ok=ok)
    return (tries[-1] if tries else {}), ok


def _io_loader_leg(rehearsal, ctx, smi):
    """``gluon.data.DataLoader`` over ``SyntheticImageDataset`` with
    ``transform_first(Compose([ToTensor(), Normalize(...)]))``, process
    workers and ``pin_memory``: two batches arrive pinned, go to the card
    and equal their CPU values and the main process's own transform."""
    from incubator_mxnet_torch.gluon.data import DataLoader
    from incubator_mxnet_torch.gluon.data.vision import SyntheticImageDataset
    from incubator_mxnet_torch.gluon.data.vision import transforms as T

    n, b, workers = (8, 4, 2) if rehearsal else IO_LOADER
    shape = (32, 32, 3) if rehearsal else (224, 224, 3)
    ds = SyntheticImageDataset(num_samples=n, shape=shape, classes=1000, seed=5)
    tds = ds.transform_first(T.Compose([T.ToTensor(),
                                        T.Normalize([m / 255 for m in IO_MEAN],
                                                    [d / 255 for d in IO_STD])]))
    t0 = time.perf_counter()
    loader = DataLoader(tds, batch_size=b, num_workers=workers, pin_memory=not rehearsal,
                        thread_pool=rehearsal)
    rows = []
    for j, (data, label) in enumerate(loader):
        on_card = data._data.to(ctx.device, non_blocking=True)
        lab_card = label._data.to(ctx.device, non_blocking=True)
        if not rehearsal:
            torch.cuda.synchronize()
        own = torch.stack([tds[i][0]._data for i in range(j * b, j * b + min(8, b))])
        rows.append(dict(shape=list(data.shape), dtype=str(data.dtype), context=str(data.context),
                         pinned=bool(data._data.is_pinned()) if not rehearsal else None,
                         card_equal=bool(torch.equal(on_card.cpu(), data._data)
                                         and torch.equal(lab_card.cpu(), label._data)),
                         first8_equal_own_transform=bool(torch.equal(data._data[:len(own)],
                                                                     own))))
    loader_s = time.perf_counter() - t0
    ok = (len(rows) == n // b and all(r["card_equal"] and r["first8_equal_own_transform"]
                                      and (rehearsal or (r["pinned"]
                                                         and r["context"] == "cpu_pinned(0)"))
                                      for r in rows))
    emit("io", leg="dataloader", samples=n, batch=b, num_workers=workers,
         pin_memory=not rehearsal, batches=rows, loader_s=loader_s, card=smi, ok=ok)
    return ok


def phase_io(rehearsal, smi=None):
    """The input pipeline on the card: the probe line, then the record leg
    (ResNet-50 from a record file), the window leg (BERT-base windows) and
    the DataLoader leg.  Returns {"io": launch counts of one ResNet-50 step
    and one BERT-base window}; exits non-zero on any miss."""
    import tempfile

    t0 = time.perf_counter()
    mx.profiler.disarm_compile_guard()  # earlier phases' programs armed it: these are new
    probe = _io_probe()
    emit("io", probe=probe)
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    tmp = tempfile.mkdtemp(prefix="mxnet_io_")
    misses = []
    try:
        resnet_counts, ok = _io_record_leg(rehearsal, ctx, smi, tmp)
        if not ok:
            misses.append("record")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    window_counts, ok = _io_window_leg(rehearsal, ctx, smi)
    if not ok:
        misses.append("window")
    if not _io_loader_leg(rehearsal, ctx, smi):
        misses.append("dataloader")
    emit("io", phase_s=time.perf_counter() - t0, failed=misses, ok=not misses)
    if misses:
        sys.exit(1)
    return {"io": {name: resnet_counts.get(name, 0) + window_counts.get(name, 0)
                   for name in ENTRIES}}


# -- phase 6g: detect ---------------------------------------------------------
# bench.py's config 5 on the card: SSD-512 on a ResNet-18 backbone (B=32,
# 512x512, SGD lr 0.01 momentum 0.9 wd 5e-4, bench_ssd) and YOLOv3 on
# Darknet-53 (B=16, 416x416, SGD lr 1e-3 momentum 0.9 wd 5e-4,
# bench_yolo3), both under AMP bf16 through SPMDTrainer on make_mesh(),
# bench.py's seeded images and label rows.  Their BatchNorms run the BN
# kernels at new shapes: SSD's downsamplers reach 2x2 and 1x1 maps (HW = 1
# takes _check_x's no-stride branch), Darknet's 13x13 and 26x26 maps give
# rows of 338 and 1352 bytes in bf16, most of them off a 16-byte boundary
# (bn.cu's scalar heads and tails).
DETECT_SSD = dict(b=32, size=512, classes=20, lr=0.01, rows=(
    (1, 0.2, 0.2, 0.7, 0.7), (5, 0.5, 0.5, 0.9, 0.9)), max_objects=4)
DETECT_YOLO = dict(b=16, size=416, classes=80, lr=1e-3, rows=(
    (1, 80, 80, 280, 280), (7, 200, 120, 380, 360)), max_objects=8)
DETECT_REPLAYS = 20      # timed replays of each main path; the losses must fall over them
DETECT_EXACT_STEPS = 2   # SPMD steps against eager steps, bit for bit
# The card's fp32 forward (train-mode BatchNorm, TF32 off) against the
# port's CPU fp32 forward of the same weights, relative L2 error of each
# output: the two differ by summation order and algorithm, about one fp32
# rounding per op, which a forward through 20-75 convolutions and
# BatchNorms grows to ~1e-5; a wrong kernel moves outputs by their own
# size.  The bound is RESNET_FP32_LOGIT_REL_BOUND's, which holds ResNet-50.
DETECT_FWD_REL_BOUND = RESNET_FP32_LOGIT_REL_BOUND
# multibox_target's box targets: the same float32 arithmetic on both, with
# log and division within an ulp; yolo3_decode's boxes and scores: exp and
# sigmoid within a few ulps of values up to ~1e4 pixels.
DETECT_BOX_REL = 1e-6
DETECT_DECODE_REL = 1e-5
DETECT_NMS_AMBIGUOUS = 1e-6  # an IoU this close to the threshold may round either way
DETECT_ITER = dict(images=64, hw=(375, 500))
# The rest of the vision zoo: one train-mode forward and backward each at
# its published input size, AMP bf16.
DETECT_ZOO = (("alexnet", 224), ("vgg16_bn", 224), ("mobilenet1.0", 224),
              ("mobilenetv2_1.0", 224), ("squeezenet1.1", 224), ("densenet121", 224),
              ("inceptionv3", 299))
DETECT_ZOO_B = 8


def ssd_bench_loss(out, label):
    """bench.py's ``ssd_loss``: multibox_target on the class predictions
    swapped to [B, C+1, N], the per-sample streaming CE over the anchors
    and the masked L1 of the box regression."""
    anchors, cls_preds, box_preds = out
    bt, bm, ct = detection_ops.multibox_target(anchors, label, cls_preds.transpose(1, 2))
    ce = streaming_softmax_ce(cls_preds, ct).mean(-1)
    return ce + ((box_preds - bt).abs() * bm).mean(-1)


def yolo_bench_loss(classes):
    """bench.py's ``yolo_loss`` (``mx.nd`` ops under the currency rule:
    tensors in, tensors out)."""
    def loss_fn(out, label):
        preds, off, anc, st = out
        gt_ids = mx.nd.slice_axis(label, axis=-1, begin=0, end=1)
        gt_boxes = mx.nd.slice_axis(label, axis=-1, begin=1, end=5)
        targets = yolo_zoo.yolo3_targets(gt_boxes, gt_ids, off, anc, st, classes)
        return yolo_zoo.yolo3_loss(preds, *targets, classes, reduction="none")
    return loss_fn


def _detect_cfgs(rehearsal):
    """(ssd, yolo) configurations: bench.py's, or tiny ones on the CPU."""
    if not rehearsal:
        return dict(DETECT_SSD), dict(DETECT_YOLO)
    return (dict(DETECT_SSD, b=2, size=64, classes=3, rows=DETECT_SSD["rows"]),
            dict(DETECT_YOLO, b=2, size=64, classes=3,
                 rows=((1, 8, 8, 30, 30), (2, 20, 12, 50, 40))))


def _detect_net(kind, cfg, ctx, rehearsal, seed=0):
    """A net of ``kind`` ("ssd", "vgg" or "yolo") from ``seed``, its shapes
    finished by a forward of zeros at B=2 as bench.py does."""
    mx.random.seed(seed)
    if rehearsal:
        if kind == "yolo":
            net = yolo_zoo.YOLOV3(yolo_zoo.DarknetV3(layers=(1, 1, 1, 1, 1),
                                                     channels=(8, 16, 32, 64, 128)),
                                  num_classes=cfg["classes"], channels=(16, 32, 64))
        else:
            feat = mx.gluon.nn.HybridSequential()
            feat.add(mx.gluon.nn.Conv2D(16, kernel_size=3, strides=2, padding=1))
            if kind == "ssd":
                feat.add(mx.gluon.nn.BatchNorm())
            feat.add(mx.gluon.nn.Activation("relu"))
            net = ssd_zoo.SSD(feat, num_classes=cfg["classes"],
                              scales=ssd_zoo.SSDAnchorScales[:3], channels=32)
    else:
        net = {"ssd": ssd_zoo.ssd_512_resnet18, "vgg": ssd_zoo.ssd_512_vgg16_atrous,
               "yolo": yolo_zoo.yolo3_darknet53}[kind](num_classes=cfg["classes"])
    net.initialize(ctx=ctx)
    with mx.autograd.predict_mode():
        net(torch.zeros(2, 3, cfg["size"], cfg["size"], device=ctx.device))
    return net


def _detect_batch(cfg, device, seed=0):
    """bench.py's batch: ``rand`` images from RandomState(seed) and the
    label rows, padded with -1."""
    rng = np.random.RandomState(seed)
    img = rng.rand(cfg["b"], 3, cfg["size"], cfg["size"]).astype(np.float32)
    lab = np.full((cfg["b"], cfg["max_objects"], 5), -1, np.float32)
    for i, row in enumerate(cfg["rows"]):
        lab[:, i] = row
    return torch.from_numpy(img).to(device), torch.from_numpy(lab).to(device)


def _sgd(cfg):
    return ("sgd", {"learning_rate": cfg["lr"], "momentum": 0.9, "wd": 5e-4})


def _n_bn(net):
    return sum(isinstance(m, mx.gluon.nn.BatchNorm) for m in net.modules())


def _detect_exact(label, make, loss_fn, batch, ctx, rehearsal):
    """DETECT_EXACT_STEPS SPMDTrainer steps (warm-up, then capture and
    replay) against as many eager steps (``autograd.backward`` and
    ``Trainer.step``) on a second copy, in deterministic mode: parameters,
    running statistics, momenta and losses bit-equal."""
    from incubator_mxnet_torch import parallel

    net, opt = make()
    tr = parallel.SPMDTrainer(net, loss_fn, *opt, mesh=_spmd_mesh(ctx))
    loss_a = [tr.step([batch[0]], batch[1])._data for _ in range(DETECT_EXACT_STEPS)]
    snap_a = _keyed(net, tr._trainer)
    captured = tr._programs["step"].captured
    del net, tr
    mx.profiler.disarm_compile_guard()
    if not rehearsal:
        torch.cuda.empty_cache()
    net, opt = make()
    trainer = mx.gluon.Trainer(net.collect_params(), *opt)
    loss_b = [_eager_step(trainer, lambda x, y: loss_fn(net(x), y), batch).float().mean()
              for _ in range(DETECT_EXACT_STEPS)]
    equal, err = _keyed_compare(snap_a, _keyed(net, trainer))
    loss_eq, loss_err = _compare(loss_a, loss_b)
    ok = equal and loss_eq and captured == (not rehearsal)
    emit("detect", check="spmd_vs_eager", model=label, steps=DETECT_EXACT_STEPS,
         params_states_running_stats=dict(bit_equal=equal, max_abs_err=err),
         losses=dict(bit_equal=loss_eq, max_abs_err=loss_err,
                     spmd=[x.item() for x in loss_a]), spmd_captured=captured, ok=ok)
    del net, trainer
    mx.profiler.disarm_compile_guard()
    if not rehearsal:
        torch.cuda.empty_cache()
    return ok


def _bn_shapes(net):
    """Forward pre-hooks that record each BatchNorm input's (N, C, H·W)."""
    shapes, handles = set(), []
    for m in net.modules():
        if isinstance(m, mx.gluon.nn.BatchNorm):
            handles.append(m.register_forward_pre_hook(
                lambda _, args: shapes.add((args[0].shape[0], args[0].shape[1],
                                            math.prod(args[0].shape[2:])))))
    return shapes, handles


def _detect_main(label, net, cfg, loss_fn, batch, ctx, rehearsal, smi):
    """The main path: ``SPMDTrainer(net, loss_fn, "sgd", ..., mesh=make_mesh())``
    on one device-resident batch; the launch counts set to 0 just before
    the first step (the eager warm-up) and read just after it; the second
    step captures; DETECT_REPLAYS replays timed with CUDA events, their
    losses finite and falling; one replay's kernels by name in a profiler
    trace.  Returns (counts, BatchNorm input shapes, ok, profile), where
    ``profile()`` prints the device time of a replay and of an eager step
    by kernel family (None in the rehearsal): the caller runs it after
    every main path's counting trace, since a session with CPU activity
    makes kineto drop records of later traces (ROADMAP §3 "Not faults")."""
    from incubator_mxnet_torch import parallel

    sync = (lambda: None) if rehearsal else torch.cuda.synchronize
    n_bn = _n_bn(net)
    tr = parallel.SPMDTrainer(net, loss_fn, *_sgd(cfg), mesh=_spmd_mesh(ctx))
    shapes, handles = _bn_shapes(net)
    reset_kernel_counts()
    losses = [tr.step([batch[0]], batch[1]).asscalar()]
    counts = kernel_counts()
    variants = dict(mt.multi_tensor_update.launches_by_variant)
    for h in handles:
        h.remove()
    losses.append(tr.step([batch[0]], batch[1]).asscalar())  # capture and replay
    sync()
    outs = []
    if rehearsal:
        t0 = time.perf_counter()
        outs = [tr.step([batch[0]], batch[1]) for _ in range(DETECT_REPLAYS)]
        step_ms = (time.perf_counter() - t0) * 1e3 / DETECT_REPLAYS
    else:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [tr.step([batch[0]], batch[1]) for _ in range(DETECT_REPLAYS)]
        end.record()
        sync()
        step_ms = start.elapsed_time(end) / DETECT_REPLAYS
    losses += [o.asscalar() for o in outs]
    want = {n: 0 for n in ENTRIES}
    want_replay = {}
    if not rehearsal:
        want_replay = {"multi_tensor": 1}
        if n_bn:
            want_replay.update(bn_stats=n_bn, bn_apply=n_bn)
        want.update(want_replay)
    tries, moved = ([], {}) if rehearsal else _replay_kernels(
        lambda: tr.step([batch[0]], batch[1]), want_replay)
    prog = tr._programs["step"]
    finite = all(math.isfinite(x) for x in losses)
    n_params = sum(p.grad_req != "null" for p in net.collect_params().values())
    ok = (finite and losses[-1] < losses[0] and counts == want
          and variants == ({} if rehearsal else {"sgd_mom": 1}) and prog.folded
          and prog.captured == (not rehearsal) and tr.fallback_reason is None
          and (rehearsal or (tries[-1] == want_replay and not moved)))
    emit("detect", check="main_path", model=label, batch=cfg["b"], size=cfg["size"],
         batchnorms=n_bn, trainable_params=n_params, losses=losses, finite=finite,
         falling=losses[-1] < losses[0], launches_one_step=counts, expected=want,
         multi_tensor_by_variant=variants,
         replay_kernels=tries[-1] if tries else None, replay_kernel_tries=len(tries),
         expected_replay_kernels=None if rehearsal else want_replay,
         python_counts_moved_by_replay=moved, captured=prog.captured, folded=prog.folded,
         replays_timed=DETECT_REPLAYS,
         **({"step_host_ms": step_ms, "note": "CPU rehearsal: host time"} if rehearsal else
            {"step_ms": step_ms, "img_per_s": cfg["b"] * 1e3 / step_ms, "card": smi}),
         ok=ok)
    mx.profiler.disarm_compile_guard()

    def profile():
        # where the device time goes: one replay (its busy share), then one
        # eager step, whose BN backward shows as ``mx.bn_backward`` ranges
        # (a replay shows none: those kernels fall in "other")
        name = label.split("(")[0]
        phase_profile(f"detect {name} folded step (one replay)",
                      lambda: tr.step([batch[0]], batch[1]), smi)
        trainer = mx.gluon.Trainer(net.collect_params(), *_sgd(cfg))
        phase_profile(f"detect {name} eager step", lambda: _eager_step(
            trainer, lambda x, y: loss_fn(net(x), y), batch), smi)
        mx.profiler.disarm_compile_guard()

    return counts, shapes, ok, None if rehearsal else profile


def _detect_bn_kernels(shapes, device, dtype=torch.bfloat16, phase="detect"):
    """The BN kernels at a path's BatchNorm shapes (n, c, hw), in the
    path's dtype (the detection paths' bf16, as AMP gives them; the fit
    phase's fp32), against their plain versions on the card; emits under
    ``phase`` and returns the names of the cases that missed."""
    gen = torch.Generator(device=device).manual_seed(4242)
    size = torch.empty((), dtype=dtype).element_size()
    misses = []
    with torch.no_grad():
        for n, c, hw in sorted(shapes, key=lambda s: (s[2], s[1])):
            case = dict(name=f"n{n}_c{c}_hw{hw}", n=n, c=c, hw=hw, dtype=dtype)
            rec, _ = _bn_case(case, gen, device)
            emit(phase, check="bn_kernels_vs_plain", row_bytes=hw * size,
                 row_16b_aligned=(hw * size) % 16 == 0, stats_bound_rel=STATS_REL, **rec)
            if not rec["ok"]:
                misses.append(case["name"])
            torch.cuda.empty_cache()
    return misses


def _detect_fwd_vs_cpu(kind, cfg, ctx, rehearsal):
    """The card's fp32 forward at B=2 (train-mode BatchNorm, no recording)
    against the port's CPU fp32 forward of the same weights; returns
    (ok, the card net's outputs, the CPU net's outputs, the input)."""
    net = _detect_net(kind, cfg, ctx, rehearsal, seed=3)
    arrays = {k: p.data().detach().float().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}
    ref = _detect_net(kind, cfg, mx.cpu(), rehearsal, seed=3)
    load_numpy_params(ref, arrays)
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 3, cfg["size"], cfg["size"])
                         .astype(np.float32))
    with mx.autograd.train_mode():
        got = [o.detach().float().cpu() for o in net(x.to(ctx.device))]
        want = [o.detach().float() for o in ref(x)]
    rels = list(_rel_l2(dict(enumerate(got)), dict(enumerate(want))).values())
    tables_equal = [torch.equal(g, w) for g, w in zip(got, want)
                    if g.shape[0] == 1]  # anchors / decode tables: data-independent
    ok = all(math.isfinite(r) and r <= DETECT_FWD_REL_BOUND for r in rels) and all(tables_equal)
    emit("detect", check="fp32_forward_vs_cpu", model=kind, batch=2, size=cfg["size"],
         outputs_rel_l2=rels, bound=DETECT_FWD_REL_BOUND, tables_bit_equal=tables_equal, ok=ok)
    del net, ref
    return ok, got, x


def _targets_vs_cpu(anchors, cfg, device):
    """multibox_target on the card against the CPU on SSD's anchors: bench.py's
    rows and seeded rows of 0-4 valid boxes, mining off (bench.py) and on
    (3:1, ties in the scores); matches and class targets exact, box
    targets within DETECT_BOX_REL."""
    rng = np.random.RandomState(11)
    b, m, n = cfg["b"], cfg["max_objects"], anchors.shape[1]
    lab = np.full((b, m, 5), -1, np.float32)
    for i in range(b):
        for j in range(i % (m + 1)):
            x0, y0 = rng.rand(2) * 0.6
            lab[i, j] = [rng.randint(cfg["classes"]), x0, y0, x0 + 0.05 + 0.35 * rng.rand(),
                         y0 + 0.05 + 0.35 * rng.rand()]
    lab[0, :len(cfg["rows"])] = cfg["rows"]
    cls = rng.rand(b, cfg["classes"] + 1, n).astype(np.float32)
    cls[:, 0, : n // 4] = 0.25  # tied background scores
    out = {}
    for mining in (-1.0, 3.0):
        args = (anchors, torch.from_numpy(lab), torch.from_numpy(cls))
        want = detection_ops.multibox_target(*args, negative_mining_ratio=mining)
        got = [t.cpu() for t in detection_ops.multibox_target(
            *(a.to(device) for a in args), negative_mining_ratio=mining)]
        out[f"mining_{mining}"] = dict(
            matches_equal=torch.equal(got[1], want[1]),
            cls_targets_equal=torch.equal(got[2], want[2]),
            box_targets_max_rel=((got[0] - want[0]).abs()
                                 / (want[0].abs() + 1e-6)).max().item(),
            matched=int(want[1].sum().item() // 4), ignored=int((want[2] < 0).sum().item()))
    ok = all(r["matches_equal"] and r["cls_targets_equal"]
             and r["box_targets_max_rel"] <= DETECT_BOX_REL for r in out.values())
    emit("detect", check="multibox_target_vs_cpu", anchors=n, batch=b, bound_rel=DETECT_BOX_REL,
         **out, ok=ok)
    return ok


def _ambiguous_samples(boxes, thresh):
    """Samples whose candidate boxes have a pairwise IoU within
    DETECT_NMS_AMBIGUOUS of the NMS threshold (CPU, float64)."""
    iou = detection_ops.box_iou(boxes.double(), boxes.double())
    return ((iou - thresh).abs() < DETECT_NMS_AMBIGUOUS).flatten(1).any(1)


def _nms_vs_cpu(anchors, cfg, device):
    """multibox_detection (nms_topk 400) and box_nms (id_index 0, topk 400)
    on the card against the CPU: each sample's rows equal (classes,
    scores and the kept pattern exact, boxes within DETECT_BOX_REL of 1),
    samples with an IoU within DETECT_NMS_AMBIGUOUS of the threshold
    excused and counted."""
    rng = np.random.RandomState(13)
    b, n = cfg["b"], anchors.shape[1]
    logits = torch.from_numpy(rng.randn(b, cfg["classes"] + 1, n).astype(np.float32) * 3)
    prob = torch.softmax(logits, dim=1)
    loc = torch.from_numpy((rng.randn(b, n * 4) * 0.2).astype(np.float32))
    rows = {}
    want = detection_ops.multibox_detection(prob, loc, anchors)
    got = detection_ops.multibox_detection(prob.to(device), loc.to(device),
                                           anchors.to(device)).cpu()
    recs = torch.cat([torch.from_numpy(rng.randint(0, 3, (b, 1000, 1)).astype(np.float32)),
                      torch.from_numpy(rng.rand(b, 1000, 1).astype(np.float32)),
                      anchors[:, :1000].expand(b, -1, -1) + torch.from_numpy(
                          (rng.rand(b, 1000, 4) * 0.02).astype(np.float32))], dim=-1)
    nms_want = detection_ops.box_nms(recs, overlap_thresh=0.5, id_index=0, topk=400)
    nms_got = detection_ops.box_nms(recs.to(device), overlap_thresh=0.5, id_index=0,
                                    topk=400).cpu()
    score, _ = prob[:, 1:].max(dim=1)
    order = detection_ops._topk_order(score, score > 0.01, 400)
    decoded = detection_ops._decode_boxes(anchors.reshape(-1, 4), loc.reshape(b, n, 4),
                                          (0.1, 0.1, 0.2, 0.2), True)
    candidates = torch.gather(decoded, 1, order[..., None].expand(-1, -1, 4))
    ok = True
    for name, g, w, boxes in (("multibox_detection", got, want, candidates),
                              ("box_nms", nms_got, nms_want, recs[..., 2:6])):
        amb = _ambiguous_samples(boxes, 0.5)
        # coordinates are normalized: within DETECT_BOX_REL of 1
        same = [(torch.equal(g[i, :, :2], w[i, :, :2])
                 and ((g[i, :, 2:] - w[i, :, 2:]).abs()
                      <= DETECT_BOX_REL * w[i, :, 2:].abs().clamp_min(1.0)).all().item())
                for i in range(b)]
        bad = [i for i in range(b) if not same[i] and not amb[i]]
        first = None
        if bad:
            i = bad[0]
            j = int((g[i] != w[i]).any(-1).nonzero()[0].item())
            first = dict(sample=i, row=j, card=g[i, j].tolist(), cpu=w[i, j].tolist())
        rows[name] = dict(kept=int((w[..., 0] >= 0).sum().item()), samples_equal=sum(same),
                          ambiguous_samples=int(amb.sum().item()), unexcused_mismatch=bad,
                          first_mismatch=first)
        ok = ok and not bad
    emit("detect", check="nms_vs_cpu", batch=b, anchors=n, **rows, ok=ok)
    return ok


def _decode_vs_cpu(tables, cfg, device):
    """yolo3_decode on the card against the CPU, on seeded predictions and
    the YOLO net's decode tables: ids exact where the top two class scores
    differ by more than DETECT_DECODE_REL relative, scores and boxes within
    DETECT_DECODE_REL of their largest |value|."""
    off, anc, st = tables
    n = off.shape[1]
    preds = torch.from_numpy(np.random.RandomState(17).randn(cfg["b"], n, 5 + cfg["classes"])
                             .astype(np.float32))
    want = yolo_zoo.yolo3_decode(preds, off, anc, st, cfg["classes"])
    got = [t.cpu() for t in yolo_zoo.yolo3_decode(preds.to(device), off.to(device),
                                                   anc.to(device), st.to(device),
                                                   cfg["classes"])]
    rel = [((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
           for g, w in zip(got[1:], want[1:])]
    scores = torch.sigmoid(preds[..., 4:5]) * torch.sigmoid(preds[..., 5:])
    top2 = scores.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > DETECT_DECODE_REL * top2[..., 0]
    ids_mismatch = int(((got[0][..., 0] != want[0][..., 0]) & clear).sum().item())
    ok = all(r <= DETECT_DECODE_REL for r in rel) and ids_mismatch == 0
    emit("detect", check="yolo3_decode_vs_cpu", priors=n, batch=cfg["b"],
         scores_boxes_rel=rel, ids_mismatch_where_top2_clear=ids_mismatch,
         near_ties=int((~clear).sum().item()), bound=DETECT_DECODE_REL, ok=ok)
    return ok


def _det_iter_leg(cfg, net, ctx, rehearsal):
    """64 seeded images with boxes through ``ImageDetIter`` with
    ``CreateDetAugmenter(rand_mirror=True)`` (resized to the net's input),
    each batch copied to the card bit-equal to its host batch, into two
    SPMD steps of the SSD main path's net; finite losses."""
    from incubator_mxnet_torch import parallel

    rng = np.random.RandomState(19)
    h, w = (48, 64) if rehearsal else DETECT_ITER["hw"]
    samples = []
    for i in range(DETECT_ITER["images"] if not rehearsal else 2 * cfg["b"]):
        boxes = []
        for _ in range(1 + i % 3):
            x0, y0 = rng.rand(2) * 0.5
            boxes.append([rng.randint(cfg["classes"]), x0, y0, x0 + 0.1 + 0.4 * rng.rand(),
                          y0 + 0.1 + 0.4 * rng.rand()])
        samples.append((np.array(boxes, np.float32),
                        rng.randint(0, 256, (h, w, 3)).astype(np.uint8)))
    np.random.seed(23)
    it = mx.image.ImageDetIter(samples, batch_size=cfg["b"],
                               data_shape=(3, cfg["size"], cfg["size"]),
                               max_objects=cfg["max_objects"], rand_mirror=True)
    tr = parallel.SPMDTrainer(net, ssd_bench_loss, *_sgd(cfg), mesh=_spmd_mesh(ctx))
    equal, losses, batches = [], [], 0
    for batch in it:
        host_x, host_y = batch.data[0]._data, batch.label[0]._data
        x, y = host_x.to(ctx.device), host_y.to(ctx.device)
        equal.append(torch.equal(x.cpu(), host_x) and torch.equal(y.cpu(), host_y))
        losses.append(tr.step([x], y).asscalar())
        batches += 1
    ok = batches == 2 and all(equal) and all(math.isfinite(x) for x in losses)
    emit("detect", check="image_det_iter", images=len(samples), batches=batches,
         batch_bit_equal=equal, losses=losses, ok=ok)
    del tr
    mx.profiler.disarm_compile_guard()
    return ok


def _zoo_leg(ctx, rehearsal):
    """The rest of the vision zoo, AMP bf16, B=DETECT_ZOO_B: one train-mode
    forward and backward each at its published size; finite gradients,
    bn_stats and bn_apply launches equal to its BatchNorm count."""
    misses = []
    zoo = DETECT_ZOO if not rehearsal else (("squeezenet1.1", 64), ("mobilenetv2_0.25", 64))
    for name, size in zoo:
        mx.random.seed(0)
        net = vision.get_model(name, classes=10 if rehearsal else 1000)
        net.initialize(ctx=ctx)
        b = 2 if rehearsal else DETECT_ZOO_B
        gen = torch.Generator(device=ctx.device).manual_seed(31)
        x = torch.rand((b, 3, size, size), generator=gen, device=ctx.device)
        labels = torch.randint(0, 10, (b,), generator=gen, device=ctx.device)
        with mx.autograd.predict_mode():
            net(x[:1])  # finish the deferred shapes
        n_bn = _n_bn(net)
        mx.amp.init("bfloat16")
        try:
            reset_kernel_counts()
            t0 = time.perf_counter()
            with mx.autograd.record():
                loss = streaming_softmax_ce(net(x), labels)
            mx.autograd.backward(loss)
            if not rehearsal:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            counts = kernel_counts()
        finally:
            mx.amp.disable()
        grads = [p.grad() for p in net.collect_params().values() if p.grad_req != "null"]
        finite = all(bool(torch.isfinite(g).all()) for g in grads) and bool(
            torch.isfinite(loss).all())
        want_bn = 0 if rehearsal else n_bn
        ok = finite and counts["bn_stats"] == want_bn and counts["bn_apply"] == want_bn
        emit("detect", check="zoo_train_forward_backward", model=name, batch=b, size=size,
             batchnorms=n_bn, bn_stats=counts["bn_stats"], bn_apply=counts["bn_apply"],
             params=len(grads), finite=finite, first_call_wall_ms=wall_ms, ok=ok)
        if not ok:
            misses.append(name)
        del net, grads, loss
        if not rehearsal:
            torch.cuda.empty_cache()
    return misses


def phase_detect(rehearsal, smi=None):
    """bench.py's config 5 on the card (see the block above): correctness
    against the CPU first (fp32 forwards, the detection ops), then in
    deterministic mode two SPMD steps bit-equal to two eager steps for
    SSD-512 ResNet-18 and YOLOv3, then the main paths under AMP bf16 (launch
    counts, replays by name, timed replays), the BN kernels at their
    BatchNorm shapes, one SPMD step of SSD-512 VGG-16 atrous, the
    ImageDetIter leg and the rest of the zoo.  Returns {"detect": launch
    counts of one step each of SSD, YOLOv3 and SSD VGG-16}; exits non-zero
    on any miss."""
    t0 = time.perf_counter()
    mx.profiler.disarm_compile_guard()
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    scfg, ycfg = _detect_cfgs(rehearsal)
    misses = []

    # correctness on the card against the CPU, fp32
    ok, sout, _ = _detect_fwd_vs_cpu("ssd", scfg, ctx, rehearsal)
    anchors = sout[0]
    if not ok:
        misses.append("ssd_forward_vs_cpu")
    if not _detect_fwd_vs_cpu("yolo", ycfg, ctx, rehearsal)[0]:
        misses.append("yolo_forward_vs_cpu")
    ynet = _detect_net("yolo", ycfg, ctx, rehearsal)
    with mx.autograd.predict_mode():
        tables = [t.cpu() for t in ynet(torch.zeros(1, 3, ycfg["size"], ycfg["size"],
                                                     device=device))[1:]]
    del ynet
    if not rehearsal:
        if not _detect_fwd_vs_cpu("vgg", scfg, ctx, rehearsal)[0]:
            misses.append("vgg_forward_vs_cpu")
        if not _targets_vs_cpu(anchors, scfg, device):
            misses.append("multibox_target_vs_cpu")
        if not _nms_vs_cpu(anchors, scfg, device):
            misses.append("nms_vs_cpu")
        if not _decode_vs_cpu(tables, ycfg, device):
            misses.append("yolo3_decode_vs_cpu")
        torch.cuda.empty_cache()

    sbatch = _detect_batch(scfg, device)
    ybatch = _detect_batch(ycfg, device)
    yloss = yolo_bench_loss(ycfg["classes"])
    mx.amp.init("bfloat16")
    try:
        with _deterministic(bert=True):
            if not _detect_exact("ssd_512_resnet18 AMP bf16 (deterministic algorithms)",
                                 lambda: (_detect_net("ssd", scfg, ctx, rehearsal), _sgd(scfg)),
                                 ssd_bench_loss, sbatch, ctx, rehearsal):
                misses.append("ssd_vs_eager")
            if not _detect_exact("yolo3_darknet53 AMP bf16 (deterministic algorithms)",
                                 lambda: (_detect_net("yolo", ycfg, ctx, rehearsal),
                                          _sgd(ycfg)), yloss, ybatch, ctx, rehearsal):
                misses.append("yolo_vs_eager")
        net = _detect_net("ssd", scfg, ctx, rehearsal)
        counts, shapes, ok, ssd_profile = _detect_main(
            "ssd_512_resnet18(num_classes=20) AMP bf16, SGD momentum", net, scfg,
            ssd_bench_loss, sbatch, ctx, rehearsal, smi)
        if not ok:
            misses.append("ssd_main_path")
        if not _det_iter_leg(scfg, net, ctx, rehearsal):
            misses.append("image_det_iter")
        net = _detect_net("yolo", ycfg, ctx, rehearsal)
        c, s, ok, yolo_profile = _detect_main(
            "yolo3_darknet53(num_classes=80) AMP bf16, SGD momentum", net, ycfg, yloss,
            ybatch, ctx, rehearsal, smi)
        counts, shapes = {k: counts[k] + c[k] for k in counts}, shapes | s
        if not ok:
            misses.append("yolo_main_path")
        if not rehearsal:
            ssd_profile()
            yolo_profile()
        del net, ssd_profile, yolo_profile
        if not rehearsal:
            torch.cuda.empty_cache()
        # one SPMD step of SSD-512 VGG-16 atrous (BatchNorm only in the
        # downsamplers)
        from incubator_mxnet_torch import parallel

        net = _detect_net("vgg", scfg, ctx, rehearsal)
        n_bn = _n_bn(net)
        tr = parallel.SPMDTrainer(net, ssd_bench_loss, *_sgd(scfg), mesh=_spmd_mesh(ctx))
        reset_kernel_counts()
        loss = tr.step([sbatch[0]], sbatch[1]).asscalar()
        c = kernel_counts()
        want = {n: 0 for n in ENTRIES}
        if not rehearsal:
            want.update(bn_stats=n_bn, bn_apply=n_bn, multi_tensor=1)
        ok = math.isfinite(loss) and c == want
        emit("detect", check="vgg16_atrous_one_step", batch=scfg["b"], batchnorms=n_bn,
             loss=loss, launches_one_step=c, expected=want, ok=ok)
        counts = {k: counts[k] + c[k] for k in counts}
        if not ok:
            misses.append("vgg_one_step")
        del tr, net
        mx.profiler.disarm_compile_guard()
    finally:
        mx.amp.disable()
    if not rehearsal:
        torch.cuda.empty_cache()
        bad = _detect_bn_kernels(shapes, device)
        if bad:
            misses.append("bn_kernels:" + ",".join(bad))
    misses += [f"zoo:{m}" for m in _zoo_leg(ctx, rehearsal)]
    emit("detect", phase_s=time.perf_counter() - t0, failed=misses, ok=not misses)
    if misses:
        sys.exit(1)
    return {"detect": counts}


# -- phase 6h: fit -------------------------------------------------------------------------

FIT_EPOCHS = 2
FIT_BATCHES = 8          # batches of RESNET_B an epoch
FIT_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
FIT_TIMED = 5            # timed steps of each kind
# One Module step against one eager Gluon step from the same weights and
# batch (fp32, TF32 off, deterministic cuDNN): the forwards run the same
# ops, and the two backwards start from differently rounded loss gradients
# (SoftmaxOutput's p - onehot against streaming_softmax_ce's backward: an
# ulp or so of each logit's gradient), which the backward carries linearly
# into every parameter's gradient.  So each updated weight and momentum is
# held within FIT_STEP_REL of the step it took (the largest |after -
# before|), and each moving statistic within FIT_STATS_REL of its largest
# |value|.  The convolution biases a BatchNorm follows are left out: their
# exact gradient is zero, and what either side computes is rounding noise.
FIT_STEP_REL = 1e-3
FIT_STATS_REL = 1e-5
# The bucketing LSTM language model at the widths of the reference's
# example/rnn/bucketing/lstm_bucketing.py defaults (as recalled: the
# reference's sources are not in this repository), on a seeded synthetic
# corpus with bigram structure in place of PTB (its vocabulary size,
# sentences over the same buckets).  The learning rate is the reference's
# 0.01.
LM = dict(vocab=10000, embed=200, hidden=200, layers=2, batch=32,
          buckets=(10, 20, 30, 40, 50, 60), invalid_label=0, lr=0.01, wd=1e-5,
          sentences=3200, epochs=3, timed=5)
# the rehearsal's 40 words and 12 batches an epoch need a larger rate to learn
TINY_LM = dict(LM, vocab=40, embed=8, hidden=8, batch=4, buckets=(3, 5), sentences=48, lr=0.5)
# fp32 with TF32 off: cuDNN's LSTM against the unrolled cells' matrix
# products, and the card against the CPU, differ in summation order over
# 200-long dot products and 60 steps; relative to each array's largest
# |value|.  bf16 on the card against fp32 on the CPU: the JAX package's bf16
# RNN bound (tests/test_rnn.py's test_rnn_megaop_bf16).
LM_FUSED_REL = 1e-4
RNN_CARD_REL = 1e-4
RNN_BF16_REL = 5e-2
RNN_CARD_SHAPE = (60, 32, 200, 200, 2)  # T, N, C, H, layers: the LM's widths
TINY_RNN_SHAPE = (5, 3, 4, 6, 2)


def _fit_resnet_symbol(rehearsal, prefix):
    sr = _tests_module("sym_resnet")
    if rehearsal:
        cfg = TINY_RESNET
        return sr.resnet_v1_symbol(mx.sym, cfg["layers"], cfg["channels"], cfg["classes"],
                                   thumbnail=True, prefix=prefix)
    return sr.resnet_v1_symbol(mx.sym, prefix=prefix)


def _fit_images(n, size, classes, seed):
    """``n`` seeded float32 images whose mean colour names their class, so
    that the labels can be learnt, and the labels (float32, as an
    ``NDArrayIter`` gives them)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    x = rng.random((n, 3, size, size), dtype=np.float32)
    x *= 0.5
    x += rng.random((classes, 3, 1, 1), dtype=np.float32)[y]
    return x, y.astype(np.float32)


def _fit_params(net):
    """The Gluon net's parameters as the symbol graph's ``arg_params`` and
    ``aux_params`` (copies)."""
    params = net.collect_params()
    arg = {n: p.data().detach().clone() for n, p in params.items() if p.grad_req != "null"}
    aux = {n: p.data().detach().clone() for n, p in params.items() if p.grad_req == "null"}
    return arg, aux


class _LogLines(logging.Handler):
    """The log records of a ``fit`` (its epoch lines, Speedometer's)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def _captured_log():
    root = logging.getLogger()
    handler, level = _LogLines(), root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield handler.lines
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def _epoch_metric(lines, name):
    """{epoch: value} of fit's ``Epoch[e] Train-<name>=<value>`` lines."""
    got = {}
    for line in lines:
        m = re.match(rf"Epoch\[(\d+)\] Train-{re.escape(name)}=([-0-9.naie+]+)$", line)
        if m:
            got[int(m.group(1))] = float(m.group(2))
    return got


def _fit_vs_gluon(rehearsal, ctx, smi):
    """One Module step (``forward_backward`` + ``update``) against one eager
    Gluon step of the same net from the same weights and batch, the launches
    of the Module step counted and traced, then both steps timed.  Returns
    (ok, launch counts of the Module step)."""
    device = ctx.device
    sync = (lambda: None) if rehearsal else torch.cuda.synchronize
    b = 4 if rehearsal else RESNET_B
    size, classes = (32, TINY_RESNET["classes"]) if rehearsal else (224, 1000)
    net = _build_resnet(rehearsal, ctx, 3)
    n_bn = sum(isinstance(m, mx.gluon.nn.BatchNorm) for m in net.modules())
    arg, aux = _fit_params(net)
    sym = _fit_resnet_symbol(rehearsal, net.prefix)
    x, y = _fit_images(b, size, classes, 5)
    opt = dict(FIT_SGD, rescale_grad=1.0 / b)  # the reference Module's 1/batch_size
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    host_batch = mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())], [mx.nd.array(y, ctx=mx.cpu())])
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(FIT_SGD))
    img, lab = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device).int()

    def module_step(batch=host_batch):
        mod.forward_backward(batch)
        mod.update()

    with _deterministic(bert=False):
        reset_kernel_counts()
        ops_nn.batch_norm.reference_calls = 0
        module_step()
        sync()
        counts = kernel_counts()
        reference_calls = ops_nn.batch_norm.reference_calls
        out_dtype = mod.get_outputs()[0]._data.dtype
        resnet_step(net, trainer, (img, lab))
        sync()
    key = {p.name: i for i, p in enumerate(trainer._params)}
    worst = {"weight": 0.0, "momentum": 0.0, "moving_stat": 0.0}
    noise = 0.0
    for name, w0 in arg.items():
        wg = net.collect_params()[name].data().detach()
        wm = mod._exec.arg_dict[name]._data
        mg, mm = trainer._states[key[name]], mod._updater_states[name]
        if re.search(r"conv2d\d+_bias$", name):
            noise = max(noise, (wm - wg).abs().max().item())
            continue
        step = (wg - w0).abs().max().item()
        worst["weight"] = max(worst["weight"], (wm - wg).abs().max().item() / step)
        worst["momentum"] = max(worst["momentum"], (mm - mg).abs().max().item()
                                / max(mg.abs().max().item(), 1e-30))
    for name in aux:
        sg = net.collect_params()[name].data().detach()
        sm = mod._exec.aux_dict[name]._data
        worst["moving_stat"] = max(worst["moving_stat"],
                                   (sm - sg).abs().max().item() / sg.abs().max().item())
    want = {n: 0 for n in ENTRIES}
    want_traced = {}
    if not rehearsal:
        want_traced = {"bn_stats": n_bn, "bn_apply": n_bn}
        want.update(want_traced)
    tries, _ = ([], {}) if rehearsal else _replay_kernels(module_step, want_traced)
    ok = (worst["weight"] <= FIT_STEP_REL and worst["momentum"] <= FIT_STEP_REL
          and worst["moving_stat"] <= FIT_STATS_REL and counts == want
          and reference_calls == 0 and out_dtype == torch.float32
          and mx.ops.registry._amp is None
          and (rehearsal or tries[-1] == want_traced))
    emit("fit", check="module_step_vs_gluon_step", batch=b, batchnorms=n_bn,
         params=len(arg), max_rel_err=worst,
         bounds=dict(weight=FIT_STEP_REL, momentum=FIT_STEP_REL, moving_stat=FIT_STATS_REL),
         bn_fed_conv_bias_max_abs_err=noise, output_dtype=str(out_dtype),
         amp_policy=None if mx.ops.registry._amp is None else "on",
         launches_one_step=counts, expected=want, batchnorm_reference_calls=reference_calls,
         traced_kernels=tries[-1] if tries else None, traced_tries=len(tries),
         expected_traced=want_traced or None, ok=ok)

    # the steps timed: Module with its batch on the host (the copy to the
    # card inside), Module with the batch on the card, the per-tensor
    # update alone, the eager Gluon step and its Trainer.step alone
    card_batch = mx.io.DataBatch([mx.nd.NDArray(img, ctx=ctx)], [mx.nd.array(y, ctx=ctx)])
    iters = 1 if rehearsal else FIT_TIMED
    t = dict(module_step_ms=_time_steps(module_step, iters),
             module_step_card_batch_ms=_time_steps(lambda: module_step(card_batch), iters))
    mod.forward_backward(card_batch)
    t["module_update_ms"] = _time_steps(mod.update, iters)
    t["gluon_step_ms"] = _time_steps(lambda: resnet_step(net, trainer, (img, lab)), iters)
    resnet_step(net, None, (img, lab))
    t["gluon_trainer_step_ms"] = _time_steps(lambda: trainer.step(b), iters)
    t["host_to_card_copy_ms"] = _time_steps(lambda: host_batch.data[0]._data.to(device), iters)
    emit("fit", check="step_times", batch=b, **t,
         module_img_per_s=b * 1e3 / t["module_step_ms"],
         module_card_batch_img_per_s=b * 1e3 / t["module_step_card_batch_ms"],
         gluon_img_per_s=b * 1e3 / t["gluon_step_ms"], batch_bytes=x.nbytes,
         note="CPU rehearsal: host time" if rehearsal else "wall, card synchronized; fp32, "
         "TF32 off", card=smi)
    if not rehearsal:
        phase_profile("fit Module step (ResNet-50 v1, fp32, batch on the host)", module_step,
                      smi)
    return ok, counts


def _fit_resnet(rehearsal, ctx, smi, tmp):
    """``Module.fit`` for FIT_EPOCHS epochs of FIT_BATCHES batches from an
    ``NDArrayIter`` with the acc, top-5 and ce metrics, ``Speedometer`` and
    ``do_checkpoint``; the training cross-entropy falls from epoch 0 to 1;
    the checkpoint loads back equal; ``Module.load(..., 2,
    load_optimizer_states=True)`` takes one step bit-equal to the module
    that was not interrupted; ``score`` and ``predict`` on the card.
    Returns ok."""
    b = 4 if rehearsal else RESNET_B
    size, classes = (32, TINY_RESNET["classes"]) if rehearsal else (224, 1000)
    net = _build_resnet(rehearsal, ctx, 7)
    arg, aux = _fit_params(net)
    sym = _fit_resnet_symbol(rehearsal, net.prefix)
    del net
    x, y = _fit_images(b * FIT_BATCHES, size, classes, 9)
    train = mx.io.NDArrayIter(x, y, batch_size=b)
    opt = dict(FIT_SGD, rescale_grad=1.0 / b)
    prefix = os.path.join(tmp, "resnet50_v1")
    mod = mx.mod.Module(sym, context=ctx)
    metrics = ["acc", mx.metric.TopKAccuracy(5), "ce"]
    t0 = time.perf_counter()
    with _captured_log() as lines:
        mod.fit(train, eval_metric=metrics, optimizer="sgd", optimizer_params=opt,
                arg_params=arg, aux_params=aux, num_epoch=FIT_EPOCHS,
                batch_end_callback=mx.callback.Speedometer(b, 4),
                epoch_end_callback=mx.callback.do_checkpoint(prefix))
    fit_s = time.perf_counter() - t0
    ce = _epoch_metric(lines, "cross-entropy")
    speeds = [float(s) for line in lines for s in re.findall(r"Speed: ([0-9.]+)", line)]
    falls = len(ce) == FIT_EPOCHS and ce[1] < ce[0]
    # the epoch-2 checkpoint of do_checkpoint is what get_params holds
    _, ck_arg, ck_aux = mx.model.load_checkpoint(prefix, FIT_EPOCHS)
    marg, maux = mod.get_params()
    ck_equal = (sorted(ck_arg) == sorted(marg) and sorted(ck_aux) == sorted(maux)
                and all(torch.equal(ck_arg[k]._data, marg[k]._data.cpu()) for k in marg)
                and all(torch.equal(ck_aux[k]._data, maux[k]._data.cpu()) for k in maux))
    files = sorted(p for p in os.listdir(tmp) if p.startswith("resnet50_v1"))
    # resume: the states saved beside the epoch-2 parameters
    mod.save_checkpoint(prefix, FIT_EPOCHS, save_optimizer_states=True)
    resumed = mx.mod.Module.load(prefix, FIT_EPOCHS, load_optimizer_states=True, context=ctx)
    resumed.bind(train.provide_data, train.provide_label, for_training=True)
    resumed.init_params()
    resumed.init_optimizer(optimizer="sgd", optimizer_params=opt)
    train.reset()
    batch = next(iter(train))
    with _deterministic(bert=False):
        for m in (mod, resumed):
            m.forward_backward(batch)
            m.update()
    ra, rx = resumed.get_params()
    ma, mx_ = mod.get_params()
    resume_equal = (all(torch.equal(ra[k]._data, ma[k]._data) for k in ma)
                    and all(torch.equal(rx[k]._data, mx_[k]._data) for k in mx_)
                    and all(torch.equal(resumed._updater_states[k], mod._updater_states[k])
                            for k in mod._updater_states))
    del resumed
    # score and predict: two batches, on the card
    val = mx.io.NDArrayIter(x[:2 * b], y[:2 * b], batch_size=b)
    with _deterministic(bert=False):
        scored = dict(mod.score(val, ["acc", "ce"]))
        pred = mod.predict(val)
    probs = pred.asnumpy()
    pred_acc = float((probs.argmax(1) == y[:2 * b]).mean())
    pred_ok = (pred.shape == (2 * b, classes) and pred.context == ctx
               and bool(np.isfinite(probs).all())
               and np.abs(probs.sum(1) - 1).max() < 1e-4
               and abs(pred_acc - scored["accuracy"]) < 1e-9)
    ok = falls and ck_equal and resume_equal and pred_ok and len(speeds) >= 1
    emit("fit", check="module_fit", model="resnet50_v1 symbol (tests/sym_resnet.py)"
         if not rehearsal else "tiny ResNetV1 symbol (CPU rehearsal)", batch=b,
         epochs=FIT_EPOCHS, batches_an_epoch=FIT_BATCHES, optimizer=opt,
         train_cross_entropy_by_epoch=ce, falls=falls,
         epoch_lines=[ln for ln in lines if ln.startswith("Epoch")],
         speedometer_samples_per_s=speeds, fit_s=fit_s, checkpoint_files=files,
         checkpoint_equals_get_params=ck_equal, resumed_step_bit_equal=resume_equal,
         score=scored, predict_shape=list(pred.shape), predict_acc=pred_acc,
         predict_ok=pred_ok, card=smi, ok=ok)
    return ok


def lm_corpus(n, vocab, buckets, seed):
    """``n`` seeded sentences of 2 to the largest bucket's tokens (1 ..
    vocab - 1; 0 is the padding label), words drawn by Zipf's law (a
    word's frequency 1/rank, as a natural corpus such as PTB has them):
    each word is followed by one of its four successors nine times in ten,
    else by any word."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab)
    zipf /= zipf.sum()
    succ = rng.choice(vocab - 1, (vocab, 4), p=zipf) + 1
    lengths = rng.integers(2, max(buckets) + 1, n)
    out = []
    for length in lengths:
        words = rng.choice(vocab - 1, length, p=zipf) + 1
        picks, keep = rng.integers(0, 4, length), rng.random(length) < 0.9
        s = [int(words[0])]
        for i in range(1, length):
            s.append(int(succ[s[-1], picks[i]]) if keep[i] else int(words[i]))
        out.append(s)
    return out


def lm_sym_gen(cfg, unrolled=False):
    """The reference example's net for a bucket: embedding, a 2-layer LSTM
    (``FusedRNNCell``, or with ``unrolled`` a SequentialRNNCell of
    LSTMCells carrying the same parameter names after ``unpack_weights``),
    the vocabulary projection and ``SoftmaxOutput``."""
    S = mx.sym

    def sym_gen(seq_len):
        embed = S.Embedding(S.var("data"), input_dim=cfg["vocab"], output_dim=cfg["embed"],
                            name="embed")
        if unrolled:
            cell = mx.rnn.SequentialRNNCell()
            for i in range(cfg["layers"]):
                cell.add(mx.rnn.LSTMCell(cfg["hidden"], prefix=f"lstm_l{i}_"))
        else:
            cell = mx.rnn.FusedRNNCell(cfg["hidden"], num_layers=cfg["layers"], mode="lstm",
                                       prefix="lstm_")
        out, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = S.FullyConnected(S.Reshape(out, shape=(-1, cfg["hidden"])),
                                num_hidden=cfg["vocab"], name="pred")
        label = S.Reshape(S.var("softmax_label"), shape=(-1,))
        return S.SoftmaxOutput(pred, label, name="softmax"), ("data",), ("softmax_label",)

    return sym_gen


def _lm_fused_init(cfg):
    """The packed LSTM parameters as the reference's FusedRNN initializer
    fills them: Xavier(in, 2.34) on each weight matrix, the i2h biases
    ``LSTMBias(1.0)``, the h2h biases 0, packed by ``pack_weights``."""
    cell = mx.rnn.FusedRNNCell(cfg["hidden"], num_layers=cfg["layers"], mode="lstm",
                               prefix="lstm_")
    n = mx.ops.rnn_ops.rnn_param_size("lstm", cfg["embed"], cfg["hidden"], cfg["layers"])
    parts = cell.unpack_weights({"lstm_parameters": np.zeros(n, np.float32)})
    xavier = mx.init.Xavier(factor_type="in", magnitude=2.34)
    for name, v in parts.items():
        if name.endswith("weight"):
            xavier(mx.init.InitDesc(name), v._data)
        elif "i2h_bias" in name:
            mx.init.LSTMBias(1.0)(mx.init.InitDesc(name), v._data)
    return cell.pack_weights(parts)["lstm_parameters"]


def _lm(rehearsal, ctx, smi):
    """The bucketing LSTM language model: ``BucketingModule`` over
    ``sym.RNN`` (FusedRNNCell) fed by ``BucketSentenceIter``, ``fit`` for
    the epochs with ``Perplexity(0)``; perplexity falls, one shared
    parameter set after every bucket trained, tokens/s for each bucket; the
    fused graph against the unrolled cells at the smallest bucket.
    Returns ok."""
    cfg = TINY_LM if rehearsal else LM
    mx.random.seed(13)
    np.random.seed(13)  # BucketSentenceIter shuffles with numpy's global generator
    sentences = lm_corpus(cfg["sentences"], cfg["vocab"], cfg["buckets"], 17)
    it = mx.rnn.BucketSentenceIter(sentences, cfg["batch"], buckets=list(cfg["buckets"]),
                                   invalid_label=cfg["invalid_label"])
    bmod = mx.mod.BucketingModule(lm_sym_gen(cfg), default_bucket_key=it.default_bucket_key,
                                  context=ctx)
    opt = {"learning_rate": cfg["lr"], "momentum": 0.0, "wd": cfg["wd"],
           "rescale_grad": 1.0 / cfg["batch"]}
    t0 = time.perf_counter()
    with _captured_log() as lines:
        bmod.fit(it, eval_metric=mx.metric.Perplexity(cfg["invalid_label"]), optimizer="sgd",
                 optimizer_params=opt, num_epoch=cfg["epochs"],
                 initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
                 arg_params={"lstm_parameters": _lm_fused_init(cfg)}, allow_missing=True,
                 batch_end_callback=mx.callback.Speedometer(cfg["batch"], 50))
    fit_s = time.perf_counter() - t0
    ppl = _epoch_metric(lines, "perplexity")
    falls = (len(ppl) == cfg["epochs"]
             and all(ppl[e + 1] < ppl[e] for e in range(cfg["epochs"] - 1)))
    arg, aux = bmod.get_params()
    n_lstm = mx.ops.rnn_ops.rnn_param_size("lstm", cfg["embed"], cfg["hidden"], cfg["layers"])
    master = bmod._buckets[bmod._default_bucket_key]
    shared = (sorted(arg) == ["embed_weight", "lstm_parameters", "pred_bias", "pred_weight"]
              and not aux and arg["lstm_parameters"].shape == (n_lstm,)
              and sorted(bmod._buckets) == sorted(cfg["buckets"])
              and all(m._exec.arg_dict[k] is master._exec.arg_dict[k]
                      for m in bmod._buckets.values() for k in arg))
    # one batch of each bucket, its training step timed (tokens/s)
    it.reset()
    first = {}
    for batch in it:
        first.setdefault(batch.bucket_key, batch)
    tokens_per_s = {}
    for key in sorted(first):
        batch = first[key]

        def step(batch=batch):
            bmod.forward(batch, is_train=True)
            bmod.backward()
            bmod.update()

        ms = _time_steps(step, 1 if rehearsal else cfg["timed"])
        tokens_per_s[key] = cfg["batch"] * key * 1e3 / ms
    if not rehearsal:
        phase_profile(f"fit LSTM LM training step (bucket {key})", step, smi)
    fused_ok, fused_err = _lm_fused_vs_unrolled(cfg, ctx, arg, first[min(first)])
    ok = falls and shared and fused_ok
    emit("fit", check="bucketing_lstm_lm", widths=dict(
        vocab=cfg["vocab"], embed=cfg["embed"], hidden=cfg["hidden"], layers=cfg["layers"],
        batch=cfg["batch"], buckets=list(cfg["buckets"])), optimizer=opt,
         corpus=dict(sentences=cfg["sentences"], batches_an_epoch=len(it._plan)),
         perplexity_by_epoch=ppl, falls=falls, lstm_parameters=n_lstm,
         one_shared_parameter_set=shared, fit_s=fit_s,
         train_step_tokens_per_s_by_bucket=tokens_per_s,
         fused_vs_unrolled_max_rel_err=fused_err, fused_bound=LM_FUSED_REL,
         note="CPU rehearsal: host time" if rehearsal else "wall, card synchronized; fp32, "
         "TF32 off", card=smi, ok=ok)
    return ok


def _lm_fused_vs_unrolled(cfg, ctx, arg, batch):
    """The fused LM graph and the unrolled one (LSTMCells with the weights
    ``unpack_weights`` gives) at one bucket: outputs and every gradient
    (the fused one unpacked) within LM_FUSED_REL of the largest |value|."""
    key = batch.bucket_key
    shapes = {"data": batch.data[0].shape, "softmax_label": batch.label[0].shape}
    exes = []
    for unrolled in (False, True):
        sym = lm_sym_gen(cfg, unrolled)(key)[0]
        ex = sym.simple_bind(ctx, **shapes)
        params = ({k: v for k, v in arg.items()} if not unrolled else
                  mx.rnn.FusedRNNCell(cfg["hidden"], num_layers=cfg["layers"], mode="lstm",
                                      prefix="lstm_").unpack_weights(arg))
        ex.copy_params_from({"data": batch.data[0], "softmax_label": batch.label[0], **params})
        ex.forward(is_train=True)
        ex.backward()
        exes.append(ex)
    fused, cells = exes
    grads = mx.rnn.FusedRNNCell(cfg["hidden"], num_layers=cfg["layers"], mode="lstm",
                                prefix="lstm_").unpack_weights(
        {k: v for k, v in fused.grad_dict.items() if k not in ("data", "softmax_label")})
    pairs = [(fused.outputs[0], cells.outputs[0])] + [
        (g, cells.grad_dict[k]) for k, g in grads.items()]
    err = max((a._data - b._data).abs().max().item() / max(b._data.abs().max().item(), 1e-30)
              for a, b in pairs)
    return err <= LM_FUSED_REL, err


def _rnn_op_case(mode, bidirectional, dtype, shape, device, seed):
    """The RNN op's outputs and gradients (data, parameters, states) on
    ``device`` in ``dtype``, from seeded fp32 CPU inputs and head
    gradients; returned as fp32 CPU tensors."""
    T, N, C, H, L = shape
    dirs = 2 if bidirectional else 1
    gen = torch.Generator().manual_seed(seed)
    n = mx.ops.rnn_ops.rnn_param_size(mode, C, H, L, bidirectional)
    inputs = [torch.randn(T, N, C, generator=gen), torch.randn(n, generator=gen) * 0.08,
              torch.randn(L * dirs, N, H, generator=gen)]
    if mode == "lstm":
        inputs.append(torch.randn(L * dirs, N, H, generator=gen))
    leaves = [t.to(device=device, dtype=dtype).requires_grad_() for t in inputs]
    outs = mx.ops.rnn_ops.rnn_mega(*leaves, mode=mode, state_size=H, num_layers=L,
                                   bidirectional=bidirectional, state_outputs=True)
    seeds = [torch.randn(o.shape, generator=gen).to(device=device, dtype=dtype) for o in outs]
    grads = torch.autograd.grad(outs, leaves, seeds)
    return [t.detach().float().cpu() for t in list(outs) + list(grads)]


def _rnn_weight_copy_ms(shape, device, iters):
    """The LSTM op's forward and backward at ``shape`` (fp32), through the
    packed vector's views (which cuDNN copies into its own buffer at every
    call), beside ``torch.nn.LSTM`` with its weights flattened into
    cuDNN's buffer (the library call): what the copy costs."""
    T, N, C, H, L = shape
    gen = torch.Generator().manual_seed(71)
    x = torch.randn(T, N, C, generator=gen).to(device).requires_grad_()
    n = mx.ops.rnn_ops.rnn_param_size("lstm", C, H, L)
    packed = (torch.randn(n, generator=gen) * 0.08).to(device).requires_grad_()
    lib = torch.nn.LSTM(C, H, L).to(device)
    lib.flatten_parameters()

    def op():
        out = mx.ops.rnn_ops.rnn_mega(x, packed, mode="lstm", state_size=H, num_layers=L)
        torch.autograd.grad(out.sum(), (x, packed))

    def library():
        out = lib(x)[0]
        torch.autograd.grad(out.sum(), [x] + list(lib.parameters()))

    return dict(op_ms=_time_steps(op, iters), library_ms=_time_steps(library, iters))


def _rnn_card_vs_cpu(rehearsal, device):
    """The RNN op at the LM's widths on the card against the port's CPU
    result: all four modes, LSTM bidirectional, LSTM in bf16."""
    shape = TINY_RNN_SHAPE if rehearsal else RNN_CARD_SHAPE
    cases = [(m, False, torch.float32) for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")]
    cases += [("lstm", True, torch.float32), ("lstm", False, torch.bfloat16)]
    rows, ok = [], True
    for i, (mode, bi, dtype) in enumerate(cases):
        got = _rnn_op_case(mode, bi, dtype, shape, device, 40 + i)
        ref = _rnn_op_case(mode, bi, torch.float32, shape, torch.device("cpu"), 40 + i)
        errs = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                for a, b in zip(got, ref)]
        bound = RNN_BF16_REL if dtype == torch.bfloat16 else RNN_CARD_REL
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        rows.append(dict(mode=mode, bidirectional=bi, dtype=str(dtype).split(".")[1],
                         max_rel_err=max(errs), bound=bound))
        ok = ok and finite and max(errs) <= bound
    return ok, rows


def _gluon_rnn_card_vs_cpu(rehearsal, ctx):
    """``gluon.rnn.LSTM``, ``GRU`` (bidirectional) and ``RNN`` (2 layers,
    hidden 200) forward and backward on the card against the CPU with the
    same weights; ``LSTMCell.unroll`` against a one-layer ``LSTM`` with the
    same weights on the card."""
    T, N, C, H, _ = TINY_RNN_SHAPE if rehearsal else RNN_CARD_SHAPE
    cpu = mx.cpu()
    makes = {"LSTM": lambda: mx.gluon.rnn.LSTM(H, num_layers=2, input_size=C),
             "GRU": lambda: mx.gluon.rnn.GRU(H, num_layers=2, bidirectional=True, input_size=C),
             "RNN": lambda: mx.gluon.rnn.RNN(H, num_layers=2, input_size=C)}
    gen = torch.Generator().manual_seed(61)
    x = torch.randn(T, N, C, generator=gen)
    rows, ok = {}, True
    for name, make in makes.items():
        mx.random.seed(62)
        ref_net = make()
        ref_net.initialize(mx.init.Uniform(0.1), ctx=cpu)
        net = make()
        load_numpy_params(net, {k: p.data().detach() for k, p in
                                ref_net._collect_params_with_prefix().items()}, ctx=ctx)
        res = []
        for n, dev in ((net, ctx.device), (ref_net, torch.device("cpu"))):
            xin = x.to(dev)
            with mx.autograd.record():
                out = n(xin)
            w = torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)
            mx.autograd.backward(out, w)
            res.append([out.detach().cpu()] + [p.grad().detach().cpu() for p in
                                               n._collect_params_with_prefix().values()])
        err = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                  for a, b in zip(*res))
        rows[name] = err
        ok = ok and err <= RNN_CARD_REL
    layer = mx.gluon.rnn.LSTM(H, input_size=C)
    layer.initialize(mx.init.Uniform(0.1), ctx=ctx)
    cell = mx.gluon.rnn.LSTMCell(H, input_size=C)
    cell.initialize(ctx=ctx)
    for n in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, n).set_data(getattr(layer, "l0_" + n).data())
    xd = x.to(ctx.device)
    with mx.autograd.predict_mode():
        fused = layer(xd)
        unrolled, _ = cell.unroll(T, xd, layout="TNC")
    rows["LSTMCell.unroll_vs_LSTM"] = ((unrolled - fused).abs().max().item()
                                       / fused.abs().max().item())
    ok = ok and rows["LSTMCell.unroll_vs_LSTM"] <= RNN_CARD_REL
    return ok, rows


def phase_fit(rehearsal, smi=None):
    """The fit loop and the RNNs on the card (see the module doc): fp32,
    AMP off.  Returns {"fit": launch counts of one ResNet-50 Module step};
    exits non-zero on any miss."""
    import tempfile

    t0 = time.perf_counter()
    mx.amp.disable()  # the earlier phases' AMP is process-wide: fit runs fp32
    mx.profiler.disarm_compile_guard()
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    misses = []
    ok, counts = _fit_vs_gluon(rehearsal, ctx, smi)
    if not ok:
        misses.append("module_step_vs_gluon")
    if not rehearsal:
        torch.cuda.empty_cache()
        # the Module step's BN kernels run fp32 at B=256 on all nine
        # ResNet-50 shapes; the bn phase holds only two of them in fp32
        bad = _detect_bn_kernels([(RESNET_B, c, hw) for c, hw in RESNET_BN_SHAPES],
                                 ctx.device, torch.float32, phase="fit")
        if bad:
            misses.append("bn_kernels:" + ",".join(bad))
    tmp = tempfile.mkdtemp(prefix="mxnet_fit_")
    try:
        if not _fit_resnet(rehearsal, ctx, smi, tmp):
            misses.append("module_fit")
    finally:
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    if not rehearsal:
        torch.cuda.empty_cache()
    if not _lm(rehearsal, ctx, smi):
        misses.append("bucketing_lm")
    rnn_ok, rnn_rows = _rnn_card_vs_cpu(rehearsal, ctx.device)
    layers_ok, layer_rows = _gluon_rnn_card_vs_cpu(rehearsal, ctx)
    emit("fit", check="rnn_card_vs_cpu", op=rnn_rows, gluon_layers_max_rel_err=layer_rows,
         bound=RNN_CARD_REL, ok=rnn_ok and layers_ok)
    shape = TINY_RNN_SHAPE if rehearsal else RNN_CARD_SHAPE
    emit("fit", check="rnn_weight_copy", shape=dict(zip("TNCHL", shape)), mode="lstm fp32",
         **_rnn_weight_copy_ms(shape, ctx.device, 1 if rehearsal else 20),
         note="CPU rehearsal: host time" if rehearsal else
         "wall, card synchronized; forward and backward", card=smi)
    if not rnn_ok:
        misses.append("rnn_op_card_vs_cpu")
    if not layers_ok:
        misses.append("gluon_rnn_card_vs_cpu")
    emit("fit", phase_s=time.perf_counter() - t0, failed=misses, ok=not misses)
    if misses:
        sys.exit(1)
    return {"fit": counts}


# -- the op library: the line recogniser of example/ctc_ocr.py ----------------------

OCR_CLASSES = 11         # blank 0 and the digits 0-9 as 1-10
OCR_FEAT = 16            # a column's features
OCR_FRAMES_PER_CHAR = 3


def ocr_batch(rng, batch, max_len=5):
    """example/ctc_ocr.py's render_batch in numpy, the same draws: T x B x
    FEAT columns (each digit paints OCR_FRAMES_PER_CHAR columns with two hot
    rows) and 1-based labels padded with 0."""
    T = max_len * OCR_FRAMES_PER_CHAR + 2
    x = rng.rand(T, batch, OCR_FEAT).astype(np.float32) * 0.1
    labels = np.zeros((batch, max_len), np.float32)
    for b in range(batch):
        n = rng.randint(1, max_len + 1)
        digits = rng.randint(0, 10, n)
        labels[b, :n] = digits + 1
        for i, d in enumerate(digits):
            lo = i * OCR_FRAMES_PER_CHAR
            x[lo:lo + OCR_FRAMES_PER_CHAR, b, d] += 1.0
            x[lo:lo + OCR_FRAMES_PER_CHAR, b, 10 + (d % 6)] += 0.5
    return x, labels


class OCRNet(mx.gluon.HybridBlock):
    """example/ctc_ocr.py's OCRNet in the port: Dense(relu), a
    bidirectional LSTM and a Dense head over [T, B, FEAT] columns."""

    def __init__(self, hidden=64, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.proj = mx.gluon.nn.Dense(hidden, activation="relu", flatten=False)
            self.lstm = mx.gluon.rnn.LSTM(hidden, bidirectional=True)
            self.head = mx.gluon.nn.Dense(OCR_CLASSES, flatten=False)

    def forward(self, x):
        return self.head(self.lstm(self.proj(x)))


def greedy_decode(logits):
    """Argmax a frame, repeats collapsed, blanks dropped: one list a sample."""
    ids = logits.detach().cpu().numpy().argmax(-1)
    out = []
    for b in range(ids.shape[1]):
        seq, prev = [], -1
        for s in ids[:, b]:
            if s != prev and s != 0:
                seq.append(int(s))
            prev = s
        out.append(seq)
    return out


OCR_TRAIN = dict(hidden=64, batch=32, epochs=10, batches=25, lr=3e-3)
TINY_OCR = dict(hidden=8, batch=4, epochs=2, batches=3, lr=3e-3)
CTC_CARD_REL = 1e-4      # the first step's loss and gradients, card against CPU (fp32)
INTERLEAVED = dict(b=64, s=128, h=12, d=64)          # BERT-base self-attention
ENCDEC = dict(b=16, sq=128, sk=128, h=16, d=64)      # transformer-big cross-attention
TINY_INTERLEAVED = dict(b=2, s=8, h=2, d=16)
TINY_ENCDEC = dict(b=2, sq=5, sk=7, h=2, d=16)
INTERLEAVED_F32_REL = 1e-5   # vs flash_wide_fwd_f32_rows (split TF32, ~2.5e-6 of max|o|)
INT8 = dict(b=64, size=224, calib_batches=2)
TINY_INT8 = dict(b=4, size=32, calib_batches=2)
LM_CELL = dict(T=35, B=32, embed=200, hidden=200)    # the fit phase's LSTM LM's cell
TINY_LM_CELL = dict(T=5, B=3, embed=6, hidden=8)
WHILE_MAX, WHILE_STOP = 12, 7
SPARSE = dict(features=1_000_000, batch=8192, nnz=32, steps=20, dense_cols=64, cast_rows=64)
TINY_SPARSE = dict(features=2000, batch=64, nnz=8, steps=3, dense_cols=8, cast_rows=8)
CTC_WARM_STEPS = 3
# an entropy threshold against the same layer's naive range: the naive pass
# saw batch 0 too; the slack covers a forward that rounds otherwise
ENTROPY_RANGE_SLACK = 1e-3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _kernel_ms(fn):
    """Kernel ms of one call of ``fn`` from a torch.profiler trace (the call
    after a warm call and a sentinel); None if the trace held none."""
    _, ms, _, _, names = _busy_share(fn, warm=True)
    return ms if names else None


def sparse_samples(num_samples, num_features, nnz, seed=0):
    """example/sparse_linear_classification.py's synthetic_sparse, the same
    draws: ``nnz`` random feature ids a sample, the label the sign of the
    sum of a hidden per-feature weight over them."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, num_features, size=(num_samples, nnz)).astype(np.float32)
    hidden = rng.randn(num_features).astype(np.float32)
    label = (hidden[ids.astype(np.int64)].sum(axis=1) > 0).astype(np.float32)
    return ids, label


# public-model widths for the op table (each case's ``terms`` is the number of
# products or samples summed into one output: its bound is REDUCE_ULPS·terms ulps)
WIDE_OP_CASES = [
    # Mask R-CNN's C4 head (He et al. 2017; Detectron's ResNet-50-C4): 1024
    # channels at stride 16 of an 800x600 image, 200 ROIs to 14x14, 2x2 samples
    dict(id="ROIAlign-C4", op="_contrib_ROIAlign", data=(1, 1024, 38, 50), rois=200,
         kw=dict(pooled_size=(14, 14), spatial_scale=1 / 16, sample_ratio=2), terms=16),
    # Fast R-CNN (Girshick 2015) VGG-16 conv5: 512 channels, 128 ROIs to 7x7
    dict(id="ROIPooling-VGG16", op="ROIPooling", data=(1, 512, 38, 50), rois=128,
         kw=dict(pooled_size=(7, 7), spatial_scale=1 / 16), terms=0),
    # Deformable ConvNets (Dai et al. 2017) res5 of ResNet-101 at stride 16:
    # a 3x3 deformable convolution, 512 channels, dilation 2
    dict(id="DeformableConvolution-res5", op="_contrib_DeformableConvolution",
         data=(1, 512, 38, 50), kw=dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2),
                                        num_filter=512), terms=512 * 9 * 4),
    # Deformable R-FCN's class head: 21 VOC classes, 7x7 position-sensitive
    # bins (1029 score maps), 128 ROIs, 4x4 samples a bin
    dict(id="DeformablePSROIPooling-RFCN", op="_contrib_DeformablePSROIPooling",
         data=(1, 21 * 49, 38, 50), rois=128,
         kw=dict(spatial_scale=1 / 16, output_dim=21, group_size=7, pooled_size=7,
                 part_size=7, sample_per_part=4, trans_std=0.1), terms=64),
    # FlowNetC (Dosovitskiy et al. 2015): conv3 features of a 384x512 pair,
    # 256 channels, displacements of ±20 at stride 2 (441 channels out)
    dict(id="Correlation-FlowNetC", op="Correlation", data=(2, 256, 48, 64),
         kw=dict(kernel_size=1, max_displacement=20, stride1=1, stride2=2, pad_size=20),
         terms=256),
]


def _wide_inputs(case, rehearsal, gen, device):
    """The case's arrays (in the rehearsal a 10x12 map, and a 64th of the
    channels but for PS-ROI pooling's 1029 score maps)."""
    b, c, h, w = case["data"]
    if rehearsal:
        c, h, w = (c if "PSROI" in case["id"] else max(c // 64, 1)), 10, 12
    data = torch.randn((b, c, h, w), generator=gen, device=device)
    args, kw = [data], dict(case["kw"])
    if "rois" in case:
        r = case["rois"] if not rehearsal else 5
        scale = 1 / kw["spatial_scale"]
        xy = torch.rand((r, 2), generator=gen, device=device) * torch.tensor(
            [w * scale * 0.7, h * scale * 0.7], device=device)
        wh = torch.rand((r, 2), generator=gen, device=device) * torch.tensor(
            [w * scale * 0.3, h * scale * 0.3], device=device) + 16
        rois = torch.cat([torch.zeros((r, 1), device=device), xy, xy + wh], 1)
        args.append(rois)
        if "PSROI" in case["id"]:
            args.append(torch.randn((r, 2, 7, 7), generator=gen, device=device))
    if case["op"] == "_contrib_DeformableConvolution":
        o = kw["num_filter"] if not rehearsal else 4
        kw["num_filter"] = o
        args.append(torch.randn((b, 18, h, w), generator=gen, device=device))
        args.append(torch.randn((o, c, 3, 3), generator=gen, device=device) / math.sqrt(c * 9))
    if case["op"] == "Correlation":
        args.append(torch.randn((b, c, h, w), generator=gen, device=device))
        if rehearsal:
            kw.update(max_displacement=4, pad_size=4)
    return args, kw


def _wide_op_table(ctx, rehearsal):
    """The public-width cases of WIDE_OP_CASES on ``ctx``'s tensors, each
    held to the port's CPU result (the library's small cases run in
    ``_nd_op_table``)."""
    C = _nd_cases()
    failed = []
    gen = torch.Generator(device=ctx.device).manual_seed(23)
    for case in WIDE_OP_CASES:
        args, kw = _wide_inputs(case, rehearsal, gen, ctx.device)
        fn = getattr(mx.nd, case["op"])
        got = fn(*args, **kw)
        ref = fn(*(a.cpu() for a in args), **kw)
        _sync(ctx.device)
        err = (got.detach().double().cpu() - ref.double()).abs().max().item()
        scale = ref.abs().max().item()
        bound = (C.REDUCE_ULPS * case["terms"] * torch.finfo(torch.float32).eps * scale)
        ms = _time_steps(lambda: fn(*args, **kw), 1 if rehearsal else 5)
        ok = got.device.type == ctx.device.type and (err <= bound if case["terms"] else
                                                     err == 0.0)
        emit("op_library", part="op_table_public_width", case=case["id"], op=case["op"],
             shapes=[list(a.shape) for a in args], max_abs_err=err, bound=bound,
             bound_rule=("exact" if not case["terms"] else
                         f"{C.REDUCE_ULPS}·{case['terms']} ulps of max|ref|"),
             ms=ms, ok=ok)
        if not ok:
            failed.append([case["id"], err / bound if bound else math.inf])
        del got, ref, args
    emit("op_library", part="op_table", failed=failed, ok=not failed)
    return not failed


def _ocr_step(net, trainer, x, y, batch):
    with mx.autograd.record():
        loss = mx.nd.CTCLoss(net(x), y).mean()
    mx.autograd.backward(loss)
    trainer.step(batch)
    return loss


def _ctc_part(rehearsal, ctx, smi):
    """example/ctc_ocr.py's OCRNet trained on the card through mx.nd.CTCLoss
    and Adam; the first step's loss and gradients held to the CPU's; the
    gluon CTCLoss on the card against the CPU."""
    cfg = TINY_OCR if rehearsal else OCR_TRAIN
    dev = ctx.device
    rng = np.random.RandomState(0)
    mx.random.seed(0)
    net = OCRNet(hidden=cfg["hidden"])
    net.initialize(ctx=ctx)
    x0, _ = ocr_batch(rng, 2)
    net(torch.from_numpy(x0).to(dev))
    ref = OCRNet(hidden=cfg["hidden"])
    ref.initialize(ctx=mx.cpu())
    ref(torch.from_numpy(x0))
    load_numpy_params(ref, {k: p.data().detach().cpu().numpy()
                            for k, p in net._collect_params_with_prefix().items()})
    x, y = ocr_batch(rng, cfg["batch"])
    grads = {}
    for name, model, device in (("card", net, dev), ("cpu", ref, torch.device("cpu"))):
        with mx.autograd.record():
            loss = mx.nd.CTCLoss(model(torch.from_numpy(x).to(device)),
                                 torch.from_numpy(y).to(device)).mean()
        mx.autograd.backward(loss)
        grads[name] = (loss.item(), {k: p.grad().detach().double().cpu()
                                     for k, p in model._collect_params_with_prefix().items()})
    loss_err = abs(grads["card"][0] - grads["cpu"][0]) / abs(grads["cpu"][0])
    grad_err = max((grads["card"][1][k] - g).abs().max().item() / max(g.abs().max().item(),
                                                                      1e-30)
                   for k, g in grads["cpu"][1].items())
    first_ok = loss_err <= CTC_CARD_REL and grad_err <= CTC_CARD_REL
    emit("op_library", part="ctc", check="first_step_vs_cpu", loss_card=grads["card"][0],
         loss_cpu=grads["cpu"][0], loss_rel_err=loss_err, grad_max_rel_err=grad_err,
         bound=CTC_CARD_REL, ok=first_ok)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": cfg["lr"]})
    epochs = []
    t0 = time.perf_counter()
    for epoch in range(cfg["epochs"]):
        total = 0.0
        for _ in range(cfg["batches"]):
            xb, yb = ocr_batch(rng, cfg["batch"])
            total += _ocr_step(net, trainer, torch.from_numpy(xb).to(dev),
                               torch.from_numpy(yb).to(dev), cfg["batch"]).item()
        xe, ye = ocr_batch(rng, cfg["batch"])
        with mx.autograd.predict_mode():
            decoded = greedy_decode(net(torch.from_numpy(xe).to(dev)))
        truth = [[int(v) for v in row if v != 0] for row in ye]
        acc = float(np.mean([d == t for d, t in zip(decoded, truth)]))
        epochs.append(total / cfg["batches"])
        emit("op_library", part="ctc", epoch=epoch, mean_loss=epochs[-1], seq_acc=acc)
    train_s = time.perf_counter() - t0
    falls = epochs[-1] < epochs[0]
    xb, yb = (torch.from_numpy(a).to(dev) for a in ocr_batch(rng, cfg["batch"]))
    step = lambda: _ocr_step(net, trainer, xb, yb, cfg["batch"])  # noqa: E731
    wall = _time_steps(step, 1 if rehearsal else 20)
    kms = kn = ctc_kms = ctc_kn = None
    if not rehearsal:
        _, kms, _, _, names = _busy_share(step, warm=True)
        kn = sum(names.values())
        logits = net(xb).detach()
        _, ctc_kms, _, _, names = _busy_share(lambda: mx.nd.CTCLoss(logits, yb), warm=True)
        ctc_kn = sum(names.values())
    emit("op_library", part="ctc", check="train", epochs=cfg["epochs"],
         batches_an_epoch=cfg["batches"], batch=cfg["batch"], first_epoch_loss=epochs[0],
         last_epoch_loss=epochs[-1], loss_falls=falls, train_s=train_s, step_wall_ms=wall,
         step_kernel_ms=kms, step_kernels=kn, ctc_forward_kernel_ms=ctc_kms,
         ctc_forward_kernels=ctc_kn, T=int(xb.shape[0]),
         note="CPU rehearsal: host time" if rehearsal else
         "wall, card synchronized; kernel ms from a torch.profiler trace", card=smi,
         ok=falls)
    # the gluon loss (its own trellis) on the card against the CPU
    r = np.random.RandomState(3)
    pred = r.randn(4, 17, OCR_CLASSES).astype(np.float32)
    lab = np.array([[1, 2, 0, 0], [3, 3, 5, 1], [4, 0, 0, 0], [2, 5, 2, 3]], np.float32)
    pl, ll = np.array([17, 12, 15, 11], np.float32), np.array([2, 4, 1, 4], np.float32)
    worst = 0.0
    for layout in ("NTC", "TNC"):
        p = pred if layout == "NTC" else np.ascontiguousarray(pred.transpose(1, 0, 2))
        for lens in ((), (pl,), (pl, ll)):
            args = [p, lab, *lens]
            loss_fn = mx.gluon.loss.CTCLoss(layout=layout)
            got = loss_fn(*(torch.from_numpy(a).to(dev) for a in args))
            want = loss_fn(*(torch.from_numpy(a) for a in args))
            worst = max(worst, ((got.cpu() - want).abs() / want.abs()).max().item())
    gluon_ok = worst <= CTC_CARD_REL
    emit("op_library", part="ctc", check="gluon_ctc_loss_vs_cpu", layouts=["NTC", "TNC"],
         lengths=["none", "pred", "pred+label"], max_rel_err=worst, bound=CTC_CARD_REL,
         ok=gluon_ok)
    return first_ok and falls and gluon_ok


def _interleave_weight(w, h):
    """A fused [3·D, D] QKV weight (rows [3, H, Dh]) interleaved a head
    ([H, 3, Dh]), as GluonNLP 0.x's interleaved projection lays it out."""
    d3 = w.shape[0]
    return w.reshape(3, h, d3 // (3 * h), *w.shape[1:]).transpose(0, 1).reshape(w.shape)


def _interleaved_case(kind, dtype, qkv_w, qkv_b, cfg, gen, device):
    """One attention through the interleaved ops and through the flash
    kernels on the same q, k, v: outputs, input gradients and bounds."""
    h, d = cfg["h"], cfg["d"]
    b = cfg["b"]
    if kind == "selfatt":
        s = cfg["s"]
        x = torch.randn((s, b, h * d), generator=gen, device=device).to(dtype)
        proj = torch.nn.functional.linear(x, _interleave_weight(qkv_w, h).to(dtype),
                                          _interleave_weight(qkv_b, h).to(dtype))
        proj = proj.detach().requires_grad_()
        parts = proj.reshape(s, b, h, 3, d)
        q, k, v = (parts[:, :, :, i] for i in range(3))
        sq = sk = s
    else:
        sq, sk = cfg["sq"], cfg["sk"]
        qx = (torch.randn((sq, b, h * d), generator=gen, device=device) * 0.5).to(dtype)
        kvx = (torch.randn((sk, b, 2 * h * d), generator=gen, device=device) * 0.5).to(dtype)
        qx.requires_grad_()
        kvx.requires_grad_()
        q = qx.reshape(sq, b, h, d)
        kv = kvx.reshape(sk, b, h, 2, d)
        k, v = kv[:, :, :, 0], kv[:, :, :, 1]
    head = torch.randn((sq, b, h * d), generator=gen, device=device).to(dtype)

    def interleaved():
        if kind == "selfatt":
            sc = mx.nd.contrib.interleaved_matmul_selfatt_qk(proj, heads=h)
            return sc, mx.nd.contrib.interleaved_matmul_selfatt_valatt(
                proj, torch.softmax(sc, -1), heads=h)
        sc = mx.nd.contrib.interleaved_matmul_encdec_qk(qx, kvx, heads=h)
        return sc, mx.nd.contrib.interleaved_matmul_encdec_valatt(kvx, torch.softmax(sc, -1),
                                                                 heads=h)

    qf, kf, vf = (t.detach().permute(1, 2, 0, 3).contiguous().requires_grad_()
                  for t in (q, k, v))  # [B, H, S, Dh]

    def flash():
        return att.flash_attention(qf, kf, vf).permute(2, 0, 1, 3).reshape(sq, b, h * d)

    with mx.autograd.record():
        scores, out = interleaved()
    out.backward(head)
    leaves = (proj,) if kind == "selfatt" else (qx, kvx)
    reset_kernel_counts()
    ref = flash()
    ref.backward(head)
    _sync(device)
    launches = {n: c for n, c in kernel_counts().items() if c}
    if kind == "selfatt":
        g = proj.grad.reshape(sq, b, h, 3, d)
        got_grads = [g[:, :, :, i].permute(1, 2, 0, 3) for i in range(3)]
    else:
        gkv = kvx.grad.reshape(sk, b, h, 2, d)
        got_grads = [qx.grad.reshape(sq, b, h, d).permute(1, 2, 0, 3)] + [
            gkv[:, :, :, i].permute(1, 2, 0, 3) for i in range(2)]
    ref_grads = [qf.grad, kf.grad, vf.grad]
    o_err = (out.float() - ref.float()).abs().max().item()
    o_scale = ref.float().abs().max().item()
    rel = lambda a, r: ((a.float() - r.float()).norm() / r.float().norm()).item()  # noqa
    g_rel = max(rel(a, r) for a, r in zip(got_grads, ref_grads))
    s_max = scores.float().abs().max().item()
    v_max = v.float().abs().max().item()
    if dtype == torch.float32:
        o_bound = INTERLEAVED_F32_REL * o_scale
        g_bound = INTERLEAVED_F32_REL * 10
        rule = (f"{INTERLEAVED_F32_REL}·max|o| (the flash fp32 kernels' split-TF32 error, "
                f"~2.5e-6); gradients' relative L2 {g_bound}")
    else:
        # bf16: the interleaved path rounds the scores (one bf16 half-ulp,
        # 2^-9 relative) and the probabilities before its fp32 product;
        # softmax moves an output by at most 2·max|δs|·max|v|, the rounded
        # probabilities by 2^-9·max|v|, both outputs' own rounding 2^-9·|o|
        o_bound = (2 * 2 ** -9 * s_max + 2 ** -9) * v_max + 2 * 2 ** -9 * o_scale
        g_bound = 4 * 2 ** -9 * max(s_max, 1.0)
        rule = ("(2·2^-9·max|s| + 2^-9)·max|v| + 2·2^-9·max|o|; gradients' relative L2 "
                "4·2^-9·max(max|s|, 1)")
    ok = (o_err <= o_bound and g_rel <= g_bound
          and all(launches.get(n, 0) > 0 for n in FLASH))
    iters = 1 if device.type != "cuda" else 10

    def run_interleaved():
        with mx.autograd.record():
            _, o = interleaved()
        o.backward(head)

    def run_flash():
        flash().backward(head)

    t_int = _time_steps(run_interleaved, iters)
    t_flash = _time_steps(run_flash, iters)
    k_int = k_flash = None
    if device.type == "cuda":
        k_int, k_flash = _kernel_ms(run_interleaved), _kernel_ms(run_flash)
    return dict(kind=kind, dtype=str(dtype).replace("torch.", ""),
                shape=dict(cfg), max_abs_o=o_scale, max_abs_s=s_max, max_abs_v=v_max,
                max_abs_err=o_err, bound=o_bound, grad_rel_l2=g_rel,
                grad_bound=g_bound, bound_rule=rule, flash_launches=launches,
                interleaved_fwd_bwd_ms=t_int, flash_fwd_bwd_ms=t_flash,
                interleaved_kernel_ms=k_int, flash_kernel_ms=k_flash,
                timing="wall a forward and backward (card synchronized); kernel ms from a "
                       "torch.profiler trace of one", ok=ok), launches


def _interleaved_part(net, rehearsal, device, smi, counts):
    """BERT-base layer 0's QKV weights interleaved a head; self-attention
    through the interleaved ops against flash_fwd/flash_bwd (bf16) and the
    fp32 flash kernels, and the enc-dec pair at transformer-big's widths;
    the flash launches added into ``counts``."""
    params = net._collect_params_with_prefix()
    w = params["bert.encoder.layer0.attention.qkv.weight"].data().detach().float()
    bias = params["bert.encoder.layer0.attention.qkv.bias"].data().detach().float()
    gen = torch.Generator(device=device).manual_seed(31)
    cfg = TINY_INTERLEAVED if rehearsal else INTERLEAVED
    ecfg = TINY_ENCDEC if rehearsal else ENCDEC
    ok = True
    for kind, c in (("selfatt", cfg), ("encdec", ecfg)):
        for dtype in (torch.bfloat16, torch.float32):
            row, launches = _interleaved_case(kind, dtype, w.to(device), bias.to(device), c,
                                              gen, device)
            if rehearsal:
                row["ok"] = row["max_abs_err"] <= row["bound"] and (
                    row["grad_rel_l2"] <= row["grad_bound"])
            for n, v in launches.items():
                counts[n] = counts.get(n, 0) + v
            emit("op_library", part="interleaved", card=smi, **row)
            ok = ok and row["ok"]
    return ok


@contextlib.contextmanager
def _int_sums(conv, matmul):
    """The quantized ops' int32 sums through ``conv`` and ``matmul`` for the
    scope (``ops/quantization.py`` resolves them at each call)."""
    from incubator_mxnet_torch.ops import quantization as qops

    real = qops.int_conv, qops.int_matmul
    qops.int_conv, qops.int_matmul = conv, matmul
    try:
        yield
    finally:
        qops.int_conv, qops.int_matmul = real


def _int8_part(rehearsal, ctx, smi):
    """ResNet-50 v1 (seeded weights) through quantize_net: naive over two
    batches, entropy once; every quantized layer's int32 sums and float
    output against the float64 plain version on the card, bit for bit; the
    int8 forward's time beside fp32's and bf16's, and its logits' distance
    from fp32's."""
    from incubator_mxnet_torch.contrib import quantization as cq
    from incubator_mxnet_torch.ops import quantization as qops

    cfg = TINY_INT8 if rehearsal else INT8
    dev = ctx.device
    b, size = cfg["b"], cfg["size"]

    def make():
        mx.random.seed(5)
        n = (vision.resnet18_v1(classes=10, thumbnail=True) if rehearsal
             else vision.resnet50_v1())
        n.initialize(mx.init.Xavier(magnitude=2.0), ctx=ctx)
        return n

    gen = torch.Generator(device=dev).manual_seed(41)
    batches = [torch.rand((b, 3, size, size), generator=gen, device=dev) * 2 - 1
               for _ in range(cfg["calib_batches"] + 1)]
    net = make()
    with mx.autograd.predict_mode():
        fp32 = net(batches[-1]).detach().float()
        iters = 1 if rehearsal else 10
        fp32_ms = _time_steps(lambda: net(batches[-1]), iters)
        bf = make()
        bf.cast("bfloat16")
        bf16_ms = _time_steps(lambda: bf(batches[-1].bfloat16()), iters)
        bf16 = bf(batches[-1].bfloat16()).detach().float()
        kernel_ms = {}
        if not rehearsal:
            kernel_ms["fp32"] = _kernel_ms(lambda: net(batches[-1]))
            kernel_ms["bf16"] = _kernel_ms(lambda: bf(batches[-1].bfloat16()))
        del bf
        t0 = time.perf_counter()
        cq.quantize_net(net, batches[:-1], calib_mode="naive")
        _sync(dev)
        naive_s = time.perf_counter() - t0
    layers = [blk for _, blk in cq._iter_blocks(net) if getattr(blk, "_quantized", False)]
    # one batch with every layer's input and output and every int32 sum recorded
    ins, outs, sums, current = {}, {}, {}, [None]

    def enter(blk, a):
        ins[id(blk)] = a[0]
        current[0] = blk

    def record(real):
        def call(*a, **k):
            acc = sums[id(current[0])] = real(*a, **k)
            return acc
        return call

    hooks = [blk.register_forward_pre_hook(enter) for blk in layers]
    hooks += [blk.register_forward_hook(lambda blk, a, o: outs.__setitem__(id(blk), o))
              for blk in layers]
    try:
        with _int_sums(record(qops.int_conv), record(qops.int_matmul)), \
                mx.autograd.predict_mode():
            int8 = net(batches[-1]).detach().float()
    finally:
        for h in hooks:
            h.detach()
    bad_sums = bad_outs = 0
    for blk in layers:
        acc = sums.get(id(blk))
        wq, wmin, wmax, lo, hi = blk._int8_state
        xq, xmin, xmax = qops.quantize_v2(ins[id(blk)], min_calib_range=lo, max_calib_range=hi)
        bias = blk.bias.data() if getattr(blk, "bias", None) is not None else None
        if isinstance(blk, mx.gluon.nn.Dense):
            plain = qops.int_matmul_plain(xq.reshape(xq.shape[0], -1), wq)
            out = qops.quantized_fully_connected
            kw = dict(num_hidden=blk._units, no_bias=bias is None, flatten=blk._flatten)
        else:
            plain = qops.int_conv_plain(xq, wq, ops_nn._tuplize(blk._stride, 2),
                                        ops_nn._tuplize(blk._dilate, 2),
                                        ops_nn._tuplize(blk._pad, 2), blk._groups)
            out = qops.quantized_conv
            kw = dict(kernel=blk._kernel, stride=blk._stride, dilate=blk._dilate, pad=blk._pad,
                      num_filter=blk._channels, num_group=blk._groups, no_bias=bias is None)
        bad_sums += acc is None or not torch.equal(acc, plain)
        with _int_sums(lambda *a, **k: plain, lambda *a, **k: plain):
            want = out(xq, wq, bias, xmin, xmax, wmin, wmax, **kw)  # the op on the plain sums
        bad_outs += not torch.equal(outs[id(blk)], want)
    with mx.autograd.predict_mode():
        int8_ms = _time_steps(lambda: net(batches[-1]), 1 if rehearsal else 10)
        if not rehearsal:
            kernel_ms["int8"] = _kernel_ms(lambda: net(batches[-1]))
    rel = ((int8 - fp32).norm() / fp32.norm()).item()
    rel_bf16 = ((bf16 - fp32).norm() / fp32.norm()).item()
    exact = bad_sums == 0 and bad_outs == 0 and len(sums) == len(layers) > 0
    finite = bool(torch.isfinite(int8).all())
    emit("op_library", part="int8", model="resnet18_v1 (rehearsal)" if rehearsal else
         "resnet50_v1", batch=b, image=size, quantized_layers=len(layers),
         int32_sums=len(sums), sums_not_bit_equal=bad_sums, outputs_not_bit_equal=bad_outs,
         calib_mode="naive", calib_batches=cfg["calib_batches"], calib_wall_s=naive_s,
         int8_ms=int8_ms, fp32_ms=fp32_ms, bf16_ms=bf16_ms, kernel_ms=kernel_ms,
         int8_vs_fp32_logits_rel_l2=rel, bf16_vs_fp32_logits_rel_l2=rel_bf16,
         note="CPU rehearsal: host time" if rehearsal else
         "wall, card synchronized, B images a call; kernel_ms from a torch.profiler trace",
         card=smi, ok=exact and finite)
    # each layer's naive max|x| over both batches (batch 0's among them)
    naive_amax = {p: max(abs(blk._int8_state[3]), abs(blk._int8_state[4]))
                  for p, blk in cq._iter_blocks(net) if getattr(blk, "_quantized", False)}
    net = make()
    # the KL sweep costs ~0.5 s a layer on the host: the rehearsal
    # calibrates four layers by entropy, the card all of ResNet-50's
    names = [blk.name for _, blk in cq._iter_blocks(net) if cq._quantizable(blk)]
    excluded = names[2:-2] if rehearsal else []
    with mx.autograd.predict_mode():
        t0 = time.perf_counter()
        cq.quantize_net(net, batches[:1], calib_mode="entropy", excluded_layers=excluded)
        _sync(dev)
        entropy_s = time.perf_counter() - t0
        ent = net(batches[-1]).detach().float()
    # a KL threshold is a bin edge of batch 0's histogram: in (0, max|x|]
    ratios = [blk._int8_state[4] / naive_amax[p] for p, blk in cq._iter_blocks(net)
              if getattr(blk, "_quantized", False)]
    ent_rel = ((ent - fp32).norm() / fp32.norm()).item()
    ent_ok = (bool(torch.isfinite(ent).all()) and len(ratios) == len(names) - len(excluded)
              and all(0 < r <= 1 + ENTROPY_RANGE_SLACK for r in ratios))
    emit("op_library", part="int8", calib_mode="entropy", calib_batches=1,
         entropy_layers=len(ratios), quantizable_layers=len(names),
         threshold_over_naive_max=dict(min=min(ratios), median=float(np.median(ratios)),
                                       max=max(ratios)),
         bound=f"each threshold in (0, (1 + {ENTROPY_RANGE_SLACK})·naive max|x|]",
         calib_wall_s=entropy_s, int8_vs_fp32_logits_rel_l2=ent_rel, ok=ent_ok)
    del net
    return exact and finite and ent_ok


def _control_flow_part(rehearsal, ctx, smi):
    """The fit phase's LSTM language model's cell unrolled by nd.contrib.foreach
    against LSTMCell.unroll (deterministic mode, bit for bit); while_loop
    with an early stop captured in a CUDA graph (no host sync a step);
    cond both ways."""
    cfg = TINY_LM_CELL if rehearsal else LM_CELL
    dev = ctx.device
    T, B, E, H = cfg["T"], cfg["B"], cfg["embed"], cfg["hidden"]
    mx.random.seed(3)
    cell = mx.gluon.rnn.LSTMCell(H, input_size=E)
    cell.initialize(ctx=ctx)
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((T, B, E), generator=gen, device=dev)
    head = torch.randn((T, B, H), generator=gen, device=dev)
    params = list(cell.collect_params().values())

    def run(use_foreach):
        xi = x.clone().requires_grad_()
        begin = [torch.zeros((B, H), device=dev), torch.zeros((B, H), device=dev)]
        with mx.autograd.record():
            if use_foreach:
                out, states = mx.nd.contrib.foreach(lambda xt, st: cell(xt, st), xi, begin)
            else:
                out, states = cell.unroll(T, xi, begin, layout="TNC", merge_outputs=True)
            loss = (out * head).sum() + states[0].sum() + 2 * states[1].sum()
        mx.autograd.backward(loss)
        return ([out.detach(), states[0].detach(), states[1].detach(), xi.grad]
                + [p.grad().detach().clone() for p in params])

    with _deterministic(True):
        a, b_ = run(True), run(False)
    equal = all(torch.equal(u, v) for u, v in zip(a, b_))
    worst = max((u - v).abs().max().item() for u, v in zip(a, b_))
    emit("op_library", part="control_flow", check="foreach_vs_unroll", T=T, B=B, embed=E,
         hidden=H, compared=["outputs", "h", "c", "input_grad"] + [p.name for p in params],
         bit_equal=equal, max_abs_diff=worst, ok=equal)
    # while_loop: s ← 0.5·s + i while i < stop, per-step outputs; captured
    stop = torch.tensor([float(WHILE_STOP)], device=dev)

    def loop(i0, s0):
        return mx.nd.contrib.while_loop(lambda i, s: i < stop,
                                        lambda i, s: ([s * 2.0], [i + 1, s * 0.5 + i]),
                                        [i0, s0], max_iterations=WHILE_MAX)

    i0 = torch.zeros(1, device=dev)
    s0 = torch.arange(4, dtype=torch.float32, device=dev)
    eager_out, (ei, es) = loop(i0, s0)
    captured = False
    if dev.type == "cuda":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            loop(i0, s0)  # warm-up off the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with step_fold._graph_capture(graph):  # a host sync inside fails the capture
            g_out, (gi, gs) = loop(i0, s0)
        graph.replay()
        torch.cuda.synchronize()
        captured = True
    else:
        g_out, gi, gs = eager_out, ei, es
    rows_zero = bool((g_out[WHILE_STOP:] == 0).all()) and bool((g_out[:WHILE_STOP] != 0).any())
    same = (torch.equal(g_out, eager_out) and torch.equal(gi, ei) and torch.equal(gs, es)
            and gi.item() == WHILE_STOP)
    while_ok = rows_zero and same and (captured or dev.type != "cuda")
    emit("op_library", part="control_flow", check="while_loop", max_iterations=WHILE_MAX,
         stop=WHILE_STOP, captured_in_cuda_graph=captured, rows_past_stop_zero=rows_zero,
         replay_equals_eager=same, ok=while_ok)
    xa, xb = torch.randn(5, device=dev), torch.randn(5, device=dev)
    outs = [mx.nd.contrib.cond(torch.tensor([flag], device=dev), lambda: xa * xb,
                               lambda: xa - xb) for flag in (1.0, 0.0)]
    cond_ok = torch.equal(outs[0], xa * xb) and torch.equal(outs[1], xa - xb)
    emit("op_library", part="control_flow", check="cond", branches=["then", "else"],
         ok=cond_ok, note="pred read on the host: a sync, outside any capture")
    return equal and while_ok and cond_ok


def _sparse_part(rehearsal, ctx, smi):
    """example/sparse_linear_classification.py's model at a million
    features: SGD with momentum, lazy row updates held row for row against
    the per-tensor lazy op on the CPU, no multi-tensor launch, the fold's
    refusal, and csr · dense against the dense product."""
    cfg = TINY_SPARSE if rehearsal else SPARSE
    dev = ctx.device
    F_, B, nnz, steps = cfg["features"], cfg["batch"], cfg["nnz"], cfg["steps"]
    X, Y = sparse_samples(B * steps, F_, nnz)
    mx.random.seed(0)
    embed = mx.gluon.nn.Embedding(F_, 1, sparse_grad=True)
    embed.initialize(ctx=ctx)
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    trainer = mx.gluon.Trainer(embed.collect_params(), "sgd",
                               {"learning_rate": 0.5, "momentum": 0.9})
    weight = embed.weight
    xs = torch.from_numpy(X).to(dev)
    ys = torch.from_numpy(Y).to(dev)

    def step(k):
        xb, yb = xs[k * B:(k + 1) * B], ys[k * B:(k + 1) * B]
        with mx.autograd.record():
            logits = embed(xb).reshape(B, -1).sum(1)
            loss = loss_fn(logits, yb)
        mx.autograd.backward(loss)
        return xb, loss

    bad_rows = bad_touched = 0
    mt_launches = 0
    losses = []
    for k in range(steps):
        xb, loss = step(k)
        w0 = weight.data().detach().cpu().clone()
        mom0 = trainer._states[0].detach().cpu().clone() if 0 in trainer._states else None
        g = weight.grad().detach().cpu().clone()
        before = mt.multi_tensor_update.launches
        trainer.step(B)
        mt_launches += mt.multi_tensor_update.launches - before
        w1 = weight.data().detach().cpu()
        mom1 = trainer._states[0].detach().cpu()
        # the per-tensor lazy op's plain version on the CPU, from the same state
        pw, pm = w0.clone(), (mom0.clone() if mom0 is not None else torch.zeros_like(w0))
        opt = trainer._optimizer
        opt_ops.sgd_mom_lazy_update(pw, g, pm, opt._get_lr(0), opt._get_wd(0),
                                    opt.rescale_grad, opt.clip_gradient, opt.momentum)
        touched = torch.zeros(F_, dtype=torch.bool)
        touched[xb.long().unique().cpu()] = True
        untouched = ~touched
        bad_rows += int(not (torch.equal(w1[untouched], w0[untouched])
                             and torch.equal(mom1[untouched], pm[untouched])))
        bad_touched += int(not (torch.equal(w1, pw) and torch.equal(mom1, pm)))
        losses.append(loss.mean().item())
    sparse_ok = bad_rows == 0 and bad_touched == 0 and mt_launches == 0
    emit("op_library", part="sparse", features=F_, batch=B, nnz=nnz, steps=steps,
         first_loss=losses[0], last_loss=losses[-1],
         steps_with_untouched_rows_changed=bad_rows,
         steps_not_equal_to_the_plain_lazy_op=bad_touched,
         multi_tensor_launches=mt_launches, ok=sparse_ok)
    step_ms = _time_steps(lambda: (step(0), trainer.step(B)), 1 if rehearsal else 10)
    prog = trainer.fold_step(lambda a, b: loss_fn(embed(a).reshape(B, -1).sum(1), b),
                             block=embed)
    prog(xs[:B], ys[:B])
    refused = (not prog.folded) and "(lazy/sparse or unsupported)" in (prog.fallback_reason
                                                                       or "")
    mx.profiler.disarm_compile_guard()
    emit("op_library", part="sparse", check="fold_refuses", fallback_reason=prog.fallback_reason,
         ok=refused, step_ms=step_ms, note="CPU rehearsal: host time" if rehearsal else
         "wall, card synchronized: forward, backward and Trainer.step", card=smi)
    # cast_storage and tostype of card arrays: the last step's gradient and
    # a batch's first rows as multi-hot dense rows; each sparse form and its
    # conversion stay on the card and give back the dense array bit for bit
    hot = torch.zeros((cfg["cast_rows"], F_), device=dev)
    hot.scatter_(1, xs[:cfg["cast_rows"]].long(), 1.0)
    placed = equal = True
    for src, first, second in ((mx.nd.NDArray(weight.grad().detach()), "row_sparse", "csr"),
                               (mx.nd.NDArray(hot), "csr", "row_sparse")):
        a1 = mx.nd.cast_storage(src, first)
        for arr in (a1, a1.tostype(second), src.tostype(second)):
            placed &= arr.data.context == ctx and arr.indices.context == ctx
            equal &= torch.equal(arr.tostype("default")._data, src._data)
    emit("op_library", part="sparse", check="cast_storage_on_the_card",
         arrays=[[F_, 1], [cfg["cast_rows"], F_]], stays_on_device=placed,
         round_trip_bit_equal=equal, ok=placed and equal)
    del hot
    # csr · dense and csrᵀ · dense against the dense product, a row block at a time
    C = _nd_cases()
    cols = cfg["dense_cols"]
    ids = xs[:B].long()
    vals = torch.rand((B, nnz), generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)
    indptr = torch.arange(0, B * nnz + 1, nnz, dtype=torch.int32, device=dev)
    csr = mx.nd.sparse.CSRNDArray(mx.nd.NDArray(vals.reshape(-1)),
                                  mx.nd.NDArray(ids.reshape(-1).int()),
                                  mx.nd.NDArray(indptr), (B, F_))
    rhs = torch.randn((F_, cols), generator=torch.Generator(device=dev).manual_seed(6),
                      device=dev)
    rhs_t = torch.randn((B, cols), generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)
    with _deterministic(True):
        got = mx.nd.sparse.dot(csr, mx.nd.NDArray(rhs))._data
        got_t = mx.nd.sparse.dot(csr, mx.nd.NDArray(rhs_t), transpose_a=True)._data
    want = torch.zeros((B, cols), device=dev)
    want_t = torch.zeros((F_, cols), device=dev)
    rows = 1024 if not rehearsal else 16
    for r0 in range(0, B, rows):
        dense = torch.zeros((min(rows, B - r0), F_), device=dev)
        dense.scatter_add_(1, ids[r0:r0 + rows], vals[r0:r0 + rows])
        want[r0:r0 + rows] = dense @ rhs
        want_t += dense.t() @ rhs_t[r0:r0 + rows]
        del dense
    eps = torch.finfo(torch.float32).eps
    counts = torch.bincount(ids.reshape(-1), minlength=F_)
    worst = 0.0
    for g, w_, terms in ((got, want, nnz), (got_t, want_t, int(counts.max()))):
        err = (g - w_).abs().max().item()
        bound = C.REDUCE_ULPS * terms * eps * w_.abs().max().item()
        worst = max(worst, err / bound)
    dot_ms = _time_steps(lambda: mx.nd.sparse.dot(csr, mx.nd.NDArray(rhs)),
                         1 if rehearsal else 10)
    emit("op_library", part="sparse", check="csr_dot_vs_dense", shape=[B, F_], nnz_a_row=nnz,
         dense_cols=cols, worst_err_over_bound=worst,
         bound="REDUCE_ULPS·terms ulps of max|ref| (terms: nnz a row; the most ids a column)",
         dot_ms=dot_ms, ok=worst <= 1.0)
    return sparse_ok and refused and placed and equal and worst <= 1.0


def phase_op_library(net, rehearsal, smi=None):
    """The rest of the op library on the card (see the module doc); exits
    non-zero on any miss.  Returns {"op_library": the flash launches of the
    interleaved part's reference attentions}."""
    t0 = time.perf_counter()
    mx.amp.disable()
    mx.profiler.disarm_compile_guard()
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    misses, counts, walls = [], {}, {}
    parts = (("op_table", lambda: _wide_op_table(ctx, rehearsal)),
             ("ctc", lambda: _ctc_part(rehearsal, ctx, smi)),
             ("interleaved", lambda: _interleaved_part(net, rehearsal, ctx.device, smi, counts)),
             ("int8", lambda: _int8_part(rehearsal, ctx, smi)),
             ("control_flow", lambda: _control_flow_part(rehearsal, ctx, smi)),
             ("sparse", lambda: _sparse_part(rehearsal, ctx, smi)))
    for name, fn in parts:
        t1 = time.perf_counter()
        if not fn():
            misses.append(name)
        walls[name] = time.perf_counter() - t1
        if not rehearsal:
            torch.cuda.empty_cache()
    # the parts' nets hold reference cycles (blocks and their hooks, the int8
    # forwards' closures): collect them here, not inside a later phase's
    # timed steps
    gc.collect()
    if not rehearsal:
        torch.cuda.empty_cache()
    emit("op_library", part_wall_s=walls, phase_s=time.perf_counter() - t0, failed=misses,
         ok=not misses)
    if misses:
        sys.exit(1)
    return {"op_library": counts}


def decode_load(records=1024, loads=400):
    """``--decode-load``: the native pool's time for one batch of 256 from
    the ``io`` phase's record file on an idle card, while ``loads`` bf16
    8192x8192 matmuls fill the SMs on the default stream and on a side
    stream, and while a 1 s sleep kernel (one block) holds each; one JSON
    line a case, with the load's CUDA-event time and whether it was still
    running when the batch came back."""
    import shutil
    import tempfile

    from incubator_mxnet_torch.io import ImageRecordIter

    smi = phase_device()
    tmp = tempfile.mkdtemp(prefix="mxnet_io_")
    try:
        rec = os.path.join(tmp, "load.rec")
        io_record_file(rec, records, IO_IMAGE, 1000)
        it = ImageRecordIter(rec, data_shape=(3, 224, 224), batch_size=RESNET_B,
                             preprocess_threads=min(os.cpu_count() or 1, 16))
        a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
        side = torch.cuda.Stream()

        def matmuls(stream):
            with torch.cuda.stream(stream):
                for _ in range(loads):
                    a @ a

        def sleep(stream):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(int(1.98e9))  # ~1 s at the H100's 1.98 GHz

        it.next()
        (a @ a).sum().item()
        for case, fn, stream in (("idle", None, None),
                                 ("matmuls_default_stream", matmuls, torch.cuda.default_stream()),
                                 ("matmuls_side_stream", matmuls, side),
                                 ("sleep_default_stream", sleep, torch.cuda.default_stream()),
                                 ("sleep_side_stream", sleep, side), ("idle", None, None)):
            torch.cuda.synchronize()
            s0 = stream or torch.cuda.current_stream()
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record(s0)
            if fn is not None:
                fn(stream)
            ev1.record(s0)
            t0 = time.perf_counter()
            try:
                it.next()
            except StopIteration:
                it.reset()
                it.next()
            batch_ms = (time.perf_counter() - t0) * 1e3
            running = not ev1.query()
            torch.cuda.synchronize()
            emit("decode_load", case=case, decoder=it.decoder, batch=RESNET_B, batch_ms=batch_ms,
                 load_ms=ev0.elapsed_time(ev1), load_running_at_batch_end=running, card=smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 6c: the rest of the training surface --------------------------------
# BERT-base pretraining under fp16 AMP with LAMB, linear warm-up and
# polynomial decay and dynamic loss scaling (large-batch BERT's recipe), and
# ResNet-50 with NAG and a warm-up cosine schedule (GluonCV's ImageNet
# recipe), each through the entry points a user calls.
SURFACE_POLY = dict(max_update=8, base_lr=1e-3, pwr=1, warmup_steps=2)
SURFACE_COSINE = dict(max_update=6, base_lr=0.1, warmup_steps=2)
SURFACE_STEPS = 6
SURFACE_RESNET_STEPS = 3
SURFACE_OVERFLOW_SCALE = 2.0 ** 40
SURFACE_MAX_SKIPS = 40  # halvings from 2^40 before a step must be finite
# the kernels one finite step of each path launches, by profiler name
SURFACE_BERT_FAMILIES = (("flash_bwd_dkv", "flash_bwd_dkv"), ("flash_bwd_dq", "flash_bwd_dq"),
                         ("flash_fwd", "flash_fwd"), ("lamb_pass1", "lamb_pass1"),
                         ("lamb_pass2", "lamb_pass2"), ("finite_pass", "finite_pass"))


def _poly_lr(k):
    """PolyScheduler(**SURFACE_POLY)'s value at update k, written out: the
    linear warm-up from 0 to base_lr, then (1 - progress)^pwr to 0."""
    c = SURFACE_POLY
    if k < c["warmup_steps"]:
        return 0 + (c["base_lr"] - 0) * k / c["warmup_steps"]
    frac = 1 - (k - c["warmup_steps"]) / (c["max_update"] - c["warmup_steps"])
    return 0 + (c["base_lr"] - 0) * frac ** c["pwr"]


def _cosine_lr(k):
    """CosineScheduler(**SURFACE_COSINE)'s value at update k, written out."""
    c = SURFACE_COSINE
    if k < c["warmup_steps"]:
        return 0 + (c["base_lr"] - 0) * k / c["warmup_steps"]
    frac = (k - c["warmup_steps"]) / (c["max_update"] - c["warmup_steps"])
    return 0 + (c["base_lr"] - 0) * (1 + math.cos(math.pi * frac)) / 2


def surface_step(net, trainer, batch, train_mode=True):
    """One pretraining step as an fp16 AMP user writes it: the loss under
    ``record``, its backward through ``amp.scale_loss``, ``trainer.step``."""
    ids, types, pos, labels = batch
    with mx.autograd.record(train_mode=train_mode):
        mlm, _ = net(ids, types, pos)
        loss = streaming_softmax_ce(mlm, labels).mean(-1)
    with mx.amp.scale_loss(loss, trainer) as scaled:
        mx.autograd.backward(scaled)
    if trainer is not None:
        trainer.step(ids.shape[0])
    return loss


class _LrLog:
    """Records every learning rate the optimizer reads for an update."""

    def __init__(self, opt):
        self.opt, self.seen = opt, []
        self._orig = opt._get_lr

    def __enter__(self):
        def get_lr(i):
            lr = self._orig(i)
            self.seen.append(lr)
            return lr
        self.opt._get_lr = get_lr
        return self

    def __exit__(self, *exc):
        del self.opt._get_lr
        return False


def _snapshot(trainer):
    return ([p.data().detach().clone() for p in trainer._params]
            + [x.clone() for x in _flat_states(trainer)])


def _traced_families(fn, families):
    """Run ``fn`` once under a CUDA-only trace: {family: kernel records}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _lead()
        fn()
        torch.cuda.synchronize()
    got = {fam: 0 for _, fam in families}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            for sub, fam in families:
                if sub in ev.name:
                    got[fam] += 1
                    break
    return got


def _surface_bert(rehearsal, cfg, ctx, batch):
    """(a): six steps, then the overflow steps; returns (net, trainer, counts
    of a finite step, ok)."""
    device = ctx.device
    num_layers = cfg.get("num_layers", 12)
    net = _build_net(cfg, ctx, "float32")
    with mx.autograd.predict_mode():  # finish the deferred shapes
        net(*batch[:3])
    trainer = mx.gluon.Trainer(net.collect_params(), "lamb", {
        "learning_rate": 1e-3, "wd": 0.01,
        "lr_scheduler": mx.lr_scheduler.PolyScheduler(**SURFACE_POLY)})
    mx.amp.init_trainer(trainer)
    scaler, opt = trainer._amp_loss_scaler, trainer._optimizer
    want_finite = {n: 0 for n in ENTRIES}
    if not rehearsal:
        want_finite.update({n: num_layers for n in FLASH}, multi_tensor_lamb=2,
                           multi_tensor_finite=1)
    want_skip = dict(want_finite, multi_tensor_lamb=0)
    want_trace = {fam: 0 for _, fam in SURFACE_BERT_FAMILIES}
    if not rehearsal:
        want_trace.update({n: num_layers for n in FLASH}, lamb_pass1=1, lamb_pass2=1,
                          finite_pass=1)
    records, misses, finite_counts, traced = [], [], None, None
    for k in range(SURFACE_STEPS + SURFACE_MAX_SKIPS):
        if k == SURFACE_STEPS:
            scaler.loss_scale = SURFACE_OVERFLOW_SCALE
        before = _snapshot(trainer)
        counts_before = (dict(opt._index_update_count), opt.num_update)
        scale = scaler.loss_scale
        trace = (not rehearsal and traced is None and k >= 2 and k < SURFACE_STEPS)
        reset_kernel_counts()
        with _LrLog(opt) as log:
            if trace:
                fams = _traced_families(lambda: surface_step(net, trainer, batch),
                                        SURFACE_BERT_FAMILIES)
            else:
                loss = surface_step(net, trainer, batch)
            if device.type == "cuda":
                torch.cuda.synchronize()
        counts = kernel_counts()
        skipped = scaler.loss_scale < scale
        after = _snapshot(trainer)
        if skipped:
            bit_exact = all(torch.equal(a, b) for a, b in zip(before, after))
            ok = (bit_exact and scaler.loss_scale == scale / 2 and not log.seen
                  and (dict(opt._index_update_count), opt.num_update) == counts_before
                  and counts == want_skip)
            rec = dict(step=k, skipped=True, loss_scale=scale, new_scale=scaler.loss_scale,
                       bit_exact=bit_exact, update_counts_kept=(dict(
                           opt._index_update_count), opt.num_update) == counts_before)
        else:
            moved = not all(torch.equal(a, b) for a, b in zip(before[:len(trainer._params)],
                                                               after[:len(trainer._params)]))
            lr_want = _poly_lr(opt.num_update)
            lrs = sorted(set(log.seen))
            ok = (moved and lrs == [lr_want] and opt.learning_rate == lr_want
                  and opt.num_update == counts_before[1] + 1 and counts == want_finite)
            rec = dict(step=k, skipped=False, loss_scale=scale, num_update=opt.num_update,
                       lr_read=lrs, lr_expected=lr_want, weights_moved=moved)
            if finite_counts is None:
                finite_counts = counts
            if trace:
                traced = fams
                ok = ok and fams == want_trace
                rec["traced_kernels"] = fams
        if not trace:
            rec["loss"] = loss.float().mean().item()
        rec.update(launches=counts, ok=ok)
        records.append(rec)
        emit("train_surface", path="bert_lamb_fp16", **rec)
        if not ok:
            misses.append(k)
        if k >= SURFACE_STEPS and not skipped:
            break
    skips = [r["step"] for r in records if r["skipped"] and r["step"] >= SURFACE_STEPS]
    ok = (not misses and bool(skips) and not records[-1]["skipped"]
          and (rehearsal or traced == want_trace))
    emit("train_surface", path="bert_lamb_fp16", model="BERTForPretrain(bert_base) fp32 "
         "parameters, AMP float16, LAMB lr 1e-3 wd 0.01, PolyScheduler" if not rehearsal else
         "tiny BERT (CPU rehearsal)", schedule=SURFACE_POLY, steps=len(records),
         overflow_scale=SURFACE_OVERFLOW_SCALE, skipped_after_overflow=len(skips),
         final_scale=scaler.loss_scale, finite_step_launches=finite_counts,
         expected_finite_step=want_finite, traced_finite_step=traced,
         expected_traced=want_trace, failed_steps=misses, ok=ok)
    return net, trainer, finite_counts, ok


def _surface_fp16_grads(net, trainer, rehearsal):
    """The fp16 AMP gradients (unscaled) of a b=2 batch, dropout off,
    against the card's fp32 gradients of the same weights and batch."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    device = next(iter(net.collect_params().values())).data().device
    gen = torch.Generator(device=device).manual_seed(41)
    batch = _train_batch(cfg, 2, 16 if rehearsal else 128, 3 if rehearsal else 20, gen,
                         device)
    scale = trainer._amp_loss_scaler.loss_scale
    ids, types, pos, labels = batch
    with mx.autograd.record(train_mode=False):
        mlm, _ = net(ids, types, pos)
        loss = streaming_softmax_ce(mlm, labels).mean(-1)
    mx.autograd.backward(loss * scale)  # what amp.scale_loss hands the backward
    got = {k: (p.grad().detach().float() / scale).cpu()
           for k, p in net._collect_params_with_prefix().items()}
    mx.amp.disable()
    try:
        train_step(net, None, batch, train_mode=False)
    finally:
        mx.amp.init("float16")
    ref = {k: p.grad().detach().float().cpu()
           for k, p in net._collect_params_with_prefix().items()}
    return _grad_check("train_surface_fp16_vs_fp32", got, ref, loss_scale=scale,
                       path="bert_lamb_fp16")


def _surface_lamb_vs_plain(trainer):
    """The BERT step's LAMB group through the kernels against the per-tensor
    LAMB (what ``aggregate_num=0`` runs: phase 1 and 2 a tensor), from the
    same gradients, one update at a time: moments bit-equal, weights within
    LAMB_STEP_REL.  Returns the largest weight difference."""
    (step, kern), (_, plain) = _optimizer_group(trainer), _optimizer_group(trainer)
    launches = mt.multi_tensor_lamb.launches
    ok, err, ratio, moments_equal = True, 0.0, 0.0, True
    for extra in range(2):
        before = [w.clone() for w in plain[0]]
        opt_ops.group_apply(step, *kern[:5], [t + extra for t in kern[5]], kern[6])
        opt_ops.group_apply_plain(step, *plain[:5], [t + extra for t in plain[5]], plain[6])
        torch.cuda.synchronize()
        for a, b, w0 in zip(kern[0], plain[0], before):
            good, e, r = _lamb_bound_ok(a, b, w0)
            ok, err, ratio = ok and good, max(err, e), max(ratio, r)
        moments_equal = moments_equal and all(
            torch.equal(a, b) for a, b in zip([x for st in kern[2] for x in st],
                                              [x for st in plain[2] for x in st]))
        for a, b in zip(kern[0], plain[0]):
            a.copy_(b)
    launched = mt.multi_tensor_lamb.launches - launches
    good = ok and moments_equal and launched == 4
    emit("kernel_vs_plain_multi_tensor", case="train_surface_bert_step_group", variant="lamb",
         tensors=len(kern[0]), elements=sum(w.numel() for w in kern[0]),
         weight_dtype=str(kern[0][0].dtype).replace("torch.", ""), updates=2,
         launches=launched, expected_launches=4, moments_bit_equal=moments_equal,
         max_abs_err=err, worst_err_over_bound=ratio,
         bound=f"|dw| <= {LAMB_STEP_REL} * |step| + 2 ulp", ok=good)
    if not good:
        sys.exit(1)
    return err


def _surface_autograd_grad(net, rehearsal):
    """(c): ``autograd.grad`` of the per-sample loss against the gradients
    ``backward`` writes, same batch, dropout off, deterministic mode: bit
    for bit, and the gradient buffers untouched by ``grad``; on the card a
    ``create_graph`` gradient through the attention kernels raises."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    device = next(iter(net.collect_params().values())).data().device
    gen = torch.Generator(device=device).manual_seed(43)
    ids, types, pos, labels = _train_batch(cfg, 2, 16 if rehearsal else 128,
                                           3 if rehearsal else 20, gen, device)
    params = [p for p in net.collect_params().values() if p.grad_req != "null"]

    def loss():
        with mx.autograd.record(train_mode=False):
            mlm, _ = net(ids, types, pos)
            return streaming_softmax_ce(mlm, labels).mean(-1)

    with _deterministic(bert=True):
        mx.autograd.backward(loss())
        written = [p.grad().detach().clone() for p in params]
        got = mx.autograd.grad(loss(), [p.data() for p in params])
    equal = all(torch.equal(a, b) for a, b in zip(got, written))
    untouched = all(torch.equal(p.grad(), w) for p, w in zip(params, written))
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, written))
    refused = None
    if not rehearsal:
        try:
            mx.autograd.grad(loss(), [params[0].data()], create_graph=True)
            refused = False
        except RuntimeError as e:
            refused = "double backward" in str(e)
    ok = equal and untouched and refused is not False
    emit("train_surface", path="autograd_grad", params=len(params), bit_equal=equal,
         max_abs_err=err, grad_buffers_untouched=untouched,
         create_graph_through_kernels_refused=refused, ok=ok)
    return ok


def _surface_resnet(rehearsal):
    """(b): ResNet-50 with NAG and the warm-up cosine schedule, three steps,
    then its NAG group through the kernel against the per-tensor loop;
    returns (net, trainer, counts of one step, ok)."""
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    b = 2 if rehearsal else RESNET_B
    mx.amp.init("bfloat16")
    try:
        net = _build_resnet(rehearsal, ctx, 0)
        trainer = mx.gluon.Trainer(net.collect_params(), "nag", {
            "momentum": 0.9, "wd": 1e-4,
            "lr_scheduler": mx.lr_scheduler.CosineScheduler(**SURFACE_COSINE)})
        batch = _image_batch(rehearsal, b, torch.Generator(device=device).manual_seed(23),
                             device)
        n_bn = sum(isinstance(m, mx.gluon.nn.BatchNorm) for m in net.modules())
        want = {n: 0 for n in ENTRIES}
        if not rehearsal:
            want.update(bn_stats=n_bn, bn_apply=n_bn, multi_tensor=1)
        opt, misses, counts = trainer._optimizer, [], None
        for k in range(SURFACE_RESNET_STEPS):
            reset_kernel_counts()
            before_fused = fused_counts()
            with _LrLog(opt) as log:
                loss = resnet_step(net, trainer, batch).mean().item()
            step_counts = kernel_counts()
            nag = mt.multi_tensor_update.launches_by_variant.get("nag_mom", 0)
            fused_ok = _optimizer_check("train_surface", net, before_fused, "nag_mom",
                                        rehearsal)
            lrs = sorted(set(log.seen))
            ok = (fused_ok and step_counts == want and lrs == [_cosine_lr(opt.num_update)]
                  and math.isfinite(loss))
            emit("train_surface", path="resnet_nag", step=k, loss=loss,
                 num_update=opt.num_update, lr_read=lrs,
                 lr_expected=_cosine_lr(opt.num_update), launches=step_counts, expected=want,
                 ok=ok)
            counts = counts or dict(step_counts, multi_tensor_nag_mom=nag)
            if not ok:
                misses.append(k)
    finally:
        mx.amp.disable()
    ok = not misses
    if not rehearsal:
        phase_main_groups_vs_plain({"train_surface_resnet_step": trainer})
    emit("train_surface", path="resnet_nag", model="resnet50_v1(classes=1000), AMP bf16, "
         "fp32 parameters, NAG momentum 0.9 wd 1e-4, CosineScheduler" if not rehearsal else
         "tiny ResNetV1 (CPU rehearsal)", b=b, schedule=SURFACE_COSINE,
         steps=SURFACE_RESNET_STEPS, failed_steps=misses, ok=ok)
    return net, trainer, batch, counts, ok


def phase_train_surface(rehearsal):
    """The rest of the training surface on the card: (a) BERT-base under
    fp16 AMP with LAMB, PolyScheduler and dynamic loss scaling, six steps
    and then forced overflows, its fp16 gradients against fp32, its LAMB
    group against the per-tensor LAMB and its fold_update against the eager
    fused update; (b) ResNet-50 with NAG and CosineScheduler; (c)
    ``autograd.grad``.  Returns ({path: launch counts of one step}, the
    BERT (net, trainer, batch), the ResNet (net, trainer, batch), the
    largest LAMB kernel-vs-plain difference)."""
    t0 = time.perf_counter()
    cfg = TINY_BERT if rehearsal else BERT_BASE
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    b, s, p = (4, 16, 3) if rehearsal else (64, 128, 20)
    batch = _train_batch(cfg, b, s, p, torch.Generator(device=device).manual_seed(17), device)
    misses = []
    mx.amp.init("float16")
    try:
        net, trainer, bert_counts, ok = _surface_bert(rehearsal, cfg, ctx, batch)
        if not ok:
            misses.append("bert_lamb_fp16")
        if not _surface_fp16_grads(net, trainer, rehearsal):
            misses.append("fp16_vs_fp32_grads")
        lamb_err = 0.0 if rehearsal else _surface_lamb_vs_plain(trainer)
        if not _surface_autograd_grad(net, rehearsal):
            misses.append("autograd_grad")
    finally:
        mx.amp.disable()

    def make_lamb():
        net = _build_net(dict(cfg, dropout=0.0), ctx, "float32")
        with mx.autograd.predict_mode():
            net(*batch[:3])
        return net, mx.gluon.Trainer(net.collect_params(), "lamb", {
            "learning_rate": 1e-3, "wd": 0.01,
            "lr_scheduler": mx.lr_scheduler.PolyScheduler(**SURFACE_POLY)})

    with _deterministic(bert=True):
        if not _fold_update_check(make_lamb, bert_loss, batch, rehearsal):
            misses.append("fold_update_lamb")
    rnet, rtrainer, rbatch, resnet_counts, ok = _surface_resnet(rehearsal)
    if not ok:
        misses.append("resnet_nag")
    emit("train_surface", phase_s=time.perf_counter() - t0, failed=misses, ok=not misses)
    if misses:
        sys.exit(1)
    return ({"train_surface_bert_step": bert_counts,
             "train_surface_resnet_step": resnet_counts},
            (net, trainer, batch), (rnet, rtrainer, rbatch), lamb_err)


# -- phase 6d: serving's last items -----------------------------------------
# symbol_block: HybridBlock.export, gluon.SymbolBlock and sym.Custom in a
# graph at BERT-base width (the slice phase's weights, the serve phase's
# graph), before the timing phase.
SB_INPUTS = ("token_ids", "token_types", "masked_positions")
SB_BURST = (2, 64)  # submitter threads, requests each


def _rel_max(got, ref):
    """max |got − ref| over max |ref| (the slice phase's unit)."""
    g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(g - r).max() / np.abs(r).max())


def phase_symbol_block(net, main_req, rehearsal, smi=None):
    """The serving items of slice 18 on the slice phase's weights: a fp32
    Gluon copy hybridized, one forward and ``export`` under ``build/``; that
    file through ``predictor.load_checkpoint`` (``Predictor``) and a
    ``SymbolBlock`` over ``tests/sym_bert.py``'s graph, each bit-equal to the
    Gluon forward (deterministic mode), and through ``amp.convert_model``
    in bf16; then the graph with every FFN activation ``sym.Custom(
    op_type="rtc_gelu")`` (the user's kernels) in bf16, through a
    ``Predictor`` and an ``InferenceServer`` burst, held to the bf16 Gluon
    net under ``rtc_gelu_ffn``.  Returns {path: launch counts}; exits
    non-zero on any miss."""
    from incubator_mxnet_torch import amp, profiler
    from incubator_mxnet_torch.predictor import Predictor, load_checkpoint
    from incubator_mxnet_torch.serving import InferenceServer

    cfg = TINY_BERT if rehearsal else BERT_BASE
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device_kw = {"dev_type": "cpu"} if rehearsal else {}
    cuda = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    layers = cfg.get("num_layers", 12)
    t_phase = time.perf_counter()
    b, s = main_req[0].shape
    p = main_req[2].shape[1]
    inputs = _serve_inputs(main_req)
    shapes = {k: v.shape for k, v in inputs.items()}
    out_dir = Path(__file__).resolve().parent / "build" / "symbol_block"
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = True

    # 1. export: the slice weights in fp32, hybridized, one forward
    gluon32 = _build_net(cfg, ctx, "float32")
    load_numpy_params(gluon32, {k: v.data().detach().float().cpu().numpy()
                                for k, v in net._collect_params_with_prefix().items()})
    names = (gluon32.bert.prefix, gluon32.prefix)
    gluon32.hybridize()
    with _deterministic(True), mx.autograd.predict_mode():
        ref32 = [o.float().cpu().numpy() for o in gluon32(*main_req)]
    t0 = time.perf_counter()
    json_path, params_path = gluon32.export(str(out_dir / "bert"))
    export_s = time.perf_counter() - t0
    del gluon32
    graph = _sym_bert().bert_symbol
    dims = (layers, cfg.get("units", 768), cfg.get("hidden_size", 3072),
            cfg.get("num_heads", 12), cfg["vocab_size"], s, p)
    sym = graph(mx.sym, *dims, names=names, max_length=cfg["max_length"])
    emit("symbol_block", part="export", params_bytes=Path(params_path).stat().st_size,
         symbol_json=json.loads(Path(json_path).read_text()), export_s=export_s)

    # 2. the file through load_checkpoint (Predictor) and SymbolBlock, fp32
    t0 = time.perf_counter()
    _, args, auxs = load_checkpoint(sym, params_path)
    pred32 = Predictor(sym, {**{"arg:" + k: v for k, v in args.items()},
                             **{"aux:" + k: v for k, v in auxs.items()}}, shapes, **device_kw)
    block = mx.gluon.SymbolBlock(sym, [mx.sym.var(n) for n in SB_INPUTS])
    block.load_parameters(params_path, ctx=ctx)
    load_s = time.perf_counter() - t0
    profiler.reset_compiles()
    with _deterministic(True), mx.autograd.predict_mode():
        got_pred = _predict(pred32, inputs)
        sync()
        reset_kernel_counts()
        got_block = [o.float().cpu().numpy() for o in block(*main_req)]
        sync()
        block_counts = kernel_counts()
        again = [o.float().cpu().numpy() for o in block(*main_req)]
    plans = len(block._plans)
    builds = profiler.compile_stats().get("gluon.symbol_block", {}).get("count")
    want32 = {n: (layers if n == "flash_fwd" and cuda else 0) for n in ENTRIES}
    pred_equal = all(np.array_equal(g, r) for g, r in zip(got_pred, ref32))
    block_equal = all(np.array_equal(g, r) for g, r in zip(got_block, ref32))
    repeat_equal = all(np.array_equal(g, r) for g, r in zip(again, got_block))
    fp32_ok = (pred_equal and block_equal and repeat_equal and plans == 1 and builds == 1
               and block_counts == want32)
    emit("symbol_block", part="fp32", b=b, s=s, p=p, load_s=load_s,
         predictor_bit_equal_gluon=pred_equal, symbol_block_bit_equal_gluon=block_equal,
         symbol_block_repeat_bit_equal=repeat_equal,
         max_abs_diff=[float(np.abs(g - r).max()) for g, r in zip(got_block, ref32)],
         plans=plans, builds_reported=builds, launches_one_forward=block_counts,
         expected=want32, ok=fp32_ok)
    ok &= fp32_ok
    pred32.close()
    del pred32, block, args, auxs

    # 3. bf16 through amp.convert_model
    conv = amp.convert_model(*load_checkpoint(sym, params_path), target_dtype="bfloat16")

    def predictor16(csym, cargs, cauxs):
        return Predictor(csym, {**{"arg:" + k: v for k, v in cargs.items()},
                                **{"aux:" + k: v for k, v in cauxs.items()}},
                         shapes, **device_kw)

    pred16 = predictor16(*conv)
    got16 = _predict(pred16, inputs)
    rel16 = max(_rel_max(g, r) for g, r in zip(got16, ref32))
    bf16_ok = rel16 <= SLICE_REL_BOUND
    emit("symbol_block", part="bf16_predictor", max_rel_err_vs_fp32=rel16,
         bound=SLICE_REL_BOUND, ok=bf16_ok)
    ok &= bf16_ok
    pred16.close()
    del pred16, conv

    # 4. the graph with the user's GELU, bf16: Predictor and a server burst
    csym = graph(mx.sym, *dims, names=names, max_length=cfg["max_length"],
                 ffn_op_type="rtc_gelu")
    cjson = out_dir / "bert_rtc-symbol.json"
    csym.save(str(cjson))
    predc = predictor16(*amp.convert_model(*load_checkpoint(str(cjson), params_path),
                                           target_dtype="bfloat16"))
    _predict(predc, inputs)  # its plan
    sync()
    reset_kernel_counts()
    RtcGelu.plain_calls = 0
    gotc = _predict(predc, inputs)
    sync()
    custom_counts, plain_calls = kernel_counts(), RtcGelu.plain_calls
    with mx.autograd.predict_mode():
        with rtc_gelu_ffn(net):
            refc = [o.float().cpu().numpy() for o in net(*main_req)]
        builtin = [o.float().cpu().numpy() for o in net(*main_req)]

    def rel_l2(a, r):
        return float(np.linalg.norm(np.asarray(a, np.float64) - r) / np.linalg.norm(r))

    relc = [rel_l2(g, r) for g, r in zip(gotc, refc)]
    on_card = {"flash_fwd", "rtc_gelu_fwd"}
    wantc = {n: (layers if n in on_card and cuda else 0) for n in ENTRIES}
    want_plain = 0 if cuda else layers
    custom_ok = (max(relc) <= GRAD_REL_BOUND and custom_counts == wantc
                 and plain_calls == want_plain)
    emit("symbol_block", part="custom_predictor", op_type="rtc_gelu",
         custom_nodes=sum(n.op == "Custom" for n in csym._topo()),
         rel_l2_vs_gluon_rtc_gelu_ffn=relc, bound=GRAD_REL_BOUND,
         rel_l2_vs_gluon_builtin_gelu=[rel_l2(g, r) for g, r in zip(gotc, builtin)],
         launches_one_forward=custom_counts, expected=wantc,
         plain_gelu_calls=plain_calls, expected_plain=want_plain, ok=custom_ok)
    ok &= custom_ok

    # a full batch dispatches at once; the budget only bounds a partial one,
    # which a CPU shared with other work must not cut into two
    srv = InferenceServer(str(cjson), params_path, {k: v.shape[1:] for k, v in inputs.items()},
                          input_dtypes={k: "int32" for k in inputs}, max_batch_size=b,
                          max_queue_ms=SERVE_QUEUE_MS if cuda else 5000.0,
                          amp_dtype="bfloat16", name="bert_rtc", **device_kw)
    warm = srv.compile_stats()
    c0 = profiler.counters()
    samples = [{k: v[i] for k, v in inputs.items()} for i in range(b)]
    reset_kernel_counts()
    full = _served(srv, samples)
    sync()
    served_counts = kernel_counts()
    served_equal = _rows_equal(full, gotc, range(b))
    threads_n, per = SB_BURST if not rehearsal else (2, 8)
    errors = []

    def submitter(t):
        try:
            for q in [srv.submit(samples[(t * per + j) % b]) for j in range(per)]:
                q.result(timeout=120.0)
        except Exception as e:  # noqa: BLE001 — counted and gated below
            errors.append(repr(e))

    workers = [threading.Thread(target=submitter, args=(t,)) for t in range(threads_n)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    burst_s = time.perf_counter() - t0
    c1 = profiler.counters()
    final = srv.stats()
    gates = {"bucket_miss_after_warmup": final["bucket_miss_after_warmup"],
             "failed": final["failed"], "submit_errors": len(errors),
             "plans_built_after_warmup": c1["compile_total"] - c0["compile_total"],
             "compile_stats_unchanged": srv.compile_stats() == warm}
    want_gates = {"bucket_miss_after_warmup": 0, "failed": 0, "submit_errors": 0,
                  "plans_built_after_warmup": 0, "compile_stats_unchanged": True}
    server_ok = (gates == want_gates and served_equal and served_counts == wantc)
    srv.close(drain=True)
    emit("symbol_block", part="custom_server", full_batch_bit_equal_predictor=served_equal,
         launches_one_batch=served_counts, expected=wantc, burst_requests=threads_n * per,
         burst_s=burst_s, samples_per_s=threads_n * per / burst_s, gates=gates,
         errors=errors[:3], ok=server_ok, card=smi)
    ok &= server_ok
    predc.close()
    del predc, srv
    for f in (json_path, params_path, cjson):
        Path(f).unlink()
    if cuda:
        torch.cuda.empty_cache()
    emit("symbol_block", phase_s=time.perf_counter() - t_phase, ok=ok)
    if not ok:
        sys.exit(1)
    return {"symbol_block_fp32_forward": block_counts, "symbol_block_custom_forward":
            custom_counts}


# -- phase 6e: observability ---------------------------------------------------
# observe: mx.profiler over the train phase's BERT-base trainer: eager
# Trainer.steps and folded calls (replays of a program captured before the
# recorder arms, so no trace starts inside a capture), step telemetry, spans,
# the compile registry, goodput, the JSONL log, the slow-step detector and
# the device trace's kernel table.
OBSERVE_STEPS = 20          # eager steps, then as many folded calls
OBSERVE_SLEEP_S = 0.2       # the injected host stall (1 s in the rehearsal: a CPU
                            # shared with other work can stretch a tiny step)
OBSERVE_SLOW_MULT = 4.0     # the threshold: this many folded steps' median wall
OBSERVE_GOODPUT_REL = 0.01  # the goodput buckets sum to the wall within this share
# the device table may miss this share of a kernel's records (kineto drops
# records outside its trace window, ROADMAP §3 "Not faults"); a shortfall is
# printed as a device_table_short line, never hidden
OBSERVE_TABLE_SLACK = 0.02
OBSERVE_TURN_CALLS = 20     # folded calls a timed turn


def _nesting(path):
    """(B/E pairs that close, every trainer/optimizer span inside a step
    span with that step's id, spans by name) of a dumped chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    stacks, spans = {}, []
    closed = True
    for e in sorted((e for e in events if e.get("ph") in ("B", "E")), key=lambda e: e["ts"]):
        st = stacks.setdefault((e["pid"], e["tid"]), [])
        if e["ph"] == "B":
            st.append(e)
        elif st:
            b = st.pop()
            spans.append((b, e["ts"]))
        else:
            closed = False
    closed &= not any(stacks.values())
    steps = [(b, end) for b, end in spans if b["cat"] == "step"]
    nested = all(any(sb["ts"] <= b["ts"] and end <= send
                     and sb["args"]["step"] == b["args"]["step"] for sb, send in steps)
                 for b, end in spans if b["cat"] in ("trainer", "optimizer"))
    by_name = {}
    for b, _ in spans:
        by_name[b["name"]] = by_name.get(b["name"], 0) + 1
    return closed, nested, by_name


def _observe_turns(prog, batch, profiler, cuda):
    """The folded step's ms with the recorder unarmed and armed (device trace
    on), in turns (unarmed, armed, armed, unarmed): CUDA events over
    OBSERVE_TURN_CALLS calls."""
    out = []
    for armed in (False, True, True, False):
        if armed:
            profiler.start()
        prog(*batch)
        if cuda:
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        for _ in range(OBSERVE_TURN_CALLS):
            prog(*batch)
        if cuda:
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / OBSERVE_TURN_CALLS
        else:
            ms = (time.perf_counter() - t0) * 1e3 / OBSERVE_TURN_CALLS
        if armed:
            profiler.stop()
        out.append({"armed": armed, "step_ms": ms})
    return out


def phase_observe(train, rehearsal, smi=None):
    """``mx.profiler`` over the train phase's BERT-base Adam multi_precision
    trainer: with ``profiler.start()`` OBSERVE_STEPS eager Trainer.steps and
    as many folded calls (one host stall of OBSERVE_SLEEP_S injected among
    them), then the checks: one step_stats entry a call with consecutive
    ids, trainer.update and fused.group_apply inside their steps in the
    dump, which ``tools/trace_merge.py --check`` passes; one gluon.step_fold
    compile record and none once the guard is armed in raise mode; the
    goodput buckets summing to the wall; the JSONL log's strictly
    increasing seq; exactly one slow step; and the device table's kernels
    of the 2·OBSERVE_STEPS steps.  Then the folded step's ms with the
    recorder unarmed and armed, in turns (reported).  Returns {path: launch
    counts of the eager steps}; exits non-zero on any miss."""
    from incubator_mxnet_torch import profiler

    tnet, trainer, batch = train
    cuda = batch[0].is_cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    layers = (TINY_BERT if rehearsal else BERT_BASE).get("num_layers", 12)
    n = OBSERVE_STEPS if not rehearsal else 4
    stall_s = OBSERVE_SLEEP_S if not rehearsal else 1.0
    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "observe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in ("metrics.jsonl", "profile.json"):
        (out_dir / f).unlink(missing_ok=True)
    profiler.stop()
    profiler.set_config(filename=str(out_dir / "profile.json"), compile_guard=None,
                        slow_step_ms=None, slow_step_auto=False)
    profiler.disarm_compile_guard()
    profiler.reset_compiles()

    # the folded program: warm-up and capture before the recorder arms
    prog = trainer.fold_step(bert_loss(tnet), block=tnet)
    prog(*batch)
    prog(*batch)
    sync()
    records = [r for r in profiler.compile_registry()["records"]
               if r["site"] == "gluon.step_fold"]
    guard = profiler.compile_guard_state()
    profiler.set_config(compile_guard="raise")
    c0 = profiler.counters()

    profiler.reset_goodput()
    profiler.start()
    profiler.start_metrics(jsonl=str(out_dir / "metrics.jsonl"), interval_s=0.1)
    first = profiler.current_step()
    events = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

    mark()
    reset_kernel_counts()
    for _ in range(n):
        train_step(tnet, trainer, batch)
        mark()
    sync()
    eager_counts = kernel_counts()
    for i in range(n):
        if i == n // 2:  # the threshold from the folded steps so far
            folded = [s["wall_ms"] for s in profiler.step_stats()[n:]]
            threshold = max(OBSERVE_SLOW_MULT * statistics.median(folded), stall_s * 1e3 / 2)
            profiler.set_config(slow_step_ms=threshold)
        if i == n // 2 + 1:
            time.sleep(stall_s)
        prog(*batch)
        mark()
    sync()
    stats = profiler.step_stats()
    goodput = profiler.goodput_snapshot()
    jsonl = out_dir / "metrics.jsonl"
    deadline = time.perf_counter() + 10.0
    while (not jsonl.exists() or jsonl.read_text().count("\n") < 2) and \
            time.perf_counter() < deadline:
        time.sleep(0.05)  # a short run: let the log write its second line
    profiler.stop_metrics()
    profiler.stop()
    c1 = profiler.counters()
    profiler.set_config(slow_step_ms=None, slow_step_auto=True, compile_guard=None)
    path = profiler.dump()
    text = profiler.dumps()

    # step telemetry: one entry a call, consecutive ids, beside device time
    ids = [s["step"] - first for s in stats]
    steps_ok = ids == list(range(2 * n))
    event_ms = ([events[i].elapsed_time(events[i + 1]) for i in range(len(events) - 1)]
                if cuda else None)
    walls = [s["wall_ms"] for s in stats]
    host = [s["host_ms"] for s in stats]

    def med(xs):
        return statistics.median(xs) if xs else None

    emit("observe", part="steps", calls=2 * n, step_stats=len(stats), ids_consecutive=steps_ok,
         eager_wall_ms_median=med(walls[:n]), eager_host_ms_median=med(host[:n]),
         eager_event_ms_median=med(event_ms[:n]) if cuda else None,
         folded_wall_ms_median=med(walls[n:]), folded_host_ms_median=med(host[n:]),
         folded_event_ms_median=med(event_ms[n:]) if cuda else None,
         wall_ms=[round(w, 3) for w in walls],
         event_ms=[round(e, 3) for e in event_ms] if cuda else None, card=smi)

    # spans nest in the dump, which trace_merge --check passes
    closed, nested, by_name = _nesting(path)
    merged = out_dir / "merged.json"
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "tools" /
                                             "trace_merge.py"), path, "-o", str(merged),
                         "--check", "--expect-ranks", "1"], capture_output=True, text=True,
                        timeout=300)
    spans_ok = (closed and nested and rc.returncode == 0
                and by_name.get("trainer.update") == n and by_name.get("step") == 2 * n
                and by_name.get("trainer.step_fold") == n
                and by_name.get("fused.group_apply", 0) >= n)
    emit("observe", part="spans", pairs_close=closed, nested_in_steps=nested,
         trace_merge_check_rc=rc.returncode, trace_merge_stderr=rc.stderr[-300:],
         spans_by_name={k: by_name[k] for k in sorted(by_name) if not k.startswith("dispatch")},
         ok=spans_ok)

    # compile registry and guard, goodput, the JSONL log, the slow step
    compile_ok = (len(records) == 1 and records[0]["program"] == "step_fold"
                  and guard["armed"] and guard["armed_by"] == "gluon.step_fold"
                  and c1["recompile_steady_state"] == c0["recompile_steady_state"]
                  and c1["compile_total"] == c0["compile_total"])
    b = goodput["buckets_s"]
    gp_rel = abs(sum(b.values()) - goodput["wall_s"]) / goodput["wall_s"]
    lines = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    seqs = [ln["seq"] for ln in lines]
    jsonl_ok = len(seqs) >= 2 and all(a < b2 for a, b2 in zip(seqs, seqs[1:]))
    slow = c1["slow_step_detected"] - c0["slow_step_detected"]
    calls = c1["step_fold_call"] - c0["step_fold_call"]
    misc_ok = (compile_ok and gp_rel <= OBSERVE_GOODPUT_REL and jsonl_ok and slow == 1
               and calls == n)
    emit("observe", part="registry", step_fold_records=len(records),
         capture_ms=records[0]["wall_ms"] if records else None, guard=guard,
         builds_while_armed=c1["compile_total"] - c0["compile_total"],
         goodput=goodput, goodput_sum_rel_err=gp_rel, bound=OBSERVE_GOODPUT_REL,
         jsonl_lines=len(lines), jsonl_seq_increasing=jsonl_ok, slow_steps=slow,
         slow_threshold_ms=threshold, step_fold_calls=calls, ok=misc_ok)

    # the device table: the kernels of the 2·n steps by name
    table = profiler._device_op_stats(topn=10 ** 6)
    fams = {"flash_fwd": "flash_fwd_tma", "flash_bwd_dq": "flash_bwd_dq_tma",
            "flash_bwd_dkv": "flash_bwd_dkv_tma", "multi_tensor": "multi_tensor_update"}
    counts = {f: sum(c for name, c, _ in table if sub in name) for f, sub in fams.items()}
    want = {f: (2 * n * (1 if f == "multi_tensor" else layers) if cuda else 0) for f in fams}
    short = {f: want[f] - counts[f] for f in fams if counts[f] != want[f]}
    table_ok = all(0 < want[f] - counts[f] <= OBSERVE_TABLE_SLACK * want[f] for f in short)
    if short and table_ok:
        emit("observe", device_table_short=short, expected=want,
             note="kineto dropped records outside its trace window")
    emit("observe", part="device_table", kernels=counts, expected=want,
         top=[[name[:60], c, round(s * 1e3, 3)] for name, c, s in table[:8]],
         dumps_device_section=("Device kernels" in text) if cuda else None, ok=table_ok)

    # the folded step unarmed and armed, in turns (reported)
    turns = _observe_turns(prog, batch, profiler, cuda)
    emit("observe", part="turns", per=f"ms a folded BERT-base step, CUDA events over "
         f"{OBSERVE_TURN_CALLS} calls", turns=turns, card=smi)
    prog.invalidate()
    del prog
    profiler.disarm_compile_guard()
    if cuda:
        torch.cuda.empty_cache()
    ok = steps_ok and spans_ok and misc_ok and table_ok
    emit("observe", phase_s=time.perf_counter() - t_phase, ok=ok)
    if not ok:
        sys.exit(1)
    return {"observe_eager_steps": eager_counts}


# -- phase 7 ----------------------------------------------------------------


def _time(fn, arg_sets, iters, uniform=False):
    """Per call of ``fn``, cycling through ``arg_sets`` (several input sets,
    so a call does not find the last one's inputs in the 50 MB L2):
    ``(device_ms, call_ms, kernels_us, records)``.  device_ms is the time of
    the kernels the calls launched (torch.profiler's CUDA trace, summed and
    divided by ``iters``), the kernel's time; call_ms is the wall time
    between CUDA events around the calls, which also holds host time where
    the host issues calls slower than the card runs them; kernels_us splits
    device time by kernel name, and records counts each name's records in
    the trace.  The trace holds a warm-up call and the sentinel before the
    counted calls, and counts what follows the sentinel.  A trace with no
    counted record is taken again, and with
    ``uniform`` (every call launches the same kernels) so is one whose
    counts are not multiples of ``iters``: at most three times in all.  The
    trace can come back empty on the card for the rest of a process; then
    device_ms is call_ms, the CUDA events' time (an upper bound of the
    kernels' own, since it also holds the gaps between launches),
    kernels_us and records are empty, and a ``timing_fallback`` line says
    so."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _lead()
            fn(*arg_sets[-1])  # the warm-up call, then the sentinel
            torch.cuda._sleep(SENTINEL_CYCLES)
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        warm, counted = _split_at_sentinel(prof)
        kernels, records = {}, {}
        for ev in counted or ():
            name = ev.name[:90]
            kernels[name] = kernels.get(name, 0.0) + ev.time_range.elapsed_us() / iters
            records[name] = records.get(name, 0) + 1
        if warm is not None:
            _note_warm_short(getattr(fn, "__qualname__", repr(fn)), warm,
                             {n: c // iters for n, c in records.items() if c % iters == 0})
        if records and (not uniform or all(n % iters == 0 for n in records.values())):
            return sum(kernels.values()) * 1e-3, call_ms, kernels, records
    emit("times", timing_fallback=getattr(fn, "__qualname__", repr(fn)), iters=iters,
         lost_records=records, device_ms_from="CUDA events around the calls")
    return call_ms, call_ms, {}, {}


def _graph_ms(fn, arg_sets, calls=40, replays=5):
    """Device ms per call of ``fn`` by a second method: ``calls`` calls,
    cycling through ``arg_sets``, captured in one CUDA graph and replayed
    ``replays`` times between CUDA events.  No host work and no profiler
    come between the kernels; the graph's own gaps between launches count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with step_fold._graph_capture(graph):
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _kernel_family(name):
    if name.startswith(("gelu_fwd_", "gelu_bwd_")):  # the user's kernels of RTC_SOURCE
        return "rtc_" + name[:8]
    if "lamb_pass" in name:
        return "multi_tensor_lamb"
    if "finite_pass" in name:
        return "multi_tensor_finite"
    for fam in ("flash_wide_bwd_dkv", "flash_wide_bwd_dq", "flash_wide_bwd_delta",
                "flash_wide_fwd", "flash_bwd_dkv",
                "flash_bwd_dq", "flash_fwd", "bn_stats", "bn_apply", "multi_tensor"):
        if fam in name:
            return fam
    if re.search(r"conv|cudnn|fprop|dgrad|wgrad|nchw|nhwc", name, re.I):
        return "convolution"
    if re.search(r"gemm|nvjet|xmma|cutlass|cublas", name, re.I):
        return "matmul"
    return "other"


def phase_profile(what, fn, smi):
    """Where one call of ``fn``'s device time goes, by kernel family, from
    torch.profiler's CUDA trace; 'not measured' if it shows none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # BatchNorm's backward is plain PyTorch inside record_function
    # ("mx.bn_backward"), which the trace also shows as a range on the
    # device: kernels that start inside one of those ranges form the
    # bn_backward_plain family, and the ranges themselves are no kernels.
    device = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    bn_ranges = [(ev.time_range.start, ev.time_range.end) for ev in device
                 if ev.name == "mx.bn_backward"]
    by_family = {}
    for ev in device:
        if ev.name.startswith("mx."):
            continue
        fam = ("bn_backward_plain" if any(a <= ev.time_range.start < b for a, b in bn_ranges)
               else _kernel_family(ev.name))
        kernels = by_family.setdefault(fam, {})
        kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    families = {fam: sum(k.values()) for fam, k in by_family.items()}
    total_us = sum(families.values())
    if total_us == 0:
        emit("profile", what=what, device_time="not measured", card=smi)
        return
    top = {fam: [[n[:90], us] for n, us in sorted(k.items(), key=lambda kv: -kv[1])[:3]]
           for fam, k in by_family.items()}
    emit("profile", what=what, wall_us=wall_us, device_us=total_us,
         device_busy_share=total_us / wall_us, families_us=families,
         top_kernels_us_by_family=top, card=smi)


def _bound(nbytes, flops, dtype=torch.bfloat16):
    """The least ms of a kernel moving ``nbytes`` and doing ``flops`` of its
    function's operations, at the peak rate of ``dtype`` (a key of
    PEAK_OPS_PER_S: a dtype, or the route "split_tf32"), and which bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _sdpa_backend(kernels):
    """The backend SDPA picked, read from the names of the kernels it
    launched in the trace (cuDNN's own kernels carry "flash" too)."""
    if not kernels:
        return "not measured (no trace)"
    names = " ".join(kernels).lower()
    for key, backend in (("cudnn", "cudnn"), ("fmha_cutlass", "efficient"), ("flash", "flash")):
        if key in names:
            return backend
    return "math (matmul and softmax kernels)"


def _fwd_row(views, bhsd_sets, smi, **tags):
    """flash_fwd, its plain version and SDPA on the same [B, S, H, Dh] views
    (of any of the kernel's dtypes; k and v may hold another S than q),
    timed in one run; emits the row and returns it.  ``tags`` join the
    row's shape."""
    b, sq, h, d = views[0][0].shape
    sk = views[0][1].shape[1]
    dtype = views[0][0].dtype
    kernel = lambda q, k, v: att.flash_fwd(q, k, v, layout="bshd")  # noqa: E731
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        kernel_ms, call_ms, _, records = _time(kernel, views, 200, uniform=True)
        plain_ms, _, _, _ = _time(lambda q, k, v: att.flash_fwd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), views, 20)
        library_ms, _, lib_kernels, lib_records = _time(sdpa, bhsd_sets, 200, uniform=True)
        graph_ms, lib_graph_ms = _graph_ms(kernel, views), _graph_ms(sdpa, bhsd_sets)
    # q and k, v read once, o written once; q·kᵀ and p·v
    nbytes = 2 * b * (sq + sk) * h * d * views[0][0].element_size()
    flops = 4 * b * h * sq * sk * d
    # the route: wgmma in 16 bits (flash_fwd.cu); in fp32 flash_wide.cu's
    # split-TF32 kernel, whose bound is taken, the CUDA cores' stated beside it
    route = "split_tf32" if dtype == torch.float32 else "wgmma"
    bound_ms, bound_by = _bound(nbytes, flops, route if route == "split_tf32" else dtype)
    bounds = {}
    if dtype == torch.float32:
        bounds = dict(route=route, cuda_core_bound_ms=_bound(nbytes, flops, dtype)[0],
                      split_tf32_bound_ms=bound_ms,
                      functions=sorted({_function_name(f) for f in records}))
    shape = dict(b=b, **(dict(s=sq) if sq == sk else dict(sq=sq, sk=sk)), h=h, d=d,
                 dtype=str(dtype).replace("torch.", ""), **tags)
    backend = _sdpa_backend(lib_kernels)
    emit("times", kernel="flash_fwd", shape=shape, **bounds,
         ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
         library="SDPA", library_backend=backend, library_kernels_us=lib_kernels,
         records=records,
         library_records=lib_records, graph_ms=graph_ms, library_graph_ms=lib_graph_ms,
         bound_ms=bound_ms, bound_by=bound_by,
         bytes=nbytes, flops=flops, share_of_bound=bound_ms / kernel_ms,
         achieved_bytes_per_s=nbytes / (kernel_ms * 1e-3), card=smi)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, shape=shape, library_backend=backend, **bounds)


# The generation path's flash_fwd calls (transformer-big, H = 16, Dh = 64,
# bf16): a cached greedy step's [4, 1, 16, 64] query against Sk = 32 and
# 128 keys of a [4, 128, 16, 64] cache, and a server prefill's [1, 128, 16,
# 64] against a 100-token prompt.
GEN_TIME_SHAPES = (("decode_sk32", 4, 1, 32, 128), ("decode_sk128", 4, 1, 128, 128),
                   ("prefill_sq128_sk100", 1, 128, 100, 128))


def _gen_fwd_row(name, b, sq, sk, t, gen, smi):
    """flash_fwd, its plain version and SDPA at one generation shape (bf16):
    q [b, sq, 16, 64], k and v the views [:, :sk] of [b, t, 16, 64] caches
    (four input sets); emits the row and returns it."""
    h, d, dtype = GEN["h"], GEN["d"], torch.bfloat16
    sets = [(_randn((b, sq, h, d), dtype, gen, gen.device),
             *(_randn((b, t, h, d), dtype, gen, gen.device)[:, :sk] for _ in range(2)))
            for _ in range(4)]
    return _fwd_row(sets, [tuple(x.transpose(1, 2).contiguous() for x in v) for v in sets],
                    smi, cache_len=t, path=name)


def _times_fwd(views, bhsd_sets, smi):
    """The main row (the training and inference batch), the same shape in
    fp32 (flash_wide_fwd_f32_rows<1>; MXNet's default dtype) and a row at
    the S=512 request shape, each beside SDPA in the same run; returns the
    main row, the fp32 one under "other_shapes"."""
    row = _fwd_row(views, bhsd_sets, smi)
    device = views[0][0].device
    gen = torch.Generator(device=device).manual_seed(98)
    fp32_views = [(x[:, :, 0], x[:, :, 1], x[:, :, 2])
                  for x in (_randn(tuple(views[0][0].shape[:2]) + (3,)
                                   + tuple(views[0][0].shape[2:]), torch.float32, gen, device)
                            for _ in range(4))]  # 302 MB: beyond the 50 MB L2
    row["other_shapes"] = [_fwd_row(
        fp32_views, [tuple(t.transpose(1, 2).contiguous() for t in v) for v in fp32_views], smi)]
    del fp32_views
    b, s, h, d = 8, 512, MAIN["h"], MAIN["d"]  # the S=512 request of the slice phase
    long_views = [(x[:, :, 0], x[:, :, 1], x[:, :, 2])
                  for x in (_randn((b, s, 3, h, d), torch.bfloat16, gen, device)
                            for _ in range(4))]  # 75 MB: beyond the 50 MB L2
    _fwd_row(long_views, [tuple(t.transpose(1, 2).contiguous() for t in v) for v in long_views],
             smi)
    del long_views
    row["other_shapes"] += [_gen_fwd_row(*shape, gen, smi) for shape in GEN_TIME_SHAPES]
    return row


def _bwd_row(b, s, gen, smi, dtype=torch.bfloat16):
    """Both backward kernels at [B, S, 12, 64] in ``dtype`` (the [B, S, 3,
    H, Dh] views of the main path), each alone and as the one ``flash_bwd`` call
    the path makes, beside the plain version and SDPA's backward in the
    same run; emits the rows and returns {kernel: row}.  The plain version
    and the library's backward compute dq, dk and dv together, so both
    rows carry the same; the library's is SDPA's, the device time of SDPA
    forward+backward less that of SDPA forward, timed only.  ``graph_ms``
    times each by CUDA-graph replay as well; ``call_ms`` is the CUDA-event
    time per call, which holds the wrapper's host cost where the host
    issues calls slower than the card runs them, beside that of the
    parent's two calls (``flash_bwd_dq`` then ``flash_bwd_dkv``)."""
    h, d = MAIN["h"], MAIN["d"]
    device = torch.device("cuda", 0)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    sets = []
    with torch.no_grad():
        for _ in range(4):  # > 200 MB: beyond the 50 MB L2
            x = _randn((b, s, 3, h, d), dtype, gen, device)
            q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
            do = _randn((b, s, h, d), dtype, gen, device)
            o, lse = att.flash_fwd(q, k, v, with_lse=True, layout="bshd")
            sets.append((q, k, v, o, do, lse))
        dq = lambda *a: att.flash_bwd_dq(*a, layout="bshd")  # noqa: E731
        dkv = lambda *a: att.flash_bwd_dkv(*a, layout="bshd")  # noqa: E731
        pair = lambda *a: att.flash_bwd(*a, layout="bshd")  # noqa: E731

        def two_calls(*a):
            dq(*a)
            dkv(*a)

        dq_ms, dq_call_ms, _, dq_records = _time(dq, sets, 200, uniform=True)
        dkv_ms, dkv_call_ms, _, dkv_records = _time(dkv, sets, 200, uniform=True)
        pair_ms, pair_call_ms, pair_kernels, _ = _time(pair, sets, 200, uniform=True)
        two_call_ms = _time(two_calls, sets, 200, uniform=True)[1]
        graph = {name: _graph_ms(fn, sets) for name, fn in
                 (("flash_bwd_dq", dq), ("flash_bwd_dkv", dkv), ("pair", pair))}
        plain_ms, _, _, _ = _time(lambda q, k, v, o, do, lse: att.flash_bwd_plain(
            t(q), t(k), t(v), t(o), t(do), lse), sets, 20)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [tuple(t(x).contiguous().requires_grad_() for x in st[:3]) + (t(st[4]).contiguous(),)
                for st in sets]

    def fwd_bwd(q, k, v, do):
        torch.autograd.grad(sdpa(q, k, v), (q, k, v), do)

    def fwd(q, k, v, do):  # the training forward, as inside fwd_bwd
        sdpa(q, k, v)

    lib_fb_ms, lib_fb_call_ms, lib_kernels, _ = _time(fwd_bwd, lib_sets, 100)
    lib_f_ms, _, _, _ = _time(fwd, lib_sets, 100)
    library_ms = lib_fb_ms - lib_f_ms
    library_graph_ms = _graph_ms(fwd_bwd, lib_sets) - _graph_ms(fwd, lib_sets)

    n = b * s * h * d * torch.finfo(dtype).bits // 8  # bytes of one [B, S, H, Dh] operand
    lse_bytes = b * h * s * 4
    shape = dict(b=b, s=s, h=h, d=d, dtype=str(dtype).replace("torch.", ""))
    backend = _sdpa_backend(lib_kernels)
    out = {}
    # bytes: q, k, v, o (in fp32 read by the call's delta launch, in 16 bits
    # by the kernel itself), do and lse read once, the gradients written once
    for name, ms, call_ms, records, nbytes, flops in (
            ("flash_bwd_dq", dq_ms, dq_call_ms, dq_records, 6 * n + lse_bytes,
             6 * b * h * s * s * d),
            ("flash_bwd_dkv", dkv_ms, dkv_call_ms, dkv_records, 7 * n + lse_bytes,
             8 * b * h * s * s * d)):
        # the route: wgmma in 16 bits (flash_bwd.cu); in fp32 flash_wide.cu's
        # delta launch and split-TF32 kernel, whose bound is taken, the CUDA
        # cores' stated beside it
        route = "split_tf32" if dtype == torch.float32 else "wgmma"
        bound_ms, bound_by = _bound(nbytes, flops, route if route == "split_tf32" else dtype)
        bounds = {}
        if dtype == torch.float32:
            bounds = dict(route=route, cuda_core_bound_ms=_bound(nbytes, flops, dtype)[0],
                          split_tf32_bound_ms=bound_ms,
                          functions=sorted({_function_name(f) for f in records}))
        emit("times", kernel=name, shape=shape, ms=ms, call_ms=call_ms, **bounds,
             graph_ms=graph[name], records=records, plain_ms=plain_ms, library_ms=library_ms,
             library="SDPA backward (fwd+bwd - fwd)", library_backend=backend,
             library_graph_ms=library_graph_ms,
             library_fwd_bwd_ms=lib_fb_ms, library_fwd_ms=lib_f_ms,
             library_fwd_bwd_call_ms=lib_fb_call_ms, library_kernels_us=lib_kernels,
             bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
             share_of_bound=bound_ms / ms, achieved_bytes_per_s=nbytes / (ms * 1e-3), card=smi)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, graph_ms=graph[name], call_ms=call_ms, shape=shape,
                         library_backend=backend, **bounds)
    pair_bound = out["flash_bwd_dq"]["bound_ms"] + out["flash_bwd_dkv"]["bound_ms"]
    emit("times", kernel="flash_bwd (dq and dk/dv passes, one call)", shape=shape, ms=pair_ms,
         kernels_us=pair_kernels, call_ms=pair_call_ms, parent_two_calls_call_ms=two_call_ms,
         graph_ms=graph["pair"], library_ms=library_ms, library_graph_ms=library_graph_ms,
         vs_library=pair_ms / library_ms, graph_vs_library=graph["pair"] / library_graph_ms,
         bound_ms=pair_bound, share_of_bound=pair_bound / pair_ms, card=smi)
    return out


def _times_bwd(gen, smi):
    """The backward rows at the main path's shape (B=64, S=128), returned
    with the same shape in fp32 (flash_wide.cu's delta launch and its
    split-TF32 flash_wide_bwd_dq_f32 and flash_wide_bwd_dkv_f32, counted on
    flash_bwd_dq and flash_bwd_dkv) under "other_shapes", and at the S=512
    request shape (B=8)."""
    rows = _bwd_row(MAIN["b"], MAIN["sq"], gen, smi)
    fp32 = _bwd_row(MAIN["b"], MAIN["sq"], gen, smi, torch.float32)
    for name, row in rows.items():
        row["other_shapes"] = [fp32[name]]
    _bwd_row(8, 512, gen, smi)
    return rows


def _times_bn(shapes, smi):
    """Each BN kernel, its plain version and the library call at the nine
    ResNet-50 shapes (N=256, bf16), and their sums over one training step's
    launches (``shapes`` = {(C, HW): launches in one step}).  The library
    calls, timed only: ``torch.batch_norm_stats`` (mean and inverse std
    from one read) for bn_stats, ``torch.batch_norm_elemt`` with mean 0 and
    inverse std 1 (so x·scale + shift) for bn_apply; bn_apply_res has no
    one-call counterpart."""
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(77)
    names = ("bn_stats", "bn_apply", "bn_apply_res")
    step = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0) for k in names}
    for c, hw in RESNET_BN_SHAPES:
        n = RESNET_B
        nbytes_x = n * c * hw * 2
        sets = []
        for _ in range(max(2, -(-160_000_000 // nbytes_x))):  # the sets exceed the 50 MB L2
            x = _bn_input(dict(n=n, c=c, hw=hw, dtype=torch.bfloat16), gen, device)
            sets.append((x, torch.rand(c, generator=gen, device=device) + 0.5,
                         torch.randn(c, generator=gen, device=device),
                         _bn_input(dict(n=n, c=c, hw=hw, dtype=torch.bfloat16), gen, device)))
        zeros, ones = torch.zeros(c, device=device), torch.ones(c, device=device)
        stats_sets = [(x,) for x, _, _, _ in sets]
        apply_sets = [(x, sc, sh) for x, sc, sh, _ in sets]
        with torch.no_grad():
            rows = {
                "bn_stats": (_time(bn.bn_stats, stats_sets, 20),
                             _time(bn.bn_stats_plain, stats_sets, 5),
                             _time(lambda x: torch.batch_norm_stats(x, 1e-5), stats_sets, 20),
                             nbytes_x + c * 8, 3 * n * c * hw),
                "bn_apply": (_time(lambda *a: bn.bn_apply(*a, relu=False), apply_sets, 20),
                             _time(lambda *a: bn.bn_apply_plain(*a, relu=False), apply_sets, 5),
                             _time(lambda x, sc, sh: torch.batch_norm_elemt(
                                 x, sc, sh, zeros, ones, 1e-5), apply_sets, 20),
                             2 * nbytes_x + c * 8, 2 * n * c * hw),
                "bn_apply_res": (_time(lambda *a: bn.bn_apply_res(*a, relu=True), sets, 20),
                                 _time(lambda *a: bn.bn_apply_plain(*a, relu=True), sets, 5),
                                 None, 3 * nbytes_x + c * 8, 3 * n * c * hw)}
        for name, (kern, plain, lib, nbytes, flops) in rows.items():
            bound_ms, bound_by = _bound(nbytes, flops, torch.float32)
            emit("times", kernel=name, shape=dict(n=n, c=c, hw=hw, dtype="bfloat16"),
                 ms=kern[0], call_ms=kern[1], plain_ms=plain[0],
                 library_ms=None if lib is None else lib[0],
                 library={"bn_stats": "torch.batch_norm_stats",
                          "bn_apply": "torch.batch_norm_elemt"}.get(name),
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                 share_of_bound=bound_ms / kern[0],
                 achieved_bytes_per_s=nbytes / (kern[0] * 1e-3), card=smi)
            k = shapes.get((c, hw), 0)
            step[name]["ms"] += k * kern[0]
            step[name]["plain_ms"] += k * plain[0]
            step[name]["library_ms"] = (None if lib is None
                                        else step[name]["library_ms"] + k * lib[0])
            step[name]["bound_ms"] += k * bound_ms
            step[name]["bound_by"] = bound_by
        del sets, stats_sets, apply_sets
    for name, row in step.items():
        emit("times", kernel=name, per="one ResNet-50 step: its BatchNorm launches at their "
             "shapes", launches=sum(shapes.values()), **row,
             share_of_bound=row["bound_ms"] / row["ms"], card=smi)
    return step


def _times_gelu(smi):
    """The two user GELU kernels at the path's shape ([64, 128, 3072] bf16),
    their plain versions and the library calls (``F.gelu`` and
    ``aten.gelu_backward``, timed only), and the sums over one BERT step's
    12 launches of each.  ``call_ms`` is the launcher's cost per call as the
    user's op makes it (UserKernel, ``Kernel.launch``: checks, output
    allocation, ctypes marshalling, ``cuLaunchKernel``) where it exceeds the
    kernel's."""
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(4242)
    n = math.prod(GELU_MAIN)
    sets = [tuple(torch.randn(GELU_MAIN, generator=gen, device=device).bfloat16()
                  for _ in range(2)) for _ in range(4)]  # 400 MB: beyond the 50 MB L2
    fwd_sets = [(x,) for x, _ in sets]
    with torch.no_grad():
        rows = {
            "rtc_gelu_fwd": (_time(GELU_FWD, fwd_sets, 200), _time(gelu_plain, fwd_sets, 20),
                             _time(torch.nn.functional.gelu, fwd_sets, 200), "F.gelu",
                             4 * n, 20 * n),
            "rtc_gelu_bwd": (_time(GELU_BWD, sets, 200), _time(gelu_bwd_plain, sets, 20),
                             _time(lambda x, dy: torch.ops.aten.gelu_backward(dy, x), sets, 200),
                             "torch.ops.aten.gelu_backward", 6 * n, 30 * n)}
        host = {"rtc_gelu_fwd": (_host_ms(GELU_FWD, fwd_sets), _host_ms(torch.nn.functional.gelu,
                                                                       fwd_sets)),
                "rtc_gelu_bwd": (_host_ms(GELU_BWD, sets), _host_ms(
                    lambda x, dy: torch.ops.aten.gelu_backward(dy, x), sets))}
    out = {}
    for name, (kern, plain, lib, lib_name, nbytes, flops) in rows.items():
        bound_ms, bound_by = _bound(nbytes, flops, torch.float32)
        emit("times", kernel=name, shape=dict(n=n, dims=list(GELU_MAIN), dtype="bfloat16"),
             ms=kern[0], call_ms=kern[1], host_ms=host[name][0],
             library_host_ms=host[name][1], plain_ms=plain[0], library_ms=lib[0],
             library=lib_name, library_kernels_us=lib[2], bound_ms=bound_ms,
             bound_by=bound_by, bytes=nbytes, flops=flops, share_of_bound=bound_ms / kern[0],
             achieved_bytes_per_s=nbytes / (kern[0] * 1e-3), step_ms_12_launches=12 * kern[0],
             card=smi)
        out[name] = dict(ms=kern[0], call_ms=kern[1], host_ms=host[name][0],
                         plain_ms=plain[0], library_ms=lib[0], bound_ms=bound_ms,
                         bound_by=bound_by)
    return out


def _optimizer_group(trainer):
    """The Trainer's one fused group as ``group_apply`` takes it, on copies
    of its parameters, gradients and states (timed calls update in place):
    ``(step, args)``."""
    opt = trainer._optimizer
    items = [(i, p.data(), p.grad()) for i, p in enumerate(trainer._params)
             if p.grad_req != "null"]
    groups, rest = fused.plan_groups(opt, items, trainer._states)
    if len(groups) != 1 or rest:
        raise RuntimeError(f"expected one fused group, got {len(groups)} and {len(rest)} left")
    (step, _, _), members = next(iter(groups.items()))
    return step, ([w.detach().clone() for _, w, _, _ in members],
                  [g.detach().clone() for _, _, g, _ in members],
                  [tuple(x.clone() for x in flat) for _, _, _, flat in members],
                  [opt._get_lr(i) for i, _, _, _ in members],
                  [opt._get_wd(i) for i, _, _, _ in members],
                  [opt._index_update_count[i] for i, _, _, _ in members], fused._scalars(opt))


def phase_main_groups_vs_plain(trainers):
    """The multi-tensor kernel on the main paths' own groups: for each
    training path (name -> trainer), two copies of its one fused group as
    the step hands it to ``group_apply`` (the BERT step's mp_adam over 159
    tensors, the ResNet-50 step's fp32 sgd_mom over 193, with their real
    gradients, states, lr, wd and counts), one through ``group_apply`` (one
    launch a step), the other through ``group_apply_plain``, for two steps;
    every weight and state must agree bit for bit.  Returns the largest
    absolute difference seen."""
    worst, misses = 0.0, []
    for what, trainer in trainers.items():
        (step, kern), (_, plain) = _optimizer_group(trainer), _optimizer_group(trainer)
        launches = mt.multi_tensor_update.launches
        for extra in range(2):
            for ws, gs, sts, lrs, wds, ts, S in (kern, plain):
                fn = opt_ops.group_apply if ws is kern[0] else opt_ops.group_apply_plain
                fn(step, ws, gs, sts, lrs, wds, [t + extra for t in ts], S)
        torch.cuda.synchronize()
        launched = mt.multi_tensor_update.launches - launches
        equal, err = True, 0.0
        for a, b in zip(kern[0] + [x for st in kern[2] for x in st],
                        plain[0] + [x for st in plain[2] for x in st]):
            equal = equal and torch.equal(a, b)
            err = max(err, (a.float() - b.float()).abs().max().item())
        worst = max(worst, err)
        ok = equal and launched == 2
        emit("kernel_vs_plain_multi_tensor", case=f"{what}_group", variant=step.variant,
             tensors=len(kern[0]), elements=sum(w.numel() for w in kern[0]),
             weight_dtype=str(kern[0][0].dtype).replace("torch.", ""), steps=2,
             launches=launched, expected_launches=2, bit_equal=equal, max_abs_err=err,
             bound=0.0, ok=ok)
        if not ok:
            misses.append(what)
        del kern, plain
    if misses:
        emit("kernel_vs_plain_multi_tensor", failed=misses)
        sys.exit(1)
    return worst


def _library_update(step, args):
    """The nearest single PyTorch call to the group's update, over fp32
    copies (``torch._fused_adam_`` / ``torch._fused_sgd_``): not the same
    function (ε outside the bias correction, no 16-bit weight copy, its own
    weight decay), timed only as a yardstick.  Returns (name, fn, arg
    sets)."""
    ws, gs, sts, lrs, wds, ts, S = args
    p32 = [w.float() for w in ws]
    g32 = [g.float() for g in gs]
    if step.variant in ("adam", "mp_adam"):
        m, v = [st[0].clone() for st in sts], [st[1].clone() for st in sts]
        steps = [torch.tensor(float(t), device=ws[0].device) for t in ts]
        return "torch._fused_adam_", lambda: torch._fused_adam_(
            p32, g32, m, v, [], steps, lr=lrs[0], beta1=S["beta1"], beta2=S["beta2"],
            weight_decay=0.0, eps=S["epsilon"], amsgrad=False, maximize=False), [()]
    if step.variant not in ("sgd_mom", "nag_mom"):
        return None, None, None
    moms = [st[0].clone() for st in sts]
    nesterov = step.variant == "nag_mom"
    return (f"torch._fused_sgd_(nesterov={nesterov})", lambda: torch._fused_sgd_(
        p32, g32, moms, weight_decay=wds[0], momentum=S["momentum"], lr=lrs[0], dampening=0.0,
        nesterov=nesterov, maximize=False, is_first_step=False), [()])


def _times_multi_tensor(train, resnet, smi):
    """The multi-tensor kernel on each training path's one fused group (the
    BERT-base step's mp_adam over 159 tensors, the ResNet-50 step's fp32
    sgd_mom over 193), its plain loop, the nearest library call, and the
    bound: the bytes the update must move (the gradient read, each fp32
    state read and written, the weight written, and read too where no fp32
    master holds it) over the memory rate.  Returns {path: row}."""
    out = {}
    for what, trainer in (("bert_train_step", train[1]), ("resnet_train_step", resnet[1])):
        step, args = _optimizer_group(trainer)
        ws, gs, sts = args[:3]
        mp = step.variant.startswith("mp_")
        numel = sum(w.numel() for w in ws)
        nbytes = sum(g.numel() * g.element_size() + 8 * sum(x.numel() for x in st)
                     + (1 if mp else 2) * w.numel() * w.element_size()
                     for w, g, st in zip(ws, gs, sts))
        flops = (15 if "adam" in step.variant else 7) * numel
        # the kernel alone: its values staged on the card once, as a replay
        # finds them (an eager call adds their 0.1 KB host-to-device copy)
        rows = torch.from_numpy(opt_ops.group_rows(step, *args[3:])).to(ws[0].device)
        kern = _time(lambda: opt_ops.group_apply(step, *args, device_rows=rows), [()], 20,
                     uniform=True)
        plain = _time(lambda: opt_ops.group_apply_plain(step, *args), [()], 3)
        lib_name, lib_fn, lib_sets = _library_update(step, args)
        lib = _time(lib_fn, lib_sets, 20)
        del lib_fn, lib_sets
        bound_ms, bound_by = _bound(nbytes, flops, torch.float32)
        row = dict(variant=step.variant, tensors=len(ws), elements=numel,
                   weight_dtype=str(ws[0].dtype).replace("torch.", ""), ms=kern[0],
                   call_ms=kern[1], plain_ms=plain[0], library_ms=lib[0], bound_ms=bound_ms,
                   bound_by=bound_by)
        emit("times", kernel="multi_tensor", per=f"one {what}: its fused group", **row,
             bytes=nbytes, bytes_per_element=nbytes / numel, flops=flops,
             share_of_bound=bound_ms / kern[0], achieved_bytes_per_s=nbytes / (kern[0] * 1e-3),
             kernels_us=kern[2], library=lib_name,
             library_note="nearest single PyTorch call over fp32 copies, not the same function",
             card=smi)
        out[what] = row
        del args, ws, gs, sts
    return out


def _times_train_surface(bert, resnet, smi):
    """The train_surface paths' kernels: LAMB on the BERT-base step's fp32
    group (two launches), the finite pass over its gradients (one launch),
    NAG on the ResNet-50 step's fp32 group (one launch), each against its
    plain version, the nearest library call where there is one, and the
    bound: the bytes the function must move (each input read once, each
    output written once) over the memory rate.  ``graph_ms`` times the same
    calls by CUDA-graph replay; where the profiler's trace came back short
    (``_time``'s fallback), ``ms`` is that graph time, not the CUDA events'
    time around eager calls, which holds their host time.  Returns {kernel:
    row}."""
    out = {}
    for name, trainer in (("multi_tensor_lamb", bert[1]), ("multi_tensor_nag_mom", resnet[1])):
        step, args = _optimizer_group(trainer)
        ws, gs, sts = args[:3]
        numel = sum(w.numel() for w in ws)
        wsize = ws[0].element_size()
        # read w, g and every state, write w and every state
        nbytes = sum((3 * wsize + 8 * len(st)) * w.numel() for w, st in zip(ws, sts))
        flops = (24 if name == "multi_tensor_lamb" else 8) * numel
        rows = torch.from_numpy(opt_ops.group_rows(step, *args[3:])).to(ws[0].device)
        scratch = mt.lamb_scratch(ws) if step.variant == "lamb" else None
        def kernel():
            opt_ops.group_apply(step, *args, device_rows=rows, scratch=scratch)

        kern = _time(kernel, [()], 20, uniform=True)
        graph = _graph_ms(kernel, [()], calls=10, replays=3)
        plain = _time(lambda: opt_ops.group_apply_plain(step, *args), [()], 3)
        lib_name, lib_fn, lib_sets = _library_update(step, args)
        lib = _time(lib_fn, lib_sets, 20) if lib_fn is not None else (None,)
        bound_ms, bound_by = _bound(nbytes, flops, torch.float32)
        row = dict(variant=step.variant, tensors=len(ws), elements=numel,
                   weight_dtype=str(ws[0].dtype).replace("torch.", ""),
                   ms=kern[0] if kern[2] else graph, ms_from="trace" if kern[2] else "graph",
                   graph_ms=graph, call_ms=kern[1], plain_ms=plain[0], library_ms=lib[0],
                   bound_ms=bound_ms, bound_by=bound_by, library=lib_name)
        emit("times", kernel=name, per="one train_surface step's fused group", **row,
             bytes=nbytes, flops=flops, share_of_bound=bound_ms / row["ms"],
             kernels_us=kern[2], card=smi)
        out[name] = row
        del args, ws, gs, sts
    grads = [p.grad() for p in bert[1]._params if p.grad_req != "null"]
    numel = sum(g.numel() for g in grads)
    nbytes = sum(g.numel() * g.element_size() for g in grads) + 8 * len(grads)
    kern = _time(lambda: mt.sum_sq_finite(grads), [()], 20, uniform=True)
    graph = _graph_ms(lambda: mt.sum_sq_finite(grads), [()], calls=10, replays=3)
    plain = _time(lambda: opt_ops.sum_sq_finite_plain(grads), [()], 3)
    bound_ms, bound_by = _bound(nbytes, 3 * numel, torch.float32)
    row = dict(tensors=len(grads), elements=numel, dtype="float32",
               ms=kern[0] if kern[2] else graph, ms_from="trace" if kern[2] else "graph",
               graph_ms=graph, call_ms=kern[1], plain_ms=plain[0], library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by, library=None)
    emit("times", kernel="multi_tensor_finite", per="one train_surface BERT-base step's "
         "gradients", **row, bytes=nbytes, share_of_bound=bound_ms / row["ms"],
         kernels_us=kern[2], card=smi)
    out["multi_tensor_finite"] = row
    return out


def _time_steps(fn, iters):
    """Mean wall ms of ``iters`` calls of ``fn`` after one warm-up (the
    card synchronized around them, if there is one)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


def _times_optimizer_paths(train, resnet, smi):
    """Before and after in one run: each training step with the optimizer's
    per-tensor loop (aggregate_num 0) and with the fused update, in turns
    (loop, fused, fused, loop), each turn the mean of 10 steps, with
    Trainer.step's own ms; then a torch.profiler breakdown of one step of
    each."""
    paths = (("BERTForPretrain(bert_base) bf16 B=64 S=128 P=20, Adam mp", train, train_step,
              _step_phases),
             ("resnet50_v1 AMP bf16 B=256 224x224, SGD momentum", resnet, resnet_step,
              _resnet_step_phases))
    for label, (net, trainer, batch), step_fn, phases in paths:
        amp = step_fn is resnet_step
        if amp:
            mx.amp.init("bfloat16")
        opt = trainer._optimizer
        agg = opt.aggregate_num
        turns = {"loop": {"step_ms": [], "trainer_step_ms": []},
                 "fused": {"step_ms": [], "trainer_step_ms": []}}
        try:
            for mode in ("loop", "fused", "fused", "loop"):
                opt.aggregate_num = 0 if mode == "loop" else agg
                turns[mode]["step_ms"].append(
                    _time_steps(lambda: step_fn(net, trainer, batch), 10))
                turns[mode]["trainer_step_ms"].append(
                    phases(net, trainer, batch, 3)["trainer_step"])
            for mode in ("loop", "fused"):
                opt.aggregate_num = 0 if mode == "loop" else agg
                phase_profile(f"train step: {label}, optimizer {mode}",
                              lambda: step_fn(net, trainer, batch), smi)
        finally:
            opt.aggregate_num = agg
            if amp:
                mx.amp.disable()
        mean = {m: {k: sum(v) / len(v) for k, v in t.items()} for m, t in turns.items()}
        emit("times", optimizer_paths=label, turns=turns, mean=mean,
             trainer_step_ms_loop=mean["loop"]["trainer_step_ms"],
             trainer_step_ms_fused=mean["fused"]["trainer_step_ms"],
             step_ms_loop=mean["loop"]["step_ms"], step_ms_fused=mean["fused"]["step_ms"],
             card=smi)


def _host_ms(fn, arg_sets, iters=100):
    """Host time per call of ``fn``: the loop issues ``iters`` calls and
    returns before the card has run them (the queue holds far more than
    ``iters`` launches), so the clock sees the caller's own cost."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host


def _time_train_step(tnet, trainer, batch, iters):
    """Mean wall ms of ``iters`` training steps after one warm-up."""
    train_step(tnet, trainer, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        train_step(tnet, trainer, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _resnet_step_phases(net, trainer, batch, iters):
    """Mean wall ms of the ResNet step's three parts, each closed by a
    synchronize (as _step_phases does for BERT)."""
    img, labels = batch
    spent = {"forward_and_loss": 0.0, "backward": 0.0, "trainer_step": 0.0}
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = streaming_softmax_ce(net(img), labels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mx.autograd.backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(img.shape[0])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2)):
            spent[key] += dt * 1e3 / iters
    return spent


def _times_resnet(resnet, smi):
    """The ResNet-50 training step: step ms, img/s, peak memory, its split,
    and a torch.profiler breakdown of its device time."""
    net, trainer, batch = resnet
    b = batch[0].shape[0]
    mx.amp.init("bfloat16")
    iters = 10
    torch.cuda.reset_peak_memory_stats()
    resnet_step(net, trainer, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        resnet_step(net, trainer, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    emit("times", train_step="resnet50_v1 AMP bf16, fp32 parameters, SGD momentum", b=b,
         image=224, step_ms=step_s * 1e3, img_per_s=b / step_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         cudnn_benchmark=torch.backends.cudnn.benchmark, card=smi)
    emit("times", resnet_train_step_phases_ms=_resnet_step_phases(net, trainer, batch, 3),
         card=smi)
    phase_profile(f"train step: resnet50_v1 AMP bf16 B={b} 224x224, SGD momentum",
                  lambda: resnet_step(net, trainer, batch), smi)
    mx.amp.disable()


def _step_phases(net, trainer, batch, iters):
    """Mean wall ms of the training step's three parts (forward with the
    loss, backward, Trainer.step), each closed by a synchronize, so each
    holds its host dispatch and the device work it queued."""
    ids, types, pos, labels = batch
    spent = {"forward_and_loss": 0.0, "backward": 0.0, "trainer_step": 0.0}
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            mlm, _ = net(ids, types, pos)
            loss = streaming_softmax_ce(mlm, labels).mean(-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mx.autograd.backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(ids.shape[0])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2)):
            spent[key] += dt * 1e3 / iters
    return spent


WIDE_TIME_SHAPE = dict(b=4, s=512, h=8, d=512)  # a head wider than 256
WIDE_TIME_SHAPES = (  # (shape, dtype, timed calls): the TMA kernels, the 256 + 64 split,
    # streamed (Dh 1024), fp32
    (WIDE_TIME_SHAPE, torch.bfloat16, 20), (dict(WIDE_TIME_SHAPE, d=320), torch.bfloat16, 20),
    (dict(WIDE_TIME_SHAPE, d=1024), torch.bfloat16, 5), (WIDE_TIME_SHAPE, torch.float32, 5))


def _wide_rows(shape, dtype, iters, gen, smi):
    """The three flash_wide kernels at one [B, S, H, Dh] shape and dtype:
    each kernel, the plain version and SDPA (the forward; its backward as
    fwd+bwd - fwd), with the kernels' bounds (in fp32 both: the CUDA cores'
    and split TF32's, the share taken against the route's), and the
    backward as the one ``flash_bwd`` call (delta, dq and dk/dv) beside
    SDPA's backward.  A dq or dk/dv call alone holds the delta launch too.
    Returns {kernel: row}."""
    b, s, h, d = (shape[k] for k in ("b", "s", "h", "d"))
    device = torch.device("cuda", 0)
    sets = []
    with torch.no_grad():
        for _ in range(2):
            q, k, v, do = (_randn((b, h, s, d), dtype, gen, device) for _ in range(4))
            o, lse = att.flash_fwd(q, k, v, with_lse=True)
            sets.append((q, k, v, o, do, lse))
        fwd_ms, fwd_call_ms, _, fwd_records = _time(lambda q, k, v, *_: att.flash_fwd(q, k, v),
                                                    sets, iters, uniform=True)
        dq_ms, dq_call_ms, _, dq_records = _time(att.flash_bwd_dq, sets, iters, uniform=True)
        dkv_ms, dkv_call_ms, _, dkv_records = _time(att.flash_bwd_dkv, sets, iters, uniform=True)
        bwd_ms, bwd_call_ms, bwd_kernels, _ = _time(att.flash_bwd, sets, iters, uniform=True)
        fwd_plain_ms = _time(lambda q, k, v, *_: att.flash_fwd_plain(q, k, v), sets, 5)[0]
        bwd_plain_ms = _time(att.flash_bwd_plain, sets, 5)[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [tuple(x.clone().requires_grad_() for x in st[:3]) + (st[4],) for st in sets]

    def fwd(q, k, v, do):
        return sdpa(q, k, v)

    def fwd_bwd(q, k, v, do):
        torch.autograd.grad(sdpa(q, k, v), (q, k, v), do)

    try:
        lib_f_ms, _, lib_f_kernels, _ = _time(fwd, lib_sets, iters)
        lib_fb_ms, _, lib_b_kernels, _ = _time(fwd_bwd, lib_sets, iters)
        lib_b_ms = lib_fb_ms - lib_f_ms
    except RuntimeError as e:  # no SDPA backend for this head dim on this build
        lib_f_ms = lib_b_ms = lib_f_kernels = lib_b_kernels = None
        emit("times", kernel="SDPA", shape=shape, library_error=repr(e)[:300])
    n = b * s * h * d * torch.finfo(dtype).bits // 8
    lse_bytes = b * h * s * 4
    label = dict(shape, dtype=str(dtype).replace("torch.", ""))
    # the call's bound: q, k, v, o, do and lse read once, dq, dk, dv written;
    # in fp32 at split TF32's rate, the route of all three kernels
    bwd_bound_ms, bwd_bound_by = _bound(8 * n + lse_bytes, 10 * b * h * s * s * d,
                                        "split_tf32" if dtype == torch.float32 else dtype)
    emit("times", kernel="flash_wide_bwd (one call: delta, dq, dk/dv)", shape=label, ms=bwd_ms,
         call_ms=bwd_call_ms, kernels_us=bwd_kernels, library_ms=lib_b_ms,
         library="SDPA backward (fwd+bwd - fwd)",
         vs_library=None if lib_b_ms is None else bwd_ms / lib_b_ms, bound_ms=bwd_bound_ms,
         bound_by=bwd_bound_by, share_of_bound=bwd_bound_ms / bwd_ms, card=smi)
    out = {}
    for name, ms, call_ms, records, plain_ms, lib_ms, nbytes, flops in (
            ("flash_wide_fwd", fwd_ms, fwd_call_ms, fwd_records, fwd_plain_ms, lib_f_ms,
             4 * n + lse_bytes, 4 * b * h * s * s * d),
            ("flash_wide_bwd_dq", dq_ms, dq_call_ms, dq_records, bwd_plain_ms, lib_b_ms,
             6 * n + lse_bytes, 6 * b * h * s * s * d),
            ("flash_wide_bwd_dkv", dkv_ms, dkv_call_ms, dkv_records, bwd_plain_ms, lib_b_ms,
             7 * n + lse_bytes, 8 * b * h * s * s * d)):
        # the route: wgmma in 16 bits; in fp32 split TF32 on the tensor cores
        # (all three passes).  The share of bound is taken against the
        # route's bound; fp32 also states the CUDA cores' one.
        route = "wgmma" if dtype != torch.float32 else "split_tf32"
        bound_ms, bound_by = _bound(nbytes, flops, dtype if route != "split_tf32" else route)
        bounds = {}
        if dtype == torch.float32:
            bounds = dict(route=route, cuda_core_bound_ms=_bound(nbytes, flops, dtype)[0],
                          split_tf32_bound_ms=_bound(nbytes, flops, "split_tf32")[0])
        lib_kernels = lib_f_kernels if name.endswith("fwd") else lib_b_kernels
        emit("times", kernel=name, shape=label, ms=ms, call_ms=call_ms, records=records, **bounds,
             plain_ms=plain_ms, library_ms=lib_ms,
             library="SDPA (its own choice of backend)" if name.endswith("fwd")
             else "SDPA backward (fwd+bwd - fwd)",
             library_backend=None if lib_kernels is None else _sdpa_backend(lib_kernels),
             library_kernels_us=lib_kernels, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
             flops=flops, share_of_bound=bound_ms / ms, card=smi)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, call_ms=call_ms, shape=label, **bounds,
                         functions=sorted({_function_name(f) for f in records}))
    del sets, lib_sets
    return out


def _function_name(record):
    """The kernel's name and template arguments in a trace record's name."""
    m = re.search(r"(\w+<[^>(]*>|\w+)\(", record)
    return m.group(1) if m else record


def _times_wide(gen, smi):
    """The flash_wide kernels at each of WIDE_TIME_SHAPES (no main path has
    a head above 256).  Returns {kernel: row} at the first, bf16 Dh 512, with
    the other shapes' rows under "other_shapes"."""
    rows = [_wide_rows(shape, dtype, iters, gen, smi) for shape, dtype, iters in WIDE_TIME_SHAPES]
    return {name: dict(row, other_shapes=[r[name] for r in rows[1:]])
            for name, row in rows[0].items()}


def _times_fold(train, resnet, progs, records, smi):
    """Each main-path step eager and folded, in turns (eager, fold, fold,
    eager), each turn the mean wall ms of 10 steps; the fold's peak memory
    over 10 steps and the memory its graphs reserve; the capture time from
    the fold phase; a torch.profiler breakdown (device busy share) of one
    folded step of each."""
    paths = (("fold_bert_step", "BERTForPretrain(bert_base) bf16 B=64 S=128 P=20, Adam mp, "
              "dropout 0.1", train, train_step, False),
             ("fold_resnet_step", "resnet50_v1 AMP bf16 B=256 224x224, SGD momentum", resnet,
              resnet_step, True))
    for key, label, (net, trainer, batch), step_fn, amp in paths:
        prog = progs[key]
        b = batch[0].shape[0]
        if amp:
            mx.amp.init("bfloat16")
        try:
            turns = {"eager": [], "fold": []}
            for mode in ("eager", "fold", "fold", "eager"):
                fn = ((lambda: step_fn(net, trainer, batch)) if mode == "eager"
                      else (lambda: prog(*batch)))
                turns[mode].append(_time_steps(fn, 10))
            torch.cuda.reset_peak_memory_stats()
            _time_steps(lambda: prog(*batch), 10)
            fold_peak = torch.cuda.max_memory_allocated()
            reserved = torch.cuda.memory_reserved()
            phase_profile(f"fold step: {label}", lambda: prog(*batch), smi)
        finally:
            if amp:
                mx.amp.disable()
        mean = {m: sum(v) / len(v) for m, v in turns.items()}
        unit = "img_per_s" if amp else "samples_per_s"
        rec = records[key]
        emit("times", fold_step=label, b=b, turns_ms=turns, eager_step_ms=mean["eager"],
             fold_step_ms=mean["fold"], **{f"eager_{unit}": b / mean["eager"] * 1e3,
                                           f"fold_{unit}": b / mean["fold"] * 1e3},
             fold_over_eager=mean["fold"] / mean["eager"], fold_peak_memory_bytes=fold_peak,
             memory_reserved_bytes=reserved, warm_up_s=rec["warm_up_s"],
             capture_and_replay_s=rec["capture_and_replay_s"], card=smi)


def phase_times(net, main_req, train, resnet, bn_shapes, counts, errs, fold, smi, surface):
    """``train`` and ``resnet`` = (net, trainer, batch) of the BERT and
    ResNet-50 training paths; ``bn_shapes`` = {(C, HW): launches in one
    ResNet-50 step}; ``counts`` = {path: launch counts}; ``errs`` =
    {kernel: max abs error at the main paths' layouts and shapes}; ``fold``
    = (programs, records) of the fold phase's main paths; ``surface`` = the
    train_surface phase's BERT and ResNet-50 (net, trainer, batch).  Returns
    the kernels line's rows."""
    device = torch.device("cuda", 0)
    b, s, h, d = MAIN["b"], MAIN["sq"], MAIN["h"], MAIN["d"]
    gen = torch.Generator(device=device).manual_seed(99)
    qkv_sets = [_randn((b, s, 3, h, d), torch.bfloat16, gen, device) for _ in range(4)]
    views = [(x[:, :, 0], x[:, :, 1], x[:, :, 2]) for x in qkv_sets]
    bhsd_sets = [tuple(t.transpose(1, 2).contiguous() for t in v) for v in views]

    before = kernel_counts()
    rows = {"flash_fwd": _times_fwd(views, bhsd_sets, smi)}
    del qkv_sets, views, bhsd_sets
    rows.update(_times_bwd(gen, smi))
    rows.update(_times_wide(gen, smi))
    rows.update(_times_bn(bn_shapes, smi))
    rows.update(_times_gelu(smi))
    mt_rows = _times_multi_tensor(train, resnet, smi)
    rows["multi_tensor"] = mt_rows["bert_train_step"]
    rows.update(_times_train_surface(*surface, smi))

    iters = 10
    torch.cuda.reset_peak_memory_stats()
    with mx.autograd.predict_mode():
        net(*main_req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            net(*main_req)
        torch.cuda.synchronize()
        fwd_s = (time.perf_counter() - t0) / iters
    emit("times", forward="BERTForPretrain(bert_base) bf16", b=b, s=s, p=main_req[2].shape[1],
         forward_ms=fwd_s * 1e3, samples_per_s=b / fwd_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), card=smi)

    tnet, trainer, batch = train
    tb = batch[0].shape[0]
    torch.cuda.reset_peak_memory_stats()
    step_ms = _time_train_step(tnet, trainer, batch, iters)
    emit("times", train_step="BERTForPretrain(bert_base) bf16, Adam multi_precision, "
         "dropout 0.1", b=tb, s=batch[0].shape[1], p=batch[2].shape[1],
         step_ms=step_ms, samples_per_s=tb / step_ms * 1e3,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), card=smi)
    emit("times", train_step_phases_ms=_step_phases(tnet, trainer, batch, 5), card=smi)
    # The host-bound step drifts within a run: built-in and rtc in turns
    # (built-in, rtc, rtc, built-in), each the mean of `iters` steps.
    turns = {"builtin": [], "rtc": []}
    for which in ("builtin", "rtc", "rtc", "builtin"):
        with rtc_gelu_ffn(tnet) if which == "rtc" else contextlib.nullcontext():
            turns[which].append(_time_train_step(tnet, trainer, batch, iters))
    rtc_ms, builtin_ms = (sum(turns[k]) / 2 for k in ("rtc", "builtin"))
    emit("times", train_step="the same, built-in GELU and the user's rtc_gelu CustomOp in "
         "turns (built-in, rtc, rtc, built-in)", b=tb, turns_ms=turns, rtc_step_ms=rtc_ms,
         rtc_samples_per_s=tb / rtc_ms * 1e3, builtin_step_ms=builtin_ms,
         builtin_samples_per_s=tb / builtin_ms * 1e3, card=smi)

    with mx.autograd.predict_mode():
        phase_profile("forward: BERTForPretrain(bert_base) bf16 B=64 S=128 P=20",
                      lambda: net(*main_req), smi)
    phase_profile("train step: BERTForPretrain(bert_base) bf16 B=64 S=128 P=20, Adam mp",
                  lambda: train_step(tnet, trainer, batch), smi)
    with rtc_gelu_ffn(tnet):
        phase_profile("train step: the same, FFN activation = the user's rtc_gelu CustomOp",
                      lambda: train_step(tnet, trainer, batch), smi)
    _times_resnet(resnet, smi)
    _times_optimizer_paths(train, resnet, smi)
    _times_fold(train, resnet, *fold, smi)
    # last, so that its net, its CPU reference run and their memory come
    # after every row the parent's runs also take
    _times_fp32_forward(main_req, iters, smi)
    set_kernel_counts(before)  # timed and profiled launches are not the main paths'
    emit("times", traces_with_warm_up_short=len(WARM_SHORT), first=WARM_SHORT[:4],
         note="kernels a trace's warm-up call lacked against its counted calls, which "
              "follow the sentinel: kineto's lost first records (ROADMAP §3 Not faults)")

    csrc = "incubator_mxnet_torch/ops/csrc/"
    sources = {"flash_fwd": (csrc + "flash_fwd.cu", "incubator_mxnet_tpu/ops/attention.py:85"),
               "flash_bwd_dq": (csrc + "flash_bwd.cu",
                                "incubator_mxnet_tpu/ops/attention.py:203"),
               "flash_bwd_dkv": (csrc + "flash_bwd.cu",
                                 "incubator_mxnet_tpu/ops/attention.py:248"),
               "flash_wide_fwd": (csrc + "flash_wide.cu",
                                  "incubator_mxnet_tpu/ops/attention.py:85"),
               "flash_wide_bwd_dq": (csrc + "flash_wide.cu",
                                     "incubator_mxnet_tpu/ops/attention.py:203"),
               "flash_wide_bwd_dkv": (csrc + "flash_wide.cu",
                                      "incubator_mxnet_tpu/ops/attention.py:248"),
               "bn_stats": (csrc + "bn.cu", "incubator_mxnet_tpu/ops/pallas_bn.py:33"),
               "bn_apply": (csrc + "bn.cu", "incubator_mxnet_tpu/ops/pallas_bn.py:67"),
               "bn_apply_res": (csrc + "bn.cu", "incubator_mxnet_tpu/ops/pallas_bn.py:75"),
               "rtc_gelu_fwd": ("chip_smoke.py", "incubator_mxnet_tpu/rtc.py:48"),
               "rtc_gelu_bwd": ("chip_smoke.py", "incubator_mxnet_tpu/rtc.py:48"),
               "multi_tensor": (csrc + "multi_tensor.cu",
                                "incubator_mxnet_tpu/ops/optimizer_ops.py:367"),
               "multi_tensor_nag_mom": (csrc + "multi_tensor.cu",
                                        "incubator_mxnet_tpu/ops/optimizer_ops.py:367"),
               "multi_tensor_lamb": (csrc + "multi_tensor.cu",
                                     "incubator_mxnet_tpu/ops/optimizer_ops.py:367"),
               "multi_tensor_finite": (csrc + "multi_tensor.cu",
                                       "incubator_mxnet_tpu/amp/amp.py:120")}
    # this slice's main path is the fold: each kernel's launches are those of
    # its fold path (warm-up and capture; a replay runs no wrapper)
    main_path = {"flash_fwd": "fold_bert_step", "flash_bwd_dq": "fold_bert_step",
                 "flash_bwd_dkv": "fold_bert_step", "flash_wide_fwd": "fold_bert_step",
                 "flash_wide_bwd_dq": "fold_bert_step", "flash_wide_bwd_dkv": "fold_bert_step",
                 "bn_stats": "fold_resnet_step", "bn_apply": "fold_resnet_step",
                 "bn_apply_res": "fold_resnet_step", "rtc_gelu_fwd": "rtc_train_step",
                 "rtc_gelu_bwd": "rtc_train_step", "multi_tensor": "fold_bert_step",
                 "multi_tensor_nag_mom": "train_surface_resnet_step",
                 "multi_tensor_lamb": "train_surface_bert_step",
                 "multi_tensor_finite": "train_surface_bert_step"}
    kernels = []
    for name, (src, replaces) in sources.items():
        path = main_path[name]
        row = rows[name]
        per = {}
        if name.startswith("bn_"):
            per = {"per": "one ResNet-50 step (B=256): ms, plain_ms, bound_ms and library_ms "
                          "sum the step's 53 BatchNorm shapes"}
        elif name.startswith("rtc_"):
            per = {"per": "one launch at [64, 128, 3072] bf16 (12 a step)",
                   "call_ms": row["call_ms"], "host_ms": row["host_ms"],
                   "compiled_by": "incubator_mxnet_torch/rtc.py (RTC_SOURCE, nvcc cubin, "
                                  "CUDA driver launch)"}
        elif name.startswith("flash_wide"):
            per = {"per": "one call at [B, S, H, Dh] = [4, 512, 8, 512] bf16 (other_shapes: "
                          "the same at Dh 320 and 1024, and fp32 at Dh 512, whose rows give "
                          "the route and both bounds, the CUDA cores' and split TF32's); a dq "
                          "or a dk/dv call alone holds the delta launch too; no main path "
                          "has a head above 256, so its launches there are 0",
                   "functions": row["functions"], "other_shapes": row["other_shapes"]}
        elif "other_shapes" in row:
            fp32 = ("flash_wide.cu's split-TF32 flash_wide_fwd_f32_rows<1> on the tensor "
                    "cores, with the route and both bounds" if name == "flash_fwd" else
                    "flash_wide.cu's delta launch and split-TF32 kernel, with the route and "
                    "both bounds; the call's time holds the delta launch")
            gen = ("; then the generation path's bf16 calls: a cached greedy step's [4, 1, "
                   "16, 64] against 32 and 128 keys of a cache, a server prefill's [1, 128, 16, "
                   "64] against 100 keys" if name == "flash_fwd" else "")
            per = {"per": "one call at the main path's [64, 128, 12, 64] bf16 (other_shapes: "
                          f"the same in fp32: {fp32}{gen})", "other_shapes": row["other_shapes"]}
        elif name == "multi_tensor":
            per = {"per": "one BERT-base step's fused group (mp_adam, 159 tensors); not a TPU "
                          "kernel but the counterpart of group_apply's one XLA dispatch; "
                          "library_ms is torch._fused_adam_ over fp32 copies, the nearest "
                          "PyTorch call, not the same function",
                   "resnet_train_step": mt_rows["resnet_train_step"]}
        elif name == "multi_tensor_nag_mom":
            per = {"per": "one train_surface ResNet-50 step's fused group (nag_mom, 193 fp32 "
                          "tensors): the multi_tensor kernel's nag_mom variant, its launches "
                          "those of that variant; library_ms is torch._fused_sgd_(nesterov="
                          "True) over fp32 copies, not the same function"}
        elif name == "multi_tensor_lamb":
            per = {"per": "one train_surface BERT-base step's fused group (lamb, fp32): pass 1 "
                          "and pass 2; PyTorch has no LAMB call (library_ms null)"}
        elif name == "multi_tensor_finite":
            per = {"per": "one train_surface BERT-base step's fp32 gradients (the loss "
                          "scaler's overflow check); replaces the JAX package's per-parameter "
                          "isfinite reduction in LossScaler.has_overflow, no Pallas kernel; "
                          "PyTorch has no single call for it (library_ms null)"}
        headers = ([str(h.relative_to(Path(__file__).resolve().parent))
                    for h in _cuda.includes(Path(__file__).resolve().parent / src)]
                   if src.endswith(".cu") else [])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "headers": headers,
            "replaces": replaces, "launches": counts[path][name],
            "launches_by_path": {p: c.get(name, 0) for p, c in counts.items()},
            "max_abs_err": errs[name], "max_err": errs[name], "ms": row["ms"],
            "kernel_ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{key: row[key] for key in ("graph_ms", "call_ms") if key in row}, **per})
    return kernels


def _times_fp32_forward(main_req, iters, smi):
    """The BERT-base inference forward in fp32 (MXNet's default dtype) at
    the main request (B=64, S=128, P=20), beside the bf16 row: the same
    seed's weights, not cast, so its 12 attention forwards a call run
    flash_wide.cu's split-TF32 kernel (counted on flash_fwd).  Timed as the
    bf16 row, the mean of ``iters`` forwards; its logits on a B=2 batch
    held to the port's fp32 run of the same weights on the CPU
    (FP32_SLICE_REL_BOUND)."""
    device = main_req[0].device
    net = _build_net(BERT_BASE, None, "float32")
    torch.cuda.reset_peak_memory_stats()
    with mx.autograd.predict_mode():
        before = att.flash_fwd.launches
        net(*main_req)
        torch.cuda.synchronize()
        launches = att.flash_fwd.launches - before
        t0 = time.perf_counter()
        for _ in range(iters):
            net(*main_req)
        torch.cuda.synchronize()
        fwd_s = (time.perf_counter() - t0) / iters
    b, s = main_req[0].shape
    emit("times", forward="BERTForPretrain(bert_base) fp32", b=b, s=s, p=main_req[2].shape[1],
         forward_ms=fwd_s * 1e3, samples_per_s=b / fwd_s, flash_fwd_launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), card=smi)
    arrays = {k: p.data().detach().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}
    ref_net = _build_net(BERT_BASE, mx.cpu(), "float32")
    load_numpy_params(ref_net, arrays)
    gen = torch.Generator(device=device).manual_seed(17)
    small = _requests([(2, s, main_req[2].shape[1])], BERT_BASE["vocab_size"], gen, device)[0]
    with mx.autograd.predict_mode():
        got = net(*small)
        ref = ref_net(*(x.cpu() for x in small))
    ok = launches == 12
    for name, g, r in zip(("mlm_logits", "nsp_logits"), got, ref):
        err = (g.float().cpu() - r).abs().max().item()
        rel = err / r.abs().max().item()
        fine = g.dtype == torch.float32 and math.isfinite(rel) and rel <= FP32_SLICE_REL_BOUND
        emit("fp32_forward_vs_cpu_fp32", output=name, max_abs_err=err,
             ref_max_abs=r.abs().max().item(), rel_err=rel, bound=FP32_SLICE_REL_BOUND, ok=fine)
        ok = ok and fine
    del net, ref_net
    if not ok:
        sys.exit(1)


def rehearse_times(net, main_req, train, resnet):
    """CPU stand-in for phase 7: host times of the plain paths, labelled as
    CPU numbers, never as the card's."""
    t0 = time.perf_counter()
    with mx.autograd.predict_mode():
        net(*main_req)
    t1 = time.perf_counter()
    train_step(*train)
    t2 = time.perf_counter()
    mx.amp.init("bfloat16")
    resnet_step(*resnet)
    mx.amp.disable()
    emit("times", device="cpu", note="CPU rehearsal: host time, not a device metric",
         forward_host_ms=(t1 - t0) * 1e3, train_step_host_ms=(t2 - t1) * 1e3,
         resnet_train_step_host_ms=(time.perf_counter() - t2) * 1e3)


# One turn of --inference-turns, run as ``python -c`` from the checkout it
# times (argv[1]), so it imports that checkout's package: the phase-4
# network and main request (BERT-base, seeds 0 and 7, B=64, S=128, P=20)
# in the dtype argv[2] (bfloat16, or float32 uncast) and phase 7's timing
# (the mean of 10 forwards), taken 10 times after one warm-up; prints one
# JSON line.
_INFERENCE_TURN = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.gluon.model_zoo import bert as bert_zoo
torch.backends.cuda.matmul.allow_tf32 = False
mx.random.seed(0)
net = bert_zoo.BERTForPretrain(bert_zoo.bert_base(vocab_size=30522, max_length=512,
                                                  dropout=0.1), vocab_size=30522)
net.initialize()
if sys.argv[2] != "float32":
    net.cast(sys.argv[2])
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(7)
req = [torch.randint(0, n, shape, generator=gen, device=dev, dtype=torch.int32)
       for n, shape in ((30522, (64, 128)), (2, (64, 128)), (128, (64, 20)))]
samples = []
with mx.autograd.predict_mode():
    net(*req)
    torch.cuda.synchronize()
    for _ in range(10):
        t0 = time.perf_counter()
        for _ in range(10):
            net(*req)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) / 10 * 1e3)
print(json.dumps({"package": mx.__file__, "dtype": sys.argv[2], "forward_ms": samples}))
'''


def inference_turns(roots, rounds, dtype="bfloat16"):
    """The BERT-base inference forward in ``dtype`` of two checkouts in
    turns (A, B, B, A each round), each turn a fresh process on the card:
    host noise that drifts within a call falls on both alike.  Emits every
    turn and every pair; exits non-zero if a turn fails."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    a, b = (str(Path(r).resolve()) for r in roots)
    turns = {a: [], b: []}
    for r in range(rounds):
        for root in (a, b, b, a):
            run = subprocess.run([sys.executable, "-c", _INFERENCE_TURN, root, dtype], cwd=root,
                                 capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr)
                emit("inference_turns", root=root, round=r, rc=run.returncode, ok=False)
                sys.exit(1)
            rec = json.loads(run.stdout.strip().splitlines()[-1])
            if not rec["package"].startswith(root):
                emit("inference_turns", root=root, package=rec["package"], ok=False)
                sys.exit(1)
            mean = sum(rec["forward_ms"]) / len(rec["forward_ms"])
            turns[root].append(mean)
            emit("inference_turns", root=root, round=r, dtype=dtype, forward_ms=rec["forward_ms"],
                 mean_forward_ms=mean, samples_per_s=64 / mean * 1e3, card=smi)
    pairs = [dict(a_ms=x, b_ms=y, b_over_a=y / x) for x, y in zip(turns[a], turns[b])]
    qa, qb = (statistics.quantiles(turns[r], n=4) for r in (a, b))
    emit("inference_turns", a=a, b=b, dtype=dtype, pairs=pairs, median_a_ms=qa[1],
         median_b_ms=qb[1],
         quartiles_a_ms=[qa[0], qa[2]], quartiles_b_ms=[qb[0], qb[2]],
         b_faster_pairs=sum(p["b_ms"] < p["a_ms"] for p in pairs), card=smi)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 4-7 on the CPU at a tiny size; never prints ok")
    ap.add_argument("--inference-turns", nargs=2, metavar=("ROOT_A", "ROOT_B"),
                    help="only time the BERT-base inference forward of two checkouts in "
                         "turns (A, B, B, A per round); never prints ok")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of --inference-turns")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="the network's dtype in --inference-turns")
    ap.add_argument("--seed", type=int, default=0,
                    help="the generation phase's weights and traffic")
    ap.add_argument("--decode-load", action="store_true",
                    help="only time the native decode pool's batch on an idle and a loaded "
                         "card; never prints ok")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cpu_rehearsal:
        # tiny tensors: one intra-op thread is faster, and keeps the run's
        # time where a CPU shared with other work leaves it
        torch.set_num_threads(1)
        net, main_req, _ = phase_slice(rehearsal=True)
        tnet, trainer, batch, _ = phase_train(rehearsal=True)
        vs_cpu = phase_train_vs_cpu(tnet, rehearsal=True)
        phase_rtc_train(tnet, trainer, batch, vs_cpu, rehearsal=True)
        del vs_cpu
        phase_nd_surface(net, rehearsal=True)
        phase_symbol_block(net, main_req, rehearsal=True)
        rnet, rtrainer, rbatch, _, _ = phase_resnet_train(rehearsal=True)
        phase_resnet_train_vs_cpu(rehearsal=True)
        phase_fold((tnet, trainer, batch), (rnet, rtrainer, rbatch), rehearsal=True)
        phase_spmd(rehearsal=True)
        phase_io(rehearsal=True)
        phase_detect(rehearsal=True)
        phase_fit(rehearsal=True)
        phase_op_library(net, rehearsal=True)
        phase_train_surface(rehearsal=True)
        rehearse_times(net, main_req, (tnet, trainer, batch), (rnet, rtrainer, rbatch))
        phase_observe((tnet, trainer, batch), rehearsal=True)
        phase_serve(net, main_req, rehearsal=True)
        phase_generation(rehearsal=True, seed=args.seed)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on the card",
              file=sys.stderr)
        return 2
    if args.inference_turns:
        inference_turns(args.inference_turns, args.rounds, args.dtype)
        return 0
    if args.decode_load:
        decode_load()
        return 0
    smi = phase_device()
    phase_build()
    device = torch.device("cuda", 0)
    errs = phase_kernel_vs_plain(device)
    errs.update(phase_kernel_vs_plain_bwd(device))
    errs.update(phase_kernel_vs_plain_bn(device))
    errs.update(phase_kernel_vs_plain_rtc(device))
    errs["multi_tensor"] = phase_kernel_vs_plain_multi_tensor(device)
    errs["multi_tensor_nag_mom"] = errs["multi_tensor"]
    errs["multi_tensor_lamb"] = phase_kernel_vs_plain_lamb(device)
    errs["multi_tensor_finite"] = phase_kernel_vs_plain_finite(device)
    net, main_req, infer_counts = phase_slice(rehearsal=False)
    tnet, trainer, batch, train_counts = phase_train(rehearsal=False)
    vs_cpu = phase_train_vs_cpu(tnet, rehearsal=False)
    rtc_counts = phase_rtc_train(tnet, trainer, batch, vs_cpu, rehearsal=False)
    del vs_cpu
    phase_nd_surface(net, rehearsal=False)
    sb_counts = phase_symbol_block(net, main_req, rehearsal=False, smi=smi)
    rnet, rtrainer, rbatch, resnet_counts, bn_shapes = phase_resnet_train(rehearsal=False)
    phase_resnet_train_vs_cpu(rehearsal=False)
    errs["multi_tensor"] = max(errs["multi_tensor"], phase_main_groups_vs_plain(
        {"bert_train_step": trainer, "resnet_train_step": rtrainer}))
    fold_counts, fold_progs, fold_records = phase_fold(
        (tnet, trainer, batch), (rnet, rtrainer, rbatch), rehearsal=False)
    surface_counts, sbert, sresnet, lamb_err = phase_train_surface(rehearsal=False)
    errs["multi_tensor_lamb"] = max(errs["multi_tensor_lamb"], lamb_err)
    kernels = phase_times(net, main_req, (tnet, trainer, batch), (rnet, rtrainer, rbatch),
                          bn_shapes, {"inference": infer_counts, "train_step": train_counts,
                                      "resnet_train_step": resnet_counts,
                                      "rtc_train_step": rtc_counts, **fold_counts,
                                      **surface_counts, **sb_counts},
                          errs, (fold_progs, fold_records), smi, (sbert, sresnet))
    del sbert, sresnet, fold_progs, fold_records
    torch.cuda.empty_cache()  # the fold's graphs: spmd captures ResNet-50 twice
    # spmd, observe and the serving phases run after the timing phase: after
    # each of them kineto drops kernel records of every later CUDA-only
    # profiler trace as out of its window (ROADMAP §3 "Not faults"), and the
    # timing phase reads those traces; observe runs before the serving
    # phases, whose drops are larger
    paths = phase_spmd(rehearsal=False, smi=smi)
    phase_dist(smi)
    paths.update(phase_io(rehearsal=False, smi=smi))
    paths.update(phase_detect(rehearsal=False, smi=smi))
    paths.update(phase_fit(rehearsal=False, smi=smi))
    paths.update(phase_op_library(net, rehearsal=False, smi=smi))
    paths.update(phase_observe((tnet, trainer, batch), rehearsal=False, smi=smi))
    paths.update(phase_generation(rehearsal=False, seed=args.seed, smi=smi))
    paths.update(phase_serve(net, main_req, rehearsal=False, smi=smi))
    for path, counts in paths.items():
        for row in kernels:
            row["launches_by_path"][path] = counts.get(row["name"], 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
