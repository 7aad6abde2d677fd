"""``GenerationServer`` — autoregressive decode with iteration-level
continuous batching over a device-resident slot KV cache.

Counterpart of the JAX package's ``serving/generation.py``.
:class:`~.server.InferenceServer` serves one forward per request;
autoregressive decode spans many device steps per request, so batching
whole requests ("drain and refill") leaves a finished sequence's lane idle
until the LAST one of its wave finishes.  **Iteration-level continuous
batching** (Orca; vLLM) revisits membership *between decode steps*:
finished sequences leave at once and queued prefills join into the freed
KV-cache slots, so the decode batch stays full under load.

The steady-state loop builds nothing:

* the KV cache is a fixed ladder of :class:`~.kv_cache.SlotKVCache` pools
  (``serving/kv_cache.py``): every decode program is shaped by a POOL,
  never by traffic;
* prefill pads prompts up to the :class:`~.bucketing.ShapeBucketer`
  length ladder (one program per bucket), and the encoder attends to the
  prompt's own keys only, so padding cannot leak into the memory the
  decode steps read;
* join/leave is host-side slot indexing plus ONE memory-insert call;
* every program is built in ``start()`` under
  ``profiler.compile_site("generation.warmup")`` and the steady-state
  compile guard is armed on exit, so with ``MXNET_COMPILE_GUARD=raise`` a
  stray build fails loudly.

On top of the loop: a **streaming token surface** (``submit()`` returns a
:class:`GenerationResult` whose ``stream()`` iterator, or ``on_token``
callback, yields tokens as they decode; ``cancel()`` frees the slot at the
next iteration boundary) and **multi-tenant admission control** (named
tenants with per-tenant queue caps, slot caps and TTFT/TPOT SLOs;
queue-depth load shedding raises :class:`AdmissionError` at ``submit()``).
Each server registers its own metrics provider.

The programs (:class:`_TransformerAdapter`) keep the reference's
semantics.  Prefill runs the encoder over the bucket-padded prompt with
every query row attending to the prompt's ``src_len`` keys: on the card
that is the port's ``flash_fwd`` kernel at Sq = bucket, Sk = ``src_len``,
one launch an encoder layer.  Decode runs one position for every slot of
a pool, each slot with its own position and memory length, so the mask
differs per row; the kernel has no per-batch key length, and the
reference computes this attention outside its kernel too, so it stays
plain PyTorch (scores in fp32, ``p`` cast to v's dtype before ``p·v``):
no kernel launch.  Its self-attention runs at the width of the ladder's
top bucket in every pool (the pool's cache zero-padded to it), so a
slot's arithmetic is the same whichever pool holds it: on the card the
order of a reduction depends on its length, and the continuous-batching
contract (a request's tokens do not depend on what shares its batch) holds
bit for bit.

Dispatch substrate: :class:`~..predictor.StatefulExecutor`: the decode
step updates the cache tensors in place, and the executor reports any
build after warm-up to the compile registry with its signature.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque

import numpy as _np
import torch

from .. import profiler
from ..ops import attention as _att
from ..predictor import StatefulExecutor
from .bucketing import ShapeBucketer
from .kv_cache import KVCacheLadder
from .server import ServerDrainingError

__all__ = ["GenerationServer", "GenerationResult", "AdmissionError", "Tenant"]

_perf = time.perf_counter
_env_int = profiler._env_int
_env_float = profiler._env_float

_name_lock = threading.Lock()
_name_seq = 0


def _default_name():
    """Unique per-process default provider key: a second default-named
    server must not replace the first's gauges, and closing one must not
    unregister the survivor's.  The first server keeps the name
    ``generation``."""
    global _name_seq
    with _name_lock:
        _name_seq += 1
        n = _name_seq
    return "generation" if n == 1 else f"generation{n}"


class AdmissionError(RuntimeError):
    """Raised by ``submit()`` when admission control sheds the request
    (tenant queue over its depth cap).  Callers should back off — the
    server is protecting the latency of requests already admitted."""


class Tenant:
    """Admission/SLO policy for one tenant.

    Parameters
    ----------
    name : tenant key (``submit(..., tenant=name)``).
    max_queue : queue-depth cap — submissions past it are SHED with
        :class:`AdmissionError` (env ``MXNET_GEN_MAX_QUEUE``, 64).
    max_slots : cap on concurrently decoding slots this tenant may hold
        (None = no cap) — a noisy neighbor cannot monopolize the cache.
    slo_ttft_ms : time-to-first-token SLO (env ``MXNET_GEN_TTFT_SLO_MS``,
        1000).
    slo_tpot_ms : per-output-token SLO (env ``MXNET_GEN_TPOT_SLO_MS``,
        200).
    """

    def __init__(self, name, max_queue=None, max_slots=None,
                 slo_ttft_ms=None, slo_tpot_ms=None):
        self.name = str(name)
        self.max_queue = int(max_queue if max_queue is not None
                             else _env_int("MXNET_GEN_MAX_QUEUE", 64))
        self.max_slots = None if max_slots is None else int(max_slots)
        self.slo_ttft_ms = float(
            slo_ttft_ms if slo_ttft_ms is not None
            else _env_float("MXNET_GEN_TTFT_SLO_MS", 1000.0))
        self.slo_tpot_ms = float(
            slo_tpot_ms if slo_tpot_ms is not None
            else _env_float("MXNET_GEN_TPOT_SLO_MS", 200.0))
        # live accounting (under the server lock)
        self.submitted = 0
        self.shed = 0
        self.completed = 0
        self.cancelled = 0
        self.failed = 0
        self.tokens = 0
        self.slo_violations = 0
        self.active_slots = 0

    def stats(self):
        return {
            "max_queue": self.max_queue,
            "max_slots": self.max_slots,
            "slo_ttft_ms": self.slo_ttft_ms,
            "slo_tpot_ms": self.slo_tpot_ms,
            "submitted": self.submitted,
            "shed": self.shed,
            "completed": self.completed,
            "cancelled": self.cancelled,
            "failed": self.failed,
            "tokens": self.tokens,
            "slo_violations": self.slo_violations,
            "active_slots": self.active_slots,
        }


class GenerationResult:
    """Streaming handle for one generation request.

    Tokens arrive as the decode loop emits them: iterate (``for tok in
    res.stream():``), poll (``tokens_so_far()``), or block for the full
    sequence (``result()``).  ``cancel()`` asks the scheduler to free the
    request's slot at the next iteration boundary — a disconnected
    client must release its cache slot, not decode to max length for
    nobody."""

    def __init__(self, request_id, tenant):
        self.request_id = request_id
        self.tenant = tenant
        self.finish_reason = None      # "eos" | "length" | "cancelled" | "error"
        self.ttft_ms = None
        self.tpot_ms = None
        self._tokens = []
        self._token_times = []
        self._cond = threading.Condition()
        self._done = False
        self._exc = None
        self._cancel = False

    # -- consumer surface ----------------------------------------------
    def done(self):
        return self._done

    def cancelled(self):
        return self._cancel

    def cancel(self):
        """Request cancellation (idempotent; safe from any thread).  The
        slot is freed at the next iteration boundary; ``finish_reason``
        becomes ``"cancelled"`` unless the request already finished."""
        with self._cond:
            self._cancel = True
            self._cond.notify_all()

    def tokens_so_far(self):
        with self._cond:
            return list(self._tokens)

    def stream(self, timeout=60.0):
        """Yield token ids as they decode; returns when the request
        finishes (raises what the scheduler raised on error).  ``timeout``
        bounds the wait for EACH token."""
        i = 0
        while True:
            with self._cond:
                while len(self._tokens) <= i and not self._done:
                    if not self._cond.wait(timeout):
                        raise TimeoutError(
                            f"request {self.request_id!r}: no token within "
                            f"{timeout}s")
                if len(self._tokens) > i:
                    tok = self._tokens[i]
                else:  # done
                    if self._exc is not None:
                        raise self._exc
                    return
            yield tok
            i += 1

    def result(self, timeout=60.0):
        """Block until finished; returns the generated token ids as a
        numpy int32 array (includes the closing ``eos`` when the model
        produced one — ``finish_reason`` tells which)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"request {self.request_id!r} not finished in {timeout}s")
            if self._exc is not None:
                raise self._exc
            return _np.asarray(self._tokens, _np.int32)

    # -- scheduler side ------------------------------------------------
    def _push(self, token, now):
        with self._cond:
            self._tokens.append(int(token))
            self._token_times.append(now)
            self._cond.notify_all()

    def _finish(self, reason, t_submit, exc=None):
        with self._cond:
            if self._done:
                return
            self.finish_reason = reason
            self._exc = exc
            if self._token_times:
                self.ttft_ms = (self._token_times[0] - t_submit) * 1e3
                if len(self._token_times) > 1:
                    self.tpot_ms = ((self._token_times[-1]
                                     - self._token_times[0])
                                    / (len(self._token_times) - 1)) * 1e3
            self._done = True
            self._cond.notify_all()


class _GenRequest:
    __slots__ = ("rid", "tenant", "prompt", "prompt_bucket", "max_new",
                 "on_token", "t_submit", "result", "pool", "slot")

    def __init__(self, rid, tenant, prompt, prompt_bucket, max_new,
                 on_token, t_submit):
        self.rid = rid
        self.tenant = tenant
        self.prompt = prompt
        self.prompt_bucket = prompt_bucket
        self.max_new = max_new
        self.on_token = on_token
        self.t_submit = t_submit
        self.result = GenerationResult(rid, tenant.name)
        self.pool = None
        self.slot = None


# ---------------------------------------------------------------------------
# model adapter: step programs over a Transformer
# ---------------------------------------------------------------------------


class _TransformerAdapter:
    """Prefill / decode-step / memory-insert programs over a
    :class:`~..gluon.model_zoo.transformer.Transformer`, reading its
    parameters live.

    Prefill = the encoder over the bucket-padded prompt + each decoder
    layer's cross-attention KV projection, padded out to the memory width
    (so one insert program a pool serves every prompt bucket).  Decode =
    one position for EVERY slot of a pool: per-slot positions, per-slot
    self-attention over the slot's cache rows, per-slot ``mem_len``-masked
    cross-attention; slots are independent, so a request decodes
    identically whatever else shares the batch."""

    def __init__(self, model):
        cells = model.decoder._layers
        if not all(getattr(c, "_pre_norm", False) for c in cells):
            raise NotImplementedError("GenerationServer requires a pre-norm decoder")
        enc_cells = model.encoder._layers
        if not all(getattr(c, "_pre_norm", False) for c in enc_cells):
            raise NotImplementedError("GenerationServer requires a pre-norm encoder")
        self.model = model
        self.enc_cells = enc_cells
        self.dec_cells = cells
        self.layers = len(cells)
        self.units = model._units
        self.vocab = model._vocab
        self.heads = cells[0].self_attention._num_heads
        self.head_dim = self.units // self.heads
        self.pos_table = model.pos_enc._table      # numpy [max_len, units]
        self.max_positions = int(self.pos_table.shape[0])
        self.params = sorted(model.collect_params().values(), key=lambda p: p.name)
        if any(p._data is None for p in self.params):
            raise ValueError(
                "model parameters are uninitialized/deferred — run one forward (or load a "
                "checkpoint) before binding a GenerationServer")
        first = self.params[0].data()
        self.dtype = first.dtype
        self.device = first.device
        self._scale = 1.0 / math.sqrt(self.head_dim)

    def _embed(self, tok, pos_rows):
        """Token embedding × sqrt(units) plus the position rows, in the
        model's dtype: ``tok`` [B, T], ``pos_rows`` [T] or [B, 1] indices."""
        x = self.model.embed(tok) * math.sqrt(self.units)
        table = self.model.pos_enc.table(x.device, x.dtype)
        return x + table[pos_rows]

    def _logits(self, x):
        model = self.model
        if model._tie:
            return torch.matmul(x, model.embed.weight.data().to(x.dtype).t())
        return model.proj(x)

    def _attend(self, q, k, v, masked):
        """q [S,1,H,dh]; k/v [S,Tk,H,dh]; masked [S,Tk] bool (True: not
        attended) → [S,1,units]: scores and softmax in fp32, p cast to v's
        dtype before p·v, products accumulated in fp32."""
        s = torch.matmul(q.float().permute(0, 2, 1, 3), k.float().permute(0, 2, 3, 1))
        s = (s * self._scale).masked_fill(masked[:, None, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out = torch.matmul(p.to(v.dtype).float(), v.float().permute(0, 2, 1, 3)).to(v.dtype)
        return out.permute(0, 2, 1, 3).reshape(out.shape[0], 1, self.units)

    def make_prefill(self, prompt_bucket, mem_width):
        """Program: (src [1, Lb] int32, src_len: a host int) → (mem_k,
        mem_v) each [layers, 1, mem_width, H, dh].  Every query row of the
        encoder attends to the first ``src_len`` keys, so the first
        ``src_len`` memory rows are what an unpadded encode gives (pad rows
        hold values the decode-side ``mem_len`` mask never reads)."""
        H, dh, Lb = self.heads, self.head_dim, int(prompt_bucket)
        pad = int(mem_width) - Lb
        positions = torch.arange(Lb, device=self.device)

        @torch.no_grad()
        def prefill(state, inputs):
            n = int(inputs["src_len"])
            x = self._embed(inputs["src"], positions)
            for cell in self.enc_cells:
                qkv = cell.attention.qkv(cell.ln_attn(x)).reshape(1, Lb, 3, H, dh)
                o = _att.flash_fwd(qkv[:, :, 0], qkv[:, :n, 1], qkv[:, :n, 2],
                                   layout="bshd")[0]
                x = x + cell.attention.out_proj(o.reshape(1, Lb, self.units))
                x = x + cell.ffn(cell.ln_ffn(x))
            kv = torch.stack([cell.cross_attention.kv_proj(x).reshape(1, Lb, 2, H, dh)
                              for cell in self.dec_cells])       # [L, 1, Lb, 2, H, dh]
            mem_k, mem_v = kv[:, :, :, 0], kv[:, :, :, 1]
            if pad > 0:
                widths = (0, 0, 0, 0, 0, pad)
                mem_k = torch.nn.functional.pad(mem_k, widths)
                mem_v = torch.nn.functional.pad(mem_v, widths)
            return (mem_k, mem_v), state

        return prefill

    def make_decode(self, slots, bucket, mem_width, width):
        """Program: state {self_k, self_v, mem_k, mem_v} + inputs (tok [S],
        pos [S], mem_len [S]) → (logits [S, V], state).  Writes each slot's
        K/V at its own position, then attends ``<= pos``: write before
        read is what lets ``free()`` skip clearing rows.  Self-attention
        runs at ``width`` columns (the ladder's top bucket), the pool's
        ``bucket``-wide cache zero-padded to it."""
        H, dh, S, T = self.heads, self.head_dim, int(slots), int(bucket)
        W = max(int(width), T)
        rows = torch.arange(S, device=self.device)
        cols = torch.arange(W, device=self.device)
        mem_cols = torch.arange(int(mem_width), device=self.device)

        def widen(c):
            return c if W == T else torch.nn.functional.pad(c, (0, 0, 0, 0, 0, W - T))

        @torch.no_grad()
        def decode(state, inputs):
            pos = inputs["pos"].long()
            self_k, self_v = state["self_k"], state["self_v"]
            mem_k, mem_v = state["mem_k"], state["mem_v"]
            after_pos = cols[None, :] > pos[:, None]                        # [S, W]
            past_mem = mem_cols[None, :] >= inputs["mem_len"][:, None]     # [S, Sm]
            x = self._embed(inputs["tok"].reshape(S, 1), pos[:, None])
            for l, cell in enumerate(self.dec_cells):
                qkv = cell.self_attention.qkv(cell.ln_self(x)).reshape(S, 1, 3, H, dh)
                self_k[l, rows, pos] = qkv[:, 0, 1].to(self_k.dtype)
                self_v[l, rows, pos] = qkv[:, 0, 2].to(self_v.dtype)
                out = self._attend(qkv[:, :, 0], widen(self_k[l]), widen(self_v[l]),
                                   after_pos)
                x = x + cell.self_attention.out_proj(out)
                q2 = cell.cross_attention.q_proj(cell.ln_cross(x)).reshape(S, 1, H, dh)
                x = x + cell.cross_attention.out_proj(
                    self._attend(q2, mem_k[l], mem_v[l], past_mem))
                x = x + cell.ffn(cell.ln_ffn(x))
            return self._logits(x)[:, 0], state

        return decode

    def make_insert(self):
        """Program: write one request's prefill product into a slot's
        memory rows (``slot`` a host int: joining slot 3 or slot 5 is the
        SAME program)."""

        @torch.no_grad()
        def insert(state, inputs):
            slot = int(inputs["slot"])
            state["mem_k"][:, slot] = inputs["mem_k"][:, 0]
            state["mem_v"][:, slot] = inputs["mem_v"][:, 0]
            return (), state

        return insert


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


class GenerationServer:
    """Continuous-batching autoregressive generation over a Transformer.

    Parameters
    ----------
    model : a pre-norm ``gluon.model_zoo.transformer.Transformer`` with
        materialized parameters (run one forward first).  The server
        treats the weights as frozen from ``start()`` to ``close()``.
    bos, eos : special token ids (decode primes with ``bos``; a sampled
        ``eos`` finishes the request).
    max_prompt_length / prompt_buckets : prompt ladder
        (:class:`ShapeBucketer` semantics; ``max_prompt_length`` is also
        the submit-time admission ceiling).
    max_new_tokens / decode_buckets : decode-length ladder for the KV
        pools; ``max_new_tokens`` is the per-request default and ceiling.
    slots_per_bucket : pool capacity (int or ``{bucket: n}``; env
        ``MXNET_GEN_SLOTS``, 4).
    tenants : ``{name: dict(max_queue=, max_slots=, slo_ttft_ms=,
        slo_tpot_ms=)}`` — a ``"default"`` tenant with env-default policy
        is always present.
    batching : ``"continuous"`` (default — join between iterations) or
        ``"static"`` (drain-and-refill: admissions only when the decode
        batch is EMPTY; the benchmark's ablation baseline).
    max_prefills_per_iter : prefill budget per iteration boundary — caps
        how long a join wave may stall decoding for requests already in
        flight (env ``MXNET_GEN_MAX_PREFILLS``, 2).
    greedy argmax is the sampling rule (the equivalence contract); the
    streaming surface and slot lifecycle are sampling-agnostic.
    """

    def __init__(self, model, *, bos, eos, max_prompt_length=None,
                 prompt_buckets=None, max_new_tokens=None,
                 decode_buckets=None, slots_per_bucket=None, tenants=None,
                 batching="continuous", max_prefills_per_iter=None,
                 memory_budget=None, name=None, warmup=True, autostart=True):
        if batching not in ("continuous", "static"):
            raise ValueError(f"batching must be 'continuous' or 'static', "
                             f"got {batching!r}")
        # memory_budget: a profiler.MemoryBudget slot admission consults —
        # while it reports pressure, queued prefills DEFER (requeued at
        # the front, memory_budget_refusal counts) instead of pushing the
        # device out of memory mid-decode.  The gate is OPT-IN:
        # an explicit budget object, or the process budget while
        # MXNET_MEM_BUDGET_MB is set (checked per admission — the env
        # limit is dynamic) — a serving deployment sized to legitimately
        # fill the card past the pressure fraction must not have every
        # admission deferred by default.
        self._budget_explicit = memory_budget is not None
        self._budget = (memory_budget if memory_budget is not None
                        else profiler.memory_budget())
        self.bos, self.eos = int(bos), int(eos)
        self.name = str(name) if name is not None else _default_name()
        self.batching = batching
        self._adapter = _TransformerAdapter(model)
        device = self._adapter.device
        self._prompt_bucketer = ShapeBucketer(
            buckets=prompt_buckets, max_length=max_prompt_length)
        self.max_new_tokens = int(
            max_new_tokens if max_new_tokens is not None
            else _env_int("MXNET_GEN_MAX_NEW_TOKENS", 64))
        slots = (slots_per_bucket if slots_per_bucket is not None
                 else _env_int("MXNET_GEN_SLOTS", 4))
        self._ladder = KVCacheLadder(
            self._adapter.layers, self._adapter.heads,
            self._adapter.head_dim,
            mem_width=self._prompt_bucketer.buckets[-1],
            buckets=decode_buckets, max_length=self.max_new_tokens,
            slots_per_bucket=slots, dtype=self._adapter.dtype, device=device)
        top = max(self._ladder.buckets[-1],
                  self._prompt_bucketer.buckets[-1])
        if top > self._adapter.max_positions:
            raise ValueError(
                f"ladder top {top} exceeds the model's positional table "
                f"({self._adapter.max_positions} positions)")
        self.max_prefills_per_iter = int(
            max_prefills_per_iter if max_prefills_per_iter is not None
            else _env_int("MXNET_GEN_MAX_PREFILLS", 2))

        # -- tenants -----------------------------------------------------
        self.tenants = {}
        for tname, cfg in (tenants or {}).items():
            self.tenants[str(tname)] = Tenant(tname, **dict(cfg))
        self.tenants.setdefault("default", Tenant("default"))
        self._queues = {t: deque() for t in self.tenants}
        self._rr = list(self.tenants)      # round-robin admission order

        # -- executors (programs bound here, built in start()) -----------
        self._prefill_exe = StatefulExecutor(
            {}, name="generation_prefill", compile_site="generation.prefill",
            device=device)
        mem_w = self._prompt_bucketer.buckets[-1]
        for lb in self._prompt_bucketer.buckets:
            self._prefill_exe.add_program(
                f"prefill_{lb}", self._adapter.make_prefill(lb, mem_w))
        self._exes = {}
        for b, pool in self._ladder.pools.items():
            exe = StatefulExecutor(pool.state, name=f"generation_decode_{b}",
                                   compile_site="generation.decode")
            pool.state = None     # ownership transfers: the buffers now
                                  # live in (and only in) the executor
            exe.add_program("decode", self._adapter.make_decode(
                pool.slots, b, mem_w, self._ladder.buckets[-1]))
            exe.add_program("insert", self._adapter.make_insert())
            self._exes[b] = exe

        # -- scheduler state --------------------------------------------
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._rid = 0
        self._started = False
        self._closing = False
        self._closed = False
        self._drain = True
        self._thread = None
        self._do_warmup = bool(warmup)
        self._iterations = 0
        self._n_completed = 0
        self._ttfts = deque(maxlen=2048)
        self._tpots = deque(maxlen=2048)
        self._tok_window = deque(maxlen=4096)    # (t_emit,) for tokens/sec
        if autostart:
            self.start()

    # ------------------------------------------------------------------
    def start(self):
        """Build every program (prefill per prompt bucket; decode + insert
        per pool) by one call each, arm the steady-state compile guard,
        start the scheduler thread, register the metrics provider.
        Idempotent."""
        with self._lock:
            if self._started:
                return self
            if self._closed:
                raise RuntimeError("server is closed")
            self._started = True
        if self._do_warmup:
            t0 = _perf()
            with profiler.compile_site("generation.warmup"), \
                    profiler.compile_guard_paused():
                warm_mem = None
                for lb in self._prompt_bucketer.buckets:
                    src = _np.zeros((1, lb), _np.int32)
                    warm_mem = self._prefill_exe.run(
                        f"prefill_{lb}", src=src, src_len=_np.int32(1))
                mk, mv = warm_mem
                for b, exe in self._exes.items():
                    pool = self._ladder.pools[b]
                    exe.run("insert", slot=_np.int32(0), mem_k=mk, mem_v=mv)
                    exe.run("decode",
                            tok=_np.zeros(pool.slots, _np.int32),
                            pos=_np.zeros(pool.slots, _np.int32),
                            mem_len=_np.ones(pool.slots, _np.int32))
            if profiler._active:
                profiler.record_span(
                    "generation.warmup", "serving", t0,
                    args={"prompt_buckets": list(self._prompt_bucketer.buckets),
                          "pools": list(self._exes)})
            # the program set is closed and built: any further build is a
            # steady-state violation (MXNET_COMPILE_GUARD escalates)
            profiler.arm_compile_guard("generation")
        self._thread = threading.Thread(
            target=self._loop, name=f"mx-{self.name}-scheduler",
            daemon=True)
        self._thread.start()
        profiler.register_metrics_provider(self.name, self._provider)
        return self

    # -- submission ----------------------------------------------------
    def submit(self, prompt, *, tenant="default", max_new_tokens=None,
               on_token=None, request_id=None):
        """Enqueue one prompt (1-D int token array) and return its
        :class:`GenerationResult`.

        Raises synchronously — a request that can never be served, or
        that admission control sheds, must fail at the door:

        * ``ValueError`` — prompt longer than the prompt ladder's
          ``max_length`` ceiling, or ``max_new_tokens`` past the decode
          ladder (clear submit-time errors, never a scheduler-thread
          failure);
        * :class:`AdmissionError` — the tenant's queue is at
          ``max_queue`` (load shedding; ``generation_shed`` counts).
        """
        prompt = _np.asarray(prompt, _np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if prompt.size > self._prompt_bucketer.max_length:
            raise ValueError(
                f"prompt length {prompt.size} exceeds max_prompt_length "
                f"{self._prompt_bucketer.max_length} — rejected at submit "
                f"(buckets: {list(self._prompt_bucketer.buckets)})")
        pb = self._prompt_bucketer.bucket_for(prompt.size)
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if max_new > self._ladder.max_length:
            raise ValueError(
                f"max_new_tokens {max_new} exceeds the decode ladder "
                f"ceiling {self._ladder.max_length} — rejected at submit")
        ten = self.tenants.get(str(tenant))
        if ten is None:
            raise ValueError(f"unknown tenant {tenant!r}; tenants are "
                             f"{sorted(self.tenants)}")
        t0 = _perf()
        with self._cond:
            if self._closing or self._closed:
                raise ServerDrainingError(
                    "server is draining/closed — retry against another "
                    "replica")
            if not self._started:
                raise RuntimeError("server is not started")
            q = self._queues[ten.name]
            if len(q) >= ten.max_queue:
                ten.shed += 1
                profiler.incr("generation_shed")
                raise AdmissionError(
                    f"tenant {ten.name!r} queue at max_queue="
                    f"{ten.max_queue} — request shed (back off)")
            self._rid += 1
            rid = request_id if request_id is not None else self._rid
            req = _GenRequest(rid, ten, prompt, pb, max_new, on_token, t0)
            q.append(req)
            ten.submitted += 1
            self._cond.notify_all()
        profiler.incr("generation_request")
        if profiler._active:
            profiler.record_span(
                "generation.enqueue", "serving", t0,
                args={"request": rid, "tenant": ten.name,
                      "prompt_bucket": pb, "max_new": max_new})
        return req.result

    def generate(self, prompt, timeout=120.0, **kw):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, **kw).result(timeout)

    # -- scheduler -----------------------------------------------------
    def _runnable_locked(self):
        """True when an iteration can make progress: live slots to
        decode, or a queued request its tenant could actually admit.  A
        queue whose every tenant is slot-capped out is NOT runnable —
        spinning on it would burn a core without advancing anything
        (when nothing is active every slot is free, so capacity can
        never be the blocker here)."""
        if self._ladder.n_active > 0:
            return True
        for tname, q in self._queues.items():
            if not q:
                continue
            ten = self.tenants[tname]
            if ten.max_slots is None or ten.active_slots < ten.max_slots:
                return True
        return False

    def _loop(self):
        while True:
            with self._cond:
                while not self._closing and not self._runnable_locked():
                    self._cond.wait()
                if self._closing:
                    if not self._drain:
                        self._fail_queued_locked(
                            RuntimeError("server closed"))
                    else:
                        # a drain can only finish requests that CAN run;
                        # a zero-slot tenant's queue would hang it forever
                        for tname, q in self._queues.items():
                            if self.tenants[tname].max_slots == 0:
                                while q:
                                    req = q.popleft()
                                    req.tenant.failed += 1
                                    req.result._finish(
                                        "error", req.t_submit,
                                        exc=RuntimeError(
                                            "server closed while tenant "
                                            f"{tname!r} is slot-capped to "
                                            "0 — request can never run"))
                    if (self._ladder.n_active == 0
                            and not any(self._queues.values())):
                        return
                    if not self._runnable_locked():
                        # closing, undrainable remainder: wait for a
                        # cancel/cap change instead of spinning
                        self._cond.wait(0.05)
                        continue
            try:
                self._iterate()
            except Exception as e:  # noqa: BLE001 — fail in-flight, not the server
                self._fail_inflight(e)

    def _fail_queued_locked(self, exc):
        for q in self._queues.values():
            while q:
                req = q.popleft()
                req.tenant.failed += 1
                req.result._finish("error", req.t_submit, exc=exc)

    def _fail_inflight(self, exc):
        with self._lock:
            for pool in self._ladder.pools.values():
                for s in list(pool.active_slots()):
                    req = pool.owners[s]
                    pool.free(s)
                    req.tenant.active_slots -= 1
                    req.tenant.failed += 1
                    profiler.incr("generation_slot_leave")
                    req.result._finish("error", req.t_submit, exc=exc)
            self._fail_queued_locked(exc)

    def _next_queued_locked(self):
        """Round-robin across tenants with queued work; respects per-
        tenant slot caps.  Returns a request or None."""
        for _ in range(len(self._rr)):
            tname = self._rr.pop(0)
            self._rr.append(tname)
            ten = self.tenants[tname]
            q = self._queues[tname]
            if not q:
                continue
            if (ten.max_slots is not None
                    and ten.active_slots >= ten.max_slots):
                continue
            return q.popleft()
        return None

    def _admit(self):
        """Join queued prefills into free slots (the iteration-level
        half of continuous batching).  In static mode admissions happen
        only into an EMPTY decode batch — the drain-and-refill baseline
        the benchmark compares against."""
        if self.batching == "static" and self._ladder.n_active > 0:
            return
        joined = 0
        while joined < self.max_prefills_per_iter:
            with self._cond:
                req = self._next_queued_locked()
            if req is None:
                return
            if req.result._cancel:
                # cancelled while still queued (client disconnected):
                # finish without ever allocating a slot or prefilling
                with self._lock:
                    req.tenant.cancelled += 1
                profiler.incr("generation_cancelled")
                req.result._finish("cancelled", req.t_submit)
                continue
            if (self._budget is not None
                    and (self._budget_explicit
                         or self._budget.limit_bytes is not None)
                    and not (self._closing and self._drain)
                    and self._budget.under_pressure()):
                # no memory headroom: defer the admission (requeued at
                # the FRONT of its tenant's queue) rather than push the
                # decode loop into an out-of-memory error.  A draining close
                # is exempt — termination outranks headroom.  The brief
                # wait only happens with NOTHING decoding (it keeps a
                # fully-blocked queue from hot-spinning; while slots are
                # live the decode loop itself paces the scheduler, and a
                # wait here would tax every in-flight request's TPOT).
                profiler.incr("memory_budget_refusal")
                with self._cond:
                    self._queues[req.tenant.name].appendleft(req)
                    self._rr.remove(req.tenant.name)
                    self._rr.insert(0, req.tenant.name)
                    if self._ladder.n_active == 0:
                        self._cond.wait(0.02)
                return
            got = self._ladder.try_alloc(req.max_new, req, req.prompt.size,
                                         self.bos)
            if got is None:
                # no capacity: requeue at the FRONT of its tenant's queue
                # (arrival order within a tenant is preserved)
                with self._cond:
                    self._queues[req.tenant.name].appendleft(req)
                    self._rr.remove(req.tenant.name)
                    self._rr.insert(0, req.tenant.name)
                return
            pool, slot = got
            req.pool, req.slot = pool, slot
            # the slot is claimed: account it to the tenant NOW, before
            # the fallible prefill/insert dispatches — if one raises,
            # _fail_inflight frees the slot and decrements, so the
            # max_slots cap never goes negative
            with self._lock:
                req.tenant.active_slots += 1
            t0 = _perf()
            src = _np.zeros((1, req.prompt_bucket), _np.int32)
            src[0, :req.prompt.size] = req.prompt
            mem_k, mem_v = self._prefill_exe.run(
                f"prefill_{req.prompt_bucket}", src=src,
                src_len=_np.int32(req.prompt.size))
            self._exes[pool.bucket].run(
                "insert", slot=_np.int32(slot), mem_k=mem_k, mem_v=mem_v)
            profiler.incr("generation_prefill")
            profiler.incr("generation_slot_join")
            if profiler._active:
                profiler.record_span(
                    "generation.prefill", "serving", t0,
                    args={"request": req.rid, "tenant": req.tenant.name,
                          "prompt_bucket": req.prompt_bucket,
                          "pool": pool.bucket, "slot": int(slot)})
            joined += 1

    def _harvest_cancelled(self):
        for pool in self._ladder.pools.values():
            for s in list(pool.active_slots()):
                req = pool.owners[s]
                if req.result._cancel and not req.result._done:
                    self._leave(pool, s, "cancelled")

    def _leave(self, pool, slot, reason, exc=None):
        req = pool.owners[slot]
        pool.free(slot)
        profiler.incr("generation_slot_leave")
        with self._lock:
            req.tenant.active_slots -= 1
            if reason == "cancelled":
                req.tenant.cancelled += 1
                profiler.incr("generation_cancelled")
            elif reason == "error":
                req.tenant.failed += 1
            else:
                req.tenant.completed += 1
                self._n_completed += 1
        req.result._finish(reason, req.t_submit, exc=exc)
        if reason in ("eos", "length"):
            self._note_latency(req.result)
            self._judge_slo(req)
        if profiler._active:
            profiler.record_span(
                "generation.complete", "serving", _perf(),
                args={"request": req.rid, "tenant": req.tenant.name,
                      "reason": reason,
                      "tokens": len(req.result._tokens),
                      "ttft_ms": round(req.result.ttft_ms or 0.0, 3)})

    def _judge_slo(self, req):
        res, ten = req.result, req.tenant
        late = ((res.ttft_ms is not None and res.ttft_ms > ten.slo_ttft_ms)
                or (res.tpot_ms is not None
                    and res.tpot_ms > ten.slo_tpot_ms))
        if late:
            profiler.incr("generation_slo_violation")
            with self._lock:
                ten.slo_violations += 1

    def _decode_all(self):
        """One decode iteration: one step program per pool that has live
        slots; the logits come to the host, where argmax picks each slot's
        token and requests emit and finish."""
        for b, pool in self._ladder.pools.items():
            act = pool.active_slots()
            if len(act) == 0:
                continue
            t0 = _perf()
            logits = self._exes[b].run(
                "decode", tok=pool.last_token.copy(), pos=pool.pos.copy(),
                mem_len=pool.mem_len.copy())
            logits = logits.float().cpu().numpy()
            now = _perf()
            profiler.incr("generation_decode_iter")
            profiler.incr("generation_token", int(len(act)))
            if profiler._active:
                profiler.record_span(
                    "generation.step", "serving", t0, now,
                    args={"pool": b, "active": int(len(act))})
            emitted = []
            with self._lock:      # ONE acquisition per pool, not per slot
                for s in act:
                    req = pool.owners[s]
                    nxt = int(logits[s].argmax())
                    pool.last_token[s] = nxt
                    pool.pos[s] += 1
                    req.tenant.tokens += 1
                    # under the lock: stats() iterates this window from
                    # the metrics-scrape thread
                    self._tok_window.append(now)
                    emitted.append((s, req, nxt))
            # stream/callback/leave OUTSIDE the lock: on_token is user
            # code and may well call stats() (non-reentrant lock)
            for s, req, nxt in emitted:
                req.result._push(nxt, now)
                if req.on_token is not None:
                    try:
                        req.on_token(req.result, nxt)
                    except Exception:  # noqa: BLE001 — a bad callback must
                        pass           # not take the decode loop down
                if nxt == self.eos:
                    self._leave(pool, s, "eos")
                elif len(req.result._tokens) >= req.max_new:
                    self._leave(pool, s, "length")
        with self._lock:
            self._iterations += 1

    def _iterate(self):
        self._harvest_cancelled()
        self._admit()
        self._decode_all()
        # memory-counter-track tick: serving-only processes have no step
        # boundaries, so the scheduler samples the watermark (throttled)
        profiler.maybe_sample_memory()

    # -- observability -------------------------------------------------
    def stats(self):
        pct = profiler.percentile
        with self._lock:
            ttfts, tpots = list(self._ttfts), list(self._tpots)
            queue_depth = sum(len(q) for q in self._queues.values())
            now = _perf()
            recent = [t for t in self._tok_window if now - t <= 10.0]
            out = {
                "queue_depth": queue_depth,
                "active_slots": self._ladder.n_active,
                "total_slots": self._ladder.n_slots,
                "iterations": self._iterations,
                "completed": self._n_completed,
                "tokens_per_s_10s": round(len(recent) / 10.0, 3),
                "ttft_ms_p50": pct(ttfts, 0.50),
                "ttft_ms_p99": pct(ttfts, 0.99),
                "tpot_ms_p50": pct(tpots, 0.50),
                "tpot_ms_p99": pct(tpots, 0.99),
                "tenants": {t: ten.stats()
                            for t, ten in self.tenants.items()},
            }
        out["pools"] = self._ladder.stats()["buckets"]
        return out

    def _provider(self):
        st = self.stats()
        flat = {k: v for k, v in st.items()
                if isinstance(v, (int, float)) or v is None}
        for tname, ts in st["tenants"].items():
            for k in ("submitted", "shed", "completed", "tokens",
                      "slo_violations", "active_slots"):
                flat[f"tenant_{tname}_{k}"] = ts[k]
        return flat

    def _note_latency(self, res):
        with self._lock:
            if res.ttft_ms is not None:
                self._ttfts.append(res.ttft_ms)
            if res.tpot_ms is not None:
                self._tpots.append(res.tpot_ms)

    def compile_stats(self):
        """``StatefulExecutor.compile_stats()`` of the prefill executor and
        every pool, with their builds summed under ``"compiles"``: the
        harness compares it around a traffic run to prove no build after
        warm-up."""
        out = {"prefill": self._prefill_exe.compile_stats()}
        for b, exe in self._exes.items():
            out[f"pool_{b}"] = exe.compile_stats()
        out["compiles"] = (out["prefill"]["compiles"]
                          + sum(out[f"pool_{b}"]["compiles"]
                                for b in self._exes))
        return out

    # -- lifecycle -----------------------------------------------------
    def close(self, drain=True, timeout=60.0):
        """Stop accepting requests.  ``drain=True`` (default) finishes
        everything queued and in flight under a ``timeout`` deadline —
        whatever the drain could not finish in time fails with a
        retriable :class:`ServerDrainingError` instead of hanging its
        clients; ``drain=False`` fails queued requests immediately and
        cancels in-flight ones at the next boundary."""
        with self._cond:
            if self._closed:
                return
            self._drain = bool(drain)
            self._closing = True
            if not drain:
                for q in self._queues.values():
                    for req in q:
                        req.tenant.failed += 1
                        req.result._finish(
                            "error", req.t_submit,
                            exc=ServerDrainingError(
                                "server closed without drain — retry "
                                "against another replica"))
                    q.clear()
                for pool in self._ladder.pools.values():
                    for s in pool.active_slots():
                        pool.owners[s].result._cancel = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                # drain deadline exceeded: fail what's still queued
                # retriably and cancel the in-flight remainder so no
                # client blocks on a server that will never answer
                with self._cond:
                    for q in self._queues.values():
                        for req in q:
                            req.tenant.failed += 1
                            req.result._finish(
                                "error", req.t_submit,
                                exc=ServerDrainingError(
                                    f"drain deadline ({timeout}s) "
                                    "exceeded — retry against another "
                                    "replica"))
                        q.clear()
                    for pool in self._ladder.pools.values():
                        for s in pool.active_slots():
                            pool.owners[s].result._cancel = True
                    self._cond.notify_all()
        profiler.unregister_metrics_provider(self.name)
        self._ladder.release()   # pool bytes leave the device-memory ledger
        with self._cond:
            self._closed = True
            # _closing stays latched: there is no reopen (start() raises
            # once closed), and clearing it would let a scheduler thread
            # that outlived the join timeout spin forever on its queues

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.close()
        return False
