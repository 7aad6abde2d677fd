"""Shared harness of the profiler parity tests (``test_torch_profiler_
telemetry.py``, ``test_torch_goodput.py``,
``test_torch_compile_observability.py``).

Each scenario of the JAX package's profiler tests runs once through each
package's ``profiler`` module (``BOTH``), each from a clean state, and the
test compares what the two return.  Imports both packages; the port never
does.
"""
import logging
import os
import subprocess
import sys
from collections import defaultdict

import pytest

from incubator_mxnet_tpu import profiler as jprof
from incubator_mxnet_torch import profiler as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = (("jax", jprof), ("torch", tprof))


def reset(p, directory):
    """A stopped recorder, a fresh filename, default knobs, zeroed counters,
    no peers, an empty compile registry and a disarmed guard."""
    p.stop()
    p.stop_metrics()
    # no device trace to read: the CPU captures no device kernels, and the
    # JAX package's first look for xprof's files takes seconds
    p._state["dir"] = None
    p.set_config(filename=str(directory / "trace.json"), ring_size=65536, slow_step_ms=None,
                 slow_step_auto=True, slow_step_auto_mult=4.0, memory_sampling=True,
                 compile_guard=None, compile_warmup_steps=None, compile_cost=None)
    p.reset_counters()
    p.reset_compiles()
    p.disarm_compile_guard()
    with p._counter_lock:
        p._peer_metrics.clear()


@pytest.fixture
def dirs(tmp_path):
    """``{package: directory}``, each package's profiler reset before and
    after the test."""
    out = {}
    for name, p in BOTH:
        out[name] = tmp_path / name
        out[name].mkdir()
        reset(p, out[name])
    yield out
    for name, p in BOTH:
        reset(p, out[name])
        p.reset_goodput()


def both(fn, dirs):
    """``{package: fn(profiler module, its directory)}``."""
    return {name: fn(p, dirs[name]) for name, p in BOTH}


def warnings_of(caplog, p):
    """The WARNING lines the profiler module ``p`` logged."""
    return [r.getMessage() for r in caplog.records
            if r.name == p.__name__ and r.levelno >= logging.WARNING]


def peer_snap(rank, host="peer-host", seq=1, wall=900.0, comms=700.0, step=77, time_unix=None):
    """A peer's metrics snapshot (the JAX tests' ``_peer_snap``)."""
    import time

    return {"schema": 1, "rank": rank, "host": host, "pid": 10000 + rank, "seq": seq,
            "time_unix": time.time() if time_unix is None else time_unix,
            "counters": {"metrics_snapshot": 1},
            "last_step": {"step": step, "wall_ms": wall, "host_ms": 50.0, "comms_ms": comms,
                          "device_ms": wall - 50.0 - comms},
            "window": {"n": 1, "wall_ms_median": wall, "wall_ms_max": wall},
            "memory_watermark_bytes": {}}


def paired_spans(events):
    """The B events of every B/E pair (per pid, tid), each with its end as
    ``_end``; asserts that every pair closes."""
    stacks = defaultdict(list)
    spans = []
    for e in sorted((e for e in events if e.get("ph") in ("B", "E")), key=lambda e: e["ts"]):
        k = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks[k].append(e)
        else:
            assert stacks[k], f"E without open B at ts={e['ts']}"
            b = stacks[k].pop()
            assert e["ts"] >= b["ts"]
            b["_end"] = e["ts"]
            spans.append(b)
    assert not any(stacks.values()), "B events left unclosed"
    return spans


def tool(name, *args):
    """Run ``tools/<name>`` on ``args``: (exit code, stdout, stderr)."""
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", name), *map(str, args)],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    return out.returncode, out.stdout, out.stderr
