"""Tracing / profiling subsystem.

The reference has no profiling beyond one ``CUDA.@time`` call
(``admm_deconv_test.jl:76``, SURVEY.md §5.1).  Here: ``jax.profiler`` trace
annotations around solver phases, a wall-clock iteration timer that ends
every timed call in ``block_until_ready``, and the reduction from a
``jax.profiler`` trace to device time per solver phase.

The solvers name their phases with ``jax.named_scope("admm/<phase>")``
(``admm/precompute``, ``admm/x_update``, ``admm/stencil``,
``admm/final_solve``, ...).  XLA keeps the scope in each instruction's
``op_name`` metadata, and the profiler tags each device event with the
instruction it ran (``hlo_op``), so :func:`device_time_by_scope` can sum
device time per phase.
"""

from __future__ import annotations

import contextlib
import glob
import os
import re
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region in a ``jax.profiler`` trace (no-op without a trace)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def force_completion(x):
    """Block until every array in ``x`` is computed; returns ``x``."""
    return jax.block_until_ready(x)


class IterationTimer:
    """Steady-state wall-clock timer for jitted functions.

    Usage::

        timer = IterationTimer(fn, make_input)   # fresh input per repeat
        stats = timer.measure(repeats=4)
        stats["seconds_per_call"], stats["calls_per_s"]
    """

    def __init__(self, fn: Callable, make_input: Callable[[int], tuple]):
        self.fn = fn
        self.make_input = make_input

    def measure(self, repeats: int = 4, warmup: int = 1) -> dict:
        for i in range(warmup):
            force_completion(self.fn(*self.make_input(-1 - i)))
        inputs = [force_completion(self.make_input(i)) for i in range(repeats)]
        t0 = time.perf_counter()
        for args in inputs:
            force_completion(self.fn(*args))
        elapsed = time.perf_counter() - t0
        per_call = elapsed / repeats
        return {
            "seconds_total": elapsed,
            "seconds_per_call": per_call,
            "calls_per_s": 1.0 / per_call if per_call > 0 else float("inf"),
            "repeats": repeats,
        }


def profile_trace(fn: Callable, *args, log_dir: str):
    """Run ``fn(*args)`` under a ``jax.profiler`` trace written to
    ``log_dir`` (viewable in TensorBoard / xprof)."""
    with jax.profiler.trace(log_dir):
        out = force_completion(fn(*args))
    return out


_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
_SCOPE = re.compile(r"admm/([a-z_0-9]+)")


def hlo_op_names(hlo_text: str) -> dict[str, str]:
    """Map each instruction name of an optimized HLO module
    (``compiled.as_text()``) to its ``op_name`` metadata."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def scope_of(op_name: str) -> str:
    """The innermost ``admm/<phase>`` scope of an ``op_name``, or
    ``"other"``."""
    found = _SCOPE.findall(op_name)
    return found[-1] if found else "other"


def latest_xplane(log_dir: str) -> str:
    paths = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return paths[-1]


def device_time_by_scope(
    xplane_path: str, op_names: dict[str, str], plane_prefix: str
) -> dict:
    """Sum the durations of the traced XLA operations per solver phase.

    Reads every event that carries an ``hlo_op`` stat on the planes whose
    name starts with ``plane_prefix`` (``"/device:GPU"`` for a GPU trace,
    ``"/host:CPU"`` for the CPU backend, where XLA runs on host threads).
    Returns ``{"scopes": {phase: ns}, "busy_ns": union of event intervals,
    "window_ns": first start to last end, "unmatched_ns": time of events
    whose instruction is not in ``op_names``, "ops": ns per instruction,
    "lines": events counted per trace line}``.
    """
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    scopes: dict[str, float] = {}
    ops: dict[str, float] = {}
    lines: dict[str, int] = {}
    intervals = []
    unmatched = 0.0
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats) if ev.stats else {}
                op = stats.get("hlo_op")
                if op is None:
                    continue
                lines[line.name] = lines.get(line.name, 0) + 1
                ops[op] = ops.get(op, 0.0) + ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if op not in op_names:
                    unmatched += ev.duration_ns
                    continue
                key = scope_of(op_names[op])
                scopes[key] = scopes.get(key, 0.0) + ev.duration_ns
    intervals.sort()
    busy, end = 0.0, None
    for s, e in intervals:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in intervals) - intervals[0][0]) if intervals else 0.0
    return {
        "scopes": scopes,
        "busy_ns": busy,
        "window_ns": window,
        "unmatched_ns": unmatched,
        "ops": ops,
        "lines": lines,
    }
