"""Tracing & profiling.

The reference's only introspection is per-step INFO logs and the FPS window
(SURVEY.md §5.1); this build integrates with jax.profiler: named trace
annotations around ingest / step / readback (visible in TensorBoard or
Perfetto), a context manager that captures a full device trace, and the
reduction from a trace to per-invocation device durations of each jitted
module.

Usage:
    with trace_session("/tmp/tpufg-trace"):   # or CLI --trace DIR
        ...
    with annotate("step"):
        ...
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace_session(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler trace into ``log_dir`` (no-op if None)."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span in the profiler timeline (host + device)."""
    return jax.profiler.TraceAnnotation(name)


def module_durations_ms(trace_dir: str) -> dict:
    """Per-invocation DEVICE durations (ms) of every XLA module in the
    newest jax.profiler trace under ``trace_dir``, keyed by module name.

    Reads the ``.xplane.pb`` with jax.profiler.ProfileData and reduces it
    with :func:`durations_from_planes`.  bench.py's p99,
    tools/bench_matrix.py's device column and tools/profile_step.py parse
    through here.
    """
    import glob

    files = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(sorted(files)[-1])
    return durations_from_planes(data.planes)


def durations_from_planes(planes) -> dict:
    """The reduction behind :func:`module_durations_ms`, on ProfileData
    planes (anything with ``.name``, ``.lines[].events[]`` and events'
    ``.name``/``.start_ns``/``.duration_ns``/``.stats``).

    The GPU trace layout (read on an H100): the host plane holds one
    ``GpuExecutable::ExecuteThunks`` event per execution, naming its
    module (``module_name``).  The device plane ``/device:GPU:N`` holds
    one line per stream; each kernel or copy names its module
    (``hlo_module``) and the launch it came from (``correlation_id``,
    increasing in launch order; every kernel of one CUDA-graph launch
    shares it).  Neither id marks the execution, but every execution of a
    program makes the same launches, so a module's launches on a device,
    in launch order, split into equal consecutive runs, one per execution.
    One invocation's duration is the span from its first kernel's start to
    its last kernel's end.

    Raises when no device kernel names a module (a run whose device did
    nothing, or a backend without device planes), when a module's kernels
    carry no launch id, or when a module's launches do not split evenly
    over its executions.
    """
    execs: dict = {}
    launches: dict = {}
    for plane in planes:
        on_device = plane.name.startswith("/device:")
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if not on_device:
                    if ev.name == "GpuExecutable::ExecuteThunks":
                        m = str(stats.get("module_name")).strip("'")
                        execs[m] = execs.get(m, 0) + 1
                    continue
                module = stats.get("hlo_module")
                if module is None:
                    continue
                module = str(module).strip("'")
                launch = stats.get("correlation_id")
                if launch is None:
                    raise RuntimeError(
                        f"device kernel {ev.name!r} of module {module!r} "
                        f"carries no correlation_id (stats: {sorted(stats)})")
                spans = launches.setdefault((plane.name, module), {})
                lo, hi = ev.start_ns, ev.start_ns + ev.duration_ns
                if launch in spans:
                    lo = min(lo, spans[launch][0])
                    hi = max(hi, spans[launch][1])
                spans[launch] = (lo, hi)
    if not launches:
        raise RuntimeError("trace holds no device kernel of any XLA module")
    n_dev: dict = {}
    for _, module in launches:
        n_dev[module] = n_dev.get(module, 0) + 1
    durs: dict = {}
    for (dev, module), spans in sorted(launches.items()):
        n_exec, rem = divmod(execs.get(module, 0), n_dev[module])
        if n_exec == 0 or rem or len(spans) % n_exec:
            raise RuntimeError(
                f"{module} on {dev}: {len(spans)} launches do not split "
                f"over {execs.get(module, 0)} host executions on "
                f"{n_dev[module]} device(s)")
        per = len(spans) // n_exec
        order = [spans[k] for k in sorted(spans, key=int)]
        for i in range(0, len(order), per):
            run = order[i:i + per]
            lo = min(a for a, _ in run)
            hi = max(b for _, b in run)
            durs.setdefault(module, []).append((hi - lo) / 1e6)
    return durs


@contextlib.contextmanager
def debug_checks(enabled: bool) -> Iterator[None]:
    """NaN/Inf guard for every computation in scope (jax debug_nans).

    The moral analog of the reference's Vulkan validation layers in debug
    builds (vulkan_context.hpp:51-59): heavy, off by default, catches
    silent numeric corruption at the op that produced it.
    """
    if not enabled:
        yield
        return
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
