"""utils.tracing: the device-trace reduction behind bench.py's p99 and
bench_matrix's device column (rate claims come from device traces)."""

import types

import jax
import jax.numpy as jnp
import pytest

from tpufg.utils.tracing import durations_from_planes, module_durations_ms


def _ev(name, start_us, dur_us, **stats):
    return types.SimpleNamespace(name=name, start_ns=start_us * 1000,
                                 duration_ns=dur_us * 1000,
                                 stats=list(stats.items()))


def _plane(name, *lines):
    return types.SimpleNamespace(
        name=name, lines=[types.SimpleNamespace(name=f"Stream #{i}",
                                                events=evs)
                          for i, evs in enumerate(lines)])


def _host(*modules):
    """Host plane: one ExecuteThunks event per execution of each module."""
    return _plane("/host:CPU", [_ev("GpuExecutable::ExecuteThunks", i, 1,
                                    module_name=m)
                                for i, m in enumerate(modules)])


def test_module_durations_parses_xla_modules_lane():
    """The GPU layout: kernels name their module and launch; one
    execution's launches are a consecutive run in launch order, and its
    duration is its kernels' span (over every stream)."""
    gpu = _plane(
        "/device:GPU:0",
        [_ev("fusion_a", 0, 1000, hlo_module="jit_step", correlation_id=1,
             scope_range_id=2),
         _ev("fusion_b", 1100, 3380, hlo_module="jit_step",
             correlation_id=2, scope_range_id=3),
         _ev("Memset 0", 4500, 1, correlation_id=3),          # no module
         _ev("fusion_a", 5000, 4520, hlo_module="jit_step",
             correlation_id=18, scope_range_id=20)],
        # a second stream: the second execution's copy extends its span
        [_ev("copy", 9000, 600, hlo_module="jit_step", correlation_id=19),
         _ev("fusion_c", 20000, 100, hlo_module="jit_other",
             correlation_id=40)])
    host = _host("jit_step", "jit_step", "jit_other")
    mods = durations_from_planes([host, gpu])
    assert mods["jit_step"] == [4.48, 4.6]
    assert mods["jit_other"] == [0.1]


def test_graph_launch_is_one_launch():
    """Kernels of one CUDA-graph launch share its correlation_id."""
    ev = lambda t, c: _ev("k", t, 10, hlo_module="jit_step", correlation_id=c)
    gpu = _plane("/device:GPU:0",
                 [ev(0, 5), ev(20, 5), ev(100, 9), ev(150, 9)])
    mods = durations_from_planes([_host("jit_step", "jit_step"), gpu])
    assert mods["jit_step"] == [0.03, 0.06]


def test_devices_are_kept_apart():
    ev = lambda t: _ev("k", t, 10, hlo_module="jit_step", correlation_id=1)
    mods = durations_from_planes([_host("jit_step", "jit_step"),
                                  _plane("/device:GPU:0", [ev(0)]),
                                  _plane("/device:GPU:1", [ev(5000)])])
    assert mods["jit_step"] == [0.01, 0.01]


def test_raises_without_launch_id():
    """A kernel that names its module but no launch cannot be assigned to
    an invocation: an error, not a merged span."""
    gpu = _plane("/device:GPU:0",
                 [_ev("fusion_a", 0, 10, hlo_module="jit_step",
                      scope_range_id=1)])
    with pytest.raises(RuntimeError, match="no correlation_id"):
        durations_from_planes([_host("jit_step"), gpu])


@pytest.mark.parametrize("n_exec", [0, 2])
def test_raises_when_launches_do_not_split(n_exec):
    """Three launches cannot be two equal executions, and launches with no
    host execution are not one: an error, never a guessed grouping."""
    ev = lambda t, c: _ev("k", t, 10, hlo_module="jit_step", correlation_id=c)
    gpu = _plane("/device:GPU:0", [ev(0, 1), ev(20, 2), ev(40, 3)])
    with pytest.raises(RuntimeError, match="do not split"):
        durations_from_planes([_host(*["jit_step"] * n_exec), gpu])


def test_module_durations_empty_without_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        module_durations_ms(str(tmp_path))


def test_raises_when_no_device_kernel(tmp_path):
    """A CPU-backend trace has no device plane: no fallback, an error."""
    f = jax.jit(lambda x: jnp.sin(x) * 2)
    x = jnp.ones((64, 64))
    jax.block_until_ready(f(x))
    jax.profiler.start_trace(str(tmp_path))
    jax.block_until_ready(f(x))
    jax.profiler.stop_trace()
    with pytest.raises(RuntimeError, match="no device kernel"):
        module_durations_ms(str(tmp_path))
