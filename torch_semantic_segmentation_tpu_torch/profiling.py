"""Tracing and timing of the port (the JAX package's `profiling.py`).

- `trace(logdir)`: `torch.profiler` over the CPU and, where there is a
  card, CUDA, written as a Chrome trace into `logdir` (chrome://tracing or
  Perfetto read it; the card's machine has no TensorBoard plugin).
- `sync(x)`: wait for the card by fetching one scalar's value.
- `Walltime` and `measure(step_fn, *args, steps, warmup)`: the time of a
  step. The port's steps update their state in place, so `measure` calls
  `step_fn(*args)` again and again. On the card it reads CUDA events
  around the timed steps: the host only enqueues the work, and its clock
  stops long before the card does. On the CPU, `time.perf_counter`.
- `memory_stats()`: the caching allocator's live and peak bytes and the
  card's memory, or None on the CPU.
- `cost_analysis(fn, *args)`: flops, bytes and transcendentals of the ATen
  operations `fn` dispatches (`torch.utils.flop_counter`'s formulas).

The JAX package's `dump_hlo` has no counterpart: an eager program has no
compiled text.
"""

from __future__ import annotations

import contextlib
import os
import time
import typing as tp

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@contextlib.contextmanager
def trace(logdir: str):
    """`with trace(logdir) as path: run_steps()`: profile the block and
    write its Chrome trace to `path` in `logdir` when the block ends."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def sync(tree: tp.Any) -> float:
    """Wait for the work that produced `tree` by fetching one scalar's
    value (the first element of its first tensor). Returns it."""
    return float(_tensors(tree)[0].detach().reshape(-1)[0])


class Walltime:
    """Step timing on the host's clock: `with Walltime(n) as w: ...`, then
    `w.seconds_per_step`."""

    def __init__(self, steps: int):
        self.steps = steps
        self.seconds_per_step = float("nan")

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds_per_step = (time.perf_counter() - self._t0) / self.steps
        return False


def _on_card(*trees) -> bool:
    return any(t.is_cuda for tree in trees for t in _tensors(tree))


def measure(step_fn: tp.Callable, *args, steps: int = 20,
            warmup: int = 1) -> tuple[float, tp.Any]:
    """Seconds a call of `step_fn(*args)`, over `steps` calls after
    `warmup` ones; returns (seconds_per_step, the last call's result).
    Where the arguments or the result hold a CUDA tensor, the time is the
    card's, between CUDA events recorded before the first and after the
    last timed call; otherwise the host's."""
    out = None
    for _ in range(warmup):
        out = step_fn(*args)
    if _on_card(args, out):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            out = step_fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / steps, out
    with Walltime(steps) as w:
        for _ in range(steps):
            out = step_fn(*args)
    return w.seconds_per_step, out


def memory_stats() -> dict[str, int] | None:
    """Live and peak bytes of the caching allocator on the current card and
    the card's memory, as the JAX package names them: `bytes_in_use`,
    `peak_bytes_in_use` (`torch.cuda.max_memory_allocated`) and
    `bytes_limit`. None on the CPU."""
    if not torch.cuda.is_available():
        return None
    st = torch.cuda.memory_stats()
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory)}


def launch_counts() -> dict[str, int]:
    """Every hand-written kernel's launches so far, by the names of
    `chip_smoke.py`'s kernels line."""
    from torch_semantic_segmentation_tpu_torch.ops import (
        depthwise, mbconv, resize_ce, sepconv, upsample_concat)
    wrappers = {
        "sepconv": sepconv.fused_separable_conv,
        "resize_ce_fwd": resize_ce.resize_ce_forward,
        "resize_ce_bwd": resize_ce.resize_ce_backward,
        "mbconv_fwd": mbconv.expand_dw_forward,
        "mbconv_bwd": mbconv.expand_dw_backward,
        "depthwise_fwd": depthwise.depthwise3x3_forward,
        "depthwise_bwd": depthwise.depthwise3x3_backward,
        "upsample_concat": upsample_concat.upsample_concat_forward,
        "resize_ce_map_fwd": resize_ce.resize_ce_map_forward,
        "resize_ce_map_bwd": resize_ce.resize_ce_map_backward,
    }
    return {k: f.launches for k, f in wrappers.items()}


_TRANSCENDENTAL = frozenset(f"aten.{op}" for op in (
    "exp", "exp_", "log", "log_", "tanh", "tanh_", "rsqrt", "rsqrt_"))
# factories whose output nothing has written yet
UNWRITTEN_OPS = ("aten::empty", "aten::new_empty", "aten::resize_",
                 "aten::set_")


class _CostMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in self.registry:
            self.flops += float(self.registry[packet](*args, **kwargs,
                                                      out_val=out))
        name = func._schema.name
        if not func.is_view and not name.startswith(UNWRITTEN_OPS):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs, out)))
        if str(packet) in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        return out


def cost_analysis(fn: tp.Callable, *args, **kwargs) -> dict[str, float]:
    """Flops, bytes and transcendentals of one call of `fn(*args,
    **kwargs)`, counted over the ATen operations it dispatches, its
    backward included: flops by `torch.utils.flop_counter`'s formulas
    (matrix products, convolutions, attention), bytes as each operation's
    inputs plus outputs (views move none), transcendentals as the elements
    out of exp, log, tanh and rsqrt.

    The hand-written kernels run through ctypes, where no dispatch mode
    sees them, so their work is left out, as XLA's count leaves out the
    JAX package's Pallas calls; `kernel_launches` gives the launches the
    call made, so the omission shows. On the CPU the kernels' plain
    versions are ATen operations and are counted."""
    before = launch_counts()
    mode = _CostMode()
    with mode:
        fn(*args, **kwargs)
    after = launch_counts()
    return {"flops": mode.flops, "bytes_accessed": mode.bytes,
            "transcendentals": mode.transcendentals,
            "kernel_launches": {k: after[k] - before[k] for k in after
                                if after[k] != before[k]}}
