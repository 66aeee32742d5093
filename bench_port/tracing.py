"""What the traced run reads: aten calls, device intervals, kernel launches.

* `aten_ops(fn)`: fn's aten operator calls, counted by a TorchDispatchMode
  (a frozen copy of chip_smoke.aten_ops).  This is the dispatch level;
  torch.profiler counts more events per step (it also records the calls
  that an operator makes of others), so the two are not compared.
* `device_events(prof)` and `reduce_device(events, window_s)`: the kernels,
  copies and fills of a torch.profiler run with CUDA activity alone (no CPU
  operator events, so the host pays next to nothing for the trace), as
  (start_ns, duration_ns, name), reduced to the busy time (the union of
  the intervals), the time and count per name, and the longest idle gaps.
* `LaunchRecorder`: while on, records every K1 and K2 launch's lanes and
  every K4 launch's lanes and operand bytes, by wrapping the port's launch
  wrappers where their callers look them up.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

Event = Tuple[int, int, str]


def aten_ops(fn):
    """(fn(), the aten operator calls fn made)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Counter() as counter:
        out = fn()
    return out, counter.n


def device_events(prof) -> List[Event]:
    """The device-side events of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
        dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)
        out.append((int(start), int(dur), e.name()))
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, cut to `width`."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    if head.startswith("void "):
        head = head[5:]
    return head[:width]


def reduce_device(events: Sequence[Event], window_s: float, top: int = 10) -> Dict:
    """busy_s (the union of the device intervals), per-name seconds and
    counts, the `top` names by time and the `top` longest idle gaps between
    device intervals, each named by the operation that ended it."""
    ev = sorted(events)
    busy_ns, per_s, per_n, gaps = 0, {}, {}, []
    cur_start = cur_end = None
    for start, dur, name in ev:
        per_s[name] = per_s.get(name, 0) + dur
        per_n[name] = per_n.get(name, 0) + 1
        end = start + dur
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy_ns += cur_end - cur_start
            gaps.append((start - cur_end, name))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_ns += cur_end - cur_start
    by_time = sorted(per_s.items(), key=lambda kv: -kv[1])[:top]
    gaps.sort(key=lambda g: -g[0])
    return {
        "window_s": window_s,
        "busy_s": busy_ns / 1e9,
        "span_s": (ev[-1][0] + ev[-1][1] - ev[0][0]) / 1e9 if ev else 0.0,
        "kernel_s": {k: v / 1e9 for k, v in per_s.items()},
        "kernel_n": per_n,
        "device_ops": [[short_name(k), v / 1e9] for k, v in by_time],
        "idle_gaps": [["before " + short_name(name), g / 1e9] for g, name in gaps[:top]],
    }


def kernel_time(trace: Dict, *markers: str) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose name holds every
    one of the markers."""
    s = n = 0
    for name, t in trace["kernel_s"].items():
        if all(m in name for m in markers):
            s += t
            n += trace["kernel_n"][name]
    return s, n


def _own_bytes(t) -> int:
    """Bytes a tensor's elements occupy, an axis of stride 0 counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class Tracer:
    """The traced run's profile: torch.profiler with CUDA activity alone
    over the profiled iterations, and the launches recorded there."""

    def __init__(self, sync):
        self.sync = sync
        self.recorder = LaunchRecorder()
        self.recorder.install()
        self.prof = None
        self.window_s = None

    @contextlib.contextmanager
    def iteration(self, first: bool, last: bool):
        import time

        import torch

        if first:
            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.sync()
            self.t0 = time.perf_counter()
        with self.recorder.recording():
            yield
        if last:
            self.sync()
            self.window_s = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            self.recorder.uninstall()

    def reduced(self) -> Dict:
        return reduce_device(device_events(self.prof), self.window_s)


class LaunchRecorder:
    """Records K1, K2 and K4 launches while `on`: K1 and K2 as (lanes,
    bases), K4 as (lanes, operand and output bytes, p, L)."""

    def __init__(self):
        self.on = False
        self.launches: Dict[str, List] = {"rns_fold_window": [], "rns_fold_window_g2": [], "mont_mul": []}
        self._undo = []

    def install(self) -> None:
        from bellman_mpc_tpu_torch.fields import limb
        from bellman_mpc_tpu_torch.ops import fold_kernels

        def fold(name, fn):
            def wrapped(f, b3, acc_res, q, sgn, tab_bound, cap):
                if self.on:
                    self.launches[name].append((int(sgn.numel()), int(sgn.shape[-1])))
                return fn(f, b3, acc_res, q, sgn, tab_bound, cap)
            return wrapped

        k4 = limb.mont_mul

        def mont_mul(field, a, b):
            out = k4(field, a, b)
            if self.on and out.is_cuda and out.numel():
                self.launches["mont_mul"].append(
                    (out.numel() // field.L, _own_bytes(a) + _own_bytes(b) + _own_bytes(out), field.p, field.L))
            return out

        for mod, name, new in ((fold_kernels, "rns_fold_window", fold("rns_fold_window", fold_kernels.rns_fold_window)),
                               (fold_kernels, "rns_fold_window_g2",
                                fold("rns_fold_window_g2", fold_kernels.rns_fold_window_g2)),
                               (limb, "mont_mul", mont_mul)):
            self._undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, new)

    def uninstall(self) -> None:
        for mod, name, old in reversed(self._undo):
            setattr(mod, name, old)
        self._undo.clear()

    @contextlib.contextmanager
    def recording(self):
        self.on = True
        try:
            yield
        finally:
            self.on = False
