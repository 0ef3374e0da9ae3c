"""The reduction of one torch.profiler session (CPU and CUDA activities, one
whole 100-step batch of the driver with its checkpoint) into what the
per-layer metrics read: the device's kernel, memcpy and memset intervals,
their union (busy time), the runtime's kernel launches, the device time of
each kernel name, and the driver phases the harness marked with
record_function spans ("nkbench.<phase>").

A reworked copy of the busy-share arithmetic of scripts/torch_profile_step.py:
the busy time is the UNION of the device intervals over the traced window
(overlapping kernels count once), not the sum of their times.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PHASE_PREFIX = "nkbench."
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def kernel_name(key: str) -> str:
    """A profiler kernel key without return type, namespaces, template
    arguments and parameters: 'void (anonymous namespace)::mega_lanes<...>(...)'
    -> 'mega_lanes'."""
    k = key.replace("(anonymous namespace)::", "")
    k = k[5:] if k.startswith("void ") else k
    k = k.split("<")[0].split("(")[0]
    return k.rsplit("::", 1)[-1].strip()


@dataclass
class Trace:
    window_us: tuple[float, float]  # the traced window on the profiler's clock
    device: list = field(default_factory=list)  # (start_us, end_us, name) sorted by start
    cpu: list = field(default_factory=list)  # (start_us, end_us, name) of host ops
    phases: list = field(default_factory=list)  # (start_us, end_us, phase)
    launches: int = 0  # runtime kernel launches in the window
    steps: int = 0  # driver steps in the window

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device intervals, clipped to the window."""
        lo, hi = self.window_us
        out: list[list[float]] = []
        for s, e, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_seconds_by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for s, e, n in self.device:
            out[n] = out.get(n, 0.0) + (e - s) * 1e-6
        return out

    def owned_kernels(self, owners: dict[str, str]) -> dict[str, float]:
        """Device seconds by owner. `owners` maps a kernel name to the op
        that launches it; a kernel name that several ops launch (None in
        the map, e.g. a shared scan) goes to the owner of the kernel just
        before it on the device, since one call's kernels run back to
        back in one stream."""
        out: dict[str, float] = {}
        last = None
        for s, e, n in self.device:
            if n in owners:
                own = owners[n]
                if own is None:
                    own = last
                else:
                    last = own
                if own is not None:
                    out[own] = out.get(own, 0.0) + (e - s) * 1e-6
            elif not n.startswith(("Memcpy", "Memset")):
                last = None
        return out

    def phase_at(self, t_us: float) -> str:
        for s, e, p in self.phases:
            if s <= t_us <= e:
                return p
        return "between phases"

    def host_op_at(self, t_us: float) -> str | None:
        """The shortest host op that spans t (the innermost one)."""
        best = None
        for s, e, n in self.cpu:
            if s <= t_us <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return None if best is None else best[2]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest idle gaps of the device in the window, each named by
        the driver phase and the host op under its middle."""
        lo, hi = self.window_us
        gaps, prev = [], lo
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            op = self.host_op_at(mid)
            label = self.phase_at(mid) + (f"/{op}" if op else "")
            out.append([label, (e - s) * 1e-6])
        return out

    def top_device_ops(self, top: int = 10) -> list[list]:
        items = sorted(self.device_seconds_by_name().items(), key=lambda kv: -kv[1])
        return [[n, s] for n, s in items[:top]]


def _fields(ev):
    """(name, is_device, start_us, end_us) of one kineto event, across the
    accessor names of torch versions."""
    name = ev.name()
    dev = str(ev.device_type()).rsplit(".", 1)[-1].upper() == "CUDA"
    if hasattr(ev, "start_ns"):
        s = ev.start_ns() * 1e-3
        d = ev.duration_ns() * 1e-3
    else:
        s = float(ev.start_us())
        d = float(ev.duration_us())
    return name, dev, s, s + d


def _raw_events(prof):
    """Every event of a finished profiler session as (name, is_device,
    start_us, end_us)."""
    try:
        return [_fields(ev) for ev in prof.profiler.kineto_results.events()]
    except AttributeError:
        out = []
        for ev in prof.events():
            dev = str(ev.device_type).rsplit(".", 1)[-1].upper() == "CUDA"
            out.append((ev.name, dev, ev.time_range.start, ev.time_range.end))
        return out


def reduce_session(prof, steps: int) -> Trace:
    """A Trace of the session. Its window runs from the start of the first
    phase span to the end of the last one."""
    dev, cpu, phases, launches = [], [], [], 0
    for name, is_dev, s, e in _raw_events(prof):
        if is_dev:
            if not name.startswith(PHASE_PREFIX):  # a span's device-side copy
                dev.append((s, e, kernel_name(name)))
        elif name.startswith(PHASE_PREFIX):
            phases.append((s, e, name[len(PHASE_PREFIX):]))
        else:
            if name in LAUNCH_NAMES:
                launches += 1
            cpu.append((s, e, name))
    dev.sort()
    phases.sort()
    if phases:
        window = (phases[0][0], max(e for _, e, _ in phases))
    elif dev:
        window = (dev[0][0], max(e for _, e, _ in dev))
    else:
        window = (0.0, 0.0)
    return Trace(window_us=window, device=dev, cpu=cpu, phases=phases,
                 launches=launches, steps=steps)
