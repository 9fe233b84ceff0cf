"""The traced part of a window, read from ``torch.profiler``'s device and host
events: device busy time, idle gaps named by what the host was doing,
device time by kernel, and the hand-written kernels told apart by name.

The port's attention kernels share one template,
``flash_sm90_kernel<NB, NWG, PIPE, RESIDENT, QSLOTS, PV8, QK8>``: QK8 is
the int8 QK^T kernel, PV8 the int8 P.V kernel, PIPE the pipelined one, two
query slots the cross-attention kernel, any other the self-attention
kernel. cuDNN's layout conversions are its ``nchwToNhwc`` / ``nhwcToNchw``
kernels.
"""

from __future__ import annotations

import dataclasses
import re

SPAN_PREFIX = "pfdbench."
_TEMPLATE = re.compile(r"flash_sm90_kernel<([^>]*)>")
_LAYOUT = re.compile(r"nchwtonhwc|nhwctonchw", re.IGNORECASE)


def _template_args(name):
    m = _TEMPLATE.search(name)
    if m:
        return [a.strip() for a in m.group(1).split(",")]
    i = name.find("flash_sm90_kernelI")
    if i >= 0:  # mangled: template arguments Li<n>E (int) and Lb<0|1>E (bool)
        return [("true" if v == "1" else "false") if t == "b" else v
                for t, v in re.findall(r"L([ib])(\d+)E", name[i:])[:7]]
    return None


def kernel_class(name):
    """The hand-written kernel (the name of its wrapper) or "layout" that a
    device event's name belongs to; None for any other."""
    if "conv_int8_kernel" in name:
        return "conv_int8"
    if "flash_sm90_kernel" in name:
        args = _template_args(name)
        if not args or len(args) < 7:
            return "flash_unparsed"
        pipe, qslots, pv8, qk8 = args[2], args[4], args[5], args[6]
        if qk8 == "true":
            return "flash_attention_int8"
        if pv8 == "true":
            return "flash_attention_pv8"
        if pipe == "true":
            return "flash_attention_pipe"
        return "cross_attention" if qslots == "2" else "flash_attention"
    if _LAYOUT.search(name):
        return "layout"
    return None


@dataclasses.dataclass
class Trace:
    """Events in microseconds of one clock: ``device`` [(name, start, end)]
    sorted by start, ``host`` [(name, start, end)], ``requests`` the traced
    requests' (start, end) spans, ``window`` (start, end)."""
    device: list
    host: list
    requests: list
    window: tuple

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self, t0=None, t1=None):
        """[(start, end)] of the union of device activity within [t0, t1]."""
        t0 = self.window[0] if t0 is None else t0
        t1 = self.window[1] if t1 is None else t1
        out = []
        for _, s, e in self.device:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self, t0=None, t1=None):
        return sum(e - s for s, e in self.busy(t0, t1)) / 1e6

    def idle_gaps(self, t0=None, t1=None):
        """[(start, end)] of the device's idle intervals within [t0, t1]."""
        t0 = self.window[0] if t0 is None else t0
        t1 = self.window[1] if t1 is None else t1
        gaps, cur = [], t0
        for s, e in self.busy(t0, t1):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if t1 > cur:
            gaps.append((cur, t1))
        return gaps

    def by_class(self):
        """{kernel class: (device seconds, launches)}."""
        out = {}
        for name, s, e in self.device:
            k = kernel_class(name)
            if k is None:
                continue
            t, n = out.get(k, (0.0, 0))
            out[k] = (t + (e - s) / 1e6, n + 1)
        return out

    def host_activity(self, t):
        """What the host was doing at time t: the innermost benchmark span
        and the innermost other host event covering t."""
        span, op = None, None
        for name, s, e in self.host:
            if s <= t < e:
                if name.startswith(SPAN_PREFIX):
                    if span is None or s >= span[1]:
                        span = (name[len(SPAN_PREFIX):], s)
                elif op is None or s >= op[1]:
                    op = (name, s)
        parts = [p[0] for p in (span, op) if p is not None]
        return "/".join(parts) or "none"

    def breakdown(self, top=10):
        """{"device_ops": the device operations that took most time, by
        name, "idle_gaps": the longest idle gaps by what the host was doing}."""
        ops = {}
        for name, s, e in self.device:
            key = name[:160]
            ops[key] = ops.get(key, 0.0) + (e - s) / 1e6
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
                "idle_gaps": [[self.host_activity((s + e) / 2), (e - s) / 1e6] for s, e in gaps]}


def from_profiler(prof, requests, window):
    """A ``Trace`` from a stopped ``torch.profiler.profile``. The profiler
    copies each user annotation (the benchmark's spans, ``torch.optim``'s and
    ``torch.distributed``'s records) onto the device's timeline, where it
    would read as device activity over all it spans, gaps included: those
    copies are left out."""
    device, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        rec = (ev.name, float(tr.start), float(tr.end))
        if ev.device_type.name != "CUDA":
            host.append(rec)
        elif not (getattr(ev, "is_user_annotation", False) or ev.name.startswith(SPAN_PREFIX)):
            device.append(rec)
    device.sort(key=lambda r: r[1])
    return Trace(device, host, list(requests), tuple(window))


def spans_of(host, name):
    """(start, end) of each host span ``SPAN_PREFIX + name``, in order."""
    return sorted((s, e) for n, s, e in host if n == SPAN_PREFIX + name)

