"""A traced stretch of a run: ``torch.profiler`` over the card (and, in a
second stretch, the host), reduced to what the per-layer metrics read.

- ``window_s``: the stretch's length on the host clock, between two
  synchronisations;
- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets; not the annotations the profiler mirrors onto the device's
  timeline) inside it, so overlapping streams count once;
- ``kernels``: device time and launches by name;
- ``gaps``: the device's idle time in the second stretch (inside the
  harness's span ``bench.window``), each idle interval named after what
  the host was doing at its midpoint (the innermost host event that spans
  it).
"""

import time

import torch
from torch.autograd import DeviceType

__all__ = ["Summary", "traced"]

WINDOW = "bench.window"
DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")


class Summary:
    """What a traced stretch showed."""

    def __init__(self, window_s, busy_s, kernels, gaps):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels  # name -> [launches, seconds]
        self.gaps = gaps        # host activity -> idle seconds

    def kernel(self, *needles):
        """``(launches, seconds)`` of the device events whose name holds
        any of ``needles``."""
        n = s = 0
        for name, (c, t) in self.kernels.items():
            if any(x in name for x in needles):
                n += c
                s += t
        return n, s

    def breakdown(self, top=10):
        def best(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best({k: v[1] for k, v in
                                    self.kernels.items()}),
                "idle_gaps": best(self.gaps)}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _device(events):
    """``(kernels, busy_ns)`` of device events ``(name, start, end)``."""
    kernels = {}
    for name, a, b in events:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-9
    busy = _union([(a, b) for _, a, b in events])
    return kernels, busy


def summarise(events):
    """Reduce kineto events (``name``, ``device``, ``start_ns``,
    ``end_ns``) to a :class:`Summary`; None without the window span."""
    window = [e for e in events if e[0] == WINDOW]
    if not window:
        return None
    w0, w1 = window[0][2], window[0][3]
    device, host = [], []
    for name, dev, a, b in events:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        (device if dev else host).append((name, a, b))
    kernels, busy = _device(device)
    host = sorted((h for h in host if h[0] != WINDOW),
                  key=lambda h: h[1])
    gaps, prev, nxt, active = {}, w0, 0, []
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            mid = (prev + a) / 2
            while nxt < len(host) and host[nxt][1] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[2] >= mid]
            label = (min(active, key=lambda h: h[2] - h[1])[0] if active
                     else "host outside any traced call")
            gaps[label] = gaps.get(label, 0.0) + (a - prev) * 1e-9
        prev = max(prev, b)
    return Summary((w1 - w0) * 1e-9, sum(b - a for a, b in busy) * 1e-9,
                   kernels, gaps)


def _events(prof):
    out = []
    for e in prof.profiler.kineto_results.events():
        host = e.device_type() == DeviceType.CPU
        if hasattr(e, "activity_type"):
            device = e.activity_type() in DEVICE_ACTIVITY
        else:  # older kineto bindings: leave out the mirrored annotations
            device = not host and not e.is_user_annotation()
        if device or host:
            out.append((e.name(), device, e.start_ns(), e.end_ns()))
    return out


def traced(fn, n, device):
    """Run ``fn(i)`` for ``i < n`` with the card's activity traced (the
    host's is not: recording every host call would slow a host-bound step
    about twofold), then ``fn(i)`` for ``n <= i < 2n`` with the host's
    activity traced too, for the idle gaps' labels. Returns the first
    stretch's results and a :class:`Summary` of the first stretch, with
    the second's gaps."""
    cuda = device.type == "cuda"
    P = torch.profiler.ProfilerActivity
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch.profiler.profile(activities=[P.CUDA] if cuda
                                else [P.CPU]) as prof:
        t0 = time.perf_counter()
        out = [fn(i) for i in range(n)]
        sync()
        window = time.perf_counter() - t0
    kernels, busy = _device([(name, a, b) for name, dev, a, b in
                             _events(prof) if dev])
    with torch.profiler.profile(activities=[P.CPU] + ([P.CUDA] if cuda
                                                      else [])) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(n, 2 * n):
                fn(i)
            sync()
    labelled = summarise(_events(prof))
    return out, Summary(window, sum(b - a for a, b in busy) * 1e-9, kernels,
                        labelled.gaps if labelled else {})
