"""The traced run's reading of ``torch.profiler``: the card's events
(kernels, copies, memsets) in start order, the union of their intervals
(the busy time, overlapping events counted once), the operations that
took most device time, and the longest idle gaps with what the host was
doing in each."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def profiled(device):
    """Profile the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def events(prof):
    """(device events, host events): (name, start us, end us) each, in
    start order."""
    import torch

    dev, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(item)
        else:
            host.append(item)
    dev.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return dev, host


def busy_us(dev):
    """Microseconds in which some device event ran: the union of the
    intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_us(dev, match):
    """Total device microseconds and count of the events whose name
    contains ``match``."""
    hits = [e - s for name, s, e in dev if match in name]
    return sum(hits), len(hits)


def top_ops(dev, n=10):
    """[name, seconds] of the ``n`` device operations with the most time."""
    by = {}
    for name, s, e in dev:
        by[name] = by.get(name, 0.0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us * 1e-6] for name, us in top]


def idle_gaps(dev, host, t0_us, t1_us, n=10):
    """[what the host was doing, seconds] of the ``n`` longest stretches of
    the traced window in which no device event ran; the host's activity is
    the innermost host event at the gap's middle, with the device events
    on either side."""
    gaps, prev_end, prev_name = [], t0_us, "window start"
    for name, s, e in dev:
        if s > prev_end:
            gaps.append((s - prev_end, prev_end, s, prev_name, name))
        if e > prev_end:
            prev_end, prev_name = e, name
    if t1_us > prev_end:
        gaps.append((t1_us - prev_end, prev_end, t1_us, prev_name,
                     "window end"))
    gaps.sort(reverse=True)
    out = []
    for us, s, e, before, after in gaps[:n]:
        mid = 0.5 * (s + e)
        inner = None
        for name, hs, he in host:
            if hs > mid:
                break
            if he >= mid:
                inner = name
        what = (f"host {inner or 'python'} | after {before[:40]} before "
                f"{after[:40]}")
        out.append([what, us * 1e-6])
    return out
