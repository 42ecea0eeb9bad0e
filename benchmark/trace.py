"""The device trace of a steady sub-window, and what it shows.

`device_trace` is torch.profiler over the device's activity only, the
device synchronized and idle for MARGIN_S after the trace starts and
again before it stops: the profiler drops a device record that its clock
places outside the trace's window, and a trace stopped as soon as a CUDA
graph's replay returned has lost the run's last kernels. The host is not
traced, so the host's pace in the traced clips is the untraced one.

`summary` reads the trace's raw events (building the profiler's event
tree takes seconds for a trace of this size): each kernel's name, start
and length.
"""

from __future__ import annotations

import contextlib
import re
import time

MARGIN_S = 0.05
# each launch counter of the program's kernel wrappers and its kernel's
# symbol in a trace (K1 over a bf16 volume is an instance of K1 bf16's)
KERNELS = {
    "corr_pyramid_build": "corr_pyramid_build_kernel",
    "corr_lookup_moenc": "corr_lookup_moenc_kernel",
    "corr_lookup": "corr_lookup_kernel",
    "modulated_deform_conv2d": "deform_conv_kernel",
    "flash_window_attention": "window_attention_kernel",
    "sparse_window_attention": "sparse_window_attention_kernel",
    "corr_pyramid_build_bf16": "corr_pyramid_build_bf16_kernel",
    "corr_lookup_moenc_bf16": "corr_lookup_moenc_bf16_kernel",
    "modulated_deform_conv2d_bf16": "deform_conv_bf16_kernel",
    "flash_window_attention_bf16": "window_attention_bf16_kernel",
    "sparse_window_attention_bf16": "sparse_window_attention_bf16_kernel",
    "corr_lookup_bf16": "corr_lookup_bf16_kernel",
    "corr_lookup_moenc_bf16_volume": "corr_lookup_moenc_bf16_kernel",
}


@contextlib.contextmanager
def device_trace():
    """torch.profiler over the block, the device's activity only, with
    MARGIN_S of idle device at each edge."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)


def events(prof) -> list:
    """[(name, start_ns, duration_ns)] of every device record (kernels,
    copies, fills), by start."""
    from torch.autograd import DeviceType

    out = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return sorted(out, key=lambda r: r[1])


def busy_ns(evs: list) -> int:
    """The length of the union of the records' intervals."""
    total, end = 0, None
    for _, s, d in evs:
        e = s + d
        if end is None or s >= end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def kernel_counts(evs: list) -> dict:
    """Records of each launch counter's kernel symbol (whole-word match:
    `window_attention_kernel` does not count the sparse one)."""
    out = {}
    for counter, sym in KERNELS.items():
        pat = re.compile(rf"\b{sym}\b")
        out[counter] = sum(1 for name, _, _ in evs if pat.search(name))
    return out


def held_counts(launches: dict) -> dict:
    """Launch counts as a trace can show them: the counters whose kernels
    share a symbol summed under each counter of that symbol."""
    by_sym: dict = {}
    for counter, n in launches.items():
        sym = KERNELS.get(counter)
        if sym is not None:
            by_sym[sym] = by_sym.get(sym, 0) + n
    return {c: by_sym.get(KERNELS[c], 0) for c in KERNELS}


def breakdown(evs: list, top: int = 10) -> dict:
    """{'device_ops': [[name, s]] the most device time by name,
    'idle_gaps': [[label, s]] the longest gaps between records, each
    labelled by the record it waited for}."""
    by_name: dict = {}
    for name, _, d in evs:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda r: -r[1])[:top]
    gaps, end = [], None
    for name, s, d in evs:
        if end is not None and s > end:
            gaps.append((f"before {name[:80]}", (s - end) / 1e9))
        end = s + d if end is None else max(end, s + d)
    gaps.sort(key=lambda r: -r[1])
    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
