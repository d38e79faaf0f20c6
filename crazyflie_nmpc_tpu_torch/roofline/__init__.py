"""Measurement tools of the port that run on the card (the counterparts of
the JAX package's `tools/` studies), and the yardsticks they share with
`chip_smoke.py`: the H100's published peaks, one CUDA-event timer (the
host-inclusive time of a window of calls) and one trace timer (the device
time of the kernels the calls launch, without the host's issue)."""

# H100 SXM published peaks (NVIDIA data sheet): HBM3 3.35 TB/s, fp32
# outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def time_events(fn, reps, rounds=1, warmup=1):
    """ms per call of fn on the CUDA device: `warmup` untimed calls, then
    CUDA events around `reps` calls, the median over `rounds` of the mean
    per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        torch.cuda.synchronize()
        out.append(ev0.elapsed_time(ev1) / reps)
    return sorted(out)[rounds // 2]


def traced_kernels(fn):
    """The device kernels that one call of fn ran, from a torch.profiler
    trace of it (CUPTI): a list of the trace's kernel events (dicts with
    "name", "ts" and "dur" in us); empty when the profiler records none."""
    import json
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return [e for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel" and "dur" in e]


def device_ms(fn, reps, warmup=1, kernel=None):
    """(ms per call, kernels per call) of fn on the CUDA device, from a
    torch.profiler trace of `reps` calls (after `warmup` untimed calls):
    the mean duration of a traced kernel times the kernels a call launches
    (the traced count over reps, rounded: a trace may miss a kernel at its
    edge).  `kernel`, a regular expression, keeps only the kernels whose
    name it finds.  Unlike time_events' window this leaves out the host's
    issue between launches.  (None, 0) when the trace holds too few
    kernels."""
    import re

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    kern = [e for e in traced_kernels(run)
            if kernel is None or re.search(kernel, e["name"])]
    per_call = round(len(kern) / reps)
    if not per_call:
        return None, 0
    return sum(e["dur"] for e in kern) / len(kern) * per_call / 1e3, per_call
