"""Measurement tools of the port that run on the card (the counterparts of
the JAX package's `tools/` studies), and the yardsticks they share with
`chip_smoke.py`: the H100's published peaks and one CUDA-event timer."""

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
