"""The reading of a traced segment: device busy time as the union of
intervals, kernels by name, and the idle gaps named by the host span open
in their middle."""

import pytest

import tracing


def ev(name, ts, dur, cat):
    return dict(name=name, ts=ts, dur=dur, cat=cat)


EVENTS = [
    ev(tracing.WINDOW_SPAN, 0.0, 1000.0, "user_annotation"),
    ev("bench.step", 10.0, 500.0, "user_annotation"),
    ev("aten::mul", 20.0, 25.0, "cpu_op"),
    ev("void (anonymous namespace)::kkt_sweep_c2_kernel<float, float>"
       "(float const*)", 100.0, 200.0, "kernel"),
    ev("void at::native::vectorized_elementwise_kernel<4>(int)", 250.0, 100.0,
       "kernel"),
    ev("Memcpy DtoH (Device -> Pinned)", 600.0, 50.0, "gpu_memcpy"),
    ev("bench.plant", 700.0, 200.0, "user_annotation"),
    ev("outside", 2000.0, 5.0, "kernel"),
]


def test_busy_and_window():
    tr = tracing.Trace(EVENTS, ticks=1)
    assert tr.window_s == pytest.approx(1e-3)
    # [100, 350] and [600, 650]
    assert tr.busy_s == pytest.approx(300e-6)
    assert len(tr.kernels) == 2
    assert len(tr.kernels_named("kkt_sweep_c2")) == 1
    assert tr.kernels_named("kkt_sweep") == []


def test_breakdown_names_gaps_by_the_open_span():
    b = tracing.Trace(EVENTS, ticks=1).breakdown()
    assert b["device_ops"][0][0] == "void kkt_sweep_c2_kernel<float, float>"
    assert b["device_ops"][0][1] == pytest.approx(200e-6)
    gaps = dict((round(s * 1e6), n) for n, s in b["idle_gaps"])
    assert gaps[350] == "host: bench.plant"      # [650, 1000]
    assert gaps[250] == "host: bench.step"       # [350, 600]
    assert gaps[100] == "host: bench.step"       # [0, 100]: aten::mul ended


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(RuntimeError):
        tracing.Trace(EVENTS[1:], ticks=1)


def test_idle_share_is_of_the_untraced_window():
    tr = tracing.Trace(EVENTS, ticks=1)
    # 300 us busy a tick against 1.2 ms a tick untraced
    assert tr.idle_share(dict(ticks=10, seconds=0.012)) == pytest.approx(75.0)
