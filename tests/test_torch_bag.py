"""The port's flight log (`runtime.bag`) and solver telemetry
(`runtime.telemetry`) vs the JAX package's, on the CPU: a bag either
package writes, the other reads to the same bytes and values;
`record_loop_result` on a port `LoopResult` (tensors) matches JAX's on
the same arrays; `TelemetryLog` aggregates the same records (tensors on
the port's side) to the same summary."""

import io

import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.runtime import bag as jbag
from crazyflie_nmpc_tpu.runtime.closed_loop import LoopResult as JLoopResult
from crazyflie_nmpc_tpu.runtime.telemetry import TelemetryLog as JTelemetry
from crazyflie_nmpc_tpu_torch.runtime import (Bag, BagWriter, LoopResult,
                                              record_loop_result)
from crazyflie_nmpc_tpu_torch.runtime import bag as tbag
from crazyflie_nmpc_tpu_torch.runtime.telemetry import TelemetryLog
from _torch_shared import one_torch_thread  # noqa: F401


def _write(writer_cls, path):
    rng = np.random.default_rng(0)
    with writer_cls(path) as w:
        w.write_series("state", np.arange(5) * 0.015,
                       rng.standard_normal((5, 13)))
        for k in range(3):
            w.write("cmd", 0.01 * k, np.array([1.0, 2.0, k], np.float32))
        w.write("mode", 0.02, np.int32(2))


@pytest.mark.parametrize("writer, reader", [
    (BagWriter, jbag.Bag), (jbag.BagWriter, Bag)], ids=["port_to_jax",
                                                         "jax_to_port"])
def test_bags_cross_between_packages(tmp_path, writer, reader):
    a, b = tmp_path / "a.bag", tmp_path / "b.bag"
    _write(writer, a)
    _write(jbag.BagWriter if writer is BagWriter else BagWriter, b)
    assert a.read_bytes() == b.read_bytes()
    got, ref = reader(a), jbag.Bag(b)
    assert got.names() == ref.names() == ["cmd", "mode", "state"]
    for name in ref.names():
        np.testing.assert_array_equal(got[name].t, ref[name].t)
        np.testing.assert_array_equal(got[name].values, ref[name].values)
        assert got[name].values.dtype == ref[name].values.dtype
    assert got.summary() == ref.summary()
    assert [(t, n) for t, n, _ in got.play()] == [
        (t, n) for t, n, _ in ref.play()]
    csv, jcsv = io.StringIO(), io.StringIO()
    got.to_csv("state", csv)
    ref.to_csv("state", jcsv)
    assert csv.getvalue() == jcsv.getvalue()


def test_torn_tail_is_ignored(tmp_path):
    path = tmp_path / "torn.bag"
    _write(BagWriter, path)
    blob = path.read_bytes()
    path.write_bytes(blob[:-5])
    assert len(Bag(path)["mode"].t) == 0
    assert len(Bag(path)["state"].t) == 5


def test_record_loop_result_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    arrays = dict(x=rng.standard_normal((6, 13)),
                  u=rng.standard_normal((6, 4)),
                  u_cmd=rng.standard_normal((6, 4)),
                  kkt_res=rng.random(6), policy_mode=np.arange(6) % 3)
    port = LoopResult(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    ref = JLoopResult(**arrays)
    extra = {"err": rng.random(6)}
    record_loop_result(tmp_path / "p.bag", port, 0.015, t0=1.0,
                       extra={"err": torch.as_tensor(extra["err"])})
    jbag.record_loop_result(tmp_path / "j.bag", ref, 0.015, t0=1.0,
                            extra=extra)
    assert ((tmp_path / "p.bag").read_bytes()
            == (tmp_path / "j.bag").read_bytes())
    got = Bag(tmp_path / "p.bag")
    np.testing.assert_array_equal(got["motvel_cmd"].values, arrays["u_cmd"])
    np.testing.assert_allclose(got["state_estimate"].t,
                               1.0 + 0.015 * np.arange(6))


def test_ascii_plot_matches_jax():
    t = np.linspace(0, 1, 40)
    y = np.stack([np.sin(6 * t), np.cos(6 * t)], axis=1)
    assert tbag.ascii_plot(t, y, label="s") == jbag.ascii_plot(t, y,
                                                              label="s")


def test_telemetry_log_matches_jax():
    rng = np.random.default_rng(2)
    port, ref = TelemetryLog(capacity=8), JTelemetry(capacity=8)
    for k in range(12):
        kkt = rng.random(4)
        mu = rng.random(4)
        wall = 0.001 * (k + 1)
        port.record(kkt_res=torch.as_tensor(kkt), qp_mu=torch.as_tensor(mu),
                    wall_s=wall, batch=4, tick=k)
        ref.record(kkt_res=kkt, qp_mu=mu, wall_s=wall, batch=4, tick=k)
    assert len(port) == len(ref) == 8
    assert port.summary() == ref.summary()
    assert [r["kkt_res"] for r in port._records] == [
        r["kkt_res"] for r in ref._records]
    assert TelemetryLog().summary() == {}
