"""Solver telemetry: per-solve diagnostics + host-side aggregation (the
PyTorch port's copy of the JAX package's `runtime/telemetry.py`; a
tensor argument is read on the host).

The reference instruments every solve with status/KKT-residual/CPU-time
(acados_mpc.cpp:614-616) and ships them in CrazyflieOpenloopTraj.cpu_time;
analysis happens offline via rosbag + rqt_plot (SURVEY.md §4-5).  Here the
device side is just arrays (RTIOutput.kkt_res / qp_mu stack under scan and
vmap for free), and this module is the host-side plane: ring-buffered
per-tick records with latency percentiles and solve rates.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from crazyflie_nmpc_tpu_torch.device import host_array


class TelemetryLog:
    """Host-side rolling log of solver ticks (the rosbag-record equivalent)."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._records: list[dict] = []
        self._t0 = time.perf_counter()

    def record(self, *, kkt_res=None, qp_mu=None, wall_s=None, batch=1,
               **extra) -> None:
        rec = dict(t=time.perf_counter() - self._t0, batch=batch, **extra)
        if kkt_res is not None:
            rec["kkt_res"] = float(np.max(host_array(kkt_res)))
        if qp_mu is not None:
            rec["qp_mu"] = float(np.max(host_array(qp_mu)))
        if wall_s is not None:
            rec["wall_s"] = float(wall_s)
        self._records.append(rec)
        if len(self._records) > self.capacity:
            del self._records[: len(self._records) - self.capacity]

    def __len__(self) -> int:
        return len(self._records)

    def summary(self) -> dict:
        """Aggregate statistics: solve rate, latency percentiles, residuals."""
        if not self._records:
            return {}
        out: dict[str, Any] = dict(ticks=len(self._records))
        walls = np.array([r["wall_s"] for r in self._records
                          if "wall_s" in r])
        if walls.size:
            out["latency_ms"] = dict(
                p50=float(np.percentile(walls, 50) * 1e3),
                p95=float(np.percentile(walls, 95) * 1e3),
                p99=float(np.percentile(walls, 99) * 1e3),
                max=float(walls.max() * 1e3),
            )
            batches = np.array([r.get("batch", 1) for r in self._records
                                if "wall_s" in r])
            out["solves_per_s"] = float(np.sum(batches) / np.sum(walls))
        kkts = np.array([r["kkt_res"] for r in self._records
                         if "kkt_res" in r])
        if kkts.size:
            out["kkt_res"] = dict(mean=float(kkts.mean()),
                                  max=float(kkts.max()))
        return out
