"""The realtime swarm tick on the card: its host time, and what shares the
interpreter with it.

    python -m crazyflie_nmpc_tpu_torch.roofline.realtime_tick

`chip_smoke.py`'s realtime wire run (2 cascade-plant vehicles at 20 Hz,
80 ticks, N=20, tf=0.3, float32, IPMConfig(iters=4)) in four forms, each
with the IPM iteration's barrier algebra replayed from CUDA graphs
(`ops.ipm_fast.LoopGraphs`, as `SwarmNMPC` runs it) and issued operation
by operation, in the order graphed, op by op, op by op, graphed:

  * `SwarmNMPC.step` alone on fixed telemetry (no wire): ms a tick and
    the aten operations a tick issues;
  * the realtime run with the vehicles' serve threads in this process
    (as `chip_smoke.py` and the JAX package's test run it) and in a
    child process of their own: emit latency, schedule slips, and the
    CPU seconds of the main thread, the vehicles' threads and the link's
    threads over the run.

Runs on the CUDA device only: without one it exits 1.
"""

from __future__ import annotations

import collections
import contextlib
import multiprocessing
import os
import sys
import threading
import time

import numpy as np

RATE, TICKS = 20.0, 80
TARGETS = ((0.0, 0.0, 0.4), (0.6, 0.0, 0.4))


def thread_cpu() -> dict:
    """CPU seconds so far of each of this process's threads, by id."""
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        out[int(tid)] = ((int(fields[11]) + int(fields[12]))
                         / os.sysconf("SC_CLK_TCK"))
    return out


def _vehicles(conn):
    """A child process serving the two vehicles in real time: sends
    (port, log variables, state) of each, serves until told to stop."""
    from crazyflie_nmpc_tpu_torch import native

    with contextlib.ExitStack() as stack:
        fws = [stack.enter_context(native.CascadeFirmwareSim(
            0, x0=(t[0], t[1], 0.03))) for t in TARGETS]
        conn.send([(fw.port, fw.log_vars, fw.x.copy()) for fw in fws])
        for fw in fws:
            fw.serve()
        conn.recv()


class _Remote:
    """What `serve_swarm` reads of a vehicle served in another process
    (its port, log variables and starting state)."""

    def __init__(self, port, log_vars, x):
        self.port, self.log_vars, self.x = port, log_vars, x


def main() -> int:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from crazyflie_nmpc_tpu_torch import native
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime.swarm import (SwarmNMPC,
                                                        serve_swarm)
    from crazyflie_nmpc_tpu_torch.solver import default_ocp

    if not torch.cuda.is_available():
        print("realtime_tick: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    spec = default_ocp(N=20, tf=0.3, dtype=torch.float32, device=dev)
    targets = np.asarray(TARGETS)

    def swarm(graphed):
        sw = SwarmNMPC(spec, targets, tick_dt=1.0 / RATE,
                       ipm_config=IPMConfig(iters=4), device=dev)
        if not graphed:
            sw._loop_graphs = None          # the algebra op by op
        return sw

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    x0 = np.zeros((len(TARGETS), 13))
    x0[:, :3] = targets
    x0[:, 3] = 1.0
    tele = (x0[:, :3], np.zeros((2, 3)), np.zeros((2, 3)))

    def alone(graphed):
        sw = swarm(graphed)
        sw.reset(x0)
        sw.step(*tele)
        ts = []
        for _ in range(TICKS):
            t0 = time.perf_counter()
            sw.step(*tele)
            ts.append(time.perf_counter() - t0)
        with Count() as count:
            sw.step(*tele)
        ts = 1e3 * np.asarray(ts)
        return (f"ms a tick p50 {np.percentile(ts, 50):.3f} p90 "
                f"{np.percentile(ts, 90):.3f}; {count.n} aten operations "
                f"a tick")

    def realtime(graphed, child):
        sw = swarm(graphed)
        with contextlib.ExitStack() as stack:
            if child:
                ctx = multiprocessing.get_context("spawn")
                here, there = ctx.Pipe()
                proc = ctx.Process(target=_vehicles, args=(there,))
                proc.start()
                stack.callback(proc.join, 10)
                stack.callback(here.send, "stop")
                fws = [_Remote(*v) for v in here.recv()]
            else:
                fws = [stack.enter_context(native.CascadeFirmwareSim(
                    0, x0=(t[0], t[1], 0.03))) for t in TARGETS]
                for fw in fws:
                    fw.serve()
            vehicles = {fw._thread.native_id for fw in fws if not child}
            server = stack.enter_context(native.LinkServer())
            for i, fw in enumerate(fws):
                server.add_vehicle(i + 1, "127.0.0.1", fw.port, 0)
            before = thread_cpu()
            rep = serve_swarm(spec, server, [1, 2], fws, sw, TICKS,
                              rate_hz=RATE, lockstep=False)
            after = thread_cpu()
        cpu = collections.Counter()
        for tid, t in after.items():
            who = ("main" if tid == threading.get_native_id() else
                   "vehicles" if tid in vehicles else "other")
            cpu[who] += t - before.get(tid, 0.0)
        lat = 1e3 * rep.latency_s
        return (f"emit latency p50 {np.percentile(lat, 50):.3f} p90 "
                f"{np.percentile(lat, 90):.3f} max {lat.max():.3f} ms, "
                f"schedule slips {rep.schedule_slips}; CPU s main "
                f"{cpu['main']:.2f}, vehicles' threads "
                f"{cpu['vehicles']:.2f}, link and other threads "
                f"{cpu['other']:.2f}")

    print(f"[realtime_tick] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; {RATE:g} Hz, {TICKS} ticks, N=20 tf=0.3 "
          f"float32 IPMConfig(iters=4), 2 vehicles")
    for graphed in (True, False, False, True):
        form = "graphed" if graphed else "op by op"
        print(f"[realtime_tick] step alone, {form}: {alone(graphed)}",
              flush=True)
    for child in (False, True):
        where = "a child process" if child else "this process"
        for graphed in (True, False, False, True):
            form = "graphed" if graphed else "op by op"
            print(f"[realtime_tick] realtime, vehicles in {where}, {form}: "
                  f"{realtime(graphed, child)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
