"""Command-line tools — the crazyflie_tools equivalents (PyTorch
counterpart of `tools.py`).

The reference ships CLI utilities to scan for vehicles and inspect
log/param variables (whoenig/crazyflie_tools, SURVEY.md §2.3).  The
link-layer here is UDP, so `scan` probes a port range with CRTP pings and
reports responding endpoints; `console` attaches to a vehicle and streams
decoded log records; `fly` runs a closed-loop simulation from a config
file and writes the flown trajectory, on the card unless `--device cpu`.

Usage:
  python -m crazyflie_nmpc_tpu_torch.tools scan --host 127.0.0.1 --ports 47000-47010
  python -m crazyflie_nmpc_tpu_torch.tools console --peer-port 47001
  python -m crazyflie_nmpc_tpu_torch.tools fly --traj helix --out flight.txt
"""

from __future__ import annotations

import argparse
import socket
import sys
import time


def cmd_scan(args) -> int:
    """Probe UDP ports with a CRTP ping; report endpoints that answer."""
    from crazyflie_nmpc_tpu_torch.native import load_library  # builds lazily

    load_library()
    lo, hi = (int(x) for x in args.ports.split("-"))
    found = []
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(args.timeout)
    ping = bytes([0xF3])  # CRTP port 15 ch 3
    for port in range(lo, hi + 1):
        try:
            sock.sendto(ping, (args.host, port))
            data, addr = sock.recvfrom(64)
            found.append((port, len(data)))
            print(f"uri udp://{args.host}:{port}  (answered {len(data)}B)")
        except socket.timeout:
            continue
        except OSError:
            continue
    sock.close()
    if not found:
        print("no vehicles found", file=sys.stderr)
    return 0


def cmd_console(args) -> int:
    """Attach a link server to a peer and stream decoded log records."""
    from crazyflie_nmpc_tpu_torch.native import LinkServer

    with LinkServer() as server:
        server.add_vehicle(0, args.host, args.peer_port, args.local_port)
        print(f"listening for log data from {args.host}:{args.peer_port} "
              f"(ctrl-c to stop)")
        try:
            deadline = (time.time() + args.duration
                        if args.duration else None)
            while deadline is None or time.time() < deadline:
                rec = server.poll_log(0)
                if rec is None:
                    time.sleep(0.005)
                    continue
                print(f"[{rec['timestamp_ms']:>10} ms] block "
                      f"{rec['block_id']}: {rec['payload'].hex()}")
        except KeyboardInterrupt:
            pass
        stats = server.stats(0)
        print(f"link stats: {stats}", file=sys.stderr)
    return 0


def cmd_imu(args) -> int:
    """IMU echo — the reference's crazyflie_imu.cpp debug node: subscribe
    to the gyro/accel stream and pretty-print it (crazyflie_imu.cpp:54-67).
    Here: create + start a 6-float imu log block, decode and print."""
    import struct

    from crazyflie_nmpc_tpu_torch.native import LinkServer

    with LinkServer() as server:
        server.add_vehicle(0, args.host, args.peer_port, args.local_port)
        # imu block: gyro.xyz + acc.xyz as floats (ids per the firmware-sim
        # default TOC; a real TOC download would resolve names → ids)
        variables = [(7, i) for i in range(6)]
        server.log_create_block(0, args.block_id, variables)
        server.log_start_block(0, args.block_id, args.period_10ms)
        print(f"imu echo from {args.host}:{args.peer_port} (ctrl-c stops)")
        try:
            deadline = (time.time() + args.duration
                        if args.duration else None)
            while deadline is None or time.time() < deadline:
                rec = server.poll_log(0)
                if rec is None or rec["block_id"] != args.block_id:
                    time.sleep(0.002)
                    continue
                if len(rec["payload"]) >= 24:
                    gx, gy, gz, ax, ay, az = struct.unpack(
                        "<6f", rec["payload"][:24])
                    print(f"[{rec['timestamp_ms']:>10} ms] "
                          f"gyro [deg/s]: {gx:+8.3f} {gy:+8.3f} {gz:+8.3f}"
                          f"   acc [g]: {ax:+7.4f} {ay:+7.4f} {az:+7.4f}")
        except KeyboardInterrupt:
            pass
        server.log_stop_block(0, args.block_id)
    return 0


def cmd_toc(args) -> int:
    """List the vehicle's param and log tables-of-contents — the
    crazyflie_tools listParams/listLogVariables equivalents."""
    from crazyflie_nmpc_tpu_torch.native import LinkServer

    type_names = {0x00: "uint8", 0x01: "uint16", 0x02: "uint32",
                  0x04: "int8", 0x05: "int16", 0x06: "int32",
                  0x08: "float", 1: "uint8", 2: "uint16", 3: "uint32",
                  7: "float"}
    with LinkServer() as server:
        server.add_vehicle(0, args.host, args.peer_port, args.local_port)
        params = server.download_param_toc(0)
        logs = server.download_log_toc(0)
        print(f"parameters ({len(params)}):")
        for name, (pid, tb) in sorted(params.items()):
            print(f"  [{pid:3d}] {name:<32s} {type_names.get(tb, hex(tb))}")
        print(f"log variables ({len(logs)}):")
        for name, (vid, tb) in sorted(logs.items()):
            print(f"  [{vid:3d}] {name:<32s} {type_names.get(tb, hex(tb))}")
    return 0


def cmd_fly(args) -> int:
    """Run a closed-loop simulated flight and write the 17-col result, in
    float64 on `--device` (default the card)."""
    import numpy as np
    import torch

    from crazyflie_nmpc_tpu_torch.device import host_array, resolve_device
    from crazyflie_nmpc_tpu_torch.models import hover_state
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime import (
        LoopConfig,
        hover_regulation,
        trajectory_tracking,
    )
    from crazyflie_nmpc_tpu_torch.solver import default_ocp
    from crazyflie_nmpc_tpu_torch.utils import (
        helix_trajectory,
        load_traj_txt,
        save_traj_txt,
        smooth_step_trajectory,
    )

    dev = resolve_device(args.device)
    f64 = torch.float64
    spec = default_ocp(dtype=f64, device=dev)
    cfg = LoopConfig(delay_steps=args.delay_steps,
                     ipm=IPMConfig(iters=args.ipm_iters))
    if args.traj == "hover":
        x0 = hover_state(spec.params, pos=(0.3, -0.2, 0.1), dtype=f64,
                         device=dev)
        res = hover_regulation(spec, x0, steps=args.steps, config=cfg)
        ref_desc = "hover(0,0,0.5)"
    else:
        if args.traj == "helix":
            table = helix_trajectory(spec.params, dtype=f64, device=dev)
        elif args.traj == "step":
            table = smooth_step_trajectory(spec.params, dtype=f64,
                                           device=dev)
        else:
            table = torch.as_tensor(load_traj_txt(args.traj), dtype=f64,
                                    device=dev)
        x0 = table[0, :13]
        steps = min(args.steps, table.shape[0] - 1)
        res = trajectory_tracking(spec, x0, table, steps=steps, config=cfg)
        ref_desc = args.traj
    out = np.concatenate([host_array(res.x), host_array(res.u)], axis=1)
    save_traj_txt(args.out, out)
    if args.bag:
        from crazyflie_nmpc_tpu_torch.runtime.bag import record_loop_result

        record_loop_result(args.bag, res, dt=float(spec.dt))
        print(f"recorded flight bag: {args.bag}")
    print(f"flew {out.shape[0]} ticks of {ref_desc} on {dev}; "
          f"wrote {args.out}")
    print(f"max |kkt|: {float(np.max(host_array(res.kkt_res))):.2e}")
    return 0


def cmd_bag(args) -> int:
    """Inspect / export / replay a flight bag — the bag_play + rqt_plot
    workflow of the reference (SURVEY.md §4), headless."""
    import numpy as np

    from crazyflie_nmpc_tpu_torch.runtime.bag import Bag, ascii_plot

    bag = Bag(args.path)
    if args.action in ("csv", "plot") and not args.channel:
        print("--channel is required for csv/plot", file=sys.stderr)
        return 2
    if args.action == "info":
        print(f"bag: {args.path}")
        for name, ent in sorted(bag.summary().items()):
            rate = (f" @ {ent['rate_hz']:.1f} Hz"
                    if "rate_hz" in ent else "")
            span = (f"  t=[{ent['t0']:.3f}, {ent['t1']:.3f}]s"
                    if "t0" in ent else "")
            print(f"  {name:<20s} {ent['count']:>7d} x "
                  f"{ent['dtype']}{ent['shape']}{rate}{span}")
    elif args.action == "csv":
        bag.to_csv(args.channel, sys.stdout)
    elif args.action == "plot":
        d = bag[args.channel]
        vals = d.values.reshape(len(d.t), -1)
        if args.col is not None:
            vals = vals[:, [args.col]]
        print(ascii_plot(d.t, vals.T, label=args.channel))
    elif args.action == "play":
        # time-ordered replay to stdout; --rate 0 dumps as fast as possible
        t_prev = None
        for t, name, value in bag.play(
                args.channel.split(",") if args.channel else None):
            if args.rate and t_prev is not None:
                time.sleep(max(0.0, (t - t_prev) / args.rate))
            t_prev = t
            flat = np.asarray(value).reshape(-1)
            body = " ".join(f"{v:+.5g}" for v in flat[:8])
            more = " ..." if flat.size > 8 else ""
            print(f"[{t:10.4f}] {name}: {body}{more}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crazyflie_nmpc_tpu_torch.tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("scan", help="probe UDP ports for CRTP endpoints")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--ports", default="47000-47016")
    p.add_argument("--timeout", type=float, default=0.2)
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser("console", help="stream decoded log records")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--peer-port", type=int, required=True)
    p.add_argument("--local-port", type=int, default=47099)
    p.add_argument("--duration", type=float, default=0.0)
    p.set_defaults(fn=cmd_console)

    p = sub.add_parser("toc", help="list param + log tables of contents")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--peer-port", type=int, required=True)
    p.add_argument("--local-port", type=int, default=47097)
    p.set_defaults(fn=cmd_toc)

    p = sub.add_parser("imu", help="echo the gyro/accel log stream")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--peer-port", type=int, required=True)
    p.add_argument("--local-port", type=int, default=47098)
    p.add_argument("--block-id", type=int, default=1)
    p.add_argument("--period-10ms", type=int, default=1)
    p.add_argument("--duration", type=float, default=0.0)
    p.set_defaults(fn=cmd_imu)

    p = sub.add_parser("fly", help="run a closed-loop simulated flight")
    p.add_argument("--traj", default="hover",
                   help="hover | helix | step | <17-col file>")
    p.add_argument("--steps", type=int, default=660)
    p.add_argument("--delay-steps", type=int, default=0)
    p.add_argument("--ipm-iters", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="default: the card (cuda), which raises without "
                        "one; cpu when asked")
    p.add_argument("--out", default="flight.txt")
    p.add_argument("--bag", default="",
                   help="also record the flight as a bag file")
    p.set_defaults(fn=cmd_fly)

    p = sub.add_parser("bag", help="inspect/export/replay a flight bag")
    p.add_argument("action", choices=["info", "csv", "plot", "play"])
    p.add_argument("path")
    p.add_argument("--channel", default="")
    p.add_argument("--col", type=int, default=None)
    p.add_argument("--rate", type=float, default=0.0,
                   help="replay speed multiplier (0 = no pacing)")
    p.set_defaults(fn=cmd_bag)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
