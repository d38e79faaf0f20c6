"""Device-side firmware simulator — the far end of the CRTP/UDP link
(the PyTorch port's copy of the JAX package's `native/firmware_sim.py`;
`port=0` binds a port the OS picks, read back as `FirmwareSim.port`).

A pure-Python, independent implementation of the wire format the native
link server speaks (so tests of the C++ codec are cross-implementation,
not self-roundtrips).  It emulates the slice of the Crazyflie firmware the
reference stack exercises (SURVEY.md §2.2-2.3):

- **param TOC** (port 2): named, typed parameters; TOC info, read, write
  with ack — the reference mirrors this table into rosparams and mutates
  it via the UpdateParams service (crazyflie_server.cpp:485-517).
- **log TOC + blocks** (port 5): named variables bound to a state-provider
  callback; create/start/stop blocks streaming at 10 ms-granularity
  periods (crazyflie_server.cpp:519-651 "start(1) // 10ms").
- **setpoints** (ports 3 and 7): attitude `cmd_vel`, stop, hover,
  position, full-state — stored as `last_setpoint`.
- **high-level commander** (port 8): takeoff/land/goTo/start-trajectory
  commands recorded to `hl_commands` (crazyflie_server.cpp:920-992).
- **trajectory memory** (port 4): chunked uploads assembled into
  `trajectory_mem`, define-trajectory registers id → (offset, n_pieces).
- **console** (port 0): greeting text pushed on first contact, like the
  firmware boot banner the reference forwards (crazyflie_server.cpp:892).

Wire format: 1 header byte (port<<4 | channel) + payload, over UDP.
"""

from __future__ import annotations

import socket
import struct
import threading

PORT_CONSOLE = 0x0
PORT_PARAM = 0x2
PORT_COMMANDER = 0x3
PORT_MEM = 0x4
PORT_LOG = 0x5
PORT_LOCALIZATION = 0x6
PORT_GENERIC_SETPOINT = 0x7
PORT_SETPOINT_HL = 0x8
PORT_LINK = 0xF

PARAM_FMTS = {0x00: "<B", 0x01: "<H", 0x02: "<I",
              0x04: "<b", 0x05: "<h", 0x06: "<i", 0x08: "<f"}
# log storage types (subset the reference's packed structs use)
LOG_FMTS = {1: "<B", 2: "<H", 3: "<I", 4: "<b", 5: "<h", 6: "<i", 7: "<f"}


def _header(port, channel=0):
    return bytes([(port << 4) | (channel & 0x3)])


class Param:
    __slots__ = ("name", "type_byte", "value")

    def __init__(self, name, type_byte, value):
        self.name = name
        self.type_byte = type_byte
        self.value = value


class FirmwareSim:
    """One simulated vehicle endpoint on a UDP port.

    `state_provider(var_name) -> float` supplies log-variable values at
    stream time (e.g. from a plant simulation); defaults to 0.0.
    """

    def __init__(self, port: int, host: str = "127.0.0.1",
                 state_provider=None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]
        self.state_provider = state_provider or (lambda name: 0.0)
        self.peer = None
        self.greeted = False

        # param TOC: id -> Param  (insertion order defines ids)
        self.params: dict[int, Param] = {}
        self.param_ids: dict[str, int] = {}
        # firmware defaults the reference's launch files touch
        # (joystick.py:16-20 set these on connect)
        for name, tb, v in [
            ("commander/enHighLevel", 0x00, 0),
            ("stabilizer/estimator", 0x00, 2),
            ("stabilizer/controller", 0x00, 1),
            ("kalman/resetEstimation", 0x00, 0),
            ("flightmode/posSet", 0x00, 0),
            ("ring/effect", 0x00, 0),
        ]:
            self.add_param(name, tb, v)

        # log TOC: name -> (id, type_byte); blocks: id -> dict
        self.log_vars: dict[str, tuple[int, int]] = {}
        self.log_var_names: dict[int, str] = {}
        self.log_blocks: dict[int, dict] = {}
        # the variable set the reference server's typed blocks bind
        # (crazyflie_server.cpp:519-651: logImu, logMotors,
        # logEulerAngles, log2 = mag/baro/vbat, logPose).  radio.rssi is
        # this seam's stand-in for the platform-RSSI empty-ack channel
        # (crazyflie_server.cpp:880-885) — no radio ACKs cross a UDP
        # link, so the dB value streams as a log variable instead.
        for name in ["gyro.x", "gyro.y", "gyro.z", "acc.x", "acc.y",
                     "acc.z", "stabilizer.roll", "stabilizer.pitch",
                     "stabilizer.yaw", "motor.m1", "motor.m2", "motor.m3",
                     "motor.m4", "pm.vbat", "stateEstimate.x",
                     "stateEstimate.y", "stateEstimate.z",
                     "mag.x", "mag.y", "mag.z", "baro.temp",
                     "baro.pressure", "radio.rssi"]:
            self.add_log_var(name, 7)  # float

        # actuation / command state
        self.last_setpoint = None          # (roll, pitch, yawrate, thrust)
        self.last_generic_setpoint = None  # dict with "type" key
        self.external_positions = []
        self.external_poses = []   # (x, y, z, compressed_quat)
        self.hl_commands = []              # decoded HL commander dicts
        self.trajectory_mem = bytearray(4096)
        self.trajectories: dict[int, tuple[int, int]] = {}
        self.ping_count = 0
        self.time_ms = 0

        self._lock = threading.Lock()
        self._thread = None
        self._running = False

    # ---- registries ------------------------------------------------------

    def add_param(self, name, type_byte, value) -> int:
        pid = len(self.params)
        self.params[pid] = Param(name, type_byte, value)
        self.param_ids[name] = pid
        return pid

    def get_param(self, name):
        return self.params[self.param_ids[name]].value

    def add_log_var(self, name, type_byte=7) -> int:
        vid = len(self.log_vars)
        self.log_vars[name] = (vid, type_byte)
        self.log_var_names[vid] = name
        return vid

    # ---- pump ------------------------------------------------------------

    def poll(self, dt_ms: int = 1):
        """Process pending packets, stream due log blocks, advance time."""
        while True:
            try:
                raw, addr = self.sock.recvfrom(64)
            except BlockingIOError:
                break
            except OSError:
                return
            self.peer = addr
            if not self.greeted:
                self.greeted = True
                self._send(_header(PORT_CONSOLE) + b"CFSIM: hello\n")
            self._handle(raw)
        self.time_ms += dt_ms
        self._stream_logs()

    def serve(self, tick_ms: int = 1):
        """Run poll() in a background thread until close()."""
        import time as _time
        self._running = True

        def loop():
            while self._running:
                self.poll(tick_ms)
                _time.sleep(tick_ms / 1000.0)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop_serving(self):
        """Stop the background poll thread WITHOUT closing the socket —
        callers can then drive `poll()` manually (e.g. fast-forwarding
        simulated time in tests) and later call serve() again."""
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def close(self):
        self.stop_serving()
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- internals ---------------------------------------------------------

    def _send(self, data: bytes):
        if self.peer is not None:
            try:
                self.sock.sendto(data, self.peer)
            except OSError:
                pass

    def _handle(self, raw: bytes):
        port, channel = raw[0] >> 4, raw[0] & 0x3
        payload = raw[1:]
        with self._lock:
            if port == PORT_LINK:
                self.ping_count += 1
            elif port == PORT_COMMANDER and len(payload) == 14:
                self.last_setpoint = struct.unpack("<fffH", payload)
            elif port == PORT_GENERIC_SETPOINT:
                self._handle_generic(payload)
            elif port == PORT_LOCALIZATION:
                if channel == 0 and len(payload) == 12:
                    self.external_positions.append(
                        struct.unpack("<fff", payload))
                elif channel == 1 and len(payload) == 17 and payload[0] == 8:
                    x, y, z, comp = struct.unpack("<fffI", payload[1:])
                    self.external_poses.append((x, y, z, comp))
            elif port == PORT_PARAM:
                self._handle_param(channel, payload)
            elif port == PORT_LOG:
                if channel == 0:
                    self._handle_log_control(payload)
            elif port == PORT_MEM:
                if channel == 2:
                    self._handle_mem_write(payload)
            elif port == PORT_SETPOINT_HL:
                self._handle_hl(payload)

    def _handle_generic(self, payload):
        t = payload[0]
        if t == 0:
            self.last_generic_setpoint = {"type": "stop"}
        elif t == 5 and len(payload) == 17:
            vx, vy, yr, zd = struct.unpack("<ffff", payload[1:])
            self.last_generic_setpoint = {
                "type": "hover", "vx": vx, "vy": vy, "yawrate": yr,
                "z_distance": zd}
        elif t == 7 and len(payload) == 17:
            x, y, z, yaw = struct.unpack("<ffff", payload[1:])
            self.last_generic_setpoint = {
                "type": "position", "x": x, "y": y, "z": z, "yaw": yaw}
        elif t == 6 and len(payload) == 29:
            self.last_generic_setpoint = {"type": "full_state",
                                          "raw": bytes(payload)}

    def _handle_param(self, channel, payload):
        if channel == 0 and payload and payload[0] == 3:  # TOC info
            crc = sum(ord(c) for p in self.params.values()
                      for c in p.name) & 0xFFFFFFFF
            self._send(_header(PORT_PARAM, 0)
                       + struct.pack("<BHI", 3, len(self.params), crc))
        elif channel == 0 and payload and payload[0] == 2:  # TOC item
            (pid,) = struct.unpack("<H", payload[1:3])
            p = self.params.get(pid)
            if p is not None:
                group, _, name = p.name.partition("/")
                self._send(_header(PORT_PARAM, 0)
                           + struct.pack("<BHB", 2, pid, p.type_byte)
                           + group.encode() + b"\0" + name.encode() + b"\0")
        elif channel == 1 and len(payload) == 2:  # read
            (pid,) = struct.unpack("<H", payload)
            p = self.params.get(pid)
            if p is not None:
                self._send(_header(PORT_PARAM, 1)
                           + struct.pack("<HB", pid, p.type_byte)
                           + struct.pack(PARAM_FMTS[p.type_byte], p.value))
        elif channel == 2 and len(payload) >= 4:  # write
            pid, tb = struct.unpack("<HB", payload[:3])
            p = self.params.get(pid)
            if p is not None and tb in PARAM_FMTS:
                (p.value,) = struct.unpack(
                    PARAM_FMTS[tb],
                    payload[3:3 + struct.calcsize(PARAM_FMTS[tb])])
                p.type_byte = tb
                # ack: echo the new value on the read channel
                self._send(_header(PORT_PARAM, 1)
                           + struct.pack("<HB", pid, tb)
                           + struct.pack(PARAM_FMTS[tb], p.value))

    def _handle_log_control(self, payload):
        cmd = payload[0]
        block_id = payload[1] if len(payload) > 1 else 0
        status = 0
        if cmd == 7:  # log TOC info (this stack's extension slot)
            self._send(_header(PORT_LOG, 0)
                       + struct.pack("<BH", 7, len(self.log_vars)))
            return
        if cmd == 8:  # log TOC item
            (vid,) = struct.unpack("<H", payload[1:3])
            name = self.log_var_names.get(vid)
            if name is not None:
                tb = self.log_vars[name][1]
                group, _, short = name.partition(".")
                self._send(_header(PORT_LOG, 0)
                           + struct.pack("<BHB", 8, vid, tb)
                           + group.encode() + b"\0" + short.encode() + b"\0")
            return
        if cmd == 6:  # CREATE_BLOCK_V2
            n = (len(payload) - 2) // 3
            var_ids = []
            for i in range(n):
                o = 2 + 3 * i
                tb = payload[o]
                (vid,) = struct.unpack("<H", payload[o + 1:o + 3])
                var_ids.append((vid, tb))
            if all(v in self.log_var_names for v, _ in var_ids):
                self.log_blocks[block_id] = {
                    "vars": var_ids, "period_ms": 0, "next_ms": None}
            else:
                status = 2  # ENOENT
        elif cmd == 3:  # START
            blk = self.log_blocks.get(block_id)
            if blk is None:
                status = 2
            else:
                period = payload[2] if len(payload) > 2 else 1
                blk["period_ms"] = max(1, period) * 10
                blk["next_ms"] = self.time_ms
        elif cmd == 4:  # STOP
            blk = self.log_blocks.get(block_id)
            if blk is None:
                status = 2
            else:
                blk["next_ms"] = None
        elif cmd == 2:  # DELETE
            self.log_blocks.pop(block_id, None)
        elif cmd == 5:  # RESET
            self.log_blocks.clear()
        self._send(_header(PORT_LOG, 0)
                   + struct.pack("<BBB", cmd, block_id, status))

    def _stream_logs(self):
        with self._lock:
            for bid, blk in self.log_blocks.items():
                if blk["next_ms"] is None or self.time_ms < blk["next_ms"]:
                    continue
                blk["next_ms"] = self.time_ms + blk["period_ms"]
                payload = b""
                for vid, tb in blk["vars"]:
                    fmt = LOG_FMTS.get(tb, "<f")
                    v = self.state_provider(self.log_var_names[vid])
                    if fmt != "<f":
                        v = int(v)
                    payload += struct.pack(fmt, v)
                ts = self.time_ms & 0xFFFFFF
                self._send(_header(PORT_LOG, 2)
                           + bytes([bid, ts & 0xFF, (ts >> 8) & 0xFF,
                                    (ts >> 16) & 0xFF])
                           + payload)

    def _handle_mem_write(self, payload):
        mem_id = payload[0]
        (addr,) = struct.unpack("<I", payload[1:5])
        data = payload[5:]
        status = 0
        if mem_id == 0 and addr + len(data) <= len(self.trajectory_mem):
            self.trajectory_mem[addr:addr + len(data)] = data
        else:
            status = 1
        self._send(_header(PORT_MEM, 2)
                   + struct.pack("<BIB", mem_id, addr, status))

    def _handle_hl(self, payload):
        cmd = payload[0]
        if cmd == 7 or cmd == 8:  # takeoff2 / land2
            g, h, yaw, ucy, dur = struct.unpack("<BffBf", payload[1:15])
            self.hl_commands.append({
                "cmd": "takeoff" if cmd == 7 else "land", "group": g,
                "height": h, "yaw": yaw, "use_current_yaw": bool(ucy),
                "duration": dur})
        elif cmd == 4:  # goTo
            g, rel, x, y, z, yaw, dur = struct.unpack("<BBfffff",
                                                      payload[1:23])
            self.hl_commands.append({
                "cmd": "go_to", "group": g, "relative": bool(rel),
                "x": x, "y": y, "z": z, "yaw": yaw, "duration": dur})
        elif cmd == 5:  # start trajectory
            g, rel, rev, tid, ts = struct.unpack("<BBBBf", payload[1:9])
            self.hl_commands.append({
                "cmd": "start_trajectory", "group": g,
                "relative": bool(rel), "reversed": bool(rev),
                "traj_id": tid, "timescale": ts})
        elif cmd == 6:  # define trajectory
            tid, ttype, off, n = struct.unpack("<BBIB", payload[1:8])
            self.trajectories[tid] = (off, n)
            self.hl_commands.append({
                "cmd": "define_trajectory", "traj_id": tid,
                "offset": off, "n_pieces": n})
        elif cmd == 3:
            self.hl_commands.append({"cmd": "stop", "group": payload[1]})
        elif cmd == 0:
            self.hl_commands.append({"cmd": "set_group_mask",
                                     "group": payload[1]})
