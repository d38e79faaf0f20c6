"""ctypes bindings for the native link layer (no pybind11 dependency);
a copy of the JAX package's `native/bindings.py` whose library is built
into `build/torch_native/` at the repo root, not beside the sources."""

from __future__ import annotations

import ctypes as ct
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
_SOURCES = ("crtp.cc", "link_server.cc")
_HEADERS = ("crtp.h", "ring.h")
_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread", "-Wall")
_BUILD_LOCK = threading.Lock()
_LIB = None


def _lib_path() -> Path:
    """The library's path, named by a hash of the sources and the flags:
    a changed source builds anew instead of loading a stale library."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update((_SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libcfl-{h.hexdigest()[:16]}.so"


def build_library(force: bool = False) -> str:
    """Compile the native library with g++ once per source hash.

    Processes race here (pytest workers): the build runs under a file
    lock, to a temporary name that is renamed into place, so no process
    loads a library another one is still writing."""
    lib = _lib_path()
    if lib.exists() and not force:
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists() and not force:
            return str(lib)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = (["g++", *_FLAGS, "-o", str(tmp)]
               + [str(_SRC_DIR / name) for name in _SOURCES])
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
    return str(lib)


def load_library() -> ct.CDLL:
    global _LIB
    with _BUILD_LOCK:
        if _LIB is None:
            lib = ct.CDLL(build_library())
            f32p = ct.POINTER(ct.c_float)
            u8p = ct.POINTER(ct.c_uint8)
            lib.cfl_server_create.restype = ct.c_void_p
            lib.cfl_server_destroy.argtypes = [ct.c_void_p]
            lib.cfl_add_vehicle.argtypes = [ct.c_void_p, ct.c_int,
                                            ct.c_char_p, ct.c_int, ct.c_int]
            lib.cfl_remove_vehicle.argtypes = [ct.c_void_p, ct.c_int]
            lib.cfl_send_setpoint.argtypes = [ct.c_void_p, ct.c_int,
                                              ct.c_float, ct.c_float,
                                              ct.c_float, ct.c_uint16]
            lib.cfl_send_stop.argtypes = [ct.c_void_p, ct.c_int]
            lib.cfl_send_hover.argtypes = [ct.c_void_p, ct.c_int] + \
                [ct.c_float] * 4
            lib.cfl_send_position.argtypes = [ct.c_void_p, ct.c_int] + \
                [ct.c_float] * 4
            lib.cfl_send_full_state.argtypes = [ct.c_void_p, ct.c_int,
                                                f32p, f32p, f32p, f32p, f32p]
            lib.cfl_send_external_position.argtypes = [
                ct.c_void_p, ct.c_int, ct.c_float, ct.c_float, ct.c_float]
            lib.cfl_send_external_pose.argtypes = [
                ct.c_void_p, ct.c_int, ct.c_float, ct.c_float, ct.c_float,
                f32p]
            lib.cfl_emergency.argtypes = [ct.c_void_p, ct.c_int]
            lib.cfl_param_write.argtypes = [ct.c_void_p, ct.c_int,
                                            ct.c_uint16, ct.c_uint8, u8p]
            lib.cfl_param_read.argtypes = [ct.c_void_p, ct.c_int,
                                           ct.c_uint16]
            lib.cfl_param_toc_info.argtypes = [ct.c_void_p, ct.c_int]
            lib.cfl_log_create_block.argtypes = [
                ct.c_void_p, ct.c_int, ct.c_uint8, ct.c_int, u8p,
                ct.POINTER(ct.c_uint16)]
            lib.cfl_log_start_block.argtypes = [ct.c_void_p, ct.c_int,
                                                ct.c_uint8, ct.c_uint8]
            lib.cfl_log_stop_block.argtypes = [ct.c_void_p, ct.c_int,
                                               ct.c_uint8]
            lib.cfl_send_takeoff.argtypes = [ct.c_void_p, ct.c_int,
                                             ct.c_uint8, ct.c_float,
                                             ct.c_float]
            lib.cfl_send_land.argtypes = [ct.c_void_p, ct.c_int, ct.c_uint8,
                                          ct.c_float, ct.c_float]
            lib.cfl_send_goto.argtypes = [ct.c_void_p, ct.c_int, ct.c_uint8,
                                          ct.c_int] + [ct.c_float] * 5
            lib.cfl_send_set_group_mask.argtypes = [ct.c_void_p, ct.c_int,
                                                    ct.c_uint8]
            lib.cfl_send_hl_stop.argtypes = [ct.c_void_p, ct.c_int,
                                             ct.c_uint8]
            lib.cfl_send_start_trajectory.argtypes = [
                ct.c_void_p, ct.c_int, ct.c_uint8, ct.c_int, ct.c_int,
                ct.c_uint8, ct.c_float]
            lib.cfl_upload_trajectory.argtypes = [
                ct.c_void_p, ct.c_int, ct.c_uint8, ct.c_uint32, u8p,
                ct.c_int, ct.c_uint8]
            lib.cfl_send_packet.argtypes = [ct.c_void_p, ct.c_int,
                                            ct.c_uint8, u8p, ct.c_int]
            lib.cfl_poll_packet.argtypes = [ct.c_void_p, ct.c_int, u8p, u8p]
            lib.cfl_poll_log.argtypes = [ct.c_void_p, ct.c_int, u8p,
                                         ct.POINTER(ct.c_uint32), u8p]
            lib.cfl_stats.argtypes = [ct.c_void_p, ct.c_int] + \
                [ct.POINTER(ct.c_uint64)] * 4
            lib.cfl_encode_setpoint.argtypes = [ct.c_float, ct.c_float,
                                                ct.c_float, ct.c_uint16, u8p]
            lib.cfl_decode_setpoint.argtypes = [u8p, ct.c_int, f32p, f32p,
                                                f32p,
                                                ct.POINTER(ct.c_uint16)]
            lib.cfl_encode_full_state.argtypes = [f32p] * 5 + [u8p]
            lib.cfl_decode_full_state.argtypes = [u8p, ct.c_int] + [f32p] * 5
            lib.cfl_encode_log_data.argtypes = [ct.c_uint8, ct.c_uint32,
                                                u8p, ct.c_int, u8p]
            lib.cfl_quat_compress.argtypes = [f32p]
            lib.cfl_quat_compress.restype = ct.c_uint32
            lib.cfl_quat_decompress.argtypes = [ct.c_uint32, f32p]
            _LIB = lib
    return _LIB


def _f32(arr):
    a = np.ascontiguousarray(arr, dtype=np.float32)
    return a, a.ctypes.data_as(ct.POINTER(ct.c_float))


# ---- standalone codec helpers ------------------------------------------

def encode_setpoint(roll, pitch, yawrate, thrust) -> bytes:
    lib = load_library()
    out = (ct.c_uint8 * 32)()
    n = lib.cfl_encode_setpoint(roll, pitch, yawrate, int(thrust), out)
    return bytes(out[:n])


def decode_setpoint(buf: bytes):
    lib = load_library()
    b = (ct.c_uint8 * len(buf)).from_buffer_copy(buf)
    roll, pitch, yawrate = ct.c_float(), ct.c_float(), ct.c_float()
    thrust = ct.c_uint16()
    rc = lib.cfl_decode_setpoint(b, len(buf), ct.byref(roll),
                                 ct.byref(pitch), ct.byref(yawrate),
                                 ct.byref(thrust))
    if rc != 0:
        raise ValueError("not a commander setpoint packet")
    return roll.value, pitch.value, yawrate.value, thrust.value


def encode_full_state(pos, vel, acc, quat, omega) -> bytes:
    lib = load_library()
    keep = [_f32(x) for x in (pos, vel, acc, quat, omega)]
    out = (ct.c_uint8 * 32)()
    n = lib.cfl_encode_full_state(*[p for _, p in keep], out)
    return bytes(out[:n])


def decode_full_state(buf: bytes):
    lib = load_library()
    b = (ct.c_uint8 * len(buf)).from_buffer_copy(buf)
    arrs = [np.zeros(3, np.float32) for _ in range(3)]
    quat = np.zeros(4, np.float32)
    omega = np.zeros(3, np.float32)
    ptrs = [a.ctypes.data_as(ct.POINTER(ct.c_float))
            for a in arrs + [quat, omega]]
    rc = lib.cfl_decode_full_state(b, len(buf), *ptrs)
    if rc != 0:
        raise ValueError("not a full-state packet")
    return dict(pos=arrs[0], vel=arrs[1], acc=arrs[2], quat=quat,
                omega=omega)


def encode_log_data(block_id: int, timestamp_ms: int,
                    payload: bytes) -> bytes:
    lib = load_library()
    pl = (ct.c_uint8 * len(payload)).from_buffer_copy(payload)
    out = (ct.c_uint8 * 32)()
    n = lib.cfl_encode_log_data(block_id, timestamp_ms, pl, len(payload),
                                out)
    return bytes(out[:n])


def quat_compress(q) -> int:
    lib = load_library()
    _, p = _f32(q)
    return int(lib.cfl_quat_compress(p))


def quat_decompress(comp: int):
    lib = load_library()
    q = np.zeros(4, np.float32)
    lib.cfl_quat_decompress(comp, q.ctypes.data_as(ct.POINTER(ct.c_float)))
    return q


# ---- server ------------------------------------------------------------

class LinkServer:
    """Pythonic wrapper over the native multi-vehicle link server."""

    def __init__(self):
        self._lib = load_library()
        self._handle = ct.c_void_p(self._lib.cfl_server_create())

    def close(self):
        if self._handle:
            self._lib.cfl_server_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add_vehicle(self, vid: int, peer_host: str, peer_port: int,
                    local_port: int):
        rc = self._lib.cfl_add_vehicle(self._handle, vid,
                                       peer_host.encode(), peer_port,
                                       local_port)
        if rc != 0:
            raise OSError(f"cfl_add_vehicle failed: {rc}")

    def remove_vehicle(self, vid: int):
        self._lib.cfl_remove_vehicle(self._handle, vid)

    def send_setpoint(self, vid, roll, pitch, yawrate, thrust) -> bool:
        return self._lib.cfl_send_setpoint(self._handle, vid, roll, pitch,
                                           yawrate, int(thrust)) == 0

    def send_stop(self, vid) -> bool:
        return self._lib.cfl_send_stop(self._handle, vid) == 0

    def send_hover(self, vid, vx, vy, yawrate, z_distance) -> bool:
        return self._lib.cfl_send_hover(self._handle, vid, vx, vy, yawrate,
                                        z_distance) == 0

    def send_position(self, vid, x, y, z, yaw) -> bool:
        return self._lib.cfl_send_position(self._handle, vid, x, y, z,
                                           yaw) == 0

    def send_full_state(self, vid, pos, vel, acc, quat, omega) -> bool:
        keep = [_f32(x) for x in (pos, vel, acc, quat, omega)]
        return self._lib.cfl_send_full_state(
            self._handle, vid, *[p for _, p in keep]) == 0

    def send_external_position(self, vid, x, y, z) -> bool:
        return self._lib.cfl_send_external_position(self._handle, vid, x, y,
                                                    z) == 0

    def send_external_pose(self, vid, x, y, z, quat) -> bool:
        """Full mocap pose (position + compressed quaternion), the
        external_pose topic equivalent (crazyflie_server.cpp:294)."""
        _, p = _f32(quat)
        return self._lib.cfl_send_external_pose(self._handle, vid, x, y, z,
                                                p) == 0

    def emergency(self, vid):
        self._lib.cfl_emergency(self._handle, vid)

    # ---- parameters (the reference's param TOC rosparams + UpdateParams
    # service, crazyflie_server.cpp:485-517).  PARAM_TYPES maps type name →
    # (wire type byte, struct format).
    PARAM_TYPES = {
        "uint8": (0x00, "<B"), "uint16": (0x01, "<H"),
        "uint32": (0x02, "<I"), "int8": (0x04, "<b"),
        "int16": (0x05, "<h"), "int32": (0x06, "<i"),
        "float": (0x08, "<f"),
    }

    def set_param(self, vid, param_id: int, value, ptype: str = "float"
                  ) -> bool:
        import struct
        tbyte, fmt = self.PARAM_TYPES[ptype]
        raw = struct.pack(fmt, value) + b"\0" * 4
        buf = (ct.c_uint8 * 4).from_buffer_copy(raw[:4])
        return self._lib.cfl_param_write(self._handle, vid, param_id, tbyte,
                                         buf) == 0

    def request_param(self, vid, param_id: int) -> bool:
        return self._lib.cfl_param_read(self._handle, vid, param_id) == 0

    def request_param_toc_info(self, vid) -> bool:
        return self._lib.cfl_param_toc_info(self._handle, vid) == 0

    # ---- TOC download (crazyflie_tools listParams/listLogVariables
    # parity; crazyflie_server.cpp:485-517 mirrors the same tables)
    def download_param_toc(self, vid, timeout: float = 5.0) -> dict:
        """Download the full param TOC: {name: (id, type_byte)}."""
        import struct
        import time

        self.request_param_toc_info(vid)
        count = None
        deadline = time.time() + timeout
        pending = {}
        while time.time() < deadline:
            pkt = self.poll_packet(vid)
            if pkt is None:
                time.sleep(0.002)
                continue
            header, payload = pkt
            if header >> 4 != 0x2 or header & 0x3 != 0:
                continue
            if payload[0] == 3:
                (count,) = struct.unpack("<H", payload[1:3])
                for i in range(count):
                    self.send_packet(vid, 0x20, bytes([2])
                                     + struct.pack("<H", i))
            elif payload[0] == 2:
                pid, tb = struct.unpack("<HB", payload[1:4])
                group, _, rest = payload[4:].partition(b"\0")
                name, _, _ = rest.partition(b"\0")
                pending[f"{group.decode()}/{name.decode()}"] = (pid, tb)
                if count is not None and len(pending) == count:
                    break
        return pending

    def download_log_toc(self, vid, timeout: float = 5.0) -> dict:
        """Download the log-variable TOC: {name: (id, type_byte)}."""
        import struct
        import time

        self.send_packet(vid, 0x50, bytes([7]))
        count = None
        deadline = time.time() + timeout
        pending = {}
        while time.time() < deadline:
            pkt = self.poll_packet(vid)
            if pkt is None:
                time.sleep(0.002)
                continue
            header, payload = pkt
            if header >> 4 != 0x5 or header & 0x3 != 0:
                continue
            if payload[0] == 7:
                (count,) = struct.unpack("<H", payload[1:3])
                for i in range(count):
                    self.send_packet(vid, 0x50, bytes([8])
                                     + struct.pack("<H", i))
            elif payload[0] == 8:
                vid_, tb = struct.unpack("<HB", payload[1:4])
                group, _, rest = payload[4:].partition(b"\0")
                name, _, _ = rest.partition(b"\0")
                pending[f"{group.decode()}.{name.decode()}"] = (vid_, tb)
                if count is not None and len(pending) == count:
                    break
        return pending

    # ---- log blocks (LogBlock<T> lifecycle, crazyflie_server.cpp:519-651)
    def log_create_block(self, vid, block_id: int, variables) -> bool:
        """variables: list of (storage_type_byte, var_id) pairs, <= 9."""
        n = len(variables)
        types = (ct.c_uint8 * n)(*[t for t, _ in variables])
        ids = (ct.c_uint16 * n)(*[i for _, i in variables])
        return self._lib.cfl_log_create_block(self._handle, vid, block_id,
                                              n, types, ids) == 0

    def log_start_block(self, vid, block_id: int, period_10ms: int) -> bool:
        return self._lib.cfl_log_start_block(self._handle, vid, block_id,
                                             period_10ms) == 0

    def log_stop_block(self, vid, block_id: int) -> bool:
        return self._lib.cfl_log_stop_block(self._handle, vid,
                                            block_id) == 0

    # ---- high-level commander (takeoff/land/goTo/trajectory services,
    # crazyflie_server.cpp:920-992)
    def takeoff(self, vid, height: float, duration: float,
                group_mask: int = 0) -> bool:
        return self._lib.cfl_send_takeoff(self._handle, vid, group_mask,
                                          height, duration) == 0

    def land(self, vid, height: float, duration: float,
             group_mask: int = 0) -> bool:
        return self._lib.cfl_send_land(self._handle, vid, group_mask,
                                       height, duration) == 0

    def go_to(self, vid, x, y, z, yaw, duration, relative=False,
              group_mask: int = 0) -> bool:
        return self._lib.cfl_send_goto(self._handle, vid, group_mask,
                                       int(relative), x, y, z, yaw,
                                       duration) == 0

    def set_group_mask(self, vid, group_mask: int) -> bool:
        """The SetGroupMask service (srv/SetGroupMask.srv): assign the
        vehicle's HL-commander group memberships."""
        return self._lib.cfl_send_set_group_mask(self._handle, vid,
                                                 group_mask) == 0

    def hl_stop(self, vid, group_mask: int = 0) -> bool:
        """The Stop service (srv/Stop.srv): abort the running high-level
        command (distinct from the low-level stop setpoint)."""
        return self._lib.cfl_send_hl_stop(self._handle, vid,
                                          group_mask) == 0

    def start_trajectory(self, vid, traj_id: int, timescale: float = 1.0,
                         relative=False, reversed=False,
                         group_mask: int = 0) -> bool:
        return self._lib.cfl_send_start_trajectory(
            self._handle, vid, group_mask, int(relative), int(reversed),
            traj_id, timescale) == 0

    def upload_trajectory(self, vid, traj_id: int, data: bytes,
                          n_pieces: int, mem_offset: int = 0) -> int:
        """Chunked mem-port upload + define-trajectory; returns #packets."""
        buf = (ct.c_uint8 * len(data)).from_buffer_copy(data)
        n = self._lib.cfl_upload_trajectory(self._handle, vid, traj_id,
                                            mem_offset, buf, len(data),
                                            n_pieces)
        if n < 0:
            raise OSError(f"upload_trajectory failed: {n}")
        return n

    # ---- generic packet path (srv/sendPacket equivalent) + downlink poll
    def send_packet(self, vid, header: int, data: bytes) -> bool:
        buf = (ct.c_uint8 * max(1, len(data))).from_buffer_copy(
            data or b"\0")
        return self._lib.cfl_send_packet(self._handle, vid, header, buf,
                                         len(data)) == 0

    def poll_packet(self, vid):
        """Pop one non-log downlink packet (param ack, console, mem ack):
        returns (header, payload bytes) or None."""
        header = ct.c_uint8()
        data = (ct.c_uint8 * 30)()
        n = self._lib.cfl_poll_packet(self._handle, vid, ct.byref(header),
                                      data)
        if n < 0:
            return None
        return header.value, bytes(data[:n])

    def poll_log(self, vid):
        """Pop one decoded log record or None."""
        block_id = ct.c_uint8()
        ts = ct.c_uint32()
        payload = (ct.c_uint8 * 26)()
        n = self._lib.cfl_poll_log(self._handle, vid, ct.byref(block_id),
                                   ct.byref(ts), payload)
        if n < 0:
            return None
        return dict(block_id=block_id.value, timestamp_ms=ts.value,
                    payload=bytes(payload[:n]))

    def stats(self, vid):
        vals = [ct.c_uint64() for _ in range(4)]
        rc = self._lib.cfl_stats(self._handle, vid,
                                 *[ct.byref(v) for v in vals])
        if rc != 0:
            raise KeyError(vid)
        return dict(sent=vals[0].value, received=vals[1].value,
                    pings=vals[2].value, dropped=vals[3].value)
