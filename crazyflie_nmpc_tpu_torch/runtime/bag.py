"""Flight-log record/replay: the reference's rosbag workflow (the PyTorch
port's copy of the JAX package's `runtime/bag.py`; the file format is the
same, so either package reads the other's bags).

The reference's entire analysis loop is log-then-analyze: `rosbag record` of
`/cf_mpc/openloop_traj`, `/cf_estimator/state_estimate`, `/crazyflie/cmd_vel`,
`/crazyflie/euler_angles` during a flight (crazy_AFL.launch:64-72,
meas_vector.launch:74-78), then `bag_play.launch` + rqt_plot replay
(bag_play.launch:1-31, test_rosbag.launch:1-18).  This module is that plane
rebuilt for the array-native stack: timestamped channels of fixed-shape
numpy records in a crash-tolerant append-only binary file, a time-ordered
replay iterator to feed recorded streams back through the estimator/solver,
and CSV/summary export for offline analysis (the rqt_plot role).

Format ("CFBG" v1), designed for the reference's failure model — the
recorder dies with the process, so every complete record must be readable:

    [8-byte magic b"CFBG\\x01\\0\\0\\0"]
    record := [u32 little-endian payload length][u8 kind][payload]
      kind 1 (channel): JSON {"id": int, "name": str, "dtype": str,
                              "shape": [int, ...]}
      kind 2 (data):    [u16 channel id][f64 t seconds][raw array bytes]
    A truncated trailing record (crash mid-write) is ignored on read.

Besides numpy, only `device.host_array` (a tensor read on the host).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from crazyflie_nmpc_tpu_torch.device import host_array

MAGIC = b"CFBG\x01\x00\x00\x00"
_KIND_CHANNEL = 1
_KIND_DATA = 2
_LEN = struct.Struct("<I")
_DATA_HDR = struct.Struct("<Hd")


@dataclass
class Channel:
    id: int
    name: str
    dtype: np.dtype
    shape: tuple


class BagWriter:
    """Append-only recorder.  Channels are declared lazily on first write;
    each channel carries one fixed dtype/shape (the log-block contract:
    typed packed structs at a fixed period, crazyflie_server.cpp:188-238).
    """

    def __init__(self, path):
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._channels: dict[str, Channel] = {}

    def _declare(self, name: str, arr: np.ndarray) -> Channel:
        ch = Channel(id=len(self._channels), name=name,
                     dtype=arr.dtype, shape=arr.shape)
        payload = json.dumps({
            "id": ch.id, "name": name, "dtype": arr.dtype.str,
            "shape": list(arr.shape),
        }).encode()
        self._f.write(_LEN.pack(len(payload) + 1))
        self._f.write(bytes([_KIND_CHANNEL]))
        self._f.write(payload)
        self._channels[name] = ch
        return ch

    def write(self, name: str, t: float, value) -> None:
        arr = np.asarray(value)
        ch = self._channels.get(name)
        if ch is None:
            ch = self._declare(name, arr)
        elif arr.shape != ch.shape or arr.dtype != ch.dtype:
            raise ValueError(
                f"channel {name!r} is {ch.dtype}{ch.shape}, got "
                f"{arr.dtype}{arr.shape}")
        raw = arr.tobytes()
        self._f.write(_LEN.pack(_DATA_HDR.size + len(raw) + 1))
        self._f.write(bytes([_KIND_DATA]))
        self._f.write(_DATA_HDR.pack(ch.id, float(t)))
        self._f.write(raw)

    def write_series(self, name: str, ts, values) -> None:
        """Record a whole (T, ...) array as T stamped records."""
        values = np.asarray(values)
        for t, v in zip(np.asarray(ts, dtype=np.float64), values):
            self.write(name, t, v)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class BagData:
    """One fully-read channel: stamped fixed-shape records."""
    name: str
    t: np.ndarray        # (T,) float64 seconds
    values: np.ndarray   # (T, *shape)


class Bag:
    """Read side: loads every complete record; tolerates a torn tail."""

    def __init__(self, path):
        self.path = str(path)
        self.channels: dict[str, BagData] = {}
        self._read()

    def _read(self) -> None:
        with open(self.path, "rb") as f:
            blob = f.read()
        if blob[:len(MAGIC)] != MAGIC:
            raise ValueError(f"{self.path}: not a CFBG bag")
        by_id: dict[int, Channel] = {}
        acc: dict[int, tuple[list, list]] = {}
        off = len(MAGIC)
        n = len(blob)
        while off + _LEN.size <= n:
            (length,) = _LEN.unpack_from(blob, off)
            start = off + _LEN.size
            end = start + length
            if end > n or length < 1:
                break  # torn trailing record: recorder died mid-write
            kind = blob[start]
            body = blob[start + 1:end]
            if kind == _KIND_CHANNEL:
                meta = json.loads(body.decode())
                ch = Channel(id=meta["id"], name=meta["name"],
                             dtype=np.dtype(meta["dtype"]),
                             shape=tuple(meta["shape"]))
                by_id[ch.id] = ch
                acc[ch.id] = ([], [])
            elif kind == _KIND_DATA:
                cid, t = _DATA_HDR.unpack_from(body, 0)
                ch = by_id.get(cid)
                if ch is None:
                    break  # data before declaration: corrupt
                raw = body[_DATA_HDR.size:]
                want = int(np.prod(ch.shape, dtype=np.int64)) * ch.dtype.itemsize
                if len(raw) != want:
                    break
                ts, vs = acc[cid]
                ts.append(t)
                vs.append(np.frombuffer(raw, ch.dtype).reshape(ch.shape))
            off = end
        for cid, ch in by_id.items():
            ts, vs = acc[cid]
            self.channels[ch.name] = BagData(
                name=ch.name,
                t=np.asarray(ts, np.float64),
                values=(np.stack(vs) if vs
                        else np.empty((0,) + ch.shape, ch.dtype)))

    def __getitem__(self, name: str) -> BagData:
        return self.channels[name]

    def __contains__(self, name: str) -> bool:
        return name in self.channels

    def names(self) -> list[str]:
        return sorted(self.channels)

    def play(self, names=None) -> Iterator[tuple[float, str, np.ndarray]]:
        """Time-ordered merge across channels — the `bag_play` equivalent.

        Yields (t, channel, value) in nondecreasing t, ties broken by
        channel name, ready to feed back through the estimator/controller
        pipeline (the reference replays bags into live nodes,
        bag_play.launch:1-31).
        """
        names = self.names() if names is None else list(names)
        heads = []
        for name in names:
            d = self.channels[name]
            for i in range(len(d.t)):
                heads.append((d.t[i], name, i))
        heads.sort(key=lambda r: (r[0], r[1]))
        for t, name, i in heads:
            yield t, name, self.channels[name].values[i]

    def summary(self) -> dict:
        out = {}
        for name, d in self.channels.items():
            ent = {"count": int(len(d.t)),
                   "dtype": d.values.dtype.str,
                   "shape": list(d.values.shape[1:])}
            if len(d.t):
                ent["t0"] = float(d.t[0])
                ent["t1"] = float(d.t[-1])
                if len(d.t) > 1:
                    dt = np.diff(d.t)
                    ent["rate_hz"] = float(1.0 / dt.mean()) if dt.mean() > 0 \
                        else float("inf")
            out[name] = ent
        return out

    def to_csv(self, name: str, file) -> None:
        """Flat CSV export of one channel (offline plotting / fitting —
        the role of rqt_plot + the sysid scripts)."""
        d = self.channels[name]
        flat = d.values.reshape(len(d.t), -1)
        cols = ",".join(f"{name}_{i}" for i in range(flat.shape[1]))
        file.write(f"t,{cols}\n")
        for i in range(len(d.t)):
            row = ",".join(repr(float(v)) for v in flat[i])
            file.write(f"{float(d.t[i])!r},{row}\n")


def record_loop_result(path, result, dt: float, t0: float = 0.0,
                       extra: dict | None = None) -> None:
    """Dump a closed-loop `LoopResult` (its tensors, wherever they are) as
    a bag: the recorded-topic set mirrors crazy_AFL.launch:64-72 (state
    estimate, applied + commanded controls, solver residual, policy mode).
    """
    x = host_array(result.x)
    ts = t0 + float(dt) * np.arange(len(x), dtype=np.float64)
    with BagWriter(path) as w:
        w.write_series("state_estimate", ts, x)
        w.write_series("motvel", ts, host_array(result.u))
        w.write_series("motvel_cmd", ts, host_array(result.u_cmd))
        w.write_series("kkt_res", ts, host_array(result.kkt_res))
        w.write_series("policy_mode", ts, host_array(result.policy_mode))
        for nm, arr in (extra or {}).items():
            w.write_series(nm, ts, host_array(arr))


def ascii_plot(t: np.ndarray, y: np.ndarray, width: int = 72,
               height: int = 14, label: str = "") -> str:
    """Terminal time-series plot (the rqt_plot stand-in for headless
    analysis).  One column of y per line bucket; multiple series share
    the canvas with distinct glyphs."""
    y = np.atleast_2d(np.asarray(y, np.float64))
    if y.shape[0] == len(t) and y.ndim == 2 and y.shape[1] != len(t):
        y = y.T  # (series, T)
    lo = float(np.nanmin(y)) if y.size else 0.0
    hi = float(np.nanmax(y)) if y.size else 1.0
    if hi - lo < 1e-12:
        hi = lo + 1.0
    canvas = [[" "] * width for _ in range(height)]
    glyphs = "*+ox#@%&"
    T = y.shape[1]
    for s in range(y.shape[0]):
        g = glyphs[s % len(glyphs)]
        for j in range(width):
            i = min(T - 1, int(j * T / width))
            v = y[s, i]
            if not np.isfinite(v):
                continue
            r = int((hi - v) / (hi - lo) * (height - 1))
            canvas[min(max(r, 0), height - 1)][j] = g
    lines = ["".join(row) for row in canvas]
    head = (f"{label}  [{lo:.4g}, {hi:.4g}]  "
            f"t=[{t[0]:.3g}, {t[-1]:.3g}]s" if len(t) else label)
    return "\n".join([head] + lines)
