"""Typed telemetry channels: the reference server's onboard->host plane
(the PyTorch port's copy of the JAX package's `native/channels.py`).

The reference driver instances a fixed set of TYPED log blocks on connect
and republishes them as unit-converted topics (crazyflie_server.cpp:
519-651 block creation, 770-835 conversions, 425-467 publishers):

  imu    : gyro.x/y/z + acc.x/y/z              @ 10 ms  (start(1), :545)
           gyro deg/s -> rad/s (:779-781), acc g -> m/s^2 via x9.81
           (:783-786 — the comment says mG, the code multiplies by 9.81,
           i.e. the firmware streams g; the CODE's conversion is kept)
  pose   : stateEstimate.x/y/z + compressed quat @ 10 ms (:630)
  sensors: mag.x/y/z [T], baro.temp [degC],
           baro.pressure [hPa], pm.vbat [V]     @ 100 ms (start(10), :616)
  rssi   : dB                                   (empty-ack RSSI, :880-885;
           over this stack's UDP seam it streams as the radio.rssi log
           variable in its own 100 ms block — the wire mechanism is
           radio-dongle-specific, the surface (a periodic dB float) is
           preserved)

This module instances those blocks over the generic log plane
(native.bindings log_create_block/log_start_block/poll_log) and decodes
the streamed records into typed, unit-converted channel dicts — the
framework's equivalent of the server's /imu, /temperature,
/magnetic_field, /pressure, /battery, /rssi topics.
"""

from __future__ import annotations

import math
import struct

# block ids reserved for the typed plane (callers' custom blocks — the
# LogBlock srv mechanism — should use other ids)
IMU_BLOCK = 0xE1
SENSORS_BLOCK = 0xE2
POSE_BLOCK = 0xE3
RSSI_BLOCK = 0xE4

IMU_VARS = ["gyro.x", "gyro.y", "gyro.z", "acc.x", "acc.y", "acc.z"]
# exactly the reference's log2 member set (6 x f32 = 24 bytes — the CRTP
# log payload cap is 26, so rssi rides its own block)
SENSOR_VARS = ["mag.x", "mag.y", "mag.z", "baro.temp", "baro.pressure",
               "pm.vbat"]
POSE_VARS = ["stateEstimate.x", "stateEstimate.y", "stateEstimate.z"]
RSSI_VARS = ["radio.rssi"]

FLOAT_TB = 7  # log storage type byte for float32


def start_typed_channels(server, vid: int, log_toc: dict,
                         imu: bool = True, sensors: bool = True,
                         pose: bool = False) -> dict:
    """Create + start the reference's typed blocks on vehicle `vid`.

    log_toc: the name -> (var_id, type_byte) map from
    server.download_log_toc(vid).  Periods match the reference: imu/pose
    at 10 ms (start(1)), sensors at 100 ms (start(10),
    crazyflie_server.cpp:545,616,630).

    Returns {block_id: [var names]} for the started blocks (the layout
    decode_channels needs).
    """
    layout = {}
    plan = []
    if imu:
        plan.append((IMU_BLOCK, IMU_VARS, 1))
    if sensors:
        plan.append((SENSORS_BLOCK, SENSOR_VARS, 10))
        plan.append((RSSI_BLOCK, RSSI_VARS, 10))
    if pose:
        plan.append((POSE_BLOCK, POSE_VARS, 1))
    for bid, names, period in plan:
        missing = [n for n in names if n not in log_toc]
        if missing:
            raise KeyError(f"log TOC missing {missing} for block {bid:#x}")
        variables = [(FLOAT_TB, log_toc[n][0]) for n in names]
        if not server.log_create_block(vid, bid, variables):
            raise RuntimeError(f"log_create_block({bid:#x}) refused")
        if not server.log_start_block(vid, bid, period):
            raise RuntimeError(f"log_start_block({bid:#x}) refused")
        layout[bid] = list(names)
    return layout


def stop_typed_channels(server, vid: int, layout: dict) -> None:
    for bid in layout:
        server.log_stop_block(vid, bid)


def decode_channels(rec: dict, layout: dict) -> dict | None:
    """Decode one poll_log record from a typed block into unit-converted
    channels (the server's republish step, crazyflie_server.cpp:770-835).

    Returns None if the record belongs to none of the typed blocks.
    The output dict always carries `timestamp_ms`; per block:

      IMU_BLOCK    -> angular_velocity (rad/s, 3), linear_acceleration
                      (m/s^2, 3)
      SENSORS_BLOCK-> magnetic_field (T, 3), temperature_c, pressure_hpa,
                      battery_v
      RSSI_BLOCK   -> rssi_db
      POSE_BLOCK   -> position (m, 3)
    """
    bid = rec["block_id"]
    names = layout.get(bid)
    if names is None:
        return None
    vals = struct.unpack(f"<{len(names)}f", rec["payload"][:4 * len(names)])
    v = dict(zip(names, vals))
    out = {"timestamp_ms": rec["timestamp_ms"]}
    if bid == IMU_BLOCK:
        # measured in deg/s -> rad/s; acc in g -> m/s^2 (x9.81)
        out["angular_velocity"] = tuple(
            math.radians(v[f"gyro.{a}"]) for a in "xyz")
        out["linear_acceleration"] = tuple(
            v[f"acc.{a}"] * 9.81 for a in "xyz")
    elif bid == SENSORS_BLOCK:
        out["magnetic_field"] = tuple(v[f"mag.{a}"] for a in "xyz")
        out["temperature_c"] = v["baro.temp"]
        out["pressure_hpa"] = v["baro.pressure"]
        out["battery_v"] = v["pm.vbat"]
    elif bid == RSSI_BLOCK:
        out["rssi_db"] = v["radio.rssi"]
    elif bid == POSE_BLOCK:
        out["position"] = tuple(v[f"stateEstimate.{a}"] for a in "xyz")
    return out
