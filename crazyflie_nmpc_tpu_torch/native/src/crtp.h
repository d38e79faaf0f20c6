// CRTP (Crazy RealTime Protocol) packet codec — the wire format the
// reference speaks to the Crazyflie firmware through crazyflie_cpp
// (SURVEY.md section 2.3: setpoint senders, log/param TOC, quatdecompress;
// use sites crazyflie_driver/src/crazyflie_server.cpp:268-403,519-651).
//
// This is a from-scratch implementation of the public protocol: fixed
// 1-byte header (port in bits 7:4, channel in bits 1:0) + <= 30 payload
// bytes.  Only plain C structs and explicit little-endian packing — no
// dependency on the reference library.
#pragma once

#include <cstdint>
#include <cstring>

namespace cfl {

constexpr std::size_t kMaxPayload = 30;

enum class Port : uint8_t {
  kConsole = 0x0,
  kParam = 0x2,
  kCommander = 0x3,
  kMem = 0x4,
  kLog = 0x5,
  kLocalization = 0x6,
  kGenericSetpoint = 0x7,
  kSetpointHl = 0x8,
  kPlatform = 0xD,
  kLink = 0xF,
};

struct Packet {
  uint8_t header = 0;
  uint8_t size = 0;  // payload bytes
  uint8_t data[kMaxPayload] = {};

  static uint8_t MakeHeader(Port port, uint8_t channel) {
    return static_cast<uint8_t>((static_cast<uint8_t>(port) << 4) |
                                (channel & 0x3));
  }
  Port port() const { return static_cast<Port>(header >> 4); }
  uint8_t channel() const { return header & 0x3; }
};

// ---- little-endian field writers (host assumed LE on x86/ARM servers; a
// static_assert in crtp.cc guards this).
namespace detail {
template <typename T>
inline void Put(uint8_t* dst, std::size_t off, T v) {
  std::memcpy(dst + off, &v, sizeof(T));
}
template <typename T>
inline T Get(const uint8_t* src, std::size_t off) {
  T v;
  std::memcpy(&v, src + off, sizeof(T));
  return v;
}
}  // namespace detail

// ---- Commander attitude setpoint (port 3 ch 0): the cmd_vel contract —
// roll/pitch [deg], yaw rate [deg/s], thrust [PWM 0..65535]
// (crazyflie_server.cpp:344-357 sendSetpoint).
Packet EncodeSetpoint(float roll_deg, float pitch_deg, float yawrate_deg,
                      uint16_t thrust);
bool DecodeSetpoint(const Packet& p, float* roll, float* pitch,
                    float* yawrate, uint16_t* thrust);

// ---- Generic setpoints (port 7 ch 0, first byte = type).
enum class SetpointType : uint8_t {
  kStop = 0,
  kVelocityWorld = 1,
  kZDistance = 2,
  kHover = 5,
  kFullState = 6,
  kPosition = 7,
};

Packet EncodeStop();
Packet EncodeHover(float vx, float vy, float yawrate_deg, float z_distance);
Packet EncodePosition(float x, float y, float z, float yaw_deg);

// Full-state setpoint (compressed, 26 bytes + type): positions [mm],
// velocities [mm/s], accelerations [mm/s^2] as int16; attitude as
// smallest-three compressed quaternion; body rates [millirad/s] int16
// (crazyflie_server.cpp:268-276 sendFullStateSetpoint path).
struct FullState {
  float pos[3];    // [m]
  float vel[3];    // [m/s]
  float acc[3];    // [m/s^2]
  float quat[4];   // (w, x, y, z), unit
  float omega[3];  // [rad/s] body rates
};
Packet EncodeFullState(const FullState& s);
bool DecodeFullState(const Packet& p, FullState* out);

// ---- External position / pose (port 6 — localization).
Packet EncodeExternalPosition(float x, float y, float z);
bool DecodeExternalPosition(const Packet& p, float* x, float* y, float* z);
// external pose: generic localization channel (ch 1), type 8 ext-pose
Packet EncodeExternalPose(float x, float y, float z, const float quat[4]);

// ---- Log data (port 5 ch 2): block id + 3-byte timestamp + values blob
// (crazyflie_server.cpp:519-651 LogBlock streaming).
struct LogData {
  uint8_t block_id;
  uint32_t timestamp_ms;  // 24-bit on the wire
  uint8_t payload[26];
  uint8_t payload_size;
};
Packet EncodeLogData(const LogData& d);
bool DecodeLogData(const Packet& p, LogData* out);

// ---- Ping / keep-alive (port 15): sent when no setpoint was queued this
// cycle so the log stream stays alive (crazyflie_server.cpp:669-681).
Packet EncodePing();
bool IsPing(const Packet& p);

// ---- Parameters (port 2).  The reference exposes the firmware param TOC
// as rosparams and an UpdateParams service (crazyflie_server.cpp:485-517,
// updateParams).  Channels: 0 = TOC access, 1 = read, 2 = write.  Params
// are identified by a 16-bit id; values are typed.  (Simplification vs the
// real TOC protocol: the value type rides in the packet instead of being
// looked up from a downloaded TOC — both endpoints here are ours.)
enum class ParamType : uint8_t {
  kUint8 = 0x00,
  kUint16 = 0x01,
  kUint32 = 0x02,
  kInt8 = 0x04,
  kInt16 = 0x05,
  kInt32 = 0x06,
  kFloat = 0x08,
};
int ParamTypeSize(ParamType t);  // bytes, or -1 if unknown

// TOC info request (ch 0, cmd 3): firmware answers {cmd, count u16, crc u32}.
Packet EncodeParamTocInfoRequest();
Packet EncodeParamTocInfoResponse(uint16_t count, uint32_t crc);
bool DecodeParamTocInfoResponse(const Packet& p, uint16_t* count,
                                uint32_t* crc);
// Read request (ch 1): {id u16}; response: {id u16, type u8, value}.
Packet EncodeParamRead(uint16_t id);
bool DecodeParamRead(const Packet& p, uint16_t* id);
Packet EncodeParamValue(uint16_t id, ParamType type, const void* value);
bool DecodeParamValue(const Packet& p, uint16_t* id, ParamType* type,
                      uint8_t value[4]);
// Write (ch 2): {id u16, type u8, value}; firmware echoes a ParamValue ack.
Packet EncodeParamWrite(uint16_t id, ParamType type, const void* value);
bool DecodeParamWrite(const Packet& p, uint16_t* id, ParamType* type,
                      uint8_t value[4]);

// ---- Log block control (port 5 ch 0) — the LogBlock<T> lifecycle the
// reference drives for each telemetry stream (crazyflie_server.cpp:519-651):
// create a block of variables, start it with a period in 10 ms units
// ("start(1) // 10ms"), stop/delete on teardown.
enum class LogControl : uint8_t {
  kDeleteBlock = 2,
  kStartBlock = 3,   // {cmd, block_id, period_10ms}
  kStopBlock = 4,    // {cmd, block_id}
  kReset = 5,
  kCreateBlockV2 = 6,  // {cmd, block_id, (storage_type u8, var_id u16)...}
};
struct LogBlockSpec {
  uint8_t block_id;
  uint8_t n_vars;
  uint8_t var_types[9];
  uint16_t var_ids[9];
};
Packet EncodeLogCreateBlock(const LogBlockSpec& spec);
bool DecodeLogCreateBlock(const Packet& p, LogBlockSpec* out);
Packet EncodeLogStartBlock(uint8_t block_id, uint8_t period_10ms);
Packet EncodeLogStopBlock(uint8_t block_id);
Packet EncodeLogDeleteBlock(uint8_t block_id);
Packet EncodeLogReset();
// Control ack (ch 0 response): {cmd, block_id, status}.
Packet EncodeLogControlAck(uint8_t cmd, uint8_t block_id, uint8_t status);
bool DecodeLogControl(const Packet& p, uint8_t* cmd, uint8_t* block_id,
                      uint8_t* period_10ms /* valid for start */);

// ---- High-level commander (port 8 ch 0) — the reference's takeoff/land/
// goTo/startTrajectory services map 1:1 onto these commands
// (crazyflie_server.cpp:920-992, srv/Takeoff|Land|GoTo|StartTrajectory).
enum class HlCommand : uint8_t {
  kSetGroupMask = 0,
  kStop = 3,
  kGoTo = 4,
  kStartTrajectory = 5,
  kDefineTrajectory = 6,
  kTakeoff2 = 7,
  kLand2 = 8,
};
Packet EncodeHlSetGroupMask(uint8_t group_mask);
Packet EncodeHlTakeoff(uint8_t group_mask, float height_m, float yaw_rad,
                       bool use_current_yaw, float duration_s);
Packet EncodeHlLand(uint8_t group_mask, float height_m, float yaw_rad,
                    bool use_current_yaw, float duration_s);
Packet EncodeHlStop(uint8_t group_mask);
Packet EncodeHlGoTo(uint8_t group_mask, bool relative, float x, float y,
                    float z, float yaw_rad, float duration_s);
Packet EncodeHlStartTrajectory(uint8_t group_mask, bool relative,
                               bool reversed, uint8_t traj_id,
                               float timescale);
Packet EncodeHlDefineTrajectory(uint8_t traj_id, uint32_t mem_offset,
                                uint8_t n_pieces);
struct HlGoTo {
  uint8_t group_mask;
  bool relative;
  float x, y, z, yaw, duration;
};
bool DecodeHlGoTo(const Packet& p, HlGoTo* out);
struct HlTakeoffLand {
  uint8_t command;  // kTakeoff2 or kLand2
  uint8_t group_mask;
  float height, yaw, duration;
  bool use_current_yaw;
};
bool DecodeHlTakeoffLand(const Packet& p, HlTakeoffLand* out);

// ---- Memory access (port 4) — trajectory upload writes packed polynomial
// pieces into the firmware trajectory memory before kDefineTrajectory
// (crazyflie_server.cpp uploadTrajectory / srv/UploadTrajectory).
// ch 1 = read {mem_id u8, addr u32, len u8}, ch 2 = write
// {mem_id u8, addr u32, data...} acked by {mem_id u8, addr u32, status u8}.
constexpr uint8_t kMemIdTrajectory = 0;
constexpr std::size_t kMemWriteChunk = 24;  // payload bytes per write packet
Packet EncodeMemWrite(uint8_t mem_id, uint32_t addr, const uint8_t* data,
                      std::size_t len);
bool DecodeMemWrite(const Packet& p, uint8_t* mem_id, uint32_t* addr,
                    uint8_t data[kMemWriteChunk], uint8_t* len);
Packet EncodeMemWriteAck(uint8_t mem_id, uint32_t addr, uint8_t status);

// ---- Console (port 0): firmware text forwarded to the host logger
// (crazyflie_server.cpp:892-901).
Packet EncodeConsole(const char* text, std::size_t len);
bool DecodeConsole(const Packet& p, char text[kMaxPayload + 1]);

// ---- Smallest-three quaternion compression (the firmware scheme that
// crazyflie_cpp's quatdecompress undoes, crazyflie_server.cpp:853):
// 2 bits index of the largest-|.| component + 3 x 10-bit signed fixed
// point of the remaining components scaled by sqrt(2).
uint32_t QuatCompress(const float q[4]);
void QuatDecompress(uint32_t comp, float q[4]);

}  // namespace cfl
