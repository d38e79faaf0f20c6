#include "crtp.h"

#include <algorithm>
#include <cmath>

namespace cfl {

static_assert(sizeof(float) == 4, "float must be IEEE-754 binary32");

namespace {
// one byte of endianness paranoia: all fields are packed little-endian via
// memcpy; on big-endian hosts this codec would need byte swaps.
const uint16_t kOne = 1;
const bool kLittleEndian = *reinterpret_cast<const uint8_t*>(&kOne) == 1;

int16_t ToI16(float v) {
  float r = std::nearbyint(v);
  r = std::min(32767.0f, std::max(-32768.0f, r));
  return static_cast<int16_t>(r);
}
}  // namespace

using detail::Get;
using detail::Put;

Packet EncodeSetpoint(float roll_deg, float pitch_deg, float yawrate_deg,
                      uint16_t thrust) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kCommander, 0);
  p.size = 14;
  Put(p.data, 0, roll_deg);
  Put(p.data, 4, pitch_deg);
  Put(p.data, 8, yawrate_deg);
  Put(p.data, 12, thrust);
  return p;
}

bool DecodeSetpoint(const Packet& p, float* roll, float* pitch,
                    float* yawrate, uint16_t* thrust) {
  if (p.port() != Port::kCommander || p.size != 14) return false;
  *roll = Get<float>(p.data, 0);
  *pitch = Get<float>(p.data, 4);
  *yawrate = Get<float>(p.data, 8);
  *thrust = Get<uint16_t>(p.data, 12);
  return true;
}

Packet EncodeStop() {
  Packet p;
  p.header = Packet::MakeHeader(Port::kGenericSetpoint, 0);
  p.size = 1;
  p.data[0] = static_cast<uint8_t>(SetpointType::kStop);
  return p;
}

Packet EncodeHover(float vx, float vy, float yawrate_deg, float z_distance) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kGenericSetpoint, 0);
  p.size = 17;
  p.data[0] = static_cast<uint8_t>(SetpointType::kHover);
  Put(p.data, 1, vx);
  Put(p.data, 5, vy);
  Put(p.data, 9, yawrate_deg);
  Put(p.data, 13, z_distance);
  return p;
}

Packet EncodePosition(float x, float y, float z, float yaw_deg) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kGenericSetpoint, 0);
  p.size = 17;
  p.data[0] = static_cast<uint8_t>(SetpointType::kPosition);
  Put(p.data, 1, x);
  Put(p.data, 5, y);
  Put(p.data, 9, z);
  Put(p.data, 13, yaw_deg);
  return p;
}

Packet EncodeFullState(const FullState& s) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kGenericSetpoint, 0);
  p.size = 29;  // 1 type + 9*int16 + 4 quat + 3*int16
  p.data[0] = static_cast<uint8_t>(SetpointType::kFullState);
  std::size_t o = 1;
  for (int i = 0; i < 3; ++i, o += 2)
    Put(p.data, o, ToI16(s.pos[i] * 1000.0f));
  for (int i = 0; i < 3; ++i, o += 2)
    Put(p.data, o, ToI16(s.vel[i] * 1000.0f));
  for (int i = 0; i < 3; ++i, o += 2)
    Put(p.data, o, ToI16(s.acc[i] * 1000.0f));
  Put(p.data, o, QuatCompress(s.quat));
  o += 4;
  for (int i = 0; i < 3; ++i, o += 2)
    Put(p.data, o, ToI16(s.omega[i] * 1000.0f));
  return p;
}

bool DecodeFullState(const Packet& p, FullState* out) {
  if (p.port() != Port::kGenericSetpoint || p.size != 29 ||
      p.data[0] != static_cast<uint8_t>(SetpointType::kFullState))
    return false;
  std::size_t o = 1;
  for (int i = 0; i < 3; ++i, o += 2)
    out->pos[i] = Get<int16_t>(p.data, o) * 1e-3f;
  for (int i = 0; i < 3; ++i, o += 2)
    out->vel[i] = Get<int16_t>(p.data, o) * 1e-3f;
  for (int i = 0; i < 3; ++i, o += 2)
    out->acc[i] = Get<int16_t>(p.data, o) * 1e-3f;
  QuatDecompress(Get<uint32_t>(p.data, o), out->quat);
  o += 4;
  for (int i = 0; i < 3; ++i, o += 2)
    out->omega[i] = Get<int16_t>(p.data, o) * 1e-3f;
  return true;
}

Packet EncodeExternalPosition(float x, float y, float z) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kLocalization, 0);
  p.size = 12;
  Put(p.data, 0, x);
  Put(p.data, 4, y);
  Put(p.data, 8, z);
  return p;
}

bool DecodeExternalPosition(const Packet& p, float* x, float* y, float* z) {
  if (p.port() != Port::kLocalization || p.channel() != 0 || p.size != 12)
    return false;
  *x = Get<float>(p.data, 0);
  *y = Get<float>(p.data, 4);
  *z = Get<float>(p.data, 8);
  return true;
}

Packet EncodeExternalPose(float x, float y, float z, const float quat[4]) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kLocalization, 1);
  p.size = 17;
  p.data[0] = 8;  // generic-loc ext-pose type
  Put(p.data, 1, x);
  Put(p.data, 5, y);
  Put(p.data, 9, z);
  Put(p.data, 13, QuatCompress(quat));
  return p;
}

Packet EncodeLogData(const LogData& d) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kLog, 2);
  p.size = static_cast<uint8_t>(4 + d.payload_size);
  p.data[0] = d.block_id;
  p.data[1] = static_cast<uint8_t>(d.timestamp_ms & 0xFF);
  p.data[2] = static_cast<uint8_t>((d.timestamp_ms >> 8) & 0xFF);
  p.data[3] = static_cast<uint8_t>((d.timestamp_ms >> 16) & 0xFF);
  std::memcpy(p.data + 4, d.payload, d.payload_size);
  return p;
}

bool DecodeLogData(const Packet& p, LogData* out) {
  if (p.port() != Port::kLog || p.channel() != 2 || p.size < 4) return false;
  out->block_id = p.data[0];
  out->timestamp_ms = static_cast<uint32_t>(p.data[1]) |
                      (static_cast<uint32_t>(p.data[2]) << 8) |
                      (static_cast<uint32_t>(p.data[3]) << 16);
  out->payload_size = static_cast<uint8_t>(p.size - 4);
  std::memcpy(out->payload, p.data + 4, out->payload_size);
  return true;
}

Packet EncodePing() {
  Packet p;
  p.header = Packet::MakeHeader(Port::kLink, 3);
  p.size = 0;
  return p;
}

bool IsPing(const Packet& p) {
  return p.port() == Port::kLink && p.channel() == 3 && p.size == 0;
}

// ---- Parameters (port 2) ------------------------------------------------

int ParamTypeSize(ParamType t) {
  switch (t) {
    case ParamType::kUint8:
    case ParamType::kInt8:
      return 1;
    case ParamType::kUint16:
    case ParamType::kInt16:
      return 2;
    case ParamType::kUint32:
    case ParamType::kInt32:
    case ParamType::kFloat:
      return 4;
  }
  return -1;
}

Packet EncodeParamTocInfoRequest() {
  Packet p;
  p.header = Packet::MakeHeader(Port::kParam, 0);
  p.size = 1;
  p.data[0] = 3;  // TOC_INFO_V2
  return p;
}

Packet EncodeParamTocInfoResponse(uint16_t count, uint32_t crc) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kParam, 0);
  p.size = 7;
  p.data[0] = 3;
  Put(p.data, 1, count);
  Put(p.data, 3, crc);
  return p;
}

bool DecodeParamTocInfoResponse(const Packet& p, uint16_t* count,
                                uint32_t* crc) {
  if (p.port() != Port::kParam || p.channel() != 0 || p.size != 7 ||
      p.data[0] != 3)
    return false;
  *count = Get<uint16_t>(p.data, 1);
  *crc = Get<uint32_t>(p.data, 3);
  return true;
}

Packet EncodeParamRead(uint16_t id) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kParam, 1);
  p.size = 2;
  Put(p.data, 0, id);
  return p;
}

bool DecodeParamRead(const Packet& p, uint16_t* id) {
  if (p.port() != Port::kParam || p.channel() != 1 || p.size != 2)
    return false;
  *id = Get<uint16_t>(p.data, 0);
  return true;
}

namespace {
Packet EncodeParamIdTypeValue(uint8_t channel, uint16_t id, ParamType type,
                              const void* value) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kParam, channel);
  const int n = ParamTypeSize(type);
  p.size = static_cast<uint8_t>(3 + n);
  Put(p.data, 0, id);
  p.data[2] = static_cast<uint8_t>(type);
  std::memcpy(p.data + 3, value, n);
  return p;
}

bool DecodeParamIdTypeValue(const Packet& p, uint8_t channel, uint16_t* id,
                            ParamType* type, uint8_t value[4]) {
  if (p.port() != Port::kParam || p.channel() != channel || p.size < 4)
    return false;
  *id = Get<uint16_t>(p.data, 0);
  *type = static_cast<ParamType>(p.data[2]);
  const int n = ParamTypeSize(*type);
  if (n < 0 || p.size != 3 + n) return false;
  std::memset(value, 0, 4);
  std::memcpy(value, p.data + 3, n);
  return true;
}
}  // namespace

Packet EncodeParamValue(uint16_t id, ParamType type, const void* value) {
  return EncodeParamIdTypeValue(1, id, type, value);
}

bool DecodeParamValue(const Packet& p, uint16_t* id, ParamType* type,
                      uint8_t value[4]) {
  return DecodeParamIdTypeValue(p, 1, id, type, value);
}

Packet EncodeParamWrite(uint16_t id, ParamType type, const void* value) {
  return EncodeParamIdTypeValue(2, id, type, value);
}

bool DecodeParamWrite(const Packet& p, uint16_t* id, ParamType* type,
                      uint8_t value[4]) {
  return DecodeParamIdTypeValue(p, 2, id, type, value);
}

// ---- Log block control (port 5 ch 0) -------------------------------------

Packet EncodeLogCreateBlock(const LogBlockSpec& spec) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kLog, 0);
  p.data[0] = static_cast<uint8_t>(LogControl::kCreateBlockV2);
  p.data[1] = spec.block_id;
  std::size_t o = 2;
  for (int i = 0; i < spec.n_vars && i < 9; ++i) {
    p.data[o++] = spec.var_types[i];
    Put(p.data, o, spec.var_ids[i]);
    o += 2;
  }
  p.size = static_cast<uint8_t>(o);
  return p;
}

bool DecodeLogCreateBlock(const Packet& p, LogBlockSpec* out) {
  if (p.port() != Port::kLog || p.channel() != 0 || p.size < 2 ||
      p.data[0] != static_cast<uint8_t>(LogControl::kCreateBlockV2))
    return false;
  if ((p.size - 2) % 3 != 0) return false;
  out->block_id = p.data[1];
  out->n_vars = static_cast<uint8_t>((p.size - 2) / 3);
  if (out->n_vars > 9) return false;
  std::size_t o = 2;
  for (int i = 0; i < out->n_vars; ++i) {
    out->var_types[i] = p.data[o++];
    out->var_ids[i] = Get<uint16_t>(p.data, o);
    o += 2;
  }
  return true;
}

namespace {
Packet LogControlPacket(LogControl cmd, uint8_t block_id, int period = -1) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kLog, 0);
  p.data[0] = static_cast<uint8_t>(cmd);
  p.data[1] = block_id;
  if (period >= 0) {
    p.data[2] = static_cast<uint8_t>(period);
    p.size = 3;
  } else {
    p.size = 2;
  }
  return p;
}
}  // namespace

Packet EncodeLogStartBlock(uint8_t block_id, uint8_t period_10ms) {
  return LogControlPacket(LogControl::kStartBlock, block_id, period_10ms);
}
Packet EncodeLogStopBlock(uint8_t block_id) {
  return LogControlPacket(LogControl::kStopBlock, block_id);
}
Packet EncodeLogDeleteBlock(uint8_t block_id) {
  return LogControlPacket(LogControl::kDeleteBlock, block_id);
}
Packet EncodeLogReset() {
  Packet p;
  p.header = Packet::MakeHeader(Port::kLog, 0);
  p.data[0] = static_cast<uint8_t>(LogControl::kReset);
  p.size = 1;
  return p;
}

Packet EncodeLogControlAck(uint8_t cmd, uint8_t block_id, uint8_t status) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kLog, 0);
  p.data[0] = cmd;
  p.data[1] = block_id;
  p.data[2] = status;
  p.size = 3;
  return p;
}

bool DecodeLogControl(const Packet& p, uint8_t* cmd, uint8_t* block_id,
                      uint8_t* period_10ms) {
  if (p.port() != Port::kLog || p.channel() != 0 || p.size < 1) return false;
  *cmd = p.data[0];
  *block_id = p.size >= 2 ? p.data[1] : 0;
  *period_10ms = p.size >= 3 ? p.data[2] : 0;
  return true;
}

// ---- High-level commander (port 8 ch 0) -----------------------------------

namespace {
Packet HlPacket(HlCommand cmd, uint8_t size) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kSetpointHl, 0);
  p.data[0] = static_cast<uint8_t>(cmd);
  p.size = size;
  return p;
}
}  // namespace

Packet EncodeHlSetGroupMask(uint8_t group_mask) {
  Packet p = HlPacket(HlCommand::kSetGroupMask, 2);
  p.data[1] = group_mask;
  return p;
}

namespace {
Packet HlTakeoffLandPacket(HlCommand cmd, uint8_t group_mask, float height,
                           float yaw, bool use_current_yaw, float duration) {
  Packet p = HlPacket(cmd, 15);
  p.data[1] = group_mask;
  Put(p.data, 2, height);
  Put(p.data, 6, yaw);
  p.data[10] = use_current_yaw ? 1 : 0;
  Put(p.data, 11, duration);
  return p;
}
}  // namespace

Packet EncodeHlTakeoff(uint8_t group_mask, float height_m, float yaw_rad,
                       bool use_current_yaw, float duration_s) {
  return HlTakeoffLandPacket(HlCommand::kTakeoff2, group_mask, height_m,
                             yaw_rad, use_current_yaw, duration_s);
}

Packet EncodeHlLand(uint8_t group_mask, float height_m, float yaw_rad,
                    bool use_current_yaw, float duration_s) {
  return HlTakeoffLandPacket(HlCommand::kLand2, group_mask, height_m,
                             yaw_rad, use_current_yaw, duration_s);
}

Packet EncodeHlStop(uint8_t group_mask) {
  Packet p = HlPacket(HlCommand::kStop, 2);
  p.data[1] = group_mask;
  return p;
}

Packet EncodeHlGoTo(uint8_t group_mask, bool relative, float x, float y,
                    float z, float yaw_rad, float duration_s) {
  Packet p = HlPacket(HlCommand::kGoTo, 23);
  p.data[1] = group_mask;
  p.data[2] = relative ? 1 : 0;
  Put(p.data, 3, x);
  Put(p.data, 7, y);
  Put(p.data, 11, z);
  Put(p.data, 15, yaw_rad);
  Put(p.data, 19, duration_s);
  return p;
}

Packet EncodeHlStartTrajectory(uint8_t group_mask, bool relative,
                               bool reversed, uint8_t traj_id,
                               float timescale) {
  Packet p = HlPacket(HlCommand::kStartTrajectory, 9);
  p.data[1] = group_mask;
  p.data[2] = relative ? 1 : 0;
  p.data[3] = reversed ? 1 : 0;
  p.data[4] = traj_id;
  Put(p.data, 5, timescale);
  return p;
}

Packet EncodeHlDefineTrajectory(uint8_t traj_id, uint32_t mem_offset,
                                uint8_t n_pieces) {
  Packet p = HlPacket(HlCommand::kDefineTrajectory, 8);
  p.data[1] = traj_id;
  p.data[2] = 0;  // TRAJECTORY_TYPE_POLY4D
  Put(p.data, 3, mem_offset);
  p.data[7] = n_pieces;
  return p;
}

bool DecodeHlGoTo(const Packet& p, HlGoTo* out) {
  if (p.port() != Port::kSetpointHl || p.size != 23 ||
      p.data[0] != static_cast<uint8_t>(HlCommand::kGoTo))
    return false;
  out->group_mask = p.data[1];
  out->relative = p.data[2] != 0;
  out->x = Get<float>(p.data, 3);
  out->y = Get<float>(p.data, 7);
  out->z = Get<float>(p.data, 11);
  out->yaw = Get<float>(p.data, 15);
  out->duration = Get<float>(p.data, 19);
  return true;
}

bool DecodeHlTakeoffLand(const Packet& p, HlTakeoffLand* out) {
  if (p.port() != Port::kSetpointHl || p.size != 15) return false;
  if (p.data[0] != static_cast<uint8_t>(HlCommand::kTakeoff2) &&
      p.data[0] != static_cast<uint8_t>(HlCommand::kLand2))
    return false;
  out->command = p.data[0];
  out->group_mask = p.data[1];
  out->height = Get<float>(p.data, 2);
  out->yaw = Get<float>(p.data, 6);
  out->use_current_yaw = p.data[10] != 0;
  out->duration = Get<float>(p.data, 11);
  return true;
}

// ---- Memory access (port 4) -----------------------------------------------

Packet EncodeMemWrite(uint8_t mem_id, uint32_t addr, const uint8_t* data,
                      std::size_t len) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kMem, 2);
  if (len > kMemWriteChunk) len = kMemWriteChunk;
  p.size = static_cast<uint8_t>(5 + len);
  p.data[0] = mem_id;
  Put(p.data, 1, addr);
  std::memcpy(p.data + 5, data, len);
  return p;
}

bool DecodeMemWrite(const Packet& p, uint8_t* mem_id, uint32_t* addr,
                    uint8_t data[kMemWriteChunk], uint8_t* len) {
  if (p.port() != Port::kMem || p.channel() != 2 || p.size < 5) return false;
  *mem_id = p.data[0];
  *addr = Get<uint32_t>(p.data, 1);
  *len = static_cast<uint8_t>(p.size - 5);
  std::memcpy(data, p.data + 5, *len);
  return true;
}

Packet EncodeMemWriteAck(uint8_t mem_id, uint32_t addr, uint8_t status) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kMem, 2);
  p.size = 6;
  p.data[0] = mem_id;
  Put(p.data, 1, addr);
  p.data[5] = status;
  return p;
}

// ---- Console (port 0) ------------------------------------------------------

Packet EncodeConsole(const char* text, std::size_t len) {
  Packet p;
  p.header = Packet::MakeHeader(Port::kConsole, 0);
  if (len > kMaxPayload) len = kMaxPayload;
  p.size = static_cast<uint8_t>(len);
  std::memcpy(p.data, text, len);
  return p;
}

bool DecodeConsole(const Packet& p, char text[kMaxPayload + 1]) {
  if (p.port() != Port::kConsole) return false;
  std::memcpy(text, p.data, p.size);
  text[p.size] = '\0';
  return true;
}

uint32_t QuatCompress(const float q[4]) {
  // smallest-three: find largest-|.| component, store its index; encode the
  // other three as signed 10-bit fixed point over [-1/sqrt2, 1/sqrt2],
  // negating the quaternion if the largest component is negative (q and -q
  // are the same rotation).
  unsigned largest = 0;
  for (unsigned i = 1; i < 4; ++i)
    if (std::fabs(q[i]) > std::fabs(q[largest])) largest = i;
  const float sign = q[largest] < 0 ? -1.0f : 1.0f;
  const float kSqrt2 = 1.41421356237f;
  uint32_t comp = largest;
  for (unsigned i = 0; i < 4; ++i) {
    if (i == largest) continue;
    const float v = sign * q[i];
    const int neg = v < 0;
    const uint32_t mag = static_cast<uint32_t>(
        std::min(511.0f, std::nearbyint(511.0f * kSqrt2 * std::fabs(v))));
    comp = (comp << 10) | (static_cast<uint32_t>(neg) << 9) | mag;
  }
  return comp;
}

void QuatDecompress(uint32_t comp, float q[4]) {
  const float kSqrt1_2 = 0.70710678118f;
  const unsigned largest = comp >> 30;
  float sum_sq = 0.0f;
  for (int i = 3; i >= 0; --i) {
    if (static_cast<unsigned>(i) == largest) continue;
    const unsigned mag = comp & 0x1FF;
    const unsigned neg = (comp >> 9) & 0x1;
    comp >>= 10;
    q[i] = (kSqrt1_2 * static_cast<float>(mag)) / 511.0f;
    if (neg) q[i] = -q[i];
    sum_sq += q[i] * q[i];
  }
  q[largest] = std::sqrt(std::max(0.0f, 1.0f - sum_sq));
}

}  // namespace cfl
