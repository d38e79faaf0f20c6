// Multi-vehicle link server — the native runtime around the TPU solver.
//
// TPU-native re-design of the reference's crazyflie_server
// (crazyflie_driver/src/crazyflie_server.cpp): one thread per vehicle with
// a private command queue (:155,1056-1204), setpoint encoding to CRTP,
// keep-alive pings when idle (:669-681), the 100-zero-setpoint thrust-lock
// release on connect (:665-667), an emergency latch that halts the loop and
// zeroes motors (:241-249,684-687), and telemetry (log-data) decode back to
// the host (:519-651).
//
// The transport is UDP (one socket per vehicle) — the seam where a real
// Crazyradio driver would attach; simulators and tests speak the same CRTP
// bytes on localhost.  Exported as a C ABI for Python ctypes.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>

#include "crtp.h"
#include "ring.h"

namespace cfl {
namespace {

using Clock = std::chrono::steady_clock;

struct WirePacket {
  uint8_t bytes[32];
  int len;
};

WirePacket Serialize(const Packet& p) {
  WirePacket w;
  w.bytes[0] = p.header;
  std::memcpy(w.bytes + 1, p.data, p.size);
  w.len = 1 + p.size;
  return w;
}

bool Deserialize(const uint8_t* buf, int len, Packet* p) {
  if (len < 1 || len > 31) return false;
  p->header = buf[0];
  p->size = static_cast<uint8_t>(len - 1);
  std::memcpy(p->data, buf + 1, p->size);
  return true;
}

struct LogRecord {
  uint8_t block_id;
  uint32_t timestamp_ms;
  uint8_t payload[26];
  uint8_t payload_size;
};

struct Vehicle {
  int id = -1;
  int sock = -1;
  sockaddr_in peer{};
  std::thread thread;
  std::atomic<bool> running{false};
  std::atomic<bool> emergency{false};
  SpscRing<Packet, 256> tx_ring;       // host -> radio
  SpscRing<LogRecord, 1024> log_ring;  // radio -> host
  SpscRing<Packet, 256> rx_ring;       // radio -> host, non-log packets
                                       // (param acks, console, mem acks)
  // stats
  std::atomic<uint64_t> sent{0};
  std::atomic<uint64_t> received{0};
  std::atomic<uint64_t> pings{0};
  std::atomic<uint64_t> dropped{0};

  void Loop() {
    // thrust-lock release: 100 zero setpoints on connect
    // (crazyflie_server.cpp:665-667)
    for (int i = 0; i < 100 && running.load(); ++i) {
      Send(EncodeSetpoint(0, 0, 0, 0));
    }
    auto last_activity = Clock::now();
    while (running.load()) {
      bool sent_this_cycle = false;
      Packet p;
      while (tx_ring.Pop(&p)) {
        if (emergency.load()) break;
        Send(p);
        sent_this_cycle = true;
      }
      if (emergency.load()) {
        // zero motors and halt the command path (reference :684-687)
        Send(EncodeStop());
        Send(EncodeSetpoint(0, 0, 0, 0));
        running.store(false);
        break;
      }
      // keep-alive ping so onboard log streaming continues
      if (!sent_this_cycle) {
        Send(EncodePing());
        pings.fetch_add(1);
      }
      Receive();
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
      (void)last_activity;
    }
  }

  void Send(const Packet& p) {
    WirePacket w = Serialize(p);
    ::sendto(sock, w.bytes, w.len, 0,
             reinterpret_cast<const sockaddr*>(&peer), sizeof(peer));
    sent.fetch_add(1);
  }

  void Receive() {
    uint8_t buf[64];
    for (;;) {
      const ssize_t n = ::recv(sock, buf, sizeof(buf), MSG_DONTWAIT);
      if (n <= 0) break;
      Packet p;
      if (!Deserialize(buf, static_cast<int>(n), &p)) continue;
      received.fetch_add(1);
      LogData d;
      if (DecodeLogData(p, &d)) {
        LogRecord rec;
        rec.block_id = d.block_id;
        rec.timestamp_ms = d.timestamp_ms;
        rec.payload_size = d.payload_size;
        std::memcpy(rec.payload, d.payload, d.payload_size);
        if (!log_ring.Push(rec)) dropped.fetch_add(1);
      } else if (!cfl::IsPing(p)) {
        // param acks, console text, mem/log-control acks → host poll queue
        if (!rx_ring.Push(p)) dropped.fetch_add(1);
      }
    }
  }
};

struct Server {
  std::mutex mu;
  std::map<int, std::unique_ptr<Vehicle>> vehicles;

  Vehicle* Find(int id) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = vehicles.find(id);
    return it == vehicles.end() ? nullptr : it->second.get();
  }
};

}  // namespace
}  // namespace cfl

using cfl::LogRecord;
using cfl::Packet;
using cfl::Server;
using cfl::Vehicle;

extern "C" {

void* cfl_server_create() { return new Server(); }

void cfl_server_destroy(void* sv) {
  auto* server = static_cast<Server*>(sv);
  {
    std::lock_guard<std::mutex> lock(server->mu);
    for (auto& [id, v] : server->vehicles) {
      v->running.store(false);
      if (v->thread.joinable()) v->thread.join();
      if (v->sock >= 0) ::close(v->sock);
    }
    server->vehicles.clear();
  }
  delete server;
}

// Register a vehicle: bind a local UDP port, aim at the peer (simulator or
// radio bridge), spawn its link thread.  Returns 0 on success.
int cfl_add_vehicle(void* sv, int id, const char* peer_host, int peer_port,
                    int local_port) {
  auto* server = static_cast<Server*>(sv);
  auto v = std::make_unique<Vehicle>();
  v->id = id;
  v->sock = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (v->sock < 0) return -1;
  sockaddr_in local{};
  local.sin_family = AF_INET;
  local.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  local.sin_port = htons(static_cast<uint16_t>(local_port));
  if (::bind(v->sock, reinterpret_cast<sockaddr*>(&local), sizeof(local)) <
      0) {
    ::close(v->sock);
    return -2;
  }
  v->peer.sin_family = AF_INET;
  v->peer.sin_port = htons(static_cast<uint16_t>(peer_port));
  if (::inet_pton(AF_INET, peer_host, &v->peer.sin_addr) != 1) {
    ::close(v->sock);
    return -3;
  }
  v->running.store(true);
  Vehicle* raw = v.get();
  raw->thread = std::thread([raw] { raw->Loop(); });
  std::lock_guard<std::mutex> lock(server->mu);
  server->vehicles[id] = std::move(v);
  return 0;
}

int cfl_remove_vehicle(void* sv, int id) {
  auto* server = static_cast<Server*>(sv);
  std::unique_ptr<Vehicle> v;
  {
    std::lock_guard<std::mutex> lock(server->mu);
    auto it = server->vehicles.find(id);
    if (it == server->vehicles.end()) return -1;
    v = std::move(it->second);
    server->vehicles.erase(it);
  }
  v->running.store(false);
  if (v->thread.joinable()) v->thread.join();
  if (v->sock >= 0) ::close(v->sock);
  return 0;
}

// ---- command path (queued to the vehicle's SPSC ring; the link thread
// encodes + transmits).  Returns 0 ok, -1 unknown vehicle, -2 queue full.
static int QueuePacket(void* sv, int id, const Packet& p) {
  auto* server = static_cast<Server*>(sv);
  Vehicle* v = server->Find(id);
  if (!v) return -1;
  return v->tx_ring.Push(p) ? 0 : -2;
}

int cfl_send_setpoint(void* sv, int id, float roll, float pitch,
                      float yawrate, uint16_t thrust) {
  return QueuePacket(sv, id, cfl::EncodeSetpoint(roll, pitch, yawrate,
                                                 thrust));
}

int cfl_send_stop(void* sv, int id) {
  return QueuePacket(sv, id, cfl::EncodeStop());
}

int cfl_send_hover(void* sv, int id, float vx, float vy, float yawrate,
                   float zd) {
  return QueuePacket(sv, id, cfl::EncodeHover(vx, vy, yawrate, zd));
}

int cfl_send_position(void* sv, int id, float x, float y, float z,
                      float yaw) {
  return QueuePacket(sv, id, cfl::EncodePosition(x, y, z, yaw));
}

int cfl_send_full_state(void* sv, int id, const float* pos, const float* vel,
                        const float* acc, const float* quat,
                        const float* omega) {
  cfl::FullState s;
  std::memcpy(s.pos, pos, 12);
  std::memcpy(s.vel, vel, 12);
  std::memcpy(s.acc, acc, 12);
  std::memcpy(s.quat, quat, 16);
  std::memcpy(s.omega, omega, 12);
  return QueuePacket(sv, id, cfl::EncodeFullState(s));
}

int cfl_send_external_position(void* sv, int id, float x, float y, float z) {
  return QueuePacket(sv, id, cfl::EncodeExternalPosition(x, y, z));
}

int cfl_send_external_pose(void* sv, int id, float x, float y, float z,
                           const float* quat) {
  return QueuePacket(sv, id, cfl::EncodeExternalPose(x, y, z, quat));
}

int cfl_emergency(void* sv, int id) {
  auto* server = static_cast<Server*>(sv);
  Vehicle* v = server->Find(id);
  if (!v) return -1;
  v->emergency.store(true);
  return 0;
}

// ---- parameter access (port 2): write is fire-and-forget here; the ack
// comes back through cfl_poll_packet (the reference's updateParams service
// + param TOC, crazyflie_server.cpp:485-517).
int cfl_param_write(void* sv, int id, uint16_t param_id, uint8_t type,
                    const uint8_t* value) {
  return QueuePacket(
      sv, id,
      cfl::EncodeParamWrite(param_id, static_cast<cfl::ParamType>(type),
                            value));
}

int cfl_param_read(void* sv, int id, uint16_t param_id) {
  return QueuePacket(sv, id, cfl::EncodeParamRead(param_id));
}

int cfl_param_toc_info(void* sv, int id) {
  return QueuePacket(sv, id, cfl::EncodeParamTocInfoRequest());
}

// ---- log block lifecycle (port 5 ch 0, LogBlock<T> semantics).
int cfl_log_create_block(void* sv, int id, uint8_t block_id, int n_vars,
                         const uint8_t* var_types, const uint16_t* var_ids) {
  cfl::LogBlockSpec spec;
  spec.block_id = block_id;
  spec.n_vars = static_cast<uint8_t>(n_vars > 9 ? 9 : n_vars);
  for (int i = 0; i < spec.n_vars; ++i) {
    spec.var_types[i] = var_types[i];
    spec.var_ids[i] = var_ids[i];
  }
  return QueuePacket(sv, id, cfl::EncodeLogCreateBlock(spec));
}

int cfl_log_start_block(void* sv, int id, uint8_t block_id,
                        uint8_t period_10ms) {
  return QueuePacket(sv, id,
                     cfl::EncodeLogStartBlock(block_id, period_10ms));
}

int cfl_log_stop_block(void* sv, int id, uint8_t block_id) {
  return QueuePacket(sv, id, cfl::EncodeLogStopBlock(block_id));
}

// ---- high-level commander (port 8): the takeoff/land/goTo/trajectory
// services (crazyflie_server.cpp:920-992).
int cfl_send_takeoff(void* sv, int id, uint8_t group, float height,
                     float duration) {
  return QueuePacket(sv, id,
                     cfl::EncodeHlTakeoff(group, height, 0.0f, true,
                                          duration));
}

int cfl_send_land(void* sv, int id, uint8_t group, float height,
                  float duration) {
  return QueuePacket(sv, id,
                     cfl::EncodeHlLand(group, height, 0.0f, true, duration));
}

int cfl_send_goto(void* sv, int id, uint8_t group, int relative, float x,
                  float y, float z, float yaw, float duration) {
  return QueuePacket(sv, id,
                     cfl::EncodeHlGoTo(group, relative != 0, x, y, z, yaw,
                                       duration));
}

int cfl_send_set_group_mask(void* sv, int id, uint8_t group) {
  return QueuePacket(sv, id, cfl::EncodeHlSetGroupMask(group));
}

int cfl_send_hl_stop(void* sv, int id, uint8_t group) {
  return QueuePacket(sv, id, cfl::EncodeHlStop(group));
}

int cfl_send_start_trajectory(void* sv, int id, uint8_t group, int relative,
                              int reversed, uint8_t traj_id,
                              float timescale) {
  return QueuePacket(sv, id,
                     cfl::EncodeHlStartTrajectory(group, relative != 0,
                                                  reversed != 0, traj_id,
                                                  timescale));
}

// Upload a trajectory blob: chunked mem writes + define-trajectory.
// Returns number of packets queued, or <0 on error.
int cfl_upload_trajectory(void* sv, int id, uint8_t traj_id,
                          uint32_t mem_offset, const uint8_t* data, int len,
                          uint8_t n_pieces) {
  int queued = 0;
  for (int off = 0; off < len;
       off += static_cast<int>(cfl::kMemWriteChunk)) {
    const int n = std::min<int>(cfl::kMemWriteChunk, len - off);
    const int rc = QueuePacket(
        sv, id,
        cfl::EncodeMemWrite(cfl::kMemIdTrajectory, mem_offset + off,
                            data + off, n));
    if (rc != 0) return rc;
    ++queued;
  }
  const int rc = QueuePacket(
      sv, id, cfl::EncodeHlDefineTrajectory(traj_id, mem_offset, n_pieces));
  if (rc != 0) return rc;
  return queued + 1;
}

// ---- generic packet path: the reference's send_packet service
// (crazyflie_server.cpp srv/sendPacket) and the host-side poll for
// non-log downlink traffic (param acks, console).
int cfl_send_packet(void* sv, int id, uint8_t header, const uint8_t* data,
                    int size) {
  Packet p;
  p.header = header;
  p.size = static_cast<uint8_t>(size > 30 ? 30 : size);
  std::memcpy(p.data, data, p.size);
  return QueuePacket(sv, id, p);
}

// Pop one non-log downlink packet: returns payload size >= 0 (header via
// out-param), or -1 if none / unknown vehicle.
int cfl_poll_packet(void* sv, int id, uint8_t* header,
                    uint8_t* data /* >= 30 bytes */) {
  auto* server = static_cast<Server*>(sv);
  Vehicle* v = server->Find(id);
  if (!v) return -1;
  Packet p;
  if (!v->rx_ring.Pop(&p)) return -1;
  *header = p.header;
  std::memcpy(data, p.data, p.size);
  return p.size;
}

// ---- telemetry path: pop one decoded log record; returns payload size
// >= 0, or -1 if none / unknown vehicle.
int cfl_poll_log(void* sv, int id, uint8_t* block_id, uint32_t* timestamp_ms,
                 uint8_t* payload /* >= 26 bytes */) {
  auto* server = static_cast<Server*>(sv);
  Vehicle* v = server->Find(id);
  if (!v) return -1;
  LogRecord rec;
  if (!v->log_ring.Pop(&rec)) return -1;
  *block_id = rec.block_id;
  *timestamp_ms = rec.timestamp_ms;
  std::memcpy(payload, rec.payload, rec.payload_size);
  return rec.payload_size;
}

int cfl_stats(void* sv, int id, uint64_t* sent, uint64_t* received,
              uint64_t* pings, uint64_t* dropped) {
  auto* server = static_cast<Server*>(sv);
  Vehicle* v = server->Find(id);
  if (!v) return -1;
  *sent = v->sent.load();
  *received = v->received.load();
  *pings = v->pings.load();
  *dropped = v->dropped.load();
  return 0;
}

// ---- standalone codec entry points (testable without a server)
int cfl_encode_setpoint(float roll, float pitch, float yawrate,
                        uint16_t thrust, uint8_t* out /*>=32*/) {
  auto w = cfl::Serialize(cfl::EncodeSetpoint(roll, pitch, yawrate, thrust));
  std::memcpy(out, w.bytes, w.len);
  return w.len;
}

int cfl_decode_setpoint(const uint8_t* buf, int len, float* roll,
                        float* pitch, float* yawrate, uint16_t* thrust) {
  Packet p;
  if (!cfl::Deserialize(buf, len, &p)) return -1;
  return cfl::DecodeSetpoint(p, roll, pitch, yawrate, thrust) ? 0 : -1;
}

int cfl_encode_full_state(const float* pos, const float* vel,
                          const float* acc, const float* quat,
                          const float* omega, uint8_t* out) {
  cfl::FullState s;
  std::memcpy(s.pos, pos, 12);
  std::memcpy(s.vel, vel, 12);
  std::memcpy(s.acc, acc, 12);
  std::memcpy(s.quat, quat, 16);
  std::memcpy(s.omega, omega, 12);
  auto w = cfl::Serialize(cfl::EncodeFullState(s));
  std::memcpy(out, w.bytes, w.len);
  return w.len;
}

int cfl_decode_full_state(const uint8_t* buf, int len, float* pos,
                          float* vel, float* acc, float* quat,
                          float* omega) {
  Packet p;
  cfl::FullState s;
  if (!cfl::Deserialize(buf, len, &p)) return -1;
  if (!cfl::DecodeFullState(p, &s)) return -1;
  std::memcpy(pos, s.pos, 12);
  std::memcpy(vel, s.vel, 12);
  std::memcpy(acc, s.acc, 12);
  std::memcpy(quat, s.quat, 16);
  std::memcpy(omega, s.omega, 12);
  return 0;
}

int cfl_encode_log_data(uint8_t block_id, uint32_t timestamp_ms,
                        const uint8_t* payload, int payload_size,
                        uint8_t* out) {
  cfl::LogData d;
  d.block_id = block_id;
  d.timestamp_ms = timestamp_ms;
  d.payload_size = static_cast<uint8_t>(payload_size);
  std::memcpy(d.payload, payload, payload_size);
  auto w = cfl::Serialize(cfl::EncodeLogData(d));
  std::memcpy(out, w.bytes, w.len);
  return w.len;
}

uint32_t cfl_quat_compress(const float* q) { return cfl::QuatCompress(q); }

void cfl_quat_decompress(uint32_t comp, float* q) {
  cfl::QuatDecompress(comp, q);
}

}  // extern "C"
