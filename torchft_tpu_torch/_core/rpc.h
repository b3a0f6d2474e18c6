// Lightweight blocking RPC over TCP with length-prefixed protobuf payloads.
//
// Plays the role tonic/gRPC plays in the reference control plane
// (/root/reference/src/lighthouse.rs, /root/reference/src/manager.rs) without
// an h2 dependency. Framing:
//   request:  [u32le len][u8 method][len-1 bytes payload]
//   response: [u32le len][u8 status][len-1 bytes payload]   status 0=OK else error
// Connections are persistent; the server runs one thread per connection so a
// handler may block (quorum rendezvous parks until the round completes, the
// same way reference handlers park on tokio broadcast channels).
//
// The server sniffs the first byte of each connection: ASCII 'G'/'P'/'H'
// (GET/POST/HEAD) routes to an optional HTTP handler — this is how the
// reference lighthouse serves its dashboard and gRPC on one port
// (src/lighthouse.rs:257-263 accept_http1).
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <functional>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace torchft_tpu {

// Method ids (shared client/server).
enum Method : uint8_t {
  kLighthouseQuorum = 1,
  kLighthouseHeartbeat = 2,
  kLighthouseStatus = 3,
  kLighthouseReplicate = 4,
  kManagerQuorum = 10,
  kManagerCheckpointAddress = 11,
  kManagerShouldCommit = 12,
  kManagerKill = 13,
  kStoreSet = 20,
  kStoreGet = 21,
};

// Returns true on success (resp filled), false on error (err filled).
using RpcHandler = std::function<bool(uint8_t method, const std::string& req,
                                      std::string* resp, std::string* err)>;
// Raw HTTP: given the full request head (up to blank line) + any body read,
// produce a complete HTTP response byte string.
using HttpHandler = std::function<std::string(const std::string& request)>;

class RpcServer {
 public:
  // bind is "host:port"; port 0 picks an ephemeral port.
  RpcServer(const std::string& bind, RpcHandler handler,
            HttpHandler http_handler = nullptr);
  ~RpcServer();

  // "host:port" actually bound (resolves port 0).
  std::string address() const { return address_; }
  void shutdown();

 private:
  void accept_loop();
  void serve_conn(int fd);

  int listen_fd_ = -1;
  std::string address_;
  RpcHandler handler_;
  HttpHandler http_handler_;
  std::thread accept_thread_;
  std::mutex conns_mu_;
  std::condition_variable conns_cv_;
  // Live connection fds only; serve_conn threads are detached and deregister
  // themselves on exit (dashboard polling creates one short-lived connection
  // per second — tracking finished threads forever would leak).
  std::set<int> conn_fds_;
  bool shutdown_ = false;
};

class RpcClient {
 public:
  // Blocks until connected or timeout; throws std::runtime_error on failure.
  RpcClient(const std::string& address, int64_t connect_timeout_ms);
  ~RpcClient();

  // Blocking call; serialized per-client (mutex). timeout_ms <= 0 means no
  // deadline. Returns true with *resp on OK; false with *err otherwise.
  // Transport failures also return false (err prefixed "transport:").
  bool call(uint8_t method, const std::string& req, std::string* resp,
            std::string* err, int64_t timeout_ms);

  // Thread-safe: aborts any in-flight call (its socket read fails
  // immediately) and makes all future calls fail fast. Used to make
  // server shutdown cancellable while a call is parked at a peer.
  void cancel();

  const std::string& address() const { return address_; }

  // Per-client monotonic call sequence. Stamped into request payloads by
  // callers that need the server to distinguish a NEW invocation from a
  // transport-level retry of a lost response: call() re-sends the *same*
  // serialized payload on retry, so same seq = replay-safe retry, higher
  // seq = fresh round.
  int64_t next_seq() { return ++seq_; }

 private:
  bool reconnect(std::string* err);
  bool check_cancelled(std::string* err);
  std::string address_;
  int64_t connect_timeout_ms_;
  int fd_ = -1;
  std::mutex mu_;
  // Guards fd_ swaps/cancellation only (mu_ is held for a whole call, so
  // cancel() cannot take it).
  std::mutex fd_mu_;
  bool cancelled_ = false;
  std::atomic<int64_t> seq_{0};
};

// --- small net utils (shared with the checkpoint/http bits) ---
// JSON string-escape for hand-built status bodies (quotes, backslashes,
// and control characters).
std::string json_escape(const std::string& s);
int net_listen(const std::string& bind, std::string* bound_addr);
int net_connect(const std::string& address, int64_t timeout_ms);
bool net_read_exact(int fd, void* buf, size_t n);
bool net_write_all(int fd, const void* buf, size_t n);
int64_t now_ms();

}  // namespace torchft_tpu
