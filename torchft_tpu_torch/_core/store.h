// In-memory KV store with blocking waits, served over the RPC layer.
//
// Plays the role torch's TCPStore plays in the reference for communicator
// rendezvous and manager-address discovery
// (/root/reference/torchft/process_group.py:67-85,
//  /root/reference/torchft/manager.py:137-167). Keys are arbitrary strings —
// callers namespace them with quorum-id prefixes exactly like the reference's
// PrefixStore trick ("{store}/torchft/{quorum_id}/{rank}",
// /root/reference/torchft/manager.py:374-376) so stragglers from an old
// quorum can never collide with the new one.
#pragma once

#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <string>

#include "rpc.h"

namespace torchft_tpu {

class StoreServer {
 public:
  explicit StoreServer(const std::string& bind);
  std::string address() const { return server_->address(); }
  void shutdown() { server_->shutdown(); }

 private:
  bool handle(uint8_t method, const std::string& req, std::string* resp,
              std::string* err);
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<std::string, std::string> data_;
  std::unique_ptr<RpcServer> server_;
};

class StoreClient {
 public:
  StoreClient(const std::string& address, int64_t connect_timeout_ms);
  void set(const std::string& key, const std::string& value);
  // Blocks up to timeout_ms for the key; throws std::runtime_error on timeout.
  std::string get(const std::string& key, int64_t timeout_ms);

 private:
  RpcClient client_;
};

}  // namespace torchft_tpu
