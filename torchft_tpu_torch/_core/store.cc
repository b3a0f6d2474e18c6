#include "store.h"

#include <stdexcept>

#include "torchft.pb.h"

namespace torchft_tpu {

StoreServer::StoreServer(const std::string& bind) {
  server_ = std::make_unique<RpcServer>(
      bind, [this](uint8_t m, const std::string& req, std::string* resp,
                   std::string* err) { return handle(m, req, resp, err); });
}

bool StoreServer::handle(uint8_t method, const std::string& req,
                         std::string* resp, std::string* err) {
  switch (method) {
    case kStoreSet: {
      StoreSetRequest r;
      if (!r.ParseFromString(req)) {
        *err = "bad StoreSetRequest";
        return false;
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        data_[r.key()] = r.value();
      }
      cv_.notify_all();
      *resp = StoreSetResponse().SerializeAsString();
      return true;
    }
    case kStoreGet: {
      StoreGetRequest r;
      if (!r.ParseFromString(req)) {
        *err = "bad StoreGetRequest";
        return false;
      }
      StoreGetResponse out;
      std::unique_lock<std::mutex> lk(mu_);
      auto deadline = std::chrono::steady_clock::now() +
                      std::chrono::milliseconds(r.timeout_ms());
      while (true) {
        auto it = data_.find(r.key());
        if (it != data_.end()) {
          out.set_found(true);
          out.set_value(it->second);
          break;
        }
        if (r.timeout_ms() <= 0 ||
            cv_.wait_until(lk, deadline) == std::cv_status::timeout) {
          if (data_.count(r.key())) continue;  // raced with a set
          out.set_found(false);
          break;
        }
      }
      *resp = out.SerializeAsString();
      return true;
    }
    default:
      *err = "store: unknown method";
      return false;
  }
}

StoreClient::StoreClient(const std::string& address,
                         int64_t connect_timeout_ms)
    : client_(address, connect_timeout_ms) {}

void StoreClient::set(const std::string& key, const std::string& value) {
  StoreSetRequest r;
  r.set_key(key);
  r.set_value(value);
  std::string resp, err;
  if (!client_.call(kStoreSet, r.SerializeAsString(), &resp, &err, 30'000))
    throw std::runtime_error("store set failed: " + err);
}

std::string StoreClient::get(const std::string& key, int64_t timeout_ms) {
  StoreGetRequest r;
  r.set_key(key);
  r.set_timeout_ms(timeout_ms);
  std::string resp, err;
  // RPC deadline must outlast the server-side blocking wait.
  if (!client_.call(kStoreGet, r.SerializeAsString(), &resp, &err,
                    timeout_ms + 10'000))
    throw std::runtime_error("store get failed: " + err);
  StoreGetResponse out;
  if (!out.ParseFromString(resp) || !out.found())
    throw std::runtime_error("store get timeout waiting for key: " + key);
  return out.value();
}

}  // namespace torchft_tpu
