#include "rpc.h"

#include <arpa/inet.h>
#include <cstdio>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <stdexcept>

namespace torchft_tpu {

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

static bool split_host_port(const std::string& addr, std::string* host,
                            std::string* port) {
  // Supports "host:port" and "[v6]:port".
  if (!addr.empty() && addr[0] == '[') {
    auto end = addr.find(']');
    if (end == std::string::npos || end + 1 >= addr.size() ||
        addr[end + 1] != ':')
      return false;
    *host = addr.substr(1, end - 1);
    *port = addr.substr(end + 2);
    return true;
  }
  auto colon = addr.rfind(':');
  if (colon == std::string::npos) return false;
  *host = addr.substr(0, colon);
  *port = addr.substr(colon + 1);
  if (host->empty()) *host = "0.0.0.0";
  return true;
}

int net_listen(const std::string& bind_addr, std::string* bound_addr) {
  std::string host, port;
  if (!split_host_port(bind_addr, &host, &port)) return -1;

  struct addrinfo hints = {}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  hints.ai_flags = AI_PASSIVE;
  if (getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0 || !res)
    return -1;

  int fd = -1;
  for (auto* ai = res; ai; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    if (bind(fd, ai->ai_addr, ai->ai_addrlen) == 0 && listen(fd, 1024) == 0)
      break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) return -1;

  // Resolve the actual bound port (for port 0).
  struct sockaddr_storage ss;
  socklen_t slen = sizeof(ss);
  if (getsockname(fd, (struct sockaddr*)&ss, &slen) == 0) {
    char hostbuf[NI_MAXHOST], portbuf[NI_MAXSERV];
    getnameinfo((struct sockaddr*)&ss, slen, hostbuf, sizeof(hostbuf), portbuf,
                sizeof(portbuf), NI_NUMERICHOST | NI_NUMERICSERV);
    std::string h = host;
    // A wildcard bind isn't a dialable address; advertise localhost, which is
    // correct for the single-host test topology and overridable by callers
    // that pass a concrete host.
    if (h == "0.0.0.0" || h == "::" || h.empty()) h = "127.0.0.1";
    *bound_addr = h + ":" + portbuf;
  }
  return fd;
}

int net_connect(const std::string& address, int64_t timeout_ms) {
  std::string host, port;
  if (!split_host_port(address, &host, &port)) return -1;
  int64_t deadline = now_ms() + (timeout_ms > 0 ? timeout_ms : 10'000);

  while (true) {
    struct addrinfo hints = {}, *res = nullptr;
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    if (getaddrinfo(host.c_str(), port.c_str(), &hints, &res) == 0 && res) {
      for (auto* ai = res; ai; ai = ai->ai_next) {
        int fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
        if (fd < 0) continue;
        if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) {
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          freeaddrinfo(res);
          return fd;
        }
        close(fd);
      }
      freeaddrinfo(res);
    }
    if (now_ms() >= deadline) return -1;
    usleep(20'000);  // retry; servers may still be starting
  }
}

bool net_read_exact(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n > 0) {
    ssize_t r = recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool net_write_all(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n > 0) {
    ssize_t r = send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

static bool write_frame(int fd, uint8_t tag, const std::string& payload) {
  uint32_t len = (uint32_t)payload.size() + 1;
  char hdr[5];
  memcpy(hdr, &len, 4);
  hdr[4] = (char)tag;
  if (!net_write_all(fd, hdr, 5)) return false;
  return payload.empty() || net_write_all(fd, payload.data(), payload.size());
}

static bool read_frame(int fd, uint8_t* tag, std::string* payload) {
  uint32_t len = 0;
  if (!net_read_exact(fd, &len, 4)) return false;
  if (len < 1 || len > (256u << 20)) return false;  // 256MB sanity cap
  if (!net_read_exact(fd, tag, 1)) return false;
  payload->resize(len - 1);
  return len == 1 || net_read_exact(fd, payload->data(), len - 1);
}

// ------------------------------------------------------------------ server

RpcServer::RpcServer(const std::string& bind, RpcHandler handler,
                     HttpHandler http_handler)
    : handler_(std::move(handler)), http_handler_(std::move(http_handler)) {
  listen_fd_ = net_listen(bind, &address_);
  if (listen_fd_ < 0)
    throw std::runtime_error("torchft_tpu: failed to bind " + bind);
  accept_thread_ = std::thread([this] { accept_loop(); });
}

RpcServer::~RpcServer() { shutdown(); }

void RpcServer::shutdown() {
  {
    std::lock_guard<std::mutex> lk(conns_mu_);
    if (shutdown_) return;
    shutdown_ = true;
  }
  ::shutdown(listen_fd_, SHUT_RDWR);
  close(listen_fd_);
  if (accept_thread_.joinable()) accept_thread_.join();
  // Wake live connections and wait for their (detached) threads to
  // deregister — handlers must not outlive the server they call into.
  std::unique_lock<std::mutex> lk(conns_mu_);
  for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
  conns_cv_.wait(lk, [this] { return conn_fds_.empty(); });
}

void RpcServer::accept_loop() {
  while (true) {
    int fd = accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) return;  // listener closed
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::lock_guard<std::mutex> lk(conns_mu_);
    if (shutdown_) {
      close(fd);
      return;
    }
    conn_fds_.insert(fd);
    std::thread([this, fd] {
      serve_conn(fd);
      // Deregister and close atomically so shutdown() can never hit a
      // recycled fd number.
      std::lock_guard<std::mutex> lk2(conns_mu_);
      conn_fds_.erase(fd);
      close(fd);
      conns_cv_.notify_all();
    }).detach();
  }
}

void RpcServer::serve_conn(int fd) {
  // Sniff for HTTP (dashboard sharing the control port, like the reference
  // lighthouse's accept_http1). A single byte is ambiguous with the RPC
  // length prefix (payload sizes whose low byte is 'G'/'P'/'H'), so require
  // a full method token.
  char head[4] = {0};
  ssize_t r = recv(fd, head, 4, MSG_PEEK | MSG_WAITALL);
  bool is_http = r == 4 && (memcmp(head, "GET ", 4) == 0 ||
                            memcmp(head, "POST", 4) == 0 ||
                            memcmp(head, "HEAD", 4) == 0);
  if (is_http && http_handler_) {
    std::string req;
    char buf[4096];
    while (req.find("\r\n\r\n") == std::string::npos) {
      ssize_t n = recv(fd, buf, sizeof(buf), 0);
      if (n <= 0) break;
      req.append(buf, n);
      if (req.size() > (1u << 20)) break;
    }
    if (!req.empty()) {
      std::string resp = http_handler_(req);
      net_write_all(fd, resp.data(), resp.size());
    }
    return;  // fd closed by the accept_loop wrapper after deregistration
  }

  while (true) {
    uint8_t method;
    std::string payload;
    if (!read_frame(fd, &method, &payload)) break;
    std::string resp, err;
    bool ok;
    try {
      ok = handler_(method, payload, &resp, &err);
    } catch (const std::exception& e) {
      ok = false;
      err = e.what();
    }
    if (!write_frame(fd, ok ? 0 : 1, ok ? resp : err)) break;
  }
  // fd closed by the accept_loop wrapper after deregistration.
}

// ------------------------------------------------------------------ client

RpcClient::RpcClient(const std::string& address, int64_t connect_timeout_ms)
    : address_(address), connect_timeout_ms_(connect_timeout_ms) {
  fd_ = net_connect(address, connect_timeout_ms);
  if (fd_ < 0)
    throw std::runtime_error("torchft_tpu: failed to connect to " + address);
}

RpcClient::~RpcClient() {
  if (fd_ >= 0) close(fd_);
}

void RpcClient::cancel() {
  std::lock_guard<std::mutex> lk(fd_mu_);
  cancelled_ = true;
  if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
}

bool RpcClient::check_cancelled(std::string* err) {
  std::lock_guard<std::mutex> lk(fd_mu_);
  if (cancelled_) *err = "transport: cancelled";
  return cancelled_;
}

bool RpcClient::reconnect(std::string* err) {
  int nfd = net_connect(address_, connect_timeout_ms_);
  std::lock_guard<std::mutex> lk(fd_mu_);
  if (fd_ >= 0) close(fd_);
  fd_ = nfd;
  if (cancelled_ && fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
  if (fd_ < 0) {
    *err = "transport: reconnect to " + address_ + " failed";
    return false;
  }
  return true;
}

bool RpcClient::call(uint8_t method, const std::string& req, std::string* resp,
                     std::string* err, int64_t timeout_ms) {
  std::lock_guard<std::mutex> lk(mu_);
  if (check_cancelled(err)) return false;
  // A previous call may have poisoned the connection (see below); frames
  // carry no call id, so a fresh socket is the only way to guarantee the
  // next response read belongs to the next request.
  if (fd_ < 0 && !reconnect(err)) return false;
  struct timeval tv = {};
  if (timeout_ms > 0) {
    tv.tv_sec = timeout_ms / 1000;
    tv.tv_usec = (timeout_ms % 1000) * 1000;
  }
  setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));

  for (int attempt = 0; attempt < 2; attempt++) {
    if (check_cancelled(err)) return false;
    if (write_frame(fd_, method, req)) {
      uint8_t status;
      std::string payload;
      if (read_frame(fd_, &status, &payload)) {
        if (status == 0) {
          *resp = std::move(payload);
          return true;
        }
        *err = payload;
        return false;
      }
      // Read failed after a successful write: the RPC may have executed
      // server-side. Only retry before any bytes were ever exchanged would be
      // safe in general, but all our RPCs are idempotent per (round, rank), so
      // a single reconnect+retry is sound and rides out server restarts.
    }
    if (attempt == 0) {
      if (!reconnect(err)) return false;
      setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    }
  }
  // Final failure with the request possibly still executing server-side
  // (e.g. a quorum handler parked on a dead lighthouse). Its LATE response
  // will eventually be written to this socket, and with no call ids in the
  // framing the next call() would consume it as ITS response — cross-
  // parsing a quorum payload as a commit decision corrupts the protocol
  // (observed: should_commit=true against a false vote during a lighthouse
  // outage). Poison the connection so the next call starts on a socket the
  // stale frame can never reach.
  {
    std::lock_guard<std::mutex> flk(fd_mu_);
    if (fd_ >= 0) {
      close(fd_);
      fd_ = -1;
    }
  }
  *err = "transport: rpc to " + address_ + " failed (timeout or disconnect)";
  return false;
}

std::string json_escape(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += (char)c;
        }
    }
  }
  return out;
}

}  // namespace torchft_tpu
