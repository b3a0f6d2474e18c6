#include "manager.h"

#include <stdlib.h>
#include <unistd.h>

#include <algorithm>
#include <cstdio>
#include <sstream>
#include <vector>

namespace torchft_tpu {

ManagerServer::ManagerServer(const ManagerOpt& opt) : opt_(opt) {
  // lighthouse_addr may be a comma-separated candidate list
  // ("primary,standby"); a standby learned from quorum responses is
  // appended at runtime (see rotate_lighthouse_locked).
  {
    std::string rest = opt_.lighthouse_addr;
    while (!rest.empty()) {
      size_t comma = rest.find(',');
      std::string one =
          comma == std::string::npos ? rest : rest.substr(0, comma);
      rest = comma == std::string::npos ? "" : rest.substr(comma + 1);
      // Trim surrounding spaces.
      size_t b = one.find_first_not_of(' ');
      size_t e = one.find_last_not_of(' ');
      if (b != std::string::npos)
        lighthouse_candidates_.push_back(one.substr(b, e - b + 1));
    }
    if (lighthouse_candidates_.empty())
      lighthouse_candidates_.push_back(opt_.lighthouse_addr);
  }
  server_ = std::make_unique<RpcServer>(
      opt.bind,
      [this](uint8_t m, const std::string& req, std::string* resp,
             std::string* err) { return handle(m, req, resp, err); },
      [this](const std::string& req) { return handle_http(req); });
  heartbeat_thread_ = std::thread([this] { heartbeat_loop(); });
}

std::string ManagerServer::current_lighthouse_locked() const {
  return lighthouse_candidates_[lh_idx_ % lighthouse_candidates_.size()];
}

void ManagerServer::rotate_lighthouse_locked(const std::string& failed_addr) {
  // Fold the learned standby into the candidate ring lazily (quorum
  // responses can race its registration; dedup keeps the ring stable).
  if (!learned_standby_.empty()) {
    bool known = false;
    for (const auto& a : lighthouse_candidates_)
      if (a == learned_standby_) known = true;
    if (!known) lighthouse_candidates_.push_back(learned_standby_);
  }
  if (lighthouse_candidates_.size() < 2) return;  // nowhere to go
  // CAS-style: only advance if the caller failed against the endpoint we
  // are still pointed at — the quorum and heartbeat loops both rotate, and
  // blindly advancing twice would skip the live standby back to the
  // corpse.
  if (current_lighthouse_locked() != failed_addr) return;
  lh_idx_ = (lh_idx_ + 1) % lighthouse_candidates_.size();
  lighthouse_redials_++;
  fprintf(stderr,
          "torchft_tpu manager [%s]: lighthouse %s unreachable; re-dialing "
          "%s (redial #%lld)\n",
          opt_.replica_id.c_str(), failed_addr.c_str(),
          current_lighthouse_locked().c_str(),
          (long long)lighthouse_redials_);
  fflush(stderr);
}

int64_t ManagerServer::lighthouse_redials() const {
  std::lock_guard<std::mutex> lk(mu_);
  return lighthouse_redials_;
}

std::string ManagerServer::lighthouse_addr() const {
  std::lock_guard<std::mutex> lk(mu_);
  return current_lighthouse_locked();
}

void ManagerServer::set_status(const std::string& metrics_json,
                               int64_t heal_count, int64_t committed_steps,
                               int64_t aborted_steps) {
  std::lock_guard<std::mutex> lk(mu_);
  metrics_json_ = metrics_json;
  heal_count_ = heal_count;
  committed_steps_ = committed_steps;
  aborted_steps_ = aborted_steps;
}

void ManagerServer::set_digest(const StepDigest& d) {
  std::lock_guard<std::mutex> lk(mu_);
  digest_ = d;
  has_digest_ = true;
}

// GET /metrics.json on the manager RPC port: the Python Manager's last
// pushed metrics snapshot (empty object before the first commit). The
// lighthouse serves cluster-level status the same one-port way.
std::string ManagerServer::handle_http(const std::string& request) {
  std::string body;
  std::string content_type = "application/json";
  if (request.rfind("GET /metrics.json", 0) == 0 ||
      request.rfind("GET / ", 0) == 0) {
    std::string metrics;
    {
      std::lock_guard<std::mutex> lk(mu_);
      metrics = metrics_json_.empty() ? "{}" : metrics_json_;
    }
    // replica_id is operator-supplied config, not attacker-controlled, but
    // escape it anyway; metrics is already JSON from the Python layer.
    body = "{\"replica_id\":\"" + json_escape(opt_.replica_id) +
           "\",\"status\":" + metrics + "}";
  } else {
    body = "{\"error\":\"unknown path; try GET /metrics.json\"}";
  }
  std::ostringstream resp;
  resp << "HTTP/1.1 200 OK\r\nContent-Type: " << content_type
       << "\r\nContent-Length: " << body.size()
       << "\r\nConnection: close\r\n\r\n"
       << body;
  return resp.str();
}

ManagerServer::~ManagerServer() { shutdown(); }

std::string ManagerServer::address() const {
  return opt_.advertise_addr.empty() ? server_->address() : opt_.advertise_addr;
}

void ManagerServer::shutdown() {
  std::shared_ptr<RpcClient> inflight;
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (shutdown_) return;
    shutdown_ = true;
    inflight = lighthouse_inflight_;
  }
  if (inflight) inflight->cancel();
  cv_.notify_all();
  if (heartbeat_thread_.joinable()) heartbeat_thread_.join();
  // Farewell beat: clears this replica's liveness record so survivors'
  // next quorum cut is not deferred by our still-fresh heartbeats (clean
  // shutdowns say goodbye; crashes rely on staleness). Best-effort; a
  // graceful preemption drain already sent it via farewell() (idempotent).
  farewell();
  server_->shutdown();
}

void ManagerServer::hard_stop() {
  {
    // Setting farewell_sent_ BEFORE shutdown suppresses the goodbye a
    // clean shutdown would send: survivors must observe exactly what a
    // SIGKILL leaves behind — silence, then staleness.
    std::lock_guard<std::mutex> lk(mu_);
    farewell_sent_ = true;
  }
  shutdown();
}

void ManagerServer::farewell() {
  std::string lh_addr;
  {
    std::unique_lock<std::mutex> lk(mu_);
    if (farewell_sent_) return;
    farewell_sent_ = true;  // also silences the heartbeat loop
    // Serialize against an in-flight periodic beat: it was sent outside
    // mu_ and may land at the lighthouse AFTER our leaving beat,
    // erasing the departed record ("back from the dead") — the drained
    // leaver would look alive and the fast path could serve a cached
    // membership naming it. The beat RPC has a 1s deadline; bound the
    // wait a little above it so a wedged transport cannot stall the
    // drain (worst case the race degrades to staleness eviction).
    cv_.wait_for(lk, std::chrono::milliseconds(1'500),
                 [this] { return !beat_inflight_; });
    lh_addr = current_lighthouse_locked();
  }
  try {
    RpcClient c(lh_addr, 1'000);
    LighthouseHeartbeatRequest r;
    r.set_replica_id(opt_.replica_id);
    r.set_leaving(true);
    std::string resp, err;
    c.call(kLighthouseHeartbeat, r.SerializeAsString(), &resp, &err, 1'000);
  } catch (...) {
  }
}

void ManagerServer::heartbeat_loop() {
  // Periodic liveness signal to the lighthouse (reference
  // src/manager.rs:148-159; visualized only there — here it is
  // load-bearing: grace, eviction, and fast-path eligibility all read it).
  //
  // Coalesced cadence: in steady state the quorum RPC piggybacks our beat
  // every step, so this thread only needs to KEEP the record fresh across
  // long steps/stalls — it relaxes to the lighthouse-advertised keepalive
  // interval whenever the last round rode the fast path and no join is in
  // flight, and skips a send entirely while a piggybacked beat is recent.
  // During churn (slow rounds, quorum in flight) it stays at the full
  // heartbeat_ms cadence: that is when grace/staleness decisions need
  // prompt signals.
  std::unique_ptr<RpcClient> client;
  while (true) {
    bool joining;
    int64_t heals, committed, aborted, cadence, last_ok;
    bool send_digest;
    StepDigest digest;
    std::string addr;
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_.wait_for(lk, std::chrono::milliseconds(opt_.heartbeat_ms));
      if (shutdown_) return;
      // After a farewell (graceful drain), beating again would revive
      // the departed record and stall survivors' fast eviction.
      if (farewell_sent_) continue;
      joining = quorum_inflight_ > 0;
      heals = heal_count_;
      committed = committed_steps_;
      aborted = aborted_steps_;
      send_digest = has_digest_;
      if (send_digest) digest = digest_;
      cadence = opt_.heartbeat_ms;
      if (!joining && last_fast_path_ && keepalive_ms_ > cadence)
        cadence = keepalive_ms_;
      last_ok = last_beat_ok_ms_;
      addr = current_lighthouse_locked();
    }
    if (last_ok > 0 && now_ms() - last_ok < cadence)
      continue;  // a beat (possibly piggybacked on a quorum RPC) is recent
    {
      // Marked in flight so farewell() can order its leaving beat AFTER
      // this one (see manager.h beat_inflight_).
      std::lock_guard<std::mutex> lk(mu_);
      if (farewell_sent_) continue;
      beat_inflight_ = true;
    }
    try {
      if (!client || client->address() != addr) {
        client.reset();
        client = std::make_unique<RpcClient>(addr, 1'000);
      }
      LighthouseHeartbeatRequest r;
      r.set_replica_id(opt_.replica_id);
      r.set_joining(joining);
      r.set_heal_count(heals);
      r.set_committed_steps(committed);
      r.set_aborted_steps(aborted);
      // Keepalive beats re-carry the last digest so a group parked in
      // a long step (compiling, healing) keeps its fleet-health row
      // fresh instead of aging into the staleness SLO.
      if (send_digest) *r.mutable_digest() = digest;
      std::string resp, err;
      if (client->call(kLighthouseHeartbeat, r.SerializeAsString(), &resp,
                       &err, 1'000)) {
        std::lock_guard<std::mutex> lk(mu_);
        last_beat_ok_ms_ = now_ms();
      } else {
        client.reset();
      }
    } catch (...) {
      client.reset();
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      beat_inflight_ = false;
    }
    cv_.notify_all();
    // Deliberately NO rotation from this loop: beats are best-effort, and
    // this 1s deadline trips on a primary that is merely stalled. Only
    // the quorum path (5s deadline, the RPC that actually matters)
    // rotates — which also keeps the standby's promotion corroboration
    // honest: a Quorum dial against its fence can only mean a manager's
    // QUORUM path to the primary failed, not a lost heartbeat. This loop
    // follows any rotation via current_lighthouse_locked() above.
  }
}

bool ManagerServer::handle(uint8_t method, const std::string& req,
                           std::string* resp, std::string* err) {
  switch (method) {
    case kManagerQuorum: {
      ManagerQuorumRequest r;
      if (!r.ParseFromString(req)) {
        *err = "bad ManagerQuorumRequest";
        return false;
      }
      ManagerQuorumResponse out;
      if (!handle_quorum(r, &out, err)) return false;
      *resp = out.SerializeAsString();
      return true;
    }
    case kManagerShouldCommit: {
      ShouldCommitRequest r;
      if (!r.ParseFromString(req)) {
        *err = "bad ShouldCommitRequest";
        return false;
      }
      ShouldCommitResponse out;
      if (!handle_should_commit(r, &out, err)) return false;
      *resp = out.SerializeAsString();
      return true;
    }
    case kManagerCheckpointAddress: {
      CheckpointAddressRequest r;
      if (!r.ParseFromString(req)) {
        *err = "bad CheckpointAddressRequest";
        return false;
      }
      CheckpointAddressResponse out;
      {
        std::lock_guard<std::mutex> lk(mu_);
        auto it = checkpoint_addrs_.find(r.rank());
        if (it == checkpoint_addrs_.end()) {
          *err = "no checkpoint address for rank " + std::to_string(r.rank());
          return false;
        }
        out.set_checkpoint_server_address(it->second);
      }
      *resp = out.SerializeAsString();
      return true;
    }
    case kManagerKill: {
      KillRequest r;
      r.ParseFromString(req);
      // Fixed-time compare (mirrors the Python side's hmac.compare_digest
      // on the checkpoint path): std::string::operator!= short-circuits
      // and would leak the token prefix via refusal timing.
      auto token_ok = [&]() {
        const std::string& a = opt_.auth_token;
        const std::string& b = r.auth_token();
        unsigned char diff = a.size() == b.size() ? 0 : 1;
        for (size_t i = 0; i < a.size(); i++)
          diff |= (unsigned char)a[i] ^
                  (unsigned char)(i < b.size() ? b[i] : 0);
        return diff == 0;
      };
      if (!opt_.auth_token.empty() && !token_ok()) {
        fprintf(stderr,
                "torchft_tpu manager [%s]: Kill RPC REFUSED (bad token)\n",
                opt_.replica_id.c_str());
        fflush(stderr);
        *err = "kill refused: missing/bad auth token";
        return false;
      }
      fprintf(stderr, "torchft_tpu manager [%s]: Kill RPC received: %s\n",
              opt_.replica_id.c_str(), r.msg().c_str());
      fflush(stderr);
      // Hard exit, matching reference semantics (src/manager.rs:368-373).
      exit(1);
    }
    default:
      *err = "manager: unknown method";
      return false;
  }
}

bool ManagerServer::handle_quorum(const ManagerQuorumRequest& r,
                                  ManagerQuorumResponse* out,
                                  std::string* err) {
  std::unique_lock<std::mutex> lk(mu_);
  auto& slot = quorum_rounds_[r.step()];
  if (!slot) slot = std::make_shared<QuorumRound>();
  // A rank re-arriving at a done round with a HIGHER call_seq is *retrying
  // the step* (its commit failed, so Manager.step() did not bump the step
  // counter) and needs a FRESH lighthouse round — replaying the stale
  // quorum would keep a dead peer in the membership forever. Same seq means
  // the transport re-sent a request whose response was lost: idempotent
  // replay (rpc.cc relies on this). Mirrors the reference's per-round reset
  // (src/manager.rs:328-355).
  {
    auto it = slot->served_seq.find(r.rank());
    if (slot->done && it != slot->served_seq.end() &&
        r.call_seq() > it->second) {
      slot = std::make_shared<QuorumRound>();
    }
  }
  auto round = slot;
  // Drop stale rounds so retries of long-gone steps can't pile up state.
  quorum_rounds_.erase(quorum_rounds_.begin(),
                       quorum_rounds_.lower_bound(r.step() - 8));
  round->joined[r.rank()] = r.checkpoint_server_addr();

  if (round->done) {
    // Client retry after a lost response: idempotent replay.
  } else if (round->joined.size() >= opt_.world_size && !round->in_flight) {
    // Last local rank to arrive does the lighthouse round-trip for the group.
    round->in_flight = true;
    QuorumMember self;
    self.set_replica_id(opt_.replica_id);
    self.set_address(address());
    self.set_store_address(opt_.store_addr);
    self.set_step(r.step());
    self.set_world_size(opt_.world_size);
    quorum_inflight_++;
    // Steady state (previous round rode the fast path): skip the announce
    // RPC below — we are a settled member, the split-quorum guard it arms
    // protects JOINERS, and the quorum RPC itself piggybacks our beat. This
    // halves steady-state control RPCs per group per step.
    bool skip_announce = last_fast_path_;
    // Coalesced heartbeat: the quorum request carries our beat (joining
    // flag + the operational counters the standalone beat sends), so the
    // lighthouse's liveness record refreshes once per step for free.
    LighthouseQuorumRequest lr;
    *lr.mutable_requester() = self;
    {
      auto* beat = lr.mutable_beat();
      beat->set_replica_id(opt_.replica_id);
      beat->set_joining(true);
      beat->set_heal_count(heal_count_);
      beat->set_committed_steps(committed_steps_);
      beat->set_aborted_steps(aborted_steps_);
      // Telemetry piggyback (docs/design/fleet_health.md): the digest
      // the Python Manager pushed at the last commit boundary rides
      // the beat — fleet health costs zero extra RPCs. Absent until
      // the first set_digest (legacy/raw clients stay bit-exact).
      if (has_digest_) *beat->mutable_digest() = digest_;
    }
    std::string announce_addr = current_lighthouse_locked();
    lk.unlock();

    // Announce intent BEFORE the quorum RPC: a synchronous joining-flagged
    // heartbeat is processed by the lighthouse before our join can land, so
    // a survivor whose fast-quorum would otherwise instantly cut us out
    // (e.g. regrow after a shrink — we may be a restarted group with a
    // fresh replica_id that no previous-quorum grace covers) defers until
    // our join arrives. Failure is non-fatal: the quorum loop below retries
    // against the same lighthouse anyway.
    if (!skip_announce) {
      try {
        RpcClient announce(announce_addr, 2'000);
        LighthouseHeartbeatRequest hb;
        hb.set_replica_id(opt_.replica_id);
        hb.set_joining(true);
        std::string hresp, herr;
        announce.call(kLighthouseHeartbeat, hb.SerializeAsString(), &hresp,
                      &herr, 2'000);
      } catch (...) {
      }
    }

    // The lighthouse legitimately parks this RPC until quorum forms (up to
    // join_timeout_ms of straggler wait), so poll with bounded per-call
    // deadlines and re-join on timeout — the lighthouse treats a re-join as
    // an overwrite of the same participant, and bounded calls keep this
    // thread cancellable by shutdown() (a deadline-less call here would
    // deadlock shutdown against the parked connection). Transport failures
    // rotate to the next lighthouse candidate (warm-standby failover): the
    // standby serves the SAME membership under the SAME quorum_id, so the
    // in-flight step commits without a ring rebuild. An unpromoted
    // standby's "not serving" refusal is transient — retry, rotating back
    // toward the primary.
    LighthouseQuorumResponse lout;
    std::string rpc_err;
    bool ok = false;
    std::shared_ptr<RpcClient> client;
    const std::string payload = lr.SerializeAsString();
    while (!ok) {
      std::string addr;
      {
        std::lock_guard<std::mutex> g(mu_);
        if (shutdown_) {
          rpc_err = "manager shutting down";
          break;
        }
        addr = current_lighthouse_locked();
      }
      try {
        if (!client || client->address() != addr) {
          client = std::make_shared<RpcClient>(addr, 2'000);
          std::lock_guard<std::mutex> g(mu_);
          lighthouse_inflight_ = client;
          if (shutdown_) client->cancel();
        }
        std::string resp;
        if (client->call(kLighthouseQuorum, payload, &resp, &rpc_err,
                         5'000)) {
          if (lout.ParseFromString(resp)) {
            ok = true;
          } else {
            rpc_err = "bad LighthouseQuorumResponse";
            break;
          }
        } else if (rpc_err == "transport: cancelled") {
          break;
        } else if (rpc_err.rfind("transport:", 0) == 0) {
          // Dead/black-holed endpoint (read timeout counts: the 5s bound
          // above already exceeds any legitimate fast-path serve, and a
          // parked slow round re-joins idempotently wherever we land).
          client.reset();
          std::lock_guard<std::mutex> g(mu_);
          rotate_lighthouse_locked(addr);
        } else {
          // Application refusal: an unpromoted standby fencing us off, or
          // a lighthouse shutting down for replacement. Rotate and retry
          // after a short backoff — the fence clears once the standby
          // observes the primary's death.
          client.reset();
          {
            std::lock_guard<std::mutex> g(mu_);
            rotate_lighthouse_locked(addr);
          }
          usleep(100'000);
        }
      } catch (const std::exception& e) {
        rpc_err = e.what();
        client.reset();
        {
          std::lock_guard<std::mutex> g(mu_);
          rotate_lighthouse_locked(addr);
        }
        usleep(200'000);  // lighthouse unreachable; back off
      }
    }

    lk.lock();
    quorum_inflight_--;
    lighthouse_inflight_.reset();
    if (!ok) {
      round->error = "lighthouse quorum failed: " + rpc_err;
    } else {
      round->quorum = lout.quorum();
      round->fast_path = lout.fast_path();
      round->fleet = lout.fleet();
      last_fast_path_ = lout.fast_path();
      keepalive_ms_ = lout.keepalive_ms();
      last_beat_ok_ms_ = now_ms();  // the request piggybacked our beat
      if (!lout.standby_address().empty() &&
          lout.standby_address() != learned_standby_)
        learned_standby_ = lout.standby_address();
      // Refresh the healing registry for this quorum.
      checkpoint_addrs_.clear();
      for (const auto& [rank, addr] : round->joined)
        checkpoint_addrs_[rank] = addr;
    }
    round->done = true;
    cv_.notify_all();
  } else {
    while (!round->done && !shutdown_) cv_.wait(lk);
    if (shutdown_) {
      *err = "manager shutting down";
      return false;
    }
  }

  round->served_seq[r.rank()] = r.call_seq();
  if (!round->error.empty()) {
    *err = round->error;
    return false;
  }
  return compute_response(*round, r.rank(), r.step(), out, err);
}

bool ManagerServer::compute_response(const QuorumRound& round, int64_t rank,
                                     int64_t req_step,
                                     ManagerQuorumResponse* out,
                                     std::string* err) {
  // The group's view of the quorum, specialized to one local rank
  // (reference src/manager.rs:244-287).
  const auto& parts = round.quorum.participants();
  int64_t replica_rank = -1;
  int64_t max_step = 0;
  for (int i = 0; i < parts.size(); i++) {
    if (parts[i].replica_id() == opt_.replica_id) replica_rank = i;
    max_step = std::max(max_step, parts[i].step());
  }
  if (replica_rank < 0) {
    *err = "own replica_id missing from quorum";
    return false;
  }
  std::vector<const QuorumMember*> max_parts;
  for (const auto& p : parts)
    if (p.step() == max_step) max_parts.push_back(&p);
  // Recovery primary for this local rank. Every group sees the same sorted
  // participant list, so rank r of every group agrees on the same primary —
  // and different local ranks pick different max-step groups, spreading both
  // healing traffic and store rendezvous load.
  const QuorumMember* primary = max_parts[rank % (int64_t)max_parts.size()];
  out->set_quorum_id(round.quorum.quorum_id());
  out->set_fast_path(round.fast_path);
  out->set_epoch(round.quorum.epoch());
  // Fleet health hint, identical for every local rank of the group
  // (the lighthouse computed it for this replica_id).
  *out->mutable_fleet() = round.fleet;
  out->set_recover_manager_address(primary->address());
  // Rendezvous store for this rank's cross-group communicator = the
  // primary's store, namespaced by quorum_id downstream (the PrefixStore
  // trick, reference manager.py:374-376).
  out->set_store_address(primary->store_address());
  out->set_max_step(max_step);
  out->set_max_world_size((int64_t)max_parts.size());
  out->set_replica_rank(replica_rank);
  out->set_replica_world_size(parts.size());
  for (int i = 0; i < (int)max_parts.size(); i++)
    if (max_parts[i]->replica_id() == opt_.replica_id) {
      out->set_has_max_rank(true);
      out->set_max_rank(i);
    }
  // Heal when lagging the quorum, or at the very first step when we are not
  // the recovery primary (initial weight sync replaces DDP's init broadcast,
  // reference src/manager.rs:266-275 + torchft/ddp.py:39-41).
  out->set_heal(max_step != req_step ||
                (max_step == 1 && primary->replica_id() != opt_.replica_id));
  return true;
}

bool ManagerServer::handle_should_commit(const ShouldCommitRequest& r,
                                         ShouldCommitResponse* out,
                                         std::string* err) {
  std::unique_lock<std::mutex> lk(mu_);
  auto& slot = commit_rounds_[r.step()];
  if (!slot) slot = std::make_shared<CommitRound>();
  // Same seq-gated fresh-round rule as handle_quorum: a higher call_seq
  // from a served rank means the step is being retried after a failed
  // commit and a new vote round must run (replaying the old "false" would
  // livelock); an equal seq is a transport retry and replays the decision.
  {
    auto it = slot->served_seq.find(r.rank());
    if (slot->done && it != slot->served_seq.end() &&
        r.call_seq() > it->second) {
      slot = std::make_shared<CommitRound>();
    }
  }
  auto round = slot;
  commit_rounds_.erase(commit_rounds_.begin(),
                       commit_rounds_.lower_bound(r.step() - 8));
  if (!round->done) round->votes[r.rank()] = r.should_commit();

  if (round->done) {
    // Idempotent replay for retries.
  } else if (round->votes.size() >= opt_.world_size) {
    // Commit only if every local rank succeeded
    // (reference src/manager.rs:314-366).
    bool all = true;
    for (const auto& [rank, v] : round->votes) all = all && v;
    round->decision = all;
    round->done = true;
    cv_.notify_all();
  } else {
    while (!round->done && !shutdown_) cv_.wait(lk);
    if (shutdown_) {
      *err = "manager shutting down";
      return false;
    }
  }
  round->served_seq[r.rank()] = r.call_seq();
  out->set_should_commit(round->decision);
  return true;
}

}  // namespace torchft_tpu
