// C ABI for Python ctypes bindings.
//
// Plays the role of the reference's pyo3 bridge (/root/reference/src/lib.rs):
// exposes embeddable Lighthouse and Manager servers, a blocking
// ManagerClient (quorum / checkpoint_address / should_commit / kill,
// reference :105-181), and the KV store. ctypes releases the GIL for the
// duration of every foreign call, giving the same GIL-released blocking
// behavior as the reference's py.allow_threads (:48,91,112).
//
// Convention: functions return 0 on success, -1 on error with *err set to a
// malloc'd message the caller frees with tft_free. All returned strings are
// malloc'd copies.

#include <string.h>

#include <string>

#include "lighthouse.h"
#include "manager.h"
#include "rpc.h"
#include "store.h"
#include "torchft.pb.h"

using namespace torchft_tpu;

namespace {
char* dup_str(const std::string& s) {
  char* p = (char*)malloc(s.size() + 1);
  memcpy(p, s.data(), s.size());
  p[s.size()] = 0;
  return p;
}
int fail(char** err, const std::string& msg) {
  if (err) *err = dup_str(msg);
  return -1;
}
}  // namespace

extern "C" {

void tft_free(void* p) { free(p); }

// ----------------------------------------------------------------- lighthouse

void* tft_lighthouse_new(const char* bind, uint64_t min_replicas,
                         int64_t join_timeout_ms, int64_t quorum_tick_ms,
                         int64_t heartbeat_fresh_ms,
                         int64_t heartbeat_grace_factor,
                         int64_t eviction_staleness_factor,
                         const char* auth_token, int32_t fast_path,
                         const char* standby_of, int64_t replicate_ms,
                         int64_t join_window_ms, const char* slo_spec,
                         char** err) {
  try {
    LighthouseOpt opt;
    opt.bind = bind;
    opt.min_replicas = min_replicas;
    opt.join_timeout_ms = join_timeout_ms;
    opt.quorum_tick_ms = quorum_tick_ms;
    opt.heartbeat_fresh_ms = heartbeat_fresh_ms;
    opt.heartbeat_grace_factor = heartbeat_grace_factor;
    opt.eviction_staleness_factor = eviction_staleness_factor;
    opt.auth_token = auth_token ? auth_token : "";
    opt.fast_path = fast_path != 0;
    opt.standby_of = standby_of ? standby_of : "";
    opt.replicate_ms = replicate_ms;
    opt.join_window_ms = join_window_ms;
    opt.slo_spec = slo_spec ? slo_spec : "";
    return new Lighthouse(opt);
  } catch (const std::exception& e) {
    fail(err, e.what());
    return nullptr;
  }
}

char* tft_lighthouse_address(void* h) {
  return dup_str(((Lighthouse*)h)->address());
}

void tft_lighthouse_shutdown(void* h) { ((Lighthouse*)h)->shutdown(); }

void tft_lighthouse_free(void* h) { delete (Lighthouse*)h; }

// -------------------------------------------------------------------- manager

void* tft_manager_new(const char* replica_id, const char* lighthouse_addr,
                      const char* bind, const char* store_addr,
                      uint64_t world_size, int64_t heartbeat_ms,
                      const char* auth_token, char** err) {
  try {
    ManagerOpt opt;
    opt.replica_id = replica_id;
    opt.lighthouse_addr = lighthouse_addr;
    opt.bind = bind;
    opt.store_addr = store_addr;
    opt.world_size = world_size;
    opt.heartbeat_ms = heartbeat_ms;
    opt.auth_token = auth_token ? auth_token : "";
    return new ManagerServer(opt);
  } catch (const std::exception& e) {
    fail(err, e.what());
    return nullptr;
  }
}

char* tft_manager_address(void* h) {
  return dup_str(((ManagerServer*)h)->address());
}

void tft_manager_set_status(void* h, const char* metrics_json,
                            int64_t heal_count, int64_t committed_steps,
                            int64_t aborted_steps) {
  ((ManagerServer*)h)->set_status(metrics_json, heal_count, committed_steps,
                                  aborted_steps);
}

// Per-step telemetry digest (docs/design/fleet_health.md): scalar args,
// not JSON — the C++ side has no JSON parser and the digest is a fixed
// small schema. Mirrors proto StepDigest field for field.
void tft_manager_set_digest(void* h, int64_t step, double step_wall_ms,
                            double fetch_ms, double ring_ms,
                            double put_ms, double vote_ms,
                            double heal_bytes_inflight,
                            double publish_bytes_inflight,
                            int64_t policy_rung,
                            double capacity_fraction,
                            double churn_per_min, int32_t healing,
                            double heal_last_ms, double publish_last_ms,
                            const char* trace_addr, int64_t quorum_id,
                            const char* state_digest,
                            double rebalance_fraction) {
  StepDigest d;
  d.set_step(step);
  d.set_step_wall_ms(step_wall_ms);
  d.set_fetch_ms(fetch_ms);
  d.set_ring_ms(ring_ms);
  d.set_put_ms(put_ms);
  d.set_vote_ms(vote_ms);
  d.set_heal_bytes_inflight(heal_bytes_inflight);
  d.set_publish_bytes_inflight(publish_bytes_inflight);
  d.set_policy_rung(policy_rung);
  d.set_capacity_fraction(capacity_fraction);
  d.set_churn_per_min(churn_per_min);
  d.set_healing(healing != 0);
  d.set_heal_last_ms(heal_last_ms);
  d.set_publish_last_ms(publish_last_ms);
  d.set_trace_addr(trace_addr ? trace_addr : "");
  // State attestation (docs/design/state_attestation.md): the digest
  // rides the same piggyback; "" = attestation off (a non-voter).
  d.set_quorum_id(quorum_id);
  d.set_state_digest(state_digest ? state_digest : "");
  // Fleet rebalance (docs/design/fleet_rebalance.md): the fraction in
  // force for the measured step; 0/unset reads as 1.0 lighthouse-side.
  d.set_rebalance_fraction(rebalance_fraction);
  ((ManagerServer*)h)->set_digest(d);
}

void tft_manager_farewell(void* h) { ((ManagerServer*)h)->farewell(); }

void tft_manager_hard_stop(void* h) { ((ManagerServer*)h)->hard_stop(); }

int64_t tft_manager_lighthouse_redials(void* h) {
  return ((ManagerServer*)h)->lighthouse_redials();
}

char* tft_manager_lighthouse_addr(void* h) {
  return dup_str(((ManagerServer*)h)->lighthouse_addr());
}

void tft_manager_shutdown(void* h) { ((ManagerServer*)h)->shutdown(); }

void tft_manager_free(void* h) { delete (ManagerServer*)h; }

// ---------------------------------------------------------------------- store

void* tft_store_new(const char* bind, char** err) {
  try {
    return new StoreServer(bind);
  } catch (const std::exception& e) {
    fail(err, e.what());
    return nullptr;
  }
}

char* tft_store_address(void* h) {
  return dup_str(((StoreServer*)h)->address());
}

void tft_store_shutdown(void* h) { ((StoreServer*)h)->shutdown(); }

void tft_store_free(void* h) { delete (StoreServer*)h; }

void* tft_store_client_new(const char* addr, int64_t connect_timeout_ms,
                           char** err) {
  try {
    return new StoreClient(addr, connect_timeout_ms);
  } catch (const std::exception& e) {
    fail(err, e.what());
    return nullptr;
  }
}

int tft_store_client_set(void* h, const char* key, const void* value,
                         size_t value_len, char** err) {
  try {
    ((StoreClient*)h)->set(key, std::string((const char*)value, value_len));
    return 0;
  } catch (const std::exception& e) {
    return fail(err, e.what());
  }
}

int tft_store_client_get(void* h, const char* key, int64_t timeout_ms,
                         void** value, size_t* value_len, char** err) {
  try {
    std::string v = ((StoreClient*)h)->get(key, timeout_ms);
    *value = malloc(v.size() ? v.size() : 1);
    memcpy(*value, v.data(), v.size());
    *value_len = v.size();
    return 0;
  } catch (const std::exception& e) {
    return fail(err, e.what());
  }
}

void tft_store_client_free(void* h) { delete (StoreClient*)h; }

// ------------------------------------------------------------- manager client

struct TftQuorumResult {
  int64_t quorum_id;
  char* recover_manager_address;
  char* store_address;
  int64_t max_step;
  int32_t has_max_rank;
  int64_t max_rank;
  int64_t max_world_size;
  int64_t replica_rank;
  int64_t replica_world_size;
  int32_t heal;
  int32_t fast_path;
  int64_t epoch;
  // Fleet health hint (docs/design/fleet_health.md); zero/empty when the
  // fleet reports no digests. Layout mirrored by _native._CQuorumResult.
  double fleet_p50_ms;
  double fleet_p95_ms;
  double fleet_max_ms;
  int64_t fleet_groups;
  double straggler_score;
  char* straggler_stage;
  char* straggler_id;
  char* slo_breach;
  // State attestation verdict (docs/design/state_attestation.md).
  int32_t sdc_diverged;
  char* sdc_quarantined;
  char* sdc_quarantined_addrs;
  // Fleet rebalance hint (docs/design/fleet_rebalance.md); 0/empty when
  // the rebalancer has nothing for this group. Layout mirrored by
  // _native._CQuorumResult.
  double rebalance_fraction;
  char* rebalance_table;
  int64_t rebalance_seq;
};

void* tft_manager_client_new(const char* addr, int64_t connect_timeout_ms,
                             char** err) {
  try {
    return new RpcClient(addr, connect_timeout_ms);
  } catch (const std::exception& e) {
    fail(err, e.what());
    return nullptr;
  }
}

int tft_manager_client_quorum(void* h, int64_t rank, int64_t step,
                              const char* checkpoint_server_addr,
                              int64_t timeout_ms, TftQuorumResult* out,
                              char** err) {
  ManagerQuorumRequest req;
  req.set_rank(rank);
  req.set_step(step);
  req.set_checkpoint_server_addr(checkpoint_server_addr);
  req.set_call_seq(((RpcClient*)h)->next_seq());
  std::string resp, e;
  if (!((RpcClient*)h)
           ->call(kManagerQuorum, req.SerializeAsString(), &resp, &e,
                  timeout_ms))
    return fail(err, e);
  ManagerQuorumResponse r;
  if (!r.ParseFromString(resp)) return fail(err, "bad ManagerQuorumResponse");
  out->quorum_id = r.quorum_id();
  out->recover_manager_address = dup_str(r.recover_manager_address());
  out->store_address = dup_str(r.store_address());
  out->max_step = r.max_step();
  out->has_max_rank = r.has_max_rank();
  out->max_rank = r.max_rank();
  out->max_world_size = r.max_world_size();
  out->replica_rank = r.replica_rank();
  out->replica_world_size = r.replica_world_size();
  out->heal = r.heal();
  out->fast_path = r.fast_path();
  out->epoch = r.epoch();
  out->fleet_p50_ms = r.fleet().fleet_p50_ms();
  out->fleet_p95_ms = r.fleet().fleet_p95_ms();
  out->fleet_max_ms = r.fleet().fleet_max_ms();
  out->fleet_groups = r.fleet().digest_groups();
  out->straggler_score = r.fleet().straggler_score();
  out->straggler_stage = dup_str(r.fleet().straggler_stage());
  out->straggler_id = dup_str(r.fleet().straggler_id());
  out->slo_breach = dup_str(r.fleet().slo_breach());
  out->sdc_diverged = r.fleet().sdc_diverged() ? 1 : 0;
  out->sdc_quarantined = dup_str(r.fleet().sdc_quarantined());
  out->sdc_quarantined_addrs = dup_str(r.fleet().sdc_quarantined_addrs());
  out->rebalance_fraction = r.fleet().rebalance_fraction();
  out->rebalance_table = dup_str(r.fleet().rebalance_table());
  out->rebalance_seq = r.fleet().rebalance_seq();
  return 0;
}

int tft_manager_client_checkpoint_address(void* h, int64_t rank,
                                          int64_t timeout_ms, char** addr,
                                          char** err) {
  CheckpointAddressRequest req;
  req.set_rank(rank);
  std::string resp, e;
  if (!((RpcClient*)h)
           ->call(kManagerCheckpointAddress, req.SerializeAsString(), &resp,
                  &e, timeout_ms))
    return fail(err, e);
  CheckpointAddressResponse r;
  if (!r.ParseFromString(resp))
    return fail(err, "bad CheckpointAddressResponse");
  *addr = dup_str(r.checkpoint_server_address());
  return 0;
}

int tft_manager_client_should_commit(void* h, int64_t rank, int64_t step,
                                     int32_t should_commit, int64_t timeout_ms,
                                     int32_t* decision, char** err) {
  ShouldCommitRequest req;
  req.set_rank(rank);
  req.set_step(step);
  req.set_should_commit(should_commit != 0);
  req.set_call_seq(((RpcClient*)h)->next_seq());
  std::string resp, e;
  if (!((RpcClient*)h)
           ->call(kManagerShouldCommit, req.SerializeAsString(), &resp, &e,
                  timeout_ms))
    return fail(err, e);
  ShouldCommitResponse r;
  if (!r.ParseFromString(resp)) return fail(err, "bad ShouldCommitResponse");
  *decision = r.should_commit() ? 1 : 0;
  return 0;
}

int tft_manager_client_kill(void* h, const char* msg, char** err) {
  KillRequest req;
  req.set_msg(msg);
  std::string resp, e;
  // The target exits before replying; transport errors are expected.
  ((RpcClient*)h)->call(kManagerKill, req.SerializeAsString(), &resp, &e, 2000);
  return 0;
}

void tft_manager_client_free(void* h) { delete (RpcClient*)h; }

// ----------------------------------------------------------- lighthouse client

// Status as a JSON string (Python side has no protobuf runtime for our proto;
// JSON keeps the bridge dependency-free).
int tft_lighthouse_client_status(const char* addr, int64_t timeout_ms,
                                 char** json, char** err) {
  try {
    RpcClient client(addr, timeout_ms > 0 ? timeout_ms : 5000);
    std::string resp, e;
    if (!client.call(kLighthouseStatus, StatusRequest().SerializeAsString(),
                     &resp, &e, timeout_ms))
      return fail(err, e);
    StatusResponse r;
    if (!r.ParseFromString(resp)) return fail(err, "bad StatusResponse");
    std::string out = Lighthouse::status_json(r);
    *json = dup_str(out);
    return 0;
  } catch (const std::exception& e) {
    return fail(err, e.what());
  }
}

}  // extern "C"
