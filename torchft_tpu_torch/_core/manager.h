// Manager: per-replica-group coordinator, lives in the group's rank-0 process.
//
// C++ re-implementation of the reference's Rust manager
// (/root/reference/src/manager.rs): parks each local rank's Quorum RPC until
// all world_size ranks arrive (reference :186-235), the completing rank does
// one Lighthouse round-trip for the whole group (:205-231), then computes
// replica_rank / max_step / recovery primary / heal for the group
// (:244-287); keeps a per-rank checkpoint-server address registry for healing
// lookups (:189-193, :295-312); runs the all-rank should_commit barrier vote
// (:314-366); heartbeats the lighthouse (:148-159); Kill = process exit
// (:368-373).
#pragma once

#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include "rpc.h"
#include "torchft.pb.h"

namespace torchft_tpu {

struct ManagerOpt {
  std::string replica_id;
  // One address, or a comma-separated candidate list ("primary,standby"):
  // the manager dials the first and rotates to the next on transport
  // failure (lighthouse death). A warm standby learned from quorum
  // responses (LighthouseQuorumResponse.standby_address) is appended to
  // the candidates automatically, so a single-address config still fails
  // over once the primary has introduced its standby.
  std::string lighthouse_addr;
  std::string bind = "0.0.0.0:0";
  // Address advertised to peers (defaults to the bound address).
  std::string advertise_addr;
  // KV store address for communicator rendezvous, advertised in QuorumMember.
  std::string store_addr;
  uint64_t world_size = 1;  // local ranks in this replica group
  int64_t heartbeat_ms = 100;
  int64_t connect_timeout_ms = 10'000;
  // When non-empty, Kill RPCs must carry the matching token (the RPC
  // hard-exits the process). Empty = reference behavior (no gate).
  std::string auth_token;
};

class ManagerServer {
 public:
  explicit ManagerServer(const ManagerOpt& opt);
  ~ManagerServer();

  std::string address() const;
  void shutdown();

  // Graceful preemption drain (docs/design/churn.md): send the leaving
  // beat to the lighthouse NOW, without shutting the server down — the
  // draining Python Manager farewells FIRST (so survivors' next quorum
  // round cuts the shrunken membership immediately) and then finishes
  // its final save/withdrawal locally before the full shutdown().
  // Idempotent; also silences the heartbeat loop so a later periodic
  // beat cannot revive the departed record. Best-effort like the
  // shutdown farewell (a lost farewell degrades to staleness eviction).
  void farewell();

  // SIGKILL simulation for churn benches/soaks: stop serving and beating
  // WITHOUT the farewell (a real SIGKILL sends none), so survivors pay
  // the staleness-eviction path — the honest control leg for the
  // graceful-drain A/B. Production code never calls this.
  void hard_stop();

  // Operator-facing status push (VERDICT r3 missing #3): the Python
  // Manager's per-step state machine owns the interesting metrics
  // (quorum/heal/allreduce timings, commit counts); it pushes a JSON
  // snapshot here once per commit. Served at GET /metrics.json on the
  // manager's RPC port, and the scalar counters ride the lighthouse
  // heartbeat so the dashboard can show per-member heal/commit/abort.
  void set_status(const std::string& metrics_json, int64_t heal_count,
                  int64_t committed_steps, int64_t aborted_steps);

  // Per-step telemetry digest (docs/design/fleet_health.md), pushed by
  // the Python Manager once per commit boundary; piggybacks on the
  // quorum RPC beat (and the periodic keepalive beat) so the lighthouse
  // can aggregate fleet health with ZERO extra RPCs. Never calling this
  // keeps the wire bit-exact with digest-less builds.
  void set_digest(const StepDigest& d);

  // Times this manager re-dialed a DIFFERENT lighthouse endpoint (primary
  // death -> standby, or rotation through a configured candidate list).
  // Surfaced in Manager.metrics() as `lighthouse_redials`.
  int64_t lighthouse_redials() const;
  // The lighthouse endpoint currently dialed (observability).
  std::string lighthouse_addr() const;

 private:
  bool handle(uint8_t method, const std::string& req, std::string* resp,
              std::string* err);
  std::string handle_http(const std::string& request);
  bool handle_quorum(const ManagerQuorumRequest& r, ManagerQuorumResponse* out,
                     std::string* err);
  bool handle_should_commit(const ShouldCommitRequest& r,
                            ShouldCommitResponse* out, std::string* err);
  void heartbeat_loop();

  ManagerOpt opt_;

  mutable std::mutex mu_;
  std::condition_variable cv_;
  bool shutdown_ = false;
  // The farewell has been sent: the heartbeat loop stops beating (a beat
  // after the farewell would erase the departed record and make fast
  // eviction wait out the grace window for a group that cleanly left).
  bool farewell_sent_ = false;
  // A periodic beat RPC is in flight (sent outside mu_ — it can take up
  // to its 1s deadline). farewell() waits for it to land before sending
  // the leaving beat: a stale beat arriving AFTER the farewell would
  // erase the departed record at the lighthouse, making the drained
  // leaver look alive again and re-arming the fast path with a cached
  // membership that names it.
  bool beat_inflight_ = false;

  // Barrier round for quorum: all world_size local ranks must arrive; the
  // completing rank performs the lighthouse RPC for the group. The response
  // is then computed PER LOCAL RANK from the shared quorum (each local rank
  // gets its own recovery primary / store, spreading healing and rendezvous
  // load across max-step groups — reference src/manager.rs:256).
  //
  // Rounds are keyed by step so a client retry after a lost response
  // re-lands in ITS OWN round and gets the identical (idempotent) answer
  // instead of double-joining the next round's barrier.
  struct QuorumRound {
    std::map<int64_t, std::string> joined;  // rank -> checkpoint server addr
    // rank -> call_seq of the invocation this round served. A done round
    // replays for the same seq (transport retry of a lost response) and
    // resets for a higher seq (genuine step retry after a failed commit).
    std::map<int64_t, int64_t> served_seq;
    bool in_flight = false;  // lighthouse RPC running
    bool done = false;
    Quorum quorum;
    bool fast_path = false;  // the lighthouse served this round from cache
    // Fleet health hint from the lighthouse response, forwarded to every
    // local rank of the group (docs/design/fleet_health.md).
    FleetHint fleet;
    std::string error;
  };
  std::map<int64_t, std::shared_ptr<QuorumRound>> quorum_rounds_;  // by step
  // Requires the round to be done and error-free.
  bool compute_response(const QuorumRound& round, int64_t rank,
                        int64_t req_step, ManagerQuorumResponse* out,
                        std::string* err);

  struct CommitRound {
    std::map<int64_t, bool> votes;  // rank -> local should_commit
    std::map<int64_t, int64_t> served_seq;  // see QuorumRound::served_seq
    bool done = false;
    bool decision = false;
  };
  std::map<int64_t, std::shared_ptr<CommitRound>> commit_rounds_;  // by step

  // rank -> checkpoint server address, refreshed each quorum; served to
  // healing peers via CheckpointAddress.
  std::map<int64_t, std::string> checkpoint_addrs_;

  // In-flight lighthouse quorum client, published so shutdown() can cancel
  // a call parked at the lighthouse.
  std::shared_ptr<RpcClient> lighthouse_inflight_;

  // Number of lighthouse quorum round-trips currently in flight. While > 0
  // the periodic heartbeat carries joining=true, keeping the lighthouse's
  // split-quorum guard armed if our join parks longer than
  // heartbeat_fresh_ms (see LighthouseHeartbeatRequest.joining).
  int64_t quorum_inflight_ = 0;

  // --- lighthouse endpoint rotation (warm-standby failover) -------------
  // Candidates = the configured comma-list plus any standby learned from
  // quorum responses; lh_idx_ indexes the current endpoint. All guarded by
  // mu_. rotate is CAS-style (only advances when the caller still observes
  // the endpoint it failed against) so the quorum and heartbeat loops
  // cannot double-rotate past the live standby on one death.
  std::vector<std::string> lighthouse_candidates_;
  size_t lh_idx_ = 0;
  std::string learned_standby_;
  int64_t lighthouse_redials_ = 0;
  // Coalesced-heartbeat state: keepalive cadence advertised by the
  // lighthouse, whether the last quorum answer rode the fast path (steady
  // state), and when our beat last reached the lighthouse (quorum
  // piggybacks count — that is the point).
  int64_t keepalive_ms_ = 0;
  bool last_fast_path_ = false;
  int64_t last_beat_ok_ms_ = 0;
  // Requires mu_: current endpoint / CAS rotation.
  std::string current_lighthouse_locked() const;
  void rotate_lighthouse_locked(const std::string& failed_addr);

  // Last status push from the Python layer (see set_status).
  std::string metrics_json_;
  int64_t heal_count_ = 0;
  int64_t committed_steps_ = 0;
  int64_t aborted_steps_ = 0;
  // Last telemetry digest push (see set_digest); attached to outgoing
  // beats only once set (has_digest_ false = bit-exact legacy beats).
  StepDigest digest_;
  bool has_digest_ = false;

  std::unique_ptr<RpcServer> server_;
  std::thread heartbeat_thread_;
};

}  // namespace torchft_tpu
