// Lighthouse: the global quorum arbiter.
//
// C++ re-implementation of the reference's Rust lighthouse
// (/root/reference/src/lighthouse.rs): tracks joining participants, forms a
// quorum per tick with fast-quorum / min_replicas / join-timeout semantics
// (reference :106-208), bumps quorum_id only when membership changes
// (reference quorum_changed :81-86), parks Quorum RPCs until the next quorum
// broadcast, records heartbeats, and serves an HTML dashboard with kill
// buttons on the same port (reference :234-252).
//
// Beyond the reference, three control-plane scaling layers
// (docs/design/control_plane.md):
//   1. membership-unchanged FAST PATH: when every member of the previous
//      quorum is provably live and no joiner is pending, a Quorum RPC is
//      served from the cached decision with a bumped epoch — no tick-loop
//      park, no fan-in barrier. Any membership delta (stale beat, joiner,
//      farewell) makes requests ineligible and falls back to the slow path,
//      so quorum semantics (join grace, eviction staleness) are untouched.
//   2. coalesced, LOCK-STRIPED heartbeats: beats (standalone or piggybacked
//      on Quorum RPCs) land in a sharded BeatTable so 64+ clients never
//      serialize on the quorum mutex.
//   3. WARM STANDBY: a second lighthouse follows the primary's quorum state
//      over kLighthouseReplicate and starts serving (same quorum_id, jumped
//      epoch) only once the primary is provably dead, so managers re-dial
//      mid-step without a ring rebuild.
#pragma once

#include <array>
#include <atomic>
#include <condition_variable>
#include <deque>
#include <functional>
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

struct LighthouseOpt {
  std::string bind = "0.0.0.0:0";
  uint64_t min_replicas = 1;
  int64_t join_timeout_ms = 60'000;
  int64_t quorum_tick_ms = 100;
  // Grace: a quorum cut that would EXCLUDE a replica we have fresh evidence
  // is alive and trying to join is deferred, up to heartbeat_grace_factor *
  // join_timeout_ms from the round's first join (the cap bounds a
  // wedged-but-beating group). Two evidence sources qualify:
  //   1. a previous-quorum member whose heartbeat is fresher than
  //      heartbeat_fresh_ms (alive, momentarily stalled — e.g. compiling);
  //   2. ANY replica whose joining-flagged heartbeat is fresh (managers
  //      announce intent with a synchronous joining beat before the Quorum
  //      RPC, so a restarted group — fresh replica_id, never a previous
  //      member — is protected too).
  // Crucially the deferral also applies to the FAST-quorum path: after a
  // shrink to {a}, a's rejoin alone satisfies fast quorum and would
  // otherwise instantly cut a solo quorum while a restarted b's join is in
  // flight — forking the job into split quorums that commit divergent
  // steps. The reference records heartbeats but never uses them in quorum
  // logic (src/lighthouse.rs:378-391); this closes that gap. Set
  // heartbeat_grace_factor = 1 to disable (reference behavior).
  int64_t heartbeat_fresh_ms = 500;
  int64_t heartbeat_grace_factor = 4;
  // Fast eviction (inverse of the grace deferral): when every previous-
  // quorum member missing from this round is *provably* gone — its latest
  // heartbeat is staler than eviction_staleness_factor * heartbeat_fresh_ms,
  // or it said farewell (leaving beat erases its record) — the shrunken
  // quorum cuts immediately instead of granting stragglers join_timeout_ms.
  // With the defaults (3 * 500ms) a crashed group stalls survivors ~1.5s
  // rather than the 60s binary-default join timeout. A wedged-but-alive
  // group still beats from its heartbeat thread, so it gets the full
  // timeout (and grace). The reference can't do this: its heartbeats are
  // dashboard-only (src/lighthouse.rs:378-391). 0 disables.
  int64_t eviction_staleness_factor = 3;
  // Shared job secret forwarded in dashboard-initiated Kill RPCs so
  // token-gated managers accept them. (The dashboard itself is read-only
  // apart from kill; put it behind your VPC firewall regardless.)
  std::string auth_token;
  // Membership-unchanged fast path (docs/design/control_plane.md). Off
  // restores strict reference behavior: every Quorum RPC parks in the
  // tick-loop rendezvous.
  bool fast_path = true;
  // Non-empty = run as a warm standby of the primary at this address:
  // follow its quorum state over kLighthouseReplicate every replicate_ms,
  // refuse Quorum RPCs until the primary is provably dead, then promote and
  // serve with the adopted quorum_id (+ an epoch jump covering any
  // unreplicated fast-path serves).
  std::string standby_of;
  int64_t replicate_ms = 100;
  // Join-coalescing window (docs/design/churn.md): once a JOINER (a
  // participant not in the previous quorum) lands in a forming round, the
  // cut is held open for this long from the first joiner's arrival so a
  // join storm is admitted as ONE membership delta — reconfigures then
  // scale with windows, not joiners. Only additive deltas are held:
  // shrinks (farewell / eviction) cut on their normal schedule, and the
  // window also caps the extra latency a lone joiner pays. 0 (default)
  // disables: every joiner cuts its own round (pre-churn behavior).
  int64_t join_window_ms = 0;
  // Fleet SLO spec (docs/design/fleet_health.md): "key=value" pairs
  // joined by ';' or ',' — step_p95_ms / commit_rate / heal_ms /
  // publish_lag_ms / staleness_ms (the same grammar
  // torchft_tpu.fleet.SLOConfig.from_spec parses). Empty = no SLOs.
  std::string slo_spec;
  // A group whose newest digest is older than this drops out of the
  // fleet aggregates (a departed/silent group must not linger as a
  // phantom straggler).
  int64_t digest_stale_ms = 60'000;
};

// Sharded liveness table: beat writes (the per-member hot path — 64+ clients
// beat or piggyback every step) take only one shard mutex, never the quorum
// lock. Quorum logic reads through the same shard locks; they are leaf locks
// (no method acquires anything else), so holding the lighthouse mutex while
// calling in is deadlock-free by ordering.
class BeatTable {
 public:
  struct Beat {
    int64_t last_ms = -1;          // any heartbeat
    int64_t last_joining_ms = -1;  // heartbeat with joining=true
    // Operational counters piggybacked on beats (see proto heal_count),
    // surfaced on the dashboard / status.json per member.
    int64_t heal_count = 0;
    int64_t committed_steps = 0;
    int64_t aborted_steps = 0;
  };

  void record(const std::string& id, int64_t now, bool joining,
              int64_t heal_count, int64_t committed, int64_t aborted);
  // Adopt a replicated beat (standby): timestamps are pre-anchored by the
  // caller; never moves an existing record backwards.
  void adopt(const std::string& id, int64_t last_ms, int64_t last_joining_ms);
  // Adopt a replicated farewell: records departure WITHOUT erasing a live
  // beat the standby heard directly after the snapshot was taken.
  void adopt_departed(const std::string& id, int64_t departed_ms);
  void farewell(const std::string& id, int64_t now);
  // Monotonic count of departure recordings (farewell / adopt_departed).
  // The fast path snapshots it before its eligibility check and re-reads
  // it before serving: a farewell landing in between (beats are lock-
  // striped, NOT under the quorum mutex) would otherwise be served a
  // cached membership naming the leaver — see handle_quorum.
  int64_t departed_seq() const {
    return departed_seq_.load(std::memory_order_acquire);
  }
  // Visit every farewell record (for replication).
  void for_each_departed(
      const std::function<void(const std::string&, int64_t)>& fn) const;
  // A join is proof of life: clears any stale farewell for this id.
  void revive(const std::string& id);
  bool lookup(const std::string& id, Beat* out) const;
  // max(last_ms, last_joining_ms); -1 when no record (incl. farewell'd).
  int64_t latest_ms(const std::string& id) const;
  bool departed(const std::string& id) const;
  // Visit every live beat record (shard at a time; the callback must not
  // re-enter this table).
  void for_each(
      const std::function<void(const std::string&, const Beat&)>& fn) const;
  // Drop records staler than keep_ms unless the id is in keep_ids.
  void prune(int64_t now, int64_t keep_ms, const std::set<std::string>& keep);

 private:
  static constexpr size_t kShards = 16;
  struct Shard {
    mutable std::mutex mu;
    std::map<std::string, Beat> beats;
    std::map<std::string, int64_t> departed;  // clean goodbyes: farewell ms
  };
  Shard& shard_for(const std::string& id) {
    return shards_[std::hash<std::string>{}(id) % kShards];
  }
  const Shard& shard_for(const std::string& id) const {
    return shards_[std::hash<std::string>{}(id) % kShards];
  }
  std::array<Shard, kShards> shards_;
  std::atomic<int64_t> departed_seq_{0};
};

// Per-group telemetry digest rings (docs/design/fleet_health.md),
// lock-striped beside the BeatTable with the same leaf-lock discipline:
// digest writes ride the quorum-RPC beat of 64+ clients, so they must
// never serialize on the quorum mutex. Bounded: kRing digests per group,
// groups pruned on farewell/staleness.
class DigestTable {
 public:
  static constexpr size_t kRing = 8;
  struct Entry {
    StepDigest d;
    int64_t recorded_ms = 0;
    // Read-time freshness (fleet._fresh_bound_ms — the mirror
    // contract): false once the row is older than ~2 of the group's
    // own boundary intervals. Stale rows stay visible in aggregates
    // but never shape baselines or attestation votes (the
    // dead-without-farewell fix).
    bool fresh = true;
  };

  void record(const std::string& id, const StepDigest& d, int64_t now);
  void erase(const std::string& id);
  // Drop groups whose newest digest is staler than keep_ms.
  void prune(int64_t now, int64_t keep_ms);
  // Latest digest per group, freshest-within-stale_ms only.
  std::map<std::string, Entry> latest(int64_t now,
                                      int64_t stale_ms) const;

 private:
  static constexpr size_t kShards = 16;
  struct Shard {
    mutable std::mutex mu;
    std::map<std::string, std::deque<Entry>> rings;
  };
  Shard& shard_for(const std::string& id) {
    return shards_[std::hash<std::string>{}(id) % kShards];
  }
  const Shard& shard_for(const std::string& id) const {
    return shards_[std::hash<std::string>{}(id) % kShards];
  }
  std::array<Shard, kShards> shards_;
};

// Straggler-aware batch-fraction ladder
// (docs/design/fleet_rebalance.md) — the authoritative copy of
// torchft_tpu.fleet.Rebalancer (the mirror contract, change together:
// constants and math are spelled identically on both sides, and the
// fraction TABLE string they emit must match byte-for-byte — frozen by
// core_test.cc and tests/test_rebalance.py). Watches each group's
// NORMALIZED step wall (wall / the digest-reported fraction in force)
// against the fleet median and walks a per-group fraction ladder with
// PolicyController-style persistence/hysteresis/cooldown; the trimmed
// slice is reallocated to headroom groups (boosts DERIVED, never
// ladder state). Not thread-safe: the owner (Lighthouse, under
// fleet_mu_) serializes.
class Rebalancer {
 public:
  struct Row {
    std::string replica_id;
    int64_t step = 0;
    double step_wall_ms = 0.0;
    // The digest's own rebalance_fraction — what the measured step
    // actually ran under (may trail the assigned one by an adoption
    // boundary). 0 must be mapped to 1.0 by the CALLER (proto default
    // = pre-rebalance manager).
    double reported_fraction = 1.0;
    // The straggler-baseline flag (fresh, not healing, full
    // capacity): ineligible rows keep their ladder fraction sticky
    // but take no observation and receive no boost.
    bool eligible = false;
  };

  // Farewell/eviction clears the group's fraction immediately.
  void forget(const std::string& rid) { state_.erase(rid); }
  // Advance the ladder one aggregate (groups absent from rows are
  // dropped as departed); returns the target fraction table, every
  // tracked group including 1.0 entries.
  std::map<std::string, double> observe(std::vector<Row> rows);
  // Ladder fractions plus derived boosts (deficit reallocated evenly
  // over eligible headroom groups, capped at the ceiling).
  std::map<std::string, double> fractions() const;
  // Canonical wire spelling: "rid=%.4f" comma-joined, sorted, entries
  // at exactly 1.0 omitted (fleet.format_rebalance_table).
  static std::string format_table(const std::map<std::string, double>& f);
  const std::string& table() const { return table_; }
  int64_t seq() const { return seq_; }

  int64_t shrinks_total = 0;
  int64_t restores_total = 0;

 private:
  struct St {
    double fraction = 1.0;
    int loud = 0;
    int quiet = 0;
    int cooldown = 0;
    int64_t last_step = 0;
    bool has_step = false;
    bool eligible = false;
  };
  std::map<std::string, St> state_;
  std::string table_;
  int64_t seq_ = 0;
};

// Parsed SLO thresholds (< 0 = disabled), mirroring
// torchft_tpu.fleet.SLOConfig.
struct SLOConfig {
  double step_p95_ms = -1;
  double commit_rate = -1;
  double heal_ms = -1;
  double publish_lag_ms = -1;
  double staleness_ms = -1;
  int64_t min_commit_samples = 8;
  static SLOConfig parse(const std::string& spec);
  bool enabled() const {
    return step_p95_ms >= 0 || commit_rate >= 0 || heal_ms >= 0 ||
           publish_lag_ms >= 0 || staleness_ms >= 0;
  }
};

// One computed fleet aggregate (the /fleet/status.json shape). The math
// mirrors torchft_tpu.fleet.FleetAggregator.aggregate exactly — robust
// z-scores vs the non-healing full-capacity baseline's median/MAD,
// slowest-stage attribution vs per-stage fleet medians.
struct FleetAggregate {
  struct Group {
    std::string replica_id;
    StepDigest d;
    int64_t age_ms = 0;
    double score = 0.0;
    // attribution; "heal"/"degraded"/"stale" when excluded
    std::string stage;
    bool baseline = false;
    std::vector<std::string> slo_breaches;  // SLOs THIS group breaches
    // State attestation (docs/design/state_attestation.md): this row
    // carries a fresh, non-healing fingerprint (a voter) / this group
    // is currently under a divergence verdict.
    bool attested = false;
    bool sdc_diverged = false;
    // Assigned rebalance batch fraction (docs/design/fleet_rebalance
    // .md): 1.0 = uniform share.
    double rebalance_fraction = 1.0;
  };
  int64_t computed_ms = 0;
  int64_t groups_n = 0;
  int64_t baseline_n = 0;
  double p50 = 0.0, p95 = 0.0, max = 0.0;
  double stage_median[4] = {0, 0, 0, 0};  // fetch, ring, put, vote
  std::string straggler_id;
  double straggler_score = 0.0;
  std::string straggler_stage;
  std::vector<Group> groups;  // score-ranked, worst first
  // Attestation verdicts at compute time (sorted replica ids, deduped
  // sorted checkpoint-server bases) + lifetime counters.
  std::vector<std::string> sdc_quarantined;
  std::vector<std::string> sdc_quarantined_addrs;
  int64_t sdc_verdicts_total = 0;
  int64_t sdc_clears_total = 0;
  // Straggler-aware rebalance (docs/design/fleet_rebalance.md): the
  // canonical fraction table, its change sequence (the flap counter),
  // and lifetime ladder moves.
  std::string rebalance_table;
  int64_t rebalance_seq = 0;
  int64_t rebalance_shrinks_total = 0;
  int64_t rebalance_restores_total = 0;
};

class Lighthouse {
 public:
  explicit Lighthouse(const LighthouseOpt& opt);
  ~Lighthouse();

  std::string address() const { return server_->address(); }
  void shutdown();

  // Pure membership-change predicate (mirrors reference quorum_changed).
  static bool quorum_changed(const Quorum& a, const Quorum& b);

  // StatusResponse -> JSON, shared by the ctypes bridge and the
  // GET /status.json dashboard endpoint.
  static std::string status_json(const StatusResponse& r);

 private:
  bool handle(uint8_t method, const std::string& req, std::string* resp,
              std::string* err);
  std::string handle_http(const std::string& request);
  bool handle_quorum(const LighthouseQuorumRequest& r,
                     LighthouseQuorumResponse* out, std::string* err);
  void record_beat(const LighthouseHeartbeatRequest& r);
  // --- fleet health plane (docs/design/fleet_health.md) -----------------
  // Recompute-or-reuse the cached fleet aggregate (bounded staleness;
  // guarded by fleet_mu_ — NEVER the quorum mutex: digest reads take
  // only the striped leaf locks, so 64+ quorum serves never convoy on
  // aggregation). Also runs the SLO evaluation (breach events, dedup,
  // gauges) when thresholds are configured.
  std::shared_ptr<const FleetAggregate> fleet_aggregate(int64_t now);
  // Fill the per-requester hint from the (cached) aggregate.
  void fill_fleet_hint(const std::string& id, FleetHint* out);
  std::string fleet_status_json(const FleetAggregate& agg);
  std::string fleet_metrics_text(const FleetAggregate& agg);
  // Requires mu_ held. Forms a quorum if valid; returns true if one formed.
  bool tick();
  bool quorum_valid_locked() const;
  // Requires mu_ held: can `id`'s request at `step` be served from the
  // cached decision? See docs/design/control_plane.md for the rules.
  bool fast_eligible_locked(const std::string& id, int64_t step) const;
  void status_locked(StatusResponse* out) const;
  void fill_response_locked(LighthouseQuorumResponse* out, bool fast) const;
  void replicate_loop();
  void adopt_replica_state(const ReplicateResponse& r);

  LighthouseOpt opt_;
  mutable std::mutex mu_;
  std::condition_variable cv_;
  struct Joiner {
    QuorumMember member;
    int64_t joined_at_ms;
  };
  std::map<std::string, Joiner> participants_;  // keyed by replica_id
  int64_t first_join_ms_ = 0;
  bool has_prev_quorum_ = false;
  Quorum prev_quorum_;
  // Seeded from boot time, NOT 0: managers detect membership changes by
  // quorum_id inequality, so a REPLACEMENT lighthouse (operator restarts
  // it at the same address after a crash — docs/pod_runbook.md "the
  // lighthouse died") must never mint ids a previous incarnation already
  // used. A counter restarting at 1 would collide with the common
  // stable-membership job (id still 1), survivors would skip the
  // communicator reconfigure, and a ring containing peers that died
  // during the outage would wedge every collective. Milliseconds-since-
  // epoch << 8 (see lighthouse.cc) leaves 256 id bumps per MILLISECOND
  // of incarnation overlap while guaranteeing the new one starts
  // strictly higher — ms, not seconds, because a supervisor can respawn
  // within the same second. (A warm STANDBY instead adopts the primary's
  // id exactly: it continues the live sequence, and minting a fresh id
  // for unchanged membership would force the pointless ring rebuild the
  // standby exists to avoid.)
  int64_t quorum_id_ = 0;
  // This incarnation's identity = the boot-time quorum_id seed, frozen at
  // construction. Shipped in ReplicateResponse so a standby can tell "the
  // primary restarted" (epoch counter reset) from "a stale poll".
  int64_t boot_id_ = 0;
  // The incarnation the standby last adopted from (0 = none yet).
  int64_t primary_boot_id_ = 0;
  int64_t broadcast_seq_ = 0;
  // Monotonic decision counter (see Quorum.epoch): bumps on every slow-path
  // formation and every fast-path serve.
  int64_t epoch_ = 0;
  // Highest step any fast-path serve answered. A pending joiner only blocks
  // fast serves for steps ABOVE this mark: the current step generation is
  // allowed to complete fast (mixing fast-served and parked members within
  // one step would deadlock the parked member against the served member's
  // collective), and the joiner is picked up by the next generation's slow
  // round.
  int64_t fast_round_step_ = -1;
  // The decisions as they were served. A member answered after a faster
  // peer has already asked at its next step must read its own round's
  // decision, not the cache the peer has since moved on (which shows the
  // peer alone at a higher max_step): the last few slow cuts by their
  // broadcast_seq_, and the step generation last served fast with its
  // quorum.
  std::map<int64_t, Quorum> cuts_;
  int64_t fast_served_step_ = -1;
  Quorum fast_served_quorum_;
  int64_t fast_path_hits_ = 0;
  int64_t slow_path_served_ = 0;
  int64_t slow_path_rounds_ = 0;
  // Join-coalescing state (docs/design/churn.md): when the first JOINER
  // (non-previous-member) of the forming round arrived (0 = none), and
  // the running count of joiners admitted beyond the first of their
  // round — the "reconfigures grow with windows, not joiners" observable.
  int64_t first_joiner_ms_ = 0;
  int64_t joins_coalesced_ = 0;
  // Previous-quorum membership as a set (updated at each formation /
  // adoption); lets the fast path and beat handling test membership without
  // scanning the proto.
  std::set<std::string> prev_ids_;
  // Registered warm standby (learned from ReplicateRequest), advertised in
  // every quorum response.
  std::string standby_addr_;
  BeatTable beats_;
  bool shutdown_ = false;

  // --- fleet health plane (docs/design/fleet_health.md) -----------------
  DigestTable digests_;
  SLOConfig slo_;
  std::mutex fleet_mu_;  // guards the aggregate cache + SLO dedup/events
  std::shared_ptr<const FleetAggregate> fleet_cache_;
  int64_t fleet_cache_ms_ = -1;
  static constexpr int64_t kFleetCacheMs = 200;  // recompute cadence cap
  // SLO breach dedup per (slo, group, step) — the flight recorder's
  // (reason, step) discipline, fleet-side — plus the bounded event log
  // /fleet/status.json serves and the exposition gauges.
  std::map<std::string, int64_t> slo_seen_;  // "slo|group" -> last step
  std::deque<std::string> slo_events_;       // JSON objects, newest last
  int64_t slo_breaches_total_ = 0;
  int64_t slo_active_ = 0;

  // --- state attestation (docs/design/state_attestation.md) -------------
  // Sticky divergence verdicts, guarded by fleet_mu_. A verdict latches
  // when a group loses a strict-majority digest vote for its
  // (quorum_id, step) ballot and clears only on a fresh digest matching
  // a later winner (the non-voter clear: quarantined groups report
  // healing=true, so their re-attest digest is not itself a ballot
  // entry) or on a clean farewell. Prune does NOT clear — a group that
  // died corrupt stays quarantined so donor filters keep excluding it.
  struct SdcVerdict {
    int64_t quorum_id = 0;
    int64_t step = 0;
    std::string digest;           // the minority digest that lost
    std::string majority_digest;  // the winner it disagreed with
    std::string trace_addr;       // checkpoint-server base, for filters
    int64_t verdict_ms = 0;
  };
  std::map<std::string, SdcVerdict> sdc_quarantined_;
  int64_t sdc_verdicts_total_ = 0;
  int64_t sdc_clears_total_ = 0;

  // --- fleet rebalance (docs/design/fleet_rebalance.md) -----------------
  // Guarded by fleet_mu_ (advanced inside fleet_aggregate, which holds
  // it; forget() on the farewell path takes it explicitly).
  // Observations are step-driven, so the 200 ms aggregate cache never
  // inflates the ladder clock.
  Rebalancer rebalancer_;

  // Standby machinery. promoted_ is true from birth on a primary; on a
  // standby it flips once the primary is provably dead and gates Quorum
  // serving (the split-brain fence: serving while the primary is alive
  // would fork the job into two quorum arbiters). Promotion requires TWO
  // independent observers: the standby's own replication polls failing
  // (armed), AND a manager demonstrating primary-unreachability by
  // dialing our fence with a Quorum attempt (corroborated) — the connect
  // layer cannot distinguish "listener gone" from "packets dropped", so
  // a standby-side partition alone must never promote (managers that can
  // still reach the primary never dial us).
  std::atomic<bool> promoted_{true};
  int64_t last_primary_ok_ms_ = 0;
  int64_t primary_poll_failures_ = 0;
  std::atomic<int64_t> last_fenced_quorum_ms_{-1};

  std::thread tick_thread_;
  std::thread replicate_thread_;
  std::unique_ptr<RpcServer> server_;
};

}  // namespace torchft_tpu
