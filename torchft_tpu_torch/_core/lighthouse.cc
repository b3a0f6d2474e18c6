#include "lighthouse.h"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <set>
#include <sstream>

namespace torchft_tpu {

// ------------------------------------------------------------------ beats

void BeatTable::record(const std::string& id, int64_t now, bool joining,
                       int64_t heal_count, int64_t committed,
                       int64_t aborted) {
  Shard& s = shard_for(id);
  std::lock_guard<std::mutex> lk(s.mu);
  Beat& b = s.beats[id];
  b.last_ms = now;
  if (joining) b.last_joining_ms = now;
  b.heal_count = heal_count;
  b.committed_steps = committed;
  b.aborted_steps = aborted;
  // Back from the dead — a membership-relevant transition like the
  // departure itself, so it bumps the same sequence the fast path's
  // serve-time recheck reads (a revival racing a serve is the mirror
  // image of a farewell racing one).
  if (s.departed.erase(id) > 0)
    departed_seq_.fetch_add(1, std::memory_order_release);
}

void BeatTable::adopt(const std::string& id, int64_t last_ms,
                      int64_t last_joining_ms) {
  Shard& s = shard_for(id);
  std::lock_guard<std::mutex> lk(s.mu);
  Beat& b = s.beats[id];
  // Replication must never make a record LOOK staler than a beat the
  // standby already received directly (managers keepalive both ways during
  // a failover window).
  b.last_ms = std::max(b.last_ms, last_ms);
  b.last_joining_ms = std::max(b.last_joining_ms, last_joining_ms);
}

void BeatTable::adopt_departed(const std::string& id, int64_t departed_ms) {
  Shard& s = shard_for(id);
  std::lock_guard<std::mutex> lk(s.mu);
  // A beat the standby heard directly AFTER the farewell snapshot wins
  // ("back from the dead"); only a record older than the farewell yields.
  auto it = s.beats.find(id);
  if (it != s.beats.end()) {
    int64_t latest = std::max(it->second.last_ms, it->second.last_joining_ms);
    if (latest >= departed_ms) return;
    s.beats.erase(it);
  }
  int64_t& d = s.departed[id];
  d = std::max(d, departed_ms);
  departed_seq_.fetch_add(1, std::memory_order_release);
}

void BeatTable::farewell(const std::string& id, int64_t now) {
  Shard& s = shard_for(id);
  std::lock_guard<std::mutex> lk(s.mu);
  s.beats.erase(id);
  s.departed[id] = now;
  departed_seq_.fetch_add(1, std::memory_order_release);
}

void BeatTable::revive(const std::string& id) {
  Shard& s = shard_for(id);
  std::lock_guard<std::mutex> lk(s.mu);
  if (s.departed.erase(id) > 0)
    departed_seq_.fetch_add(1, std::memory_order_release);
}

bool BeatTable::lookup(const std::string& id, Beat* out) const {
  const Shard& s = shard_for(id);
  std::lock_guard<std::mutex> lk(s.mu);
  auto it = s.beats.find(id);
  if (it == s.beats.end()) return false;
  *out = it->second;
  return true;
}

int64_t BeatTable::latest_ms(const std::string& id) const {
  Beat b;
  if (!lookup(id, &b)) return -1;
  return std::max(b.last_ms, b.last_joining_ms);
}

bool BeatTable::departed(const std::string& id) const {
  const Shard& s = shard_for(id);
  std::lock_guard<std::mutex> lk(s.mu);
  return s.departed.count(id) != 0;
}

void BeatTable::for_each(
    const std::function<void(const std::string&, const Beat&)>& fn) const {
  for (const Shard& s : shards_) {
    std::lock_guard<std::mutex> lk(s.mu);
    for (const auto& [id, b] : s.beats) fn(id, b);
  }
}

void BeatTable::for_each_departed(
    const std::function<void(const std::string&, int64_t)>& fn) const {
  for (const Shard& s : shards_) {
    std::lock_guard<std::mutex> lk(s.mu);
    for (const auto& [id, ms] : s.departed) fn(id, ms);
  }
}

void BeatTable::prune(int64_t now, int64_t keep_ms,
                      const std::set<std::string>& keep) {
  for (Shard& s : shards_) {
    std::lock_guard<std::mutex> lk(s.mu);
    for (auto it = s.beats.begin(); it != s.beats.end();) {
      int64_t latest = std::max(it->second.last_ms, it->second.last_joining_ms);
      if (now - latest > keep_ms && !keep.count(it->first))
        it = s.beats.erase(it);
      else
        ++it;
    }
    for (auto it = s.departed.begin(); it != s.departed.end();) {
      if (now - it->second > keep_ms && !keep.count(it->first))
        it = s.departed.erase(it);
      else
        ++it;
    }
  }
}

// ---------------------------------------------------------------- digests

void DigestTable::record(const std::string& id, const StepDigest& d,
                         int64_t now) {
  Shard& s = shard_for(id);
  std::lock_guard<std::mutex> lk(s.mu);
  auto& ring = s.rings[id];
  ring.push_back(Entry{d, now});
  while (ring.size() > kRing) ring.pop_front();
}

void DigestTable::erase(const std::string& id) {
  Shard& s = shard_for(id);
  std::lock_guard<std::mutex> lk(s.mu);
  s.rings.erase(id);
}

void DigestTable::prune(int64_t now, int64_t keep_ms) {
  for (Shard& s : shards_) {
    std::lock_guard<std::mutex> lk(s.mu);
    for (auto it = s.rings.begin(); it != s.rings.end();) {
      if (it->second.empty() ||
          now - it->second.back().recorded_ms > keep_ms)
        it = s.rings.erase(it);
      else
        ++it;
    }
  }
}

// Read-time freshness bound (fleet._fresh_bound_ms — the mirror
// contract, change together): ~2.5x the group's own median boundary
// interval, floored at 2s, capped at stale_ms. Fewer than two positive
// deltas means no cadence estimate, so fall back to stale_ms (never
// stricter than the hard staleness cut).
static int64_t fresh_bound_ms(const std::deque<DigestTable::Entry>& ring,
                              int64_t stale_ms) {
  constexpr double kFreshIntervals = 2.5;  // fleet.FRESH_INTERVALS
  constexpr double kMinFreshMs = 2000.0;   // fleet.MIN_FRESH_MS
  if (ring.size() >= 3) {
    std::vector<double> deltas;
    for (size_t i = 0; i + 1 < ring.size(); i++) {
      double d = (double)(ring[i + 1].recorded_ms - ring[i].recorded_ms);
      if (d > 0) deltas.push_back(d);
    }
    if (deltas.size() >= 2) {
      std::sort(deltas.begin(), deltas.end());
      size_t n = deltas.size();
      double interval =
          n % 2 ? deltas[n / 2] : 0.5 * (deltas[n / 2 - 1] + deltas[n / 2]);
      if (interval > 0.0)
        return (int64_t)std::min(
            (double)stale_ms, std::max(kFreshIntervals * interval,
                                       kMinFreshMs));
    }
  }
  return stale_ms;
}

std::map<std::string, DigestTable::Entry> DigestTable::latest(
    int64_t now, int64_t stale_ms) const {
  std::map<std::string, Entry> out;
  for (const Shard& s : shards_) {
    std::lock_guard<std::mutex> lk(s.mu);
    for (const auto& [id, ring] : s.rings) {
      if (ring.empty()) continue;
      Entry e = ring.back();
      if (now - e.recorded_ms > stale_ms) continue;
      e.fresh = now - e.recorded_ms <= fresh_bound_ms(ring, stale_ms);
      out[id] = e;
    }
  }
  return out;
}

// ------------------------------------------------------------ fleet math
// Mirrors torchft_tpu.fleet (the tier-1-testable Python spelling): the
// two implementations must rank and attribute identically — change them
// together (docs/design/fleet_health.md).

namespace {

// 1/Phi^-1(3/4): MAD -> sigma consistency constant (fleet.MAD_SIGMA).
constexpr double kMadSigma = 1.4826;
const char* kDigestStages[4] = {"fetch", "ring", "put", "vote"};

double stage_value(const StepDigest& d, int i) {
  switch (i) {
    case 0: return d.fetch_ms();
    case 1: return d.ring_ms();
    case 2: return d.put_ms();
    default: return d.vote_ms();
  }
}

double median_of(std::vector<double> v) {
  if (v.empty()) return 0.0;
  std::sort(v.begin(), v.end());
  size_t n = v.size();
  return n % 2 ? v[n / 2] : 0.5 * (v[n / 2 - 1] + v[n / 2]);
}

double percentile_of(std::vector<double> v, double q) {
  if (v.empty()) return 0.0;
  std::sort(v.begin(), v.end());
  size_t idx = (size_t)((double)v.size() * q);
  if (idx >= v.size()) idx = v.size() - 1;
  return v[idx];
}

// Healers / degraded-capacity groups are excluded from the straggler
// baseline (their slowness is explained) — fleet.StepDigest
// .baseline_eligible.
bool baseline_eligible(const StepDigest& d) {
  return !d.healing() && d.capacity_fraction() >= 0.999;
}

// Slowest-stage attribution vs the fleet's per-stage medians; ties
// break in protocol order, all-under-median falls back to the group's
// own largest stage (fleet.attribute_stage).
std::string attribute_stage(const StepDigest& d,
                            const double (&med)[4]) {
  int best = -1;
  double best_excess = -1e300;
  for (int i = 0; i < 4; i++) {
    double excess = stage_value(d, i) - med[i];
    if (excess > best_excess + 1e-12) {
      best = i;
      best_excess = excess;
    }
  }
  if (best < 0 || best_excess <= 0.0) {
    int biggest = 0;
    for (int i = 1; i < 4; i++)
      if (stage_value(d, i) > stage_value(d, biggest)) biggest = i;
    return stage_value(d, biggest) > 0.0 ? kDigestStages[biggest] : "";
  }
  return kDigestStages[best];
}

double round3(double v) { return std::floor(v * 1e3 + 0.5) / 1e3; }
double round4(double v) { return std::floor(v * 1e4 + 0.5) / 1e4; }

// Straggler-aware rebalance constants (docs/design/fleet_rebalance.md)
// — every value spelled identically in torchft_tpu.fleet (the mirror
// contract: both sides must compute bit-identical fraction tables from
// the same digest stream). The ladder moves in exact-binary eighths so
// the mirrors cannot drift through accumulated rounding.
constexpr double kRebalanceFloor = 0.5;
constexpr double kRebalanceCeil = 1.5;
constexpr double kRebalanceStep = 0.125;
constexpr double kRebalanceHi = 1.5;
constexpr double kRebalanceLo = 1.15;
constexpr int kRebalancePersist = 3;
constexpr int kRebalanceRelax = 6;
constexpr int kRebalanceCooldown = 4;

std::string fmt_double(double v) {
  char buf[64];
  snprintf(buf, sizeof buf, "%.6g", v);
  return buf;
}

}  // namespace

// ------------------------------------------------------ fleet rebalance
// Mirror of torchft_tpu.fleet.Rebalancer — change together. The two
// implementations iterate in the same order (rows sorted by
// replica_id, state in map order) and use the same arithmetic, so the
// fraction table is bit-identical given the same digest stream.

std::string Rebalancer::format_table(
    const std::map<std::string, double>& f) {
  // fleet.format_rebalance_table: "rid=%.4f" comma-joined, sorted by
  // rid (std::map order), entries at exactly 1.0 omitted.
  std::string out;
  for (const auto& [rid, frac] : f) {
    if (std::fabs(frac - 1.0) <= 1e-9) continue;
    char buf[32];
    snprintf(buf, sizeof buf, "%.4f", frac);
    if (!out.empty()) out += ",";
    out += rid + "=" + buf;
  }
  return out;
}

std::map<std::string, double> Rebalancer::observe(std::vector<Row> rows) {
  std::set<std::string> present;
  for (const auto& r : rows) present.insert(r.replica_id);
  for (auto it = state_.begin(); it != state_.end();) {
    if (!present.count(it->first))
      it = state_.erase(it);  // departed: fraction cleared immediately
    else
      ++it;
  }

  std::sort(rows.begin(), rows.end(), [](const Row& a, const Row& b) {
    return a.replica_id < b.replica_id;
  });
  std::map<std::string, double> norm;
  std::vector<double> norm_vals;
  for (const auto& r : rows) {
    if (!r.eligible) continue;
    // Judge each group at its would-be full-batch pace: divide the
    // wall by the fraction its measured step actually ran under
    // (clamped to the ladder bounds — a corrupt report must not
    // explode the normalization).
    double rep = std::min(kRebalanceCeil,
                          std::max(kRebalanceFloor, r.reported_fraction));
    double v = r.step_wall_ms / rep;
    norm[r.replica_id] = v;
    norm_vals.push_back(v);
  }
  double med = median_of(norm_vals);

  for (const auto& r : rows) {
    St& st = state_[r.replica_id];
    st.eligible = r.eligible;
    if (!r.eligible) {
      // A healer/degraded/stale row is not comparable: freeze the
      // ladder (sticky fraction) and restart persistence.
      st.loud = st.quiet = 0;
      continue;
    }
    if (st.has_step && r.step == st.last_step)
      continue;  // no new boundary: not a new observation
    st.has_step = true;
    st.last_step = r.step;
    if (st.cooldown > 0) st.cooldown--;
    if (med <= 1e-9) {
      st.loud = st.quiet = 0;
      continue;
    }
    double ratio = norm[r.replica_id] / med;
    if (ratio >= kRebalanceHi) {
      st.loud++;
      st.quiet = 0;
      if (st.loud >= kRebalancePersist && st.cooldown == 0 &&
          st.fraction > kRebalanceFloor + 1e-9) {
        st.fraction =
            std::max(kRebalanceFloor, st.fraction - kRebalanceStep);
        st.cooldown = kRebalanceCooldown;
        st.loud = 0;
        shrinks_total++;
      }
    } else if (ratio <= kRebalanceLo) {
      st.quiet++;
      st.loud = 0;
      if (st.quiet >= kRebalanceRelax && st.cooldown == 0 &&
          st.fraction < 1.0 - 1e-9) {
        st.fraction = std::min(1.0, st.fraction + kRebalanceStep);
        st.cooldown = kRebalanceCooldown;
        st.quiet = 0;
        restores_total++;
      }
    } else {
      st.loud = st.quiet = 0;  // dead zone resets both streaks
    }
  }

  auto f = fractions();
  std::string t = format_table(f);
  if (t != table_) {
    table_ = t;
    seq_++;
  }
  return f;
}

std::map<std::string, double> Rebalancer::fractions() const {
  // fleet.Rebalancer.fractions: the trimmed mass sum(1 - ladder) is
  // reallocated evenly over headroom groups (ladder 1.0 AND eligible
  // — a shrunken group that went healing still counts as deficit, but
  // a healer never receives boost), capped at the ceiling; remainder
  // past the cap goes unallocated.
  double deficit = 0.0;
  size_t headroom = 0;
  for (const auto& [rid, st] : state_) {
    if (st.fraction < 1.0 - 1e-9)
      deficit += 1.0 - st.fraction;
    else if (st.eligible)
      headroom++;
  }
  double bonus =
      (headroom && deficit > 1e-9) ? deficit / (double)headroom : 0.0;
  std::map<std::string, double> out;
  for (const auto& [rid, st] : state_) {
    if (st.fraction < 1.0 - 1e-9)
      out[rid] = st.fraction;
    else if (st.eligible && bonus > 0.0)
      out[rid] = std::min(kRebalanceCeil, 1.0 + bonus);
    else
      out[rid] = 1.0;
  }
  return out;
}

SLOConfig SLOConfig::parse(const std::string& spec) {
  // Same grammar as fleet.SLOConfig.from_spec; unknown keys are
  // IGNORED here (a C++ server must not die on a spec written for a
  // newer build — the Python CLI validates strictly before passing).
  SLOConfig cfg;
  std::string rest = spec;
  for (char& c : rest)
    if (c == ',') c = ';';
  while (!rest.empty()) {
    size_t semi = rest.find(';');
    std::string part =
        semi == std::string::npos ? rest : rest.substr(0, semi);
    rest = semi == std::string::npos ? "" : rest.substr(semi + 1);
    size_t eq = part.find('=');
    if (eq == std::string::npos) continue;
    // Trim spaces around the key.
    std::string key = part.substr(0, eq);
    size_t b = key.find_first_not_of(' ');
    size_t e = key.find_last_not_of(' ');
    key = b == std::string::npos ? "" : key.substr(b, e - b + 1);
    double val = atof(part.substr(eq + 1).c_str());
    if (key == "step_p95_ms") cfg.step_p95_ms = val;
    else if (key == "commit_rate") cfg.commit_rate = val;
    else if (key == "heal_ms") cfg.heal_ms = val;
    else if (key == "publish_lag_ms") cfg.publish_lag_ms = val;
    else if (key == "staleness_ms") cfg.staleness_ms = val;
  }
  return cfg;
}

// ------------------------------------------------------------- lighthouse

Lighthouse::Lighthouse(const LighthouseOpt& opt) : opt_(opt) {
  // Boot-time id seed: a replacement lighthouse must mint ids strictly
  // above any previous incarnation's (see lighthouse.h quorum_id_).
  // WALL clock, not now_ms(): now_ms() is steady_clock (arbitrary epoch,
  // usually host uptime), so a replacement on a freshly-booted or
  // different machine could seed BELOW the dead incarnation and replay
  // its ids — the exact collision this seed exists to prevent.
  // MILLISECOND granularity: a supervisor (systemd Restart=always) can
  // respawn within the same second; ms<<8 still leaves 256 membership
  // changes per ms of incarnation overlap, far beyond any real churn.
  // (A standby overwrites this with the primary's id on adoption.)
  quorum_id_ =
      std::chrono::duration_cast<std::chrono::milliseconds>(
          std::chrono::system_clock::now().time_since_epoch())
          .count()
      << 8;
  boot_id_ = quorum_id_;  // frozen incarnation identity (see lighthouse.h)
  slo_ = SLOConfig::parse(opt_.slo_spec);
  // The staleness SLO must be able to SEE a silent group: one older
  // than digest_stale_ms is dropped from the aggregates entirely, so a
  // threshold at/past the retention window could never breach (and an
  // active breach would self-clear while the group is still silent).
  // Widen retention to 2x the threshold so the breach fires and holds
  // for a full staleness window before the group ages out.
  if (slo_.staleness_ms >= 0)
    opt_.digest_stale_ms = std::max(
        opt_.digest_stale_ms, (int64_t)(2 * slo_.staleness_ms));
  promoted_.store(opt_.standby_of.empty());
  server_ = std::make_unique<RpcServer>(
      opt.bind,
      [this](uint8_t m, const std::string& req, std::string* resp,
             std::string* err) { return handle(m, req, resp, err); },
      [this](const std::string& req) { return handle_http(req); });
  tick_thread_ = std::thread([this] {
    std::unique_lock<std::mutex> lk(mu_);
    while (!shutdown_) {
      cv_.wait_for(lk, std::chrono::milliseconds(opt_.quorum_tick_ms));
      if (!shutdown_) tick();
    }
  });
  if (!opt_.standby_of.empty())
    replicate_thread_ = std::thread([this] { replicate_loop(); });
}

Lighthouse::~Lighthouse() { shutdown(); }

void Lighthouse::shutdown() {
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (shutdown_) return;
    shutdown_ = true;
  }
  cv_.notify_all();
  if (tick_thread_.joinable()) tick_thread_.join();
  if (replicate_thread_.joinable()) replicate_thread_.join();
  server_->shutdown();
}

static std::string html_escape(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (char c : s) {
    switch (c) {
      case '<': out += "&lt;"; break;
      case '>': out += "&gt;"; break;
      case '&': out += "&amp;"; break;
      case '"': out += "&quot;"; break;
      case '\'': out += "&#39;"; break;
      default: out += c;
    }
  }
  return out;
}

// Percent-encode for use inside a URL path segment (the kill-button form
// action); HTML escaping is only correct for display text.
static std::string url_encode(const std::string& s) {
  static const char* hex = "0123456789ABCDEF";
  std::string out;
  out.reserve(s.size());
  for (unsigned char c : s) {
    if (isalnum(c) || c == '-' || c == '_' || c == '.' || c == '~') {
      out += (char)c;
    } else {
      out += '%';
      out += hex[c >> 4];
      out += hex[c & 0xF];
    }
  }
  return out;
}

std::string Lighthouse::status_json(const StatusResponse& r) {
  std::string out = "{\"quorum_id\":" + std::to_string(r.quorum_id()) +
                    ",\"quorum_age_ms\":" + std::to_string(r.quorum_age_ms()) +
                    ",\"epoch\":" + std::to_string(r.epoch()) +
                    ",\"fast_path_hits\":" +
                    std::to_string(r.fast_path_hits()) +
                    ",\"slow_path_served\":" +
                    std::to_string(r.slow_path_served()) +
                    ",\"slow_path_rounds\":" +
                    std::to_string(r.slow_path_rounds()) +
                    ",\"joins_coalesced\":" +
                    std::to_string(r.joins_coalesced()) +
                    ",\"fast_path_eligible\":" +
                    (r.fast_path_eligible() ? "true" : "false") +
                    ",\"is_standby\":" + (r.is_standby() ? "true" : "false") +
                    ",\"standby_address\":\"" +
                    json_escape(r.standby_address()) + "\",\"members\":[";
  for (int i = 0; i < r.members_size(); i++) {
    const auto& m = r.members(i);
    if (i) out += ",";
    out += "{\"replica_id\":\"" + json_escape(m.member().replica_id()) +
           "\",\"address\":\"" + json_escape(m.member().address()) +
           "\",\"step\":" + std::to_string(m.member().step()) +
           ",\"world_size\":" + std::to_string(m.member().world_size()) +
           ",\"heartbeat_age_ms\":" + std::to_string(m.heartbeat_age_ms()) +
           ",\"heal_count\":" + std::to_string(m.heal_count()) +
           ",\"committed_steps\":" + std::to_string(m.committed_steps()) +
           ",\"aborted_steps\":" + std::to_string(m.aborted_steps()) +
           "}";
  }
  out += "],\"joining\":[";
  for (int i = 0; i < r.joining_size(); i++) {
    if (i) out += ",";
    out += "\"" + json_escape(r.joining(i)) + "\"";
  }
  out += "]}";
  return out;
}

bool Lighthouse::quorum_changed(const Quorum& a, const Quorum& b) {
  // Membership (replica_id set) comparison only — step changes alone do not
  // constitute a new quorum (mirrors reference src/lighthouse.rs:81-86).
  std::set<std::string> sa, sb;
  for (const auto& m : a.participants()) sa.insert(m.replica_id());
  for (const auto& m : b.participants()) sb.insert(m.replica_id());
  return sa != sb;
}

bool Lighthouse::quorum_valid_locked() const {
  if (participants_.empty()) return false;
  int64_t now = now_ms();
  // Pending-alive: fresh evidence that a replica absent from this round is
  // alive and trying to join. Cutting a quorum that excludes it risks the
  // split-quorum fork (both sides commit divergent solo steps at the same
  // max_step, so neither ever heals) — defer instead, up to the grace cap.
  //  (1) any replica with a fresh joining-flagged beat (restarted groups
  //      announce before their Quorum RPC — see manager.cc);
  //  (2) a previous-quorum member with any fresh beat (alive, stalled).
  // A dead group's beats go stale within heartbeat_fresh_ms, so
  // shrink-on-death latency is unchanged.
  bool pending_alive = false;
  beats_.for_each([&](const std::string& id, const BeatTable::Beat& b) {
    if (pending_alive || participants_.count(id)) return;
    if (b.last_joining_ms >= 0 &&
        now - b.last_joining_ms < opt_.heartbeat_fresh_ms)
      pending_alive = true;
  });
  if (!pending_alive && has_prev_quorum_) {
    for (const auto& m : prev_quorum_.participants()) {
      if (participants_.count(m.replica_id())) continue;
      BeatTable::Beat b;
      if (beats_.lookup(m.replica_id(), &b) && b.last_ms >= 0 &&
          now - b.last_ms < opt_.heartbeat_fresh_ms) {
        pending_alive = true;
        break;
      }
    }
  }
  // Join-coalescing window (docs/design/churn.md): a JOINER in the
  // forming round holds the cut open for join_window_ms from the first
  // joiner's arrival, so a storm of replacements is admitted as ONE
  // membership delta (one quorum_id bump, one ring reconfigure) instead
  // of one per joiner. Placed BEFORE the fast-quorum cut — with all
  // previous members re-joined plus one joiner, all_present would
  // otherwise cut instantly on the first arrival. Only additive deltas
  // are held: a round with no joiner (shrink / unchanged) never enters
  // this branch, so farewell/eviction latency is untouched.
  if (opt_.join_window_ms > 0 && has_prev_quorum_ && first_joiner_ms_ > 0 &&
      now - first_joiner_ms_ < opt_.join_window_ms) {
    bool any_new = false;
    for (const auto& [pid, j] : participants_) {
      (void)j;
      if (!prev_ids_.count(pid)) {
        any_new = true;
        break;
      }
    }
    if (any_new) return false;
  }
  if (has_prev_quorum_ && !pending_alive) {
    // Fast quorum: every member of the previous quorum has re-joined AND
    // no alive joiner would be excluded — membership is settled, cut now
    // (reference src/lighthouse.rs:118-131, plus the exclusion guard).
    bool all_present = true;
    for (const auto& m : prev_quorum_.participants())
      if (!participants_.count(m.replica_id())) {
        all_present = false;
        break;
      }
    if (all_present) return true;
  }
  if (participants_.size() < opt_.min_replicas) return false;
  // Fast eviction: the round is shrinking, nobody alive is being excluded
  // (pending_alive is false), and every missing previous member is provably
  // gone — beats stale by >= eviction_staleness_factor * heartbeat_fresh_ms,
  // or farewell'd (record erased). Waiting join_timeout_ms for a crashed
  // process to show up only stalls the survivors; cut now. An alive member
  // keeps beating from its dedicated heartbeat thread even while wedged, so
  // it still gets the full straggler wait below.
  if (has_prev_quorum_ && !pending_alive &&
      opt_.eviction_staleness_factor > 0) {
    const int64_t stale_ms =
        opt_.eviction_staleness_factor * opt_.heartbeat_fresh_ms;
    bool any_missing = false;
    bool all_missing_gone = true;
    for (const auto& m : prev_quorum_.participants()) {
      if (participants_.count(m.replica_id())) continue;
      any_missing = true;
      BeatTable::Beat b;
      if (!beats_.lookup(m.replica_id(), &b)) {
        // Provably gone only via explicit farewell; a member that never
        // beat gets the join-timeout benefit of the doubt (it may be a
        // non-beating client whose re-join is racing this round).
        if (!beats_.departed(m.replica_id())) {
          all_missing_gone = false;
          break;
        }
        continue;
      }
      int64_t latest = std::max(b.last_ms, b.last_joining_ms);
      if (latest >= 0 && now - latest < stale_ms) {
        all_missing_gone = false;
        break;
      }
    }
    if (any_missing && all_missing_gone) return true;
  }
  // Membership is changing (or an alive joiner is en route): give
  // stragglers join_timeout_ms — or the grace cap when pending-alive —
  // measured from the first join of this round, before forming the
  // smaller/different quorum (reference src/lighthouse.rs:133-156).
  int64_t wait = pending_alive
                     ? opt_.join_timeout_ms * opt_.heartbeat_grace_factor
                     : opt_.join_timeout_ms;
  return now - first_join_ms_ >= wait;
}

bool Lighthouse::fast_eligible_locked(const std::string& id,
                                      int64_t step) const {
  if (!opt_.fast_path || !has_prev_quorum_ || shutdown_) return false;
  // Only previous-quorum members can ride the cache; a new replica_id is by
  // definition a membership change and must rendezvous on the slow path.
  if (!prev_ids_.count(id)) return false;
  // A previous member parked in a forming slow round means the round MUST
  // complete via the rendezvous for everyone: fast-serving the remaining
  // members would let them run a collective the parked member can never
  // join (it is blocked here) — a control/data-plane deadlock.
  for (const auto& [pid, j] : participants_) {
    (void)j;
    if (prev_ids_.count(pid)) return false;
  }
  // Additive invalidation (joiner pending): defer NEW step generations to
  // the slow path so the joiner is admitted, but let the CURRENT generation
  // (steps at or below the fast-path high-water mark) finish fast — a
  // generation split between fast-served and parked members deadlocks as
  // above. The joiner waits at most one step.
  if (step > fast_round_step_) {
    if (!participants_.empty()) return false;  // joiner already parked
    bool fresh_joiner = false;
    int64_t now = now_ms();
    beats_.for_each([&](const std::string& bid, const BeatTable::Beat& b) {
      if (fresh_joiner || prev_ids_.count(bid)) return;
      if (b.last_joining_ms >= 0 &&
          now - b.last_joining_ms < opt_.heartbeat_fresh_ms)
        fresh_joiner = true;
    });
    if (fresh_joiner) return false;
  }
  // Subtractive invalidation (stale beat / farewell / kill): every member
  // must be provably alive within the same staleness bound fast eviction
  // uses — "fast-path-eligible" and "would not be evicted" are deliberately
  // the same predicate, so the cache can never outlive a membership the
  // slow path would already have shrunk. (Factor 0 disables eviction but
  // must not disable the fast path; fall back to the default bound.)
  const int64_t factor = opt_.eviction_staleness_factor > 0
                             ? opt_.eviction_staleness_factor
                             : 3;
  const int64_t bound = factor * opt_.heartbeat_fresh_ms;
  int64_t now = now_ms();
  for (const auto& m : prev_quorum_.participants()) {
    if (beats_.departed(m.replica_id())) return false;
    int64_t latest = beats_.latest_ms(m.replica_id());
    if (latest < 0 || now - latest >= bound) return false;
  }
  return true;
}

bool Lighthouse::tick() {
  // Prune long-stale beat entries (each restart brings a fresh uuid-suffixed
  // replica_id, so the table otherwise grows without bound across a long
  // job). Previous-quorum members are kept so the dashboard can show their
  // staleness.
  {
    int64_t now = now_ms();
    int64_t keep_ms = std::max<int64_t>(10'000, 20 * opt_.heartbeat_fresh_ms);
    beats_.prune(now, keep_ms, prev_ids_);
    // Silent groups fall out of the fleet aggregates the same way
    // (latest() already filters by staleness; pruning bounds memory
    // across a long job's churn of uuid-suffixed replica ids).
    digests_.prune(now, opt_.digest_stale_ms);
  }
  if (!quorum_valid_locked()) return false;
  Quorum q;
  // Deterministic participant order: sorted by replica_id (std::map
  // iteration order), mirrors reference :175. Replica ranks derive from it.
  for (const auto& [id, joiner] : participants_)
    *q.add_participants() = joiner.member;
  // Join-coalescing accounting: joiners admitted by this cut beyond the
  // first of their round rode an already-open window — each is one
  // reconfigure the fleet did NOT pay (docs/design/churn.md).
  if (has_prev_quorum_) {
    int64_t new_members = 0;
    for (const auto& [id, joiner] : participants_) {
      (void)joiner;
      if (!prev_ids_.count(id)) new_members++;
    }
    if (new_members > 1) joins_coalesced_ += new_members - 1;
  }
  if (!has_prev_quorum_ || quorum_changed(prev_quorum_, q)) quorum_id_++;
  q.set_quorum_id(quorum_id_);
  q.set_created_unix_ms(
      std::chrono::duration_cast<std::chrono::milliseconds>(
          std::chrono::system_clock::now().time_since_epoch())
          .count());
  epoch_++;
  q.set_epoch(epoch_);
  prev_quorum_ = q;
  has_prev_quorum_ = true;
  prev_ids_.clear();
  fast_round_step_ = -1;
  for (const auto& m : q.participants()) {
    prev_ids_.insert(m.replica_id());
    fast_round_step_ = std::max(fast_round_step_, m.step());
  }
  slow_path_rounds_++;
  participants_.clear();
  first_join_ms_ = 0;
  first_joiner_ms_ = 0;
  broadcast_seq_++;
  // The cut as its members are answered: a fast registration may move the
  // cache on before a parked member wakes.
  cuts_[broadcast_seq_] = q;
  while (cuts_.size() > 16) cuts_.erase(cuts_.begin());
  fast_served_step_ = -1;
  cv_.notify_all();
  return true;
}

void Lighthouse::fill_response_locked(LighthouseQuorumResponse* out,
                                      bool fast) const {
  *out->mutable_quorum() = prev_quorum_;
  out->set_fast_path(fast);
  out->set_standby_address(standby_addr_);
  // Standalone beats only need to keep the liveness record fresher than the
  // fast-path staleness bound; half of heartbeat_fresh_ms leaves 3x slack
  // against the default eviction bound (3 * fresh).
  out->set_keepalive_ms(std::max<int64_t>(opt_.heartbeat_fresh_ms / 2, 1));
}

void Lighthouse::record_beat(const LighthouseHeartbeatRequest& r) {
  if (r.replica_id().empty()) return;
  if (r.leaving()) {
    beats_.farewell(r.replica_id(), now_ms());
    // A clean goodbye withdraws the group from the fleet aggregates
    // immediately — no departed group may linger as a phantom
    // straggler (docs/design/fleet_health.md). A farewell also clears
    // any divergence verdict (fleet.FleetAggregator.remove): the
    // replacement rejoins behind max_step and heals from the attested
    // majority before it can attest anything. Prune deliberately does
    // NOT clear — dead-without-farewell stays quarantined.
    digests_.erase(r.replica_id());
    {
      std::lock_guard<std::mutex> flk(fleet_mu_);
      sdc_quarantined_.erase(r.replica_id());
      // Farewell clears the rebalance fraction immediately: the
      // group's slice is gone, and the next aggregate re-derives the
      // survivors' boosts without it (fleet.FleetAggregator.remove).
      rebalancer_.forget(r.replica_id());
    }
  } else {
    beats_.record(r.replica_id(), now_ms(), r.joining(), r.heal_count(),
                  r.committed_steps(), r.aborted_steps());
    if (r.has_digest()) digests_.record(r.replica_id(), r.digest(),
                                        now_ms());
  }
}

// --------------------------------------------------- fleet health plane

std::shared_ptr<const FleetAggregate> Lighthouse::fleet_aggregate(
    int64_t now) {
  std::lock_guard<std::mutex> lk(fleet_mu_);
  if (fleet_cache_ && fleet_cache_ms_ >= 0 &&
      now - fleet_cache_ms_ < kFleetCacheMs)
    return fleet_cache_;

  auto agg = std::make_shared<FleetAggregate>();
  agg->computed_ms = now;
  auto latest = digests_.latest(now, opt_.digest_stale_ms);
  agg->groups_n = (int64_t)latest.size();
  // Garbage-collect SLO dedup entries for groups that left the
  // aggregate (farewell/staleness): under long uuid-suffixed spot
  // churn the map would otherwise fill to its backstop and evict the
  // map-ordered FIRST key — possibly a LIVE group's, whose unchanged
  // breach would then re-count as new. Keys are "slo|group".
  for (auto it = slo_seen_.begin(); it != slo_seen_.end();) {
    size_t bar = it->first.find('|');
    std::string gid =
        bar == std::string::npos ? "" : it->first.substr(bar + 1);
    if (latest.count(gid) == 0)
      it = slo_seen_.erase(it);
    else
      ++it;
  }

  // State attestation vote (fleet.FleetAggregator._attest_vote — the
  // mirror contract, change together): majority vote per
  // (quorum_id, step) over fresh, non-healing digests carrying a
  // fingerprint. A ballot needs a STRICT majority to produce a
  // verdict (ties/50-50 fail open); minority groups latch into the
  // sticky quarantine map; a quarantined group clears on a fresh
  // digest matching a later winner even though it is not itself a
  // voter (its own latch reports it healing — demanding a vote from
  // it would deadlock the clear).
  {
    std::map<std::pair<int64_t, int64_t>,
             std::map<std::string, std::vector<std::string>>>
        ballots;
    for (const auto& [id, e] : latest) {
      if (!e.fresh || e.d.healing() || e.d.state_digest().empty() ||
          e.d.quorum_id() < 0)
        continue;
      ballots[{e.d.quorum_id(), e.d.step()}][e.d.state_digest()]
          .push_back(id);
    }
    for (const auto& [key, by_digest] : ballots) {
      size_t voters = 0;
      for (const auto& [dg, rids] : by_digest) voters += rids.size();
      // max over (count, digest) — the digest tie-break is inert (a
      // tied winner fails the strict-majority check) but keeps
      // iteration-order independence with the Python mirror.
      const std::string* winner = nullptr;
      size_t winner_n = 0;
      for (const auto& [dg, rids] : by_digest) {
        if (rids.size() > winner_n ||
            (winner && rids.size() == winner_n && dg > *winner)) {
          winner = &dg;
          winner_n = rids.size();
        }
      }
      if (!winner || 2 * winner_n <= voters) continue;  // fail open
      for (const auto& [id, e] : latest) {
        auto it = sdc_quarantined_.find(id);
        if (it == sdc_quarantined_.end()) continue;
        if (e.fresh && e.d.state_digest() == *winner &&
            e.d.quorum_id() == key.first && e.d.step() == key.second) {
          sdc_quarantined_.erase(it);
          sdc_clears_total_++;
        }
      }
      for (const auto& [dg, rids] : by_digest) {
        for (const auto& id : rids) {
          if (dg == *winner) {
            if (sdc_quarantined_.erase(id)) sdc_clears_total_++;
          } else if (!sdc_quarantined_.count(id)) {
            SdcVerdict v;
            v.quorum_id = key.first;
            v.step = key.second;
            v.digest = dg;
            v.majority_digest = *winner;
            v.trace_addr = latest.at(id).d.trace_addr();
            v.verdict_ms = now;
            sdc_quarantined_[id] = std::move(v);
            sdc_verdicts_total_++;
            fprintf(stderr,
                    "torchft_tpu lighthouse: SDC DIVERGENCE on %s "
                    "(quorum %lld step %lld: %s vs majority %s)\n",
                    id.c_str(), (long long)key.first,
                    (long long)key.second, dg.c_str(),
                    winner->c_str());
            fflush(stderr);
          }
        }
      }
    }
    for (const auto& [id, v] : sdc_quarantined_) {
      agg->sdc_quarantined.push_back(id);
      if (!v.trace_addr.empty())
        agg->sdc_quarantined_addrs.push_back(v.trace_addr);
    }
    std::sort(agg->sdc_quarantined_addrs.begin(),
              agg->sdc_quarantined_addrs.end());
    agg->sdc_quarantined_addrs.erase(
        std::unique(agg->sdc_quarantined_addrs.begin(),
                    agg->sdc_quarantined_addrs.end()),
        agg->sdc_quarantined_addrs.end());
    agg->sdc_verdicts_total = sdc_verdicts_total_;
    agg->sdc_clears_total = sdc_clears_total_;
  }

  // Rebalance ladder (fleet.FleetAggregator.aggregate — the mirror
  // contract): one observation per group per NEW step, from the same
  // latest view. Eligibility == the straggler-baseline flag; a
  // zero-valued reported fraction is a pre-rebalance manager and
  // reads as 1.0.
  std::map<std::string, double> rebalance_fractions;
  {
    std::vector<Rebalancer::Row> rows;
    rows.reserve(latest.size());
    for (const auto& [id, e] : latest) {
      Rebalancer::Row row;
      row.replica_id = id;
      row.step = e.d.step();
      row.step_wall_ms = e.d.step_wall_ms();
      row.reported_fraction =
          e.d.rebalance_fraction() > 0.0 ? e.d.rebalance_fraction() : 1.0;
      row.eligible = baseline_eligible(e.d) && e.fresh;
      rows.push_back(std::move(row));
    }
    rebalance_fractions = rebalancer_.observe(std::move(rows));
    agg->rebalance_table = rebalancer_.table();
    agg->rebalance_seq = rebalancer_.seq();
    agg->rebalance_shrinks_total = rebalancer_.shrinks_total;
    agg->rebalance_restores_total = rebalancer_.restores_total;
  }

  // Baseline median/MAD (fleet.robust_zscores) + per-stage medians.
  // Stale rows stay visible in the group list but never shape the
  // baseline (the dead-without-farewell fix).
  std::vector<double> walls;
  std::vector<double> stage_vals[4];
  for (const auto& [id, e] : latest) {
    if (!baseline_eligible(e.d) || !e.fresh) continue;
    walls.push_back(e.d.step_wall_ms());
    for (int i = 0; i < 4; i++)
      stage_vals[i].push_back(stage_value(e.d, i));
  }
  agg->baseline_n = (int64_t)walls.size();
  agg->p50 = round3(percentile_of(walls, 0.50));
  agg->p95 = round3(percentile_of(walls, 0.95));
  agg->max = walls.empty()
                 ? 0.0
                 : round3(*std::max_element(walls.begin(), walls.end()));
  for (int i = 0; i < 4; i++)
    agg->stage_median[i] = round3(median_of(stage_vals[i]));
  double med = median_of(walls);
  std::vector<double> dev;
  dev.reserve(walls.size());
  for (double w : walls) dev.push_back(std::fabs(w - med));
  double denom = kMadSigma * median_of(dev);

  for (const auto& [id, e] : latest) {
    FleetAggregate::Group g;
    g.replica_id = id;
    g.d = e.d;
    g.age_ms = now - e.recorded_ms;
    g.baseline = baseline_eligible(e.d) && e.fresh;
    g.attested = !e.d.state_digest().empty() && e.fresh &&
                 !e.d.healing();
    g.sdc_diverged = sdc_quarantined_.count(id) > 0;
    {
      auto rit = rebalance_fractions.find(id);
      g.rebalance_fraction =
          rit == rebalance_fractions.end() ? 1.0 : round4(rit->second);
    }
    if (g.baseline) {
      // Zero dispersion (uniform fleet / single group) -> all scores
      // 0.0, never NaN (fleet.robust_zscores).
      g.score = denom > 1e-9
                    ? std::floor((e.d.step_wall_ms() - med) / denom *
                                     1e4 + 0.5) / 1e4
                    : 0.0;
      g.stage = attribute_stage(e.d, agg->stage_median);
    } else {
      g.score = 0.0;
      g.stage = !e.fresh ? "stale"
                         : (e.d.healing() ? "heal" : "degraded");
    }
    agg->groups.push_back(std::move(g));
  }
  std::sort(agg->groups.begin(), agg->groups.end(),
            [](const FleetAggregate::Group& a,
               const FleetAggregate::Group& b) {
              if (a.score != b.score) return a.score > b.score;
              return a.replica_id < b.replica_id;
            });
  for (const auto& g : agg->groups) {
    if (!g.baseline) continue;
    // Ranked worst-first; the first baseline group is the straggler.
    agg->straggler_id = g.replica_id;
    agg->straggler_score = g.score;
    agg->straggler_stage = g.stage;
    break;
  }

  // SLO evaluation (fleet.SLOEngine.evaluate): attach current breaches
  // per group, dedup NEW ones per (slo, group, step) into the bounded
  // event log, and refresh the gauges. Commit-rate reads the beat
  // counters that ride the same RPC.
  if (slo_.enabled()) {
    int64_t active = 0;
    auto breach = [&](FleetAggregate::Group& g, const char* slo,
                      double value, double threshold) {
      g.slo_breaches.push_back(slo);
      active++;
      std::string key = std::string(slo) + "|" + g.replica_id;
      auto it = slo_seen_.find(key);
      if (it != slo_seen_.end() && it->second == g.d.step()) return;
      slo_seen_[key] = g.d.step();
      if (slo_seen_.size() > 4096)  // bounded dedup memory
        slo_seen_.erase(slo_seen_.begin());
      slo_breaches_total_++;
      std::string ev = "{\"slo\":\"" + std::string(slo) +
                       "\",\"replica_id\":\"" +
                       json_escape(g.replica_id) +
                       "\",\"step\":" + std::to_string(g.d.step()) +
                       ",\"value\":" + fmt_double(value) +
                       ",\"threshold\":" + fmt_double(threshold) + "}";
      slo_events_.push_back(ev);
      while (slo_events_.size() > 64) slo_events_.pop_front();
      fprintf(stderr,
              "torchft_tpu lighthouse: SLO BREACH %s on %s "
              "(value %.3f, threshold %.3f, step %lld)\n",
              slo, g.replica_id.c_str(), value, threshold,
              (long long)g.d.step());
      fflush(stderr);
    };
    for (auto& g : agg->groups) {
      if (slo_.step_p95_ms >= 0 && agg->p95 > slo_.step_p95_ms &&
          g.replica_id == agg->straggler_id)
        breach(g, "step_p95", agg->p95, slo_.step_p95_ms);
      if (slo_.heal_ms >= 0 && g.d.heal_last_ms() > slo_.heal_ms)
        breach(g, "heal", g.d.heal_last_ms(), slo_.heal_ms);
      if (slo_.publish_lag_ms >= 0 &&
          g.d.publish_last_ms() > slo_.publish_lag_ms)
        breach(g, "publish_lag", g.d.publish_last_ms(),
               slo_.publish_lag_ms);
      if (slo_.staleness_ms >= 0 &&
          (double)g.age_ms > slo_.staleness_ms)
        breach(g, "staleness", (double)g.age_ms, slo_.staleness_ms);
      if (slo_.commit_rate >= 0) {
        BeatTable::Beat b;
        if (beats_.lookup(g.replica_id, &b)) {
          int64_t total = b.committed_steps + b.aborted_steps;
          if (total >= slo_.min_commit_samples) {
            double rate = (double)b.committed_steps / (double)total;
            if (rate < slo_.commit_rate)
              breach(g, "commit_rate", rate, slo_.commit_rate);
          }
        }
      }
    }
    slo_active_ = active;
  }

  fleet_cache_ = agg;
  fleet_cache_ms_ = now;
  return agg;
}

void Lighthouse::fill_fleet_hint(const std::string& id, FleetHint* out) {
  auto agg = fleet_aggregate(now_ms());
  if (agg->groups_n == 0) return;  // digest-less fleet: zero hint
  out->set_fleet_p50_ms(agg->p50);
  out->set_fleet_p95_ms(agg->p95);
  out->set_fleet_max_ms(agg->max);
  out->set_digest_groups(agg->groups_n);
  out->set_straggler_id(agg->straggler_id);
  for (const auto& g : agg->groups) {
    if (g.replica_id != id) continue;
    out->set_straggler_score(g.score);
    out->set_straggler_stage(g.stage);
    std::string joined;
    for (const auto& s : g.slo_breaches) {
      if (!joined.empty()) joined += ",";
      joined += s;
    }
    out->set_slo_breach(joined);
    break;
  }
  // Divergence verdict echo (docs/design/state_attestation.md): the
  // requester learns its own verdict plus the full quarantine set so
  // every group's donor filters exclude the same peers.
  bool diverged = false;
  std::string q_rids, q_addrs;
  for (const auto& r : agg->sdc_quarantined) {
    if (r == id) diverged = true;
    if (!q_rids.empty()) q_rids += ",";
    q_rids += r;
  }
  for (const auto& a : agg->sdc_quarantined_addrs) {
    if (!q_addrs.empty()) q_addrs += ",";
    q_addrs += a;
  }
  out->set_sdc_diverged(diverged);
  out->set_sdc_quarantined(q_rids);
  out->set_sdc_quarantined_addrs(q_addrs);
  // Rebalance echo (docs/design/fleet_rebalance.md): the requester's
  // own assigned fraction plus the full fleet table the decider
  // publishes verbatim; seq bumps on every table change (the flap
  // counter).
  double reb = 1.0;
  for (const auto& g : agg->groups) {
    if (g.replica_id == id) {
      reb = g.rebalance_fraction;
      break;
    }
  }
  out->set_rebalance_fraction(reb);
  out->set_rebalance_table(agg->rebalance_table);
  out->set_rebalance_seq(agg->rebalance_seq);
}

std::string Lighthouse::fleet_status_json(const FleetAggregate& agg) {
  std::string out = "{\"format\":\"tft-fleet-1\",\"computed_ms\":" +
                    std::to_string(agg.computed_ms) +
                    ",\"fleet\":{\"groups\":" +
                    std::to_string(agg.groups_n) +
                    ",\"baseline_groups\":" +
                    std::to_string(agg.baseline_n) +
                    ",\"p50_ms\":" + fmt_double(agg.p50) +
                    ",\"p95_ms\":" + fmt_double(agg.p95) +
                    ",\"max_ms\":" + fmt_double(agg.max) +
                    ",\"stage_median_ms\":{";
  for (int i = 0; i < 4; i++) {
    if (i) out += ",";
    out += "\"" + std::string(kDigestStages[i]) +
           "\":" + fmt_double(agg.stage_median[i]);
  }
  int64_t slo_active, slo_total;
  std::string events;
  {
    std::lock_guard<std::mutex> lk(fleet_mu_);
    slo_active = slo_active_;
    slo_total = slo_breaches_total_;
    bool first = true;
    for (const auto& ev : slo_events_) {
      if (!first) events += ",";
      first = false;
      events += ev;
    }
  }
  out += "},\"sdc_quarantined\":[";
  for (size_t i = 0; i < agg.sdc_quarantined.size(); i++) {
    if (i) out += ",";
    out += "\"" + json_escape(agg.sdc_quarantined[i]) + "\"";
  }
  out += "],\"sdc_quarantined_addrs\":[";
  for (size_t i = 0; i < agg.sdc_quarantined_addrs.size(); i++) {
    if (i) out += ",";
    out += "\"" + json_escape(agg.sdc_quarantined_addrs[i]) + "\"";
  }
  out += "],\"sdc_verdicts_total\":" +
         std::to_string(agg.sdc_verdicts_total) +
         ",\"sdc_clears_total\":" +
         std::to_string(agg.sdc_clears_total);
  // Rebalance section (fleet.FleetAggregator.aggregate's fleet keys):
  // only entries != 1.0 appear in the fractions map, like the table.
  out += ",\"rebalance_fractions\":{";
  {
    bool first = true;
    for (const auto& g : agg.groups) {
      if (std::fabs(g.rebalance_fraction - 1.0) <= 1e-9) continue;
      if (!first) out += ",";
      first = false;
      out += "\"" + json_escape(g.replica_id) +
             "\":" + fmt_double(g.rebalance_fraction);
    }
  }
  out += "},\"rebalance_table\":\"" + json_escape(agg.rebalance_table) +
         "\",\"rebalance_seq\":" + std::to_string(agg.rebalance_seq) +
         ",\"rebalance_shrinks_total\":" +
         std::to_string(agg.rebalance_shrinks_total) +
         ",\"rebalance_restores_total\":" +
         std::to_string(agg.rebalance_restores_total);
  out += "},\"straggler\":{\"replica_id\":\"" +
         json_escape(agg.straggler_id) +
         "\",\"score\":" + fmt_double(agg.straggler_score) +
         ",\"stage\":\"" + json_escape(agg.straggler_stage) +
         "\"},\"slo\":{\"active\":" + std::to_string(slo_active) +
         ",\"breaches_total\":" + std::to_string(slo_total) +
         ",\"events\":[" + events;
  out += "]},\"groups\":[";
  for (size_t i = 0; i < agg.groups.size(); i++) {
    const auto& g = agg.groups[i];
    if (i) out += ",";
    out += "{\"replica_id\":\"" + json_escape(g.replica_id) +
           "\",\"step\":" + std::to_string(g.d.step()) +
           ",\"age_ms\":" + std::to_string(g.age_ms) +
           ",\"step_wall_ms\":" + fmt_double(round3(g.d.step_wall_ms())) +
           ",\"stage_ms\":{";
    for (int s = 0; s < 4; s++) {
      if (s) out += ",";
      out += "\"" + std::string(kDigestStages[s]) +
             "\":" + fmt_double(round3(stage_value(g.d, s)));
    }
    out += "},\"straggler_score\":" + fmt_double(g.score) +
           ",\"straggler_stage\":\"" + json_escape(g.stage) +
           "\",\"healing\":" + (g.d.healing() ? "true" : "false") +
           ",\"capacity_fraction\":" +
           fmt_double(g.d.capacity_fraction()) +
           ",\"policy_rung\":" + std::to_string(g.d.policy_rung()) +
           ",\"churn_per_min\":" + fmt_double(g.d.churn_per_min()) +
           ",\"heal_bytes_inflight\":" +
           fmt_double(g.d.heal_bytes_inflight()) +
           ",\"publish_bytes_inflight\":" +
           fmt_double(g.d.publish_bytes_inflight()) +
           ",\"heal_last_ms\":" + fmt_double(g.d.heal_last_ms()) +
           ",\"publish_last_ms\":" + fmt_double(g.d.publish_last_ms()) +
           ",\"baseline\":" + (g.baseline ? "true" : "false") +
           ",\"slo_breach\":[";
    for (size_t b = 0; b < g.slo_breaches.size(); b++) {
      if (b) out += ",";
      out += "\"" + json_escape(g.slo_breaches[b]) + "\"";
    }
    out += "],\"trace_addr\":\"" + json_escape(g.d.trace_addr()) +
           "\",\"attested\":" + (g.attested ? "true" : "false") +
           ",\"sdc_diverged\":" + (g.sdc_diverged ? "true" : "false") +
           ",\"rebalance_fraction\":" +
           fmt_double(g.rebalance_fraction) + "}";
  }
  out += "]}";
  return out;
}

std::string Lighthouse::fleet_metrics_text(const FleetAggregate& agg) {
  // Same names torchft_tpu.fleet.status_prometheus renders — the two
  // expositions must not drift (frozen by tests/test_fleet.py).
  int64_t slo_active_snapshot, slo_total_snapshot;
  {
    std::lock_guard<std::mutex> lk(fleet_mu_);
    slo_active_snapshot = slo_active_;
    slo_total_snapshot = slo_breaches_total_;
  }
  int64_t reb_groups = 0;
  for (const auto& g : agg.groups)
    if (std::fabs(g.rebalance_fraction - 1.0) > 1e-9) reb_groups++;
  std::ostringstream os;
  os << "# HELP torchft_fleet_groups groups contributing digests\n"
     << "# TYPE torchft_fleet_groups gauge\n"
     << "torchft_fleet_groups " << fmt_double((double)agg.groups_n)
     << "\n"
     << "# HELP torchft_fleet_step_ms fleet step-wall quantiles (ms)\n"
     << "# TYPE torchft_fleet_step_ms summary\n"
     << "torchft_fleet_step_ms{quantile=\"0.5\"} " << fmt_double(agg.p50)
     << "\n"
     << "torchft_fleet_step_ms{quantile=\"0.95\"} "
     << fmt_double(agg.p95) << "\n"
     << "# HELP torchft_fleet_step_ms_max slowest group step wall (ms)\n"
     << "# TYPE torchft_fleet_step_ms_max gauge\n"
     << "torchft_fleet_step_ms_max " << fmt_double(agg.max) << "\n"
     << "# HELP torchft_fleet_slo_breach (slo, group) pairs out of SLO\n"
     << "# TYPE torchft_fleet_slo_breach gauge\n"
     << "torchft_fleet_slo_breach "
     << fmt_double((double)slo_active_snapshot) << "\n"
     << "# HELP torchft_fleet_slo_breaches_total breaches detected\n"
     << "# TYPE torchft_fleet_slo_breaches_total counter\n"
     << "torchft_fleet_slo_breaches_total "
     << fmt_double((double)slo_total_snapshot) << "\n"
     << "# HELP torchft_fleet_sdc_quarantined groups under a "
        "divergence verdict\n"
     << "# TYPE torchft_fleet_sdc_quarantined gauge\n"
     << "torchft_fleet_sdc_quarantined "
     << fmt_double((double)agg.sdc_quarantined.size()) << "\n"
     << "# HELP torchft_fleet_sdc_verdicts_total divergence verdicts "
        "issued\n"
     << "# TYPE torchft_fleet_sdc_verdicts_total counter\n"
     << "torchft_fleet_sdc_verdicts_total "
     << fmt_double((double)agg.sdc_verdicts_total) << "\n"
     << "# HELP torchft_fleet_rebalance_groups groups with a "
        "rebalance fraction != 1\n"
     << "# TYPE torchft_fleet_rebalance_groups gauge\n"
     << "torchft_fleet_rebalance_groups "
     << fmt_double((double)reb_groups) << "\n"
     << "# HELP torchft_fleet_rebalance_seq fraction-table change "
        "counter\n"
     << "# TYPE torchft_fleet_rebalance_seq counter\n"
     << "torchft_fleet_rebalance_seq "
     << fmt_double((double)agg.rebalance_seq) << "\n"
     << "# HELP torchft_fleet_stage_median_ms fleet per-stage medians\n"
     << "# TYPE torchft_fleet_stage_median_ms gauge\n";
  for (int i = 0; i < 4; i++)
    os << "torchft_fleet_stage_median_ms{stage=\"" << kDigestStages[i]
       << "\"} " << fmt_double(agg.stage_median[i]) << "\n";
  os << "# HELP torchft_fleet_straggler_score robust z of step wall vs "
        "the fleet\n"
     << "# TYPE torchft_fleet_straggler_score gauge\n"
     << "# HELP torchft_fleet_group_step_ms group step wall (ms)\n"
     << "# TYPE torchft_fleet_group_step_ms gauge\n"
     << "# HELP torchft_fleet_rebalance_fraction assigned rebalance "
        "batch fraction\n"
     << "# TYPE torchft_fleet_rebalance_fraction gauge\n";
  for (const auto& g : agg.groups) {
    std::string rid = json_escape(g.replica_id);
    os << "torchft_fleet_straggler_score{replica_id=\"" << rid
       << "\"} " << fmt_double(g.score) << "\n"
       << "torchft_fleet_group_step_ms{replica_id=\"" << rid << "\"} "
       << fmt_double(round3(g.d.step_wall_ms())) << "\n"
       << "torchft_fleet_rebalance_fraction{replica_id=\"" << rid
       << "\"} " << fmt_double(g.rebalance_fraction) << "\n";
  }
  // Publication relay tier (docs/design/serving.md): the lighthouse
  // aggregates no relay beats itself (the publisher owns the table),
  // so the scalar families render zero and the per-relay families
  // render names only — but the EXPOSITION NAME SET stays identical to
  // the Python renderer's (tests/test_fleet.py freezes both against
  // FLEET_METRIC_NAMES; scrape configs read either endpoint).
  os << "# HELP torchft_fleet_relays live publication relays\n"
     << "# TYPE torchft_fleet_relays gauge\n"
     << "torchft_fleet_relays 0.0\n"
     << "# HELP torchft_fleet_relay_children downstream consumers "
        "across the relay tier\n"
     << "# TYPE torchft_fleet_relay_children gauge\n"
     << "torchft_fleet_relay_children 0.0\n"
     << "# HELP torchft_fleet_relay_lag_gens_max worst relay staleness "
        "(generations behind the head)\n"
     << "# TYPE torchft_fleet_relay_lag_gens_max gauge\n"
     << "torchft_fleet_relay_lag_gens_max 0.0\n"
     << "# HELP torchft_fleet_relay_child_count per-relay downstream "
        "consumers\n"
     << "# TYPE torchft_fleet_relay_child_count gauge\n"
     << "# HELP torchft_fleet_relay_lag_gens per-relay staleness "
        "(generations behind the head)\n"
     << "# TYPE torchft_fleet_relay_lag_gens gauge\n";
  return os.str();
}

// Fan-in of a fast-path round at `step`, read from the cached quorum,
// whose entries carry the step each member last asked at: 1 when every
// member has asked at `step`, 0 while one has not asked yet, -1 when one
// has asked past it (the asker lags and must heal through the rendezvous).
static int fast_fan_in(const Quorum& q, int64_t step) {
  int state = 1;
  for (const auto& m : q.participants()) {
    if (m.step() > step) return -1;
    if (m.step() < step) state = 0;
  }
  return state;
}

bool Lighthouse::handle_quorum(const LighthouseQuorumRequest& r,
                               LighthouseQuorumResponse* out,
                               std::string* err) {
  if (!promoted_.load()) {
    // Split-brain fence: an unpromoted standby must never arbitrate
    // membership while the primary may still be serving. Managers treat
    // this as transient and retry (rotating back to the primary). The
    // attempt itself is recorded as promotion CORROBORATION: a manager
    // only dials us after ITS path to the primary failed — an observer
    // independent of our own replication polls (see replicate_loop).
    last_fenced_quorum_ms_.store(now_ms());
    *err = "standby: not serving (primary " + opt_.standby_of +
           " not known dead); retry";
    return false;
  }
  const QuorumMember& me = r.requester();
  // Coalesced heartbeat: managers piggyback their beat on the quorum RPC
  // (joining flag + the operational counters the standalone beat sends),
  // so in steady state the quorum round IS the liveness signal. Recorded
  // BEFORE taking the quorum lock: beats only touch the sharded table.
  // Deliberately no synthesis for beat-less requests: a client that never
  // beats keeps the reference's exact grace/eviction timing (no liveness
  // record -> plain join_timeout), and without beats it simply never
  // qualifies for the fast path.
  if (r.has_beat() && !r.beat().replica_id().empty()) record_beat(r.beat());

  std::unique_lock<std::mutex> lk(mu_);
  // Farewell-vs-serve race guard: beats (and farewells) land in the
  // lock-striped BeatTable WITHOUT the quorum mutex, so a farewell can
  // arrive between the eligibility check below and the serve. Snapshot
  // the departure counter first and re-read it before answering — a
  // cached decision naming a member that just said goodbye must never be
  // served (the requester would run its next collective against a peer
  // that is exiting: the exact vote abort the graceful-drain protocol
  // exists to prevent). A farewell landing after the re-read is
  // indistinguishable from one landing after the response hit the wire.
  //
  // Fan-in: a cached answer is served only once every member of the cached
  // quorum has asked at this step. An entry carries the step its member
  // last asked at, and the managers count as max_world_size only the
  // members at max_step (manager.cc compute_response): answering the first
  // asker of a step at once would show it alone at the top, and it would
  // divide the ring sum by 1 while its peers divide by n. So the asker
  // registers its step in the cache, then waits (the lock released) until
  // every other member has registered the same step. The slow path takes
  // an ask at or below the step its member last asked at (the retry of an
  // aborted step, which the cache cannot tell from a peer that moved on),
  // an asker behind a peer, a fan-in that outlasts join_timeout_ms, and a
  // membership that stops being eligible while the asker waits. Nobody is
  // served before every member has registered, so a step generation is
  // never split between fast-served and parked members. Once one member of
  // a generation is served, every other member registered in it is served
  // the same decision, whatever it finds when it wakes: its beat may have
  // gone stale meanwhile, or a served peer may already have registered its
  // next step, which leaves the cache showing that peer alone at the top.
  bool registered = false;
  int64_t deadline = 0;
  const auto serve_fast = [&]() {
    epoch_++;
    fast_path_hits_++;
    fill_response_locked(out, /*fast=*/true);
    *out->mutable_quorum() = fast_served_quorum_;
    out->mutable_quorum()->set_epoch(epoch_);
    // Fleet health hint (docs/design/fleet_health.md): cached-aggregate
    // read under fleet_mu_ + leaf digest locks only — the fast path's
    // latency budget never pays for aggregation (bounded by the
    // kFleetCacheMs recompute cap).
    fill_fleet_hint(me.replica_id(), out->mutable_fleet());
  };
  for (;;) {
    if (registered && fast_served_step_ == me.step()) {
      serve_fast();
      return true;
    }
    const int64_t dseq = beats_.departed_seq();
    if (!fast_eligible_locked(me.replica_id(), me.step())) break;
    if (!registered) {
      QuorumMember* mine = nullptr;
      for (auto& m : *prev_quorum_.mutable_participants())
        if (m.replica_id() == me.replica_id()) mine = &m;
      if (mine == nullptr || me.step() <= mine->step()) break;
      mine->set_step(me.step());
      mine->set_address(me.address());
      mine->set_store_address(me.store_address());
      mine->set_world_size(me.world_size());
      fast_round_step_ = std::max(fast_round_step_, me.step());
      registered = true;
      deadline = now_ms() + opt_.join_timeout_ms;
      cv_.notify_all();
    }
    const int fan = fast_fan_in(prev_quorum_, me.step());
    if (fan < 0 || beats_.departed_seq() != dseq) break;
    if (fan > 0) {
      // FAST PATH: membership is settled, everyone is provably alive and
      // has asked at this step — serve the cached decision with a bumped
      // epoch. No tick-loop park, and the quorum_id is untouched
      // (membership unchanged by construction).
      fast_served_step_ = me.step();
      fast_served_quorum_ = prev_quorum_;
      serve_fast();
      prev_quorum_.set_epoch(epoch_);
      return true;
    }
    if (shutdown_ || now_ms() >= deadline) break;
    cv_.wait_for(lk, std::chrono::milliseconds(opt_.quorum_tick_ms));
  }

  // SLOW PATH: the reference rendezvous — park until the round cuts.
  if (participants_.empty()) first_join_ms_ = now_ms();
  // First JOINER (not a previous member) opens the coalescing window.
  if (has_prev_quorum_ && first_joiner_ms_ == 0 &&
      !prev_ids_.count(me.replica_id()))
    first_joiner_ms_ = now_ms();
  participants_[me.replica_id()] = {me, now_ms()};
  // A join is proof of life: clear any stale farewell from a previous
  // incarnation of this id, or fast eviction would treat the live,
  // re-joined (possibly never-beating) member as provably gone.
  beats_.revive(me.replica_id());
  int64_t entry_seq = broadcast_seq_;
  tick();  // proactive: don't wait for the tick thread if already valid
  while (broadcast_seq_ == entry_seq && !shutdown_) {
    cv_.wait_for(lk, std::chrono::milliseconds(opt_.quorum_tick_ms));
    if (broadcast_seq_ == entry_seq && !shutdown_) tick();
  }
  if (shutdown_) {
    *err = "lighthouse shutting down";
    return false;
  }
  slow_path_served_++;
  fill_response_locked(out, /*fast=*/false);
  // This member was parked at entry_seq, so the next cut holds it.
  auto cut = cuts_.find(entry_seq + 1);
  if (cut != cuts_.end()) *out->mutable_quorum() = cut->second;
  fill_fleet_hint(me.replica_id(), out->mutable_fleet());
  return true;
}

bool Lighthouse::handle(uint8_t method, const std::string& req,
                        std::string* resp, std::string* err) {
  switch (method) {
    case kLighthouseQuorum: {
      LighthouseQuorumRequest r;
      if (!r.ParseFromString(req)) {
        *err = "bad LighthouseQuorumRequest";
        return false;
      }
      LighthouseQuorumResponse out;
      if (!handle_quorum(r, &out, err)) return false;
      *resp = out.SerializeAsString();
      return true;
    }
    case kLighthouseHeartbeat: {
      LighthouseHeartbeatRequest r;
      if (!r.ParseFromString(req)) {
        *err = "bad LighthouseHeartbeatRequest";
        return false;
      }
      // Lock-striped: beats never touch the quorum mutex, so 64+ clients
      // beating at keepalive cadence cannot convoy the control plane.
      record_beat(r);
      // A joining beat can lift a fast-quorum deferral the moment the
      // announcer lands in participants_ via its Quorum RPC; no tick needed
      // here — beats alone never form quorums.
      *resp = LighthouseHeartbeatResponse().SerializeAsString();
      return true;
    }
    case kLighthouseReplicate: {
      ReplicateRequest r;
      if (!r.ParseFromString(req)) {
        *err = "bad ReplicateRequest";
        return false;
      }
      if (!promoted_.load()) {
        *err = "replicate: target is itself an unpromoted standby";
        return false;
      }
      ReplicateResponse out;
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (!r.standby_address().empty())
          standby_addr_ = r.standby_address();
        if (has_prev_quorum_) *out.mutable_quorum() = prev_quorum_;
        out.set_quorum_id(quorum_id_);
        out.set_epoch(epoch_);
        out.set_boot_id(boot_id_);
      }
      int64_t now = now_ms();
      beats_.for_each([&](const std::string& id, const BeatTable::Beat& b) {
        BeatAge* a = out.add_beats();
        a->set_replica_id(id);
        a->set_age_ms(b.last_ms >= 0 ? now - b.last_ms : -1);
        a->set_joining_age_ms(
            b.last_joining_ms >= 0 ? now - b.last_joining_ms : -1);
      });
      beats_.for_each_departed([&](const std::string& id, int64_t ms) {
        BeatAge* a = out.add_departed();
        a->set_replica_id(id);
        a->set_age_ms(now - ms);
      });
      *resp = out.SerializeAsString();
      return true;
    }
    case kLighthouseStatus: {
      StatusResponse out;
      {
        std::lock_guard<std::mutex> lk(mu_);
        status_locked(&out);
      }
      *resp = out.SerializeAsString();
      return true;
    }
    default:
      *err = "lighthouse: unknown method";
      return false;
  }
}

void Lighthouse::adopt_replica_state(const ReplicateResponse& r) {
  int64_t now = now_ms();
  {
    std::lock_guard<std::mutex> lk(mu_);
    // Epoch is an in-memory counter that restarts when the primary
    // restarts: a changed incarnation resets the monotonicity baseline,
    // or adoption would freeze forever on `epoch < adopted` while the new
    // primary's membership evolves. Local epoch_ never regresses (the
    // max below) so the standby's own eventual serves stay ordered.
    bool new_incarnation = r.boot_id() != primary_boot_id_;
    if (new_incarnation) primary_boot_id_ = r.boot_id();
    if (r.has_quorum() && (new_incarnation || r.epoch() >= epoch_)) {
      prev_quorum_ = r.quorum();
      has_prev_quorum_ = true;
      // EXACT id adoption, not max with the boot seed: the standby
      // continues the primary's live sequence, so its first post-failover
      // quorum with unchanged membership reuses the id managers already
      // hold — no spurious reconfigure/ring rebuild (see lighthouse.h
      // quorum_id_; the boot seed exists for cold REPLACEMENTS, which
      // have no state to continue).
      quorum_id_ = r.quorum_id();
      epoch_ = std::max(epoch_, r.epoch());
      prev_ids_.clear();
      fast_round_step_ = -1;
      fast_served_step_ = -1;
      for (const auto& m : prev_quorum_.participants()) {
        prev_ids_.insert(m.replica_id());
        fast_round_step_ = std::max(fast_round_step_, m.step());
      }
    } else if (!r.has_quorum()) {
      quorum_id_ = std::max(quorum_id_, r.quorum_id());
      epoch_ = std::max(epoch_, r.epoch());
    }
  }
  for (const auto& b : r.beats()) {
    beats_.adopt(b.replica_id(),
                 b.age_ms() >= 0 ? now - b.age_ms() : -1,
                 b.joining_age_ms() >= 0 ? now - b.joining_age_ms() : -1);
  }
  for (const auto& d : r.departed()) {
    if (d.age_ms() >= 0)
      beats_.adopt_departed(d.replica_id(), now - d.age_ms());
  }
}

void Lighthouse::replicate_loop() {
  std::unique_ptr<RpcClient> client;
  const int64_t poll_timeout =
      std::max<int64_t>(2 * opt_.replicate_ms, 500);
  while (true) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_.wait_for(lk, std::chrono::milliseconds(opt_.replicate_ms));
      if (shutdown_) return;
    }
    bool ok = false;
    bool refused = false;
    try {
      if (!client)
        client = std::make_unique<RpcClient>(opt_.standby_of, poll_timeout);
      ReplicateRequest req;
      req.set_standby_address(address());
      {
        std::lock_guard<std::mutex> lk(mu_);
        req.set_have_epoch(epoch_);
      }
      std::string resp, err;
      if (client->call(kLighthouseReplicate, req.SerializeAsString(), &resp,
                       &err, poll_timeout)) {
        ReplicateResponse rr;
        if (rr.ParseFromString(resp)) {
          adopt_replica_state(rr);
          ok = true;
        }
      } else {
        client.reset();
        // "reconnect ... failed" = the listener is gone (connection
        // refused): a much stronger death signal than a timeout, which a
        // loaded-but-alive primary can also produce.
        refused = err.find("reconnect") != std::string::npos;
      }
    } catch (...) {  // initial connect failed: listener gone
      client.reset();
      refused = true;
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (shutdown_) return;
      int64_t now = now_ms();
      if (ok) {
        // A live primary instantly disarms any death suspicion.
        last_primary_ok_ms_ = now;
        primary_poll_failures_ = 0;
        continue;
      }
      primary_poll_failures_++;
      // ARMED: our own view says the primary is gone. The connect layer
      // cannot distinguish a dead listener from a partition dropping our
      // packets ("reconnect failed" covers both), so arming alone must
      // never promote — that would fork the job into two arbiters the
      // moment a standby-side network blip outlasts a few polls.
      bool armed =
          (refused && primary_poll_failures_ >= 2) ||
          primary_poll_failures_ >= 5 ||
          (last_primary_ok_ms_ > 0 &&
           now - last_primary_ok_ms_ >
               std::max<int64_t>(10 * opt_.replicate_ms, 2'000));
      // CORROBORATED: a manager recently dialed our fence with a Quorum
      // attempt — its own path to the primary failed too. Two independent
      // observers of primary death are required to promote; managers that
      // can still reach the primary never dial us, so a standby-only
      // partition leaves the fence up forever (safe: nobody needs us).
      int64_t fenced = last_fenced_quorum_ms_.load();
      bool corroborated =
          fenced >= 0 &&
          now - fenced <= std::max<int64_t>(20 * opt_.replicate_ms, 5'000);
      if (!armed || !corroborated) continue;  // keep polling either way
      // PROMOTE: serve quorums from the adopted state. The epoch jump
      // covers fast-path serves the final missed polls never replicated,
      // keeping epoch monotonicity across the failover (bounded by serve
      // rate x poll interval; 2^20 is orders of magnitude beyond it).
      epoch_ += 1 << 20;
      promoted_.store(true);
      fprintf(stderr,
              "torchft_tpu lighthouse standby: primary %s unreachable "
              "(%lld failed polls%s) and managers are dialing the fence; "
              "PROMOTED at quorum_id=%lld\n",
              opt_.standby_of.c_str(), (long long)primary_poll_failures_,
              refused ? ", connection refused" : "",
              (long long)quorum_id_);
      fflush(stderr);
      return;
    }
  }
}

void Lighthouse::status_locked(StatusResponse* out) const {
  out->set_quorum_id(quorum_id_);
  out->set_epoch(epoch_);
  out->set_fast_path_hits(fast_path_hits_);
  out->set_slow_path_served(slow_path_served_);
  out->set_slow_path_rounds(slow_path_rounds_);
  out->set_joins_coalesced(joins_coalesced_);
  out->set_standby_address(standby_addr_);
  out->set_is_standby(!promoted_.load());
  out->set_fast_path_eligible(
      has_prev_quorum_ && !prev_ids_.empty() &&
      fast_eligible_locked(*prev_ids_.begin(), fast_round_step_));
  if (has_prev_quorum_) {
    int64_t created = prev_quorum_.created_unix_ms();
    int64_t now_wall = std::chrono::duration_cast<std::chrono::milliseconds>(
                           std::chrono::system_clock::now().time_since_epoch())
                           .count();
    out->set_quorum_age_ms(now_wall - created);
    for (const auto& m : prev_quorum_.participants()) {
      auto* ms = out->add_members();
      *ms->mutable_member() = m;
      BeatTable::Beat b;
      if (!beats_.lookup(m.replica_id(), &b) || b.last_ms < 0) {
        ms->set_heartbeat_age_ms(-1);
      } else {
        ms->set_heartbeat_age_ms(now_ms() - b.last_ms);
        ms->set_heal_count(b.heal_count);
        ms->set_committed_steps(b.committed_steps);
        ms->set_aborted_steps(b.aborted_steps);
      }
    }
  }
  for (const auto& [id, j] : participants_) {
    (void)j;
    out->add_joining(id);
  }
}

// Minimal HTML dashboard: quorum status, per-member step/heartbeat, kill
// buttons (the reference's askama/htmx dashboard, templates/status.html),
// plus the control-plane scaling row: fast-path hit rate, cached-quorum
// epoch/age, and the registered warm-standby address.
std::string Lighthouse::handle_http(const std::string& request) {
  std::string body;
  std::string content_type = "text/html";
  // GET /status.json → machine-readable status (what the embedded binding's
  // status() returns), so SREs/scripts can scrape without the Python bridge.
  if (request.rfind("GET /status.json", 0) == 0) {
    StatusResponse st;
    {
      std::lock_guard<std::mutex> lk(mu_);
      status_locked(&st);
    }
    body = status_json(st);
    content_type = "application/json";
  } else
  // GET /fleet/status.json → the fleet health aggregate (per-group
  // digests, straggler ranking + attribution, SLO state) — the
  // operator's "which group is slowing the quorum, and why" endpoint
  // (docs/design/fleet_health.md). Never takes the quorum mutex.
  if (request.rfind("GET /fleet/status.json", 0) == 0) {
    auto agg = fleet_aggregate(now_ms());
    body = fleet_status_json(*agg);
    content_type = "application/json";
  } else
  // GET /fleet/metrics → the same aggregate as Prometheus text
  // exposition (scrape config in docs/design/fleet_health.md).
  if (request.rfind("GET /fleet/metrics", 0) == 0) {
    auto agg = fleet_aggregate(now_ms());
    body = fleet_metrics_text(*agg);
    content_type = "text/plain; version=0.0.4; charset=utf-8";
  } else
  // POST /replica/{id}/kill → Kill RPC to that member's manager.
  if (request.rfind("POST /replica/", 0) == 0) {
    const size_t id_start = strlen("POST /replica/");
    size_t id_end = request.find("/kill", id_start);
    std::string id = id_end == std::string::npos
                         ? ""
                         : request.substr(id_start, id_end - id_start);
    // Undo the form action's percent-encoding.
    std::string decoded;
    decoded.reserve(id.size());
    for (size_t i = 0; i < id.size(); i++) {
      if (id[i] == '%' && i + 2 < id.size()) {
        decoded += (char)strtol(id.substr(i + 1, 2).c_str(), nullptr, 16);
        i += 2;
      } else {
        decoded += id[i];
      }
    }
    id = decoded;
    std::string target;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (has_prev_quorum_)
        for (const auto& m : prev_quorum_.participants())
          if (m.replica_id() == id) target = m.address();
    }
    if (!target.empty()) {
      // The target exits before replying, so a transport error on the reply
      // is the expected success shape; only a failed connect means the kill
      // definitely did not land.
      try {
        RpcClient c(target, 2'000);
        std::string resp, err;
        KillRequest kr;
        kr.set_msg("killed from lighthouse dashboard");
        kr.set_auth_token(opt_.auth_token);
        bool ok = c.call(kManagerKill, kr.SerializeAsString(), &resp, &err,
                         2'000);
        // The target exits before replying on success, so a TRANSPORT
        // error is the expected success shape; an APPLICATION error (e.g.
        // the manager's token gate refusing) means the replica is still
        // alive and the operator must see why.
        if (ok || err.rfind("transport:", 0) == 0) {
          body = "killed " + id;
        } else {
          body = "kill of " + id + " refused: " + err;
        }
      } catch (const std::exception& e) {
        body = "kill of " + id + " failed: " + e.what();
      }
    } else {
      body = "unknown replica " + id;
    }
  } else {
    StatusResponse st;
    {
      std::lock_guard<std::mutex> lk(mu_);
      status_locked(&st);
    }
    std::ostringstream os;
    os << "<html><head><title>torchft_tpu lighthouse</title>"
       << "<meta http-equiv=refresh content=1></head><body>"
       << "<h1>torchft_tpu lighthouse"
       << (st.is_standby() ? " (STANDBY, not serving)" : "") << "</h1>"
       << "<p>quorum_id: " << st.quorum_id()
       << " &middot; age: " << st.quorum_age_ms() << "ms"
       << " &middot; epoch: " << st.epoch() << "</p>";
    {
      int64_t fast = st.fast_path_hits();
      int64_t slow = st.slow_path_served();
      int64_t total = fast + slow;
      char rate[32];
      snprintf(rate, sizeof rate, "%.1f%%",
               total > 0 ? 100.0 * (double)fast / (double)total : 0.0);
      os << "<p>fast path: " << (st.fast_path_eligible() ? "armed" : "cold")
         << " &middot; hit rate " << rate << " (" << fast << " fast / "
         << slow << " slow serves, " << st.slow_path_rounds()
         << " full rounds)"
         << " &middot; standby: "
         << (st.standby_address().empty()
                 ? std::string("none registered")
                 : html_escape(st.standby_address()))
         << "</p>";
    }
    {
      // Fleet health row (docs/design/fleet_health.md): one line of
      // the aggregate + links to the machine endpoints; the full
      // straggler table lives in `lighthouse.py --dashboard`.
      auto agg = fleet_aggregate(now_ms());
      os << "<p>fleet telemetry: " << agg->groups_n
         << " group(s) reporting";
      if (agg->groups_n > 0) {
        char line[160];
        snprintf(line, sizeof line,
                 " &middot; step p50/p95/max %.0f/%.0f/%.0fms",
                 agg->p50, agg->p95, agg->max);
        os << line;
        if (!agg->straggler_id.empty())
          os << " &middot; straggler: "
             << html_escape(agg->straggler_id) << " ("
             << html_escape(agg->straggler_stage.empty()
                                ? std::string("-")
                                : agg->straggler_stage)
             << ")";
      }
      os << " &middot; <a href='/fleet/status.json'>status</a> "
         << "<a href='/fleet/metrics'>metrics</a></p>";
    }
    os << "<table border=1 cellpadding=4><tr><th>replica</th><th>step</th>"
       << "<th>world</th><th>heartbeat age</th><th>heals</th>"
       << "<th>committed</th><th>aborted</th><th></th></tr>";
    int64_t max_step = 0;
    for (const auto& m : st.members())
      max_step = std::max(max_step, m.member().step());
    for (const auto& m : st.members()) {
      bool recovering = m.member().step() != max_step;
      std::string id = html_escape(m.member().replica_id());
      os << "<tr" << (recovering ? " style='background:#fdd'" : "") << "><td>"
         << id << "</td><td>" << m.member().step() << "</td><td>"
         << m.member().world_size() << "</td><td>" << m.heartbeat_age_ms()
         << "ms</td><td>" << m.heal_count() << "</td><td>"
         << m.committed_steps() << "</td><td>" << m.aborted_steps()
         << "</td>"
         << "<td><form method=post action='/replica/"
         << url_encode(m.member().replica_id())
         << "/kill'><button>kill</button></form></td></tr>";
    }
    os << "</table><p>joining: ";
    for (const auto& j : st.joining()) os << html_escape(j) << " ";
    os << "</p></body></html>";
    body = os.str();
  }
  std::ostringstream resp;
  resp << "HTTP/1.1 200 OK\r\nContent-Type: " << content_type
       << "\r\nContent-Length: " << body.size()
       << "\r\nConnection: close\r\n\r\n"
       << body;
  return resp.str();
}

}  // namespace torchft_tpu
