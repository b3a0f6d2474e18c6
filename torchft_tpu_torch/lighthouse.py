"""Standalone lighthouse server CLI.

The reference ships a ``torchft_lighthouse`` console binary
(src/bin/lighthouse.rs, wired via pyproject
``[project.scripts]``). Same surface here:

    python -m torchft_tpu_torch.lighthouse --bind 0.0.0.0:29510 \
        --min-replicas 2 --join-timeout-ms 60000 --quorum-tick-ms 100

Serves the quorum RPC and the HTML dashboard (quorum age, per-member step
with recovering highlight, heartbeat staleness, kill buttons) on one port.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

from torchft_tpu_torch._native import Lighthouse


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="torchft_tpu lighthouse: global quorum server")
    # Defaults mirror the reference binary (src/lighthouse.rs:64-79).
    parser.add_argument("--bind", default="0.0.0.0:29510")
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument("--join-timeout-ms", type=int, default=60_000)
    parser.add_argument("--quorum-tick-ms", type=int, default=100)
    parser.add_argument("--heartbeat-fresh-ms", type=int, default=500,
                        help="a missing prev member heartbeating within "
                        "this window counts as alive-and-en-route")
    parser.add_argument("--heartbeat-grace-factor", type=int, default=4,
                        help="straggler wait extends to factor * "
                        "join_timeout while such a member keeps beating "
                        "(1 = reference behavior)")
    parser.add_argument("--eviction-staleness-factor", type=int, default=3,
                        help="cut a shrunken quorum immediately when every "
                        "missing member's beats are staler than factor * "
                        "heartbeat_fresh_ms (0 = wait the full join "
                        "timeout, reference behavior)")
    parser.add_argument("--auth-token",
                        default=os.environ.get("TORCHFT_AUTH_TOKEN", ""),
                        help="shared job secret forwarded in dashboard "
                        "Kill RPCs (env TORCHFT_AUTH_TOKEN)")
    parser.add_argument("--no-fast-path", action="store_true",
                        help="disable the membership-unchanged quorum fast "
                        "path (cached decision + bumped epoch; see "
                        "docs/design/control_plane.md) — every Quorum RPC "
                        "then parks in the tick-loop rendezvous")
    parser.add_argument("--standby-of", default="",
                        help="run as a WARM STANDBY of the primary "
                        "lighthouse at this host:port: replicate its "
                        "quorum state, refuse Quorum RPCs until it is "
                        "provably dead, then promote with the same "
                        "quorum_id (managers re-dial without a ring "
                        "rebuild)")
    parser.add_argument("--replicate-ms", type=int, default=100,
                        help="standby replication poll interval")
    parser.add_argument("--join-window-ms", type=int, default=0,
                        help="join-coalescing window "
                        "(docs/design/churn.md): hold a forming round "
                        "open this long from the first JOINER's arrival "
                        "so a join storm is admitted as one membership "
                        "delta — reconfigures scale with windows, not "
                        "joiners (0 = cut per joiner)")
    parser.add_argument("--address-file", default="",
                        help="write the bound host:port to this file once "
                        "listening (for scripts/tests that bind port 0)")
    parser.add_argument("--slo",
                        default=os.environ.get("TORCHFT_SLO", ""),
                        help="fleet SLO spec "
                        "(docs/design/fleet_health.md), e.g. "
                        "'step_p95_ms=2500;commit_rate=0.95;"
                        "heal_ms=60000;publish_lag_ms=5000;"
                        "staleness_ms=30000' (env TORCHFT_SLO); a "
                        "breach lands a fleet event, flips the "
                        "slo_breach gauge on /fleet/metrics, and is "
                        "echoed to the guilty group (triggering its "
                        "flight-recorder dump)")
    parser.add_argument("--dashboard", action="store_true",
                        help="render the live fleet health table "
                        "(straggler-ranked groups, stage attribution, "
                        "SLO breaches) to stdout while serving — the "
                        "terminal spelling of GET /fleet/status.json")
    parser.add_argument("--dashboard-interval", type=float, default=2.0,
                        help="fleet table refresh seconds "
                        "(with --dashboard)")
    args = parser.parse_args(argv)

    # Validate the SLO spec STRICTLY up front (the C++ parser ignores
    # unknown keys by design — a typo'd threshold silently never firing
    # is the worst failure mode an SLO can have).
    from torchft_tpu_torch import fleet as fleet_mod

    fleet_mod.SLOConfig.from_spec(args.slo)

    logging.basicConfig(level=logging.INFO)
    lh = Lighthouse(
        bind=args.bind,
        min_replicas=args.min_replicas,
        join_timeout_ms=args.join_timeout_ms,
        quorum_tick_ms=args.quorum_tick_ms,
        heartbeat_fresh_ms=args.heartbeat_fresh_ms,
        heartbeat_grace_factor=args.heartbeat_grace_factor,
        eviction_staleness_factor=args.eviction_staleness_factor,
        auth_token=args.auth_token,
        fast_path=not args.no_fast_path,
        standby_of=args.standby_of,
        replicate_ms=args.replicate_ms,
        join_window_ms=args.join_window_ms,
        slo=args.slo,
    )
    if args.address_file:
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(lh.address())
        os.replace(tmp, args.address_file)  # readers never see a torn write
    logging.info("lighthouse listening on %s (dashboard: http://%s/)%s",
                 lh.address(), lh.address(),
                 f" [standby of {args.standby_of}]" if args.standby_of
                 else "")
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    if args.dashboard:
        # Poll our own /fleet/status.json and render the straggler
        # table — "which group is slowing the quorum, and why" at a
        # glance (docs/design/fleet_health.md). Errors (no digests
        # yet, transient scrape failures) never kill the server loop.
        interval = max(args.dashboard_interval, 0.2)
        while not stop.wait(interval):
            try:
                status = fleet_mod.fetch_fleet_status(lh.address(),
                                                      timeout=5.0)
                print("\033[2J\033[H"  # clear + home (ANSI)
                      + fleet_mod.format_fleet_table(status)
                      + f"\nslo: active="
                        f"{status.get('slo', {}).get('active', 0)} "
                        f"breaches_total="
                        f"{status.get('slo', {}).get('breaches_total', 0)}",
                      flush=True)
            except Exception as e:  # noqa: BLE001
                logging.debug("fleet dashboard refresh failed: %s", e)
    else:
        stop.wait()
    lh.shutdown()


if __name__ == "__main__":
    main()
