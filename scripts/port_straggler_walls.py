"""Do the fleet digest's step walls show a straggler in a lockstep fleet?

Runs three ``torchft_tpu_torch.train_lm`` groups of the tiny model on the
CPU under one lighthouse (three members per quorum), with the weighted
fold, the rebalance table adopted (``TORCHFT_DEGRADED=1``,
``TORCHFT_REBALANCE=1``) and the elastic stream (``ELASTIC_DATA=1``).
The last group runs the chaos ``slow`` band: every boundary it sleeps
``factor - 1`` times its natural step wall. The lighthouse's
``/fleet/status.json`` is polled while they run; the script prints, per
group and step, the wall the digest reported and the rebalance fraction
stamped beside it, the lighthouse's table each time it changed, and each
group's adopted fractions and draws.

    python scripts/port_straggler_walls.py [--steps 12] [--factor 3]

Every group's boundaries are barriers of the ring and the vote, so the
question is whether the slow group's wall stands out at all.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def fleet_status(addr: str) -> dict:
    with urllib.request.urlopen(f"http://{addr}/fleet/status.json",
                                timeout=5) as resp:
        return json.load(resp)


def main(argv: list) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--factor", type=float, default=3.0)
    ap.add_argument("--groups", type=int, default=3)
    args = ap.parse_args(argv)
    from torchft_tpu_torch._native import Lighthouse

    work = tempfile.mkdtemp(prefix="straggler_walls_")
    lh = Lighthouse(bind="127.0.0.1:0", min_replicas=args.groups,
                    join_timeout_ms=2000, quorum_tick_ms=50)
    procs = []
    try:
        for g in range(args.groups):
            env = dict(os.environ, MODEL="tiny", BATCH_SIZE="8",
                       SEQ_LEN="64", TOTAL_STEPS=str(args.steps),
                       REPLICA_GROUP_ID=str(g),
                       NUM_REPLICA_GROUPS=str(args.groups),
                       TORCHFT_LIGHTHOUSE=lh.address(), DATA_DIR=work,
                       ELASTIC_DATA="1", TORCHFT_DEGRADED="1",
                       TORCHFT_REBALANCE="1", INIT_SEED=str(g),
                       TORCHFT_CHECKPOINT_BIND="127.0.0.1",
                       REPORT_FILE=os.path.join(work, f"report_{g}.json"),
                       PYTHONPATH=ROOT)
            if g == args.groups - 1:
                env["TORCHFT_CHAOS"] = (
                    f"seed=1;slow:slow_rate=1.0,slow_factor={args.factor}")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torchft_tpu_torch.train_lm",
                 "--device", "cpu"], cwd=ROOT, env=env,
                stdout=open(os.path.join(work, f"group_{g}.log"), "w"),
                stderr=subprocess.STDOUT))
        walls: dict = {}  # replica id -> {step: (wall ms, fraction)}
        tables = []
        while any(p.poll() is None for p in procs):
            try:
                st = fleet_status(lh.address())
            except OSError:
                time.sleep(0.2)
                continue
            fleet = st.get("fleet", {})
            table = fleet.get("rebalance_table", "")
            if not tables or tables[-1][1] != table:
                tables.append((time.monotonic(), table))
            for grp in st.get("groups", []):
                walls.setdefault(grp["replica_id"], {})[grp["step"]] = (
                    grp["step_wall_ms"], grp["rebalance_fraction"],
                    grp["straggler_score"], grp["healing"])
            time.sleep(0.05)
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        lh.shutdown()
    print(f"exit codes {rcs}")
    for rid, by_step in sorted(walls.items()):
        print(f"group {rid}:")
        for step in sorted(by_step):
            wall, frac, score, healing = by_step[step]
            print(f"  step {step}: digest wall {wall:.1f} ms, fraction "
                  f"{frac}, straggler score {score:.3f}, healing {healing}")
    print("lighthouse tables:", [t for _, t in tables])
    for g in range(args.groups):
        with open(os.path.join(work, f"report_{g}.json")) as f:
            rep = json.load(f)
        print(f"report group {g}: step_s={rep['step_s']} "
              f"samples={rep['samples']} "
              f"rebalance_fraction={rep['rebalance_fraction']}")
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
