"""Fault-tolerant LM training across replica groups: the port of
``examples/train_lm.py``.

One process per replica group; the groups average gradients over the host
TCP ring, vote on every commit, and a group that (re)joins heals from a
healthy peer's live state over HTTP.

    # quorum server + dashboard
    python -m torchft_tpu_torch.lighthouse --bind 0.0.0.0:29510 \\
        --min-replicas 1

    # one per group k in {0, 1}
    REPLICA_GROUP_ID=$k NUM_REPLICA_GROUPS=2 \\
    TORCHFT_LIGHTHOUSE=localhost:29510 MODEL=llama2_7b NUM_LAYERS=2 \\
    BATCH_SIZE=1 SEQ_LEN=2048 python -m torchft_tpu_torch.train_lm

Knobs (environment): ``REPLICA_GROUP_ID``, ``NUM_REPLICA_GROUPS``,
``TOTAL_STEPS``, ``BATCH_SIZE``, ``SEQ_LEN``, ``MODEL`` (``tiny`` or
``llama2_7b``; the latter runs the flash-attention kernels),
``NUM_LAYERS`` (cuts the model's depth), ``INIT_SEED`` (weight init; a
group that joins a running job heals to the job's weights whatever its
seed), ``TOKENS_FILE`` / ``DATA_DIR`` (corpus; a synthetic one is made
when absent), ``REPORT_FILE``: a JSON file rewritten after every
step with the losses, votes, step walls, manager timings, kernel launch
counts and, at the end, a sha256 of the parameters and optimizer state,
and ``HOLD_AFTER_STEP``: a fault drill — after committing that step the
process stops stepping and waits to be killed (``"held": true`` in the
report); under overlap the held step's exchange is then still in flight.
The report also carries the recovery plane: the digests made and their
wall, the quarantine ladder's counters (``sdc``), the donors of the last
heal (``heal_striped_donors``) and the last state digest pushed; with
``REPORT_HOST_DIGEST=1``, the final report adds the attestation digest of
the final state on the card and numpy's on a host copy (``final_digest``,
tens of seconds at 7B widths).
``OVERLAP_STEPS=1`` runs the cross-step overlap engine: step N's
allreduce drains under step N+1's forward and backward, and its vote and
update land at the N+1 boundary (one-step-stale gradients); every group
must set it alike.

Durable checkpoints: with ``CHECKPOINT_DIR``, each group keeps its own
``CHECKPOINT_DIR/<group>`` and, at start, resumes from the newest file
there that verifies and is committed (``checkpoint_io.recover``, which
quarantines torn or corrupt files, then ``load``: trainer, loader and
manager state). Every ``CHECKPOINT_EVERY`` (10) committed steps it saves
through ``Manager.save_durable`` to an ``AsyncCheckpointer(keep=3)``: a
snapshot on the card, the copy to the host and the write on the writer's
thread. SIGTERM arms the graceful preemption drain: at the next clean
commit boundary the group says farewell to the quorum, takes a final
save of the same tree, withdraws its advertisements and exits 0
(``"preempted": true``). The report then adds the resume (path, step,
the state hash right after the load, recover and load wall), each save's
dispatch ms on this thread and the snapshot's ms on the card, the
writer's wall and bytes, the ``ckpt_*`` / ``preempt_*`` counters and
the peak card memory. ``ELASTIC_DATA=1`` swaps the static 2D sampler
for the quorum-following stream (``ElasticLoader(ElasticSampler(...),
prefetch=2)``, batches placed on the device): each participating group
draws one slot of one global stream, so membership changes re-partition
it instead of losing a dead group's shard, and the stream position is
the manager's ``batches_committed``, which rides the manager state — no
loader state is saved, the checkpoints go to their own
``CHECKPOINT_DIR/<group>-elastic`` lineage, and a resume continues from
the restored count. The report then adds each step's drawn sample count
(``samples``), whether the group took part (``participating``), the
participant count and the capacity and rebalance fractions in force.
``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import signal
import tempfile
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from torchft_tpu_torch import checkpoint_io, serialization
from torchft_tpu_torch.backends.host import HostCommunicator
from torchft_tpu_torch.data import (DistributedSampler, ElasticLoader,
                                    ElasticSampler, StatefulLoader,
                                    TokenFileDataset)
from torchft_tpu_torch.manager import Manager, PreemptedExit
from torchft_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  chunked_causal_lm_loss,
                                                  llama2_7b_config,
                                                  tiny_config)
from torchft_tpu_torch.ops import attest
from torchft_tpu_torch.ops import flash_attention as fa
from torchft_tpu_torch.parallel.step import FTTrainer
from torchft_tpu_torch.utils import tree_flatten_with_path

logger = logging.getLogger("train_lm")


def make_config() -> TransformerConfig:
    """Size from the environment: ``tiny`` (plain attention) or Llama-2-7B
    widths with the flash-attention kernels, depth cut by NUM_LAYERS."""
    if os.environ.get("MODEL", "tiny") == "tiny":
        return tiny_config(max_seq_len=128)
    overrides: Dict[str, Any] = dict(attention_fn=fa.flash_attention,
                                     remat=True)
    if os.environ.get("NUM_LAYERS"):
        overrides["num_layers"] = int(os.environ["NUM_LAYERS"])
    return llama2_7b_config(**overrides)


# The recovery plane's counters in the report: digests and their wall,
# the quarantine ladder, chaos flips.
SDC_KEYS = ("sdc_digests_total", "sdc_digest_ms_total", "sdc_quarantined",
            "sdc_quarantines_total", "sdc_quarantine_clears_total",
            "sdc_reheals_total", "sdc_chaos_flips_total")
# The durability plane's counters in the report: the writer's, the
# recovery scan's (added to the manager's, which count only its own
# cold_start) and the drain's.
CKPT_KEYS = ("ckpt_save_count", "ckpt_save_errors", "ckpt_save_fatal",
             "ckpt_save_stalls", "ckpt_save_bytes_total",
             "ckpt_save_ms_total", "ckpt_corrupt_quarantined",
             "ckpt_recover_fallbacks", "ckpt_recover_legacy",
             "ckpt_cold_starts", "ckpt_save_skipped")
PREEMPT_KEYS = ("preempt_notices_total", "preempt_drain_deferrals_total",
                "preempt_deadline_expired_total", "graceful_exits_total")


def state_hash(trainer: FTTrainer, fingerprint: bool = False
               ) -> Tuple[str, str]:
    """sha256 over every parameter and optimizer-state tensor, in the
    serializer's sorted-key order; with ``fingerprint``, also the numpy
    attestation fingerprint of the same host copies (else "")."""
    h = hashlib.sha256()
    acc = [serialization.ATTEST_FNV_BASIS] * 4
    for path, leaf in tree_flatten_with_path(trainer.state_dict())[0]:
        h.update("/".join(map(str, path)).encode())
        if isinstance(leaf, torch.Tensor):
            host = leaf.detach().cpu().contiguous()
            h.update(host.view(-1).view(torch.uint8).numpy().tobytes())
            if fingerprint and host.numel():
                acc = serialization.attest_fold(
                    acc, *serialization.attest_leaf_words(host))
        else:
            h.update(repr(leaf).encode())
    return (h.hexdigest(),
            serialization.attest_combine(acc) if fingerprint else "")


def main(argv: Any = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")
    logging.basicConfig(level=logging.INFO)
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", 0))
    num_groups = int(os.environ.get("NUM_REPLICA_GROUPS", 2))
    total_steps = int(os.environ.get("TOTAL_STEPS", 50))
    batch_size = int(os.environ.get("BATCH_SIZE", 8))
    seq_len = int(os.environ.get("SEQ_LEN", 128))
    seed = int(os.environ.get("INIT_SEED", 0))
    report_file = os.environ.get("REPORT_FILE")
    hold = os.environ.get("HOLD_AFTER_STEP")
    overlap = int(os.environ.get("OVERLAP_STEPS", 0))
    host_digest_check = os.environ.get("REPORT_HOST_DIGEST") == "1"

    cfg = make_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Transformer(cfg, device=device, generator=gen)

    tokens_file = os.environ.get("TOKENS_FILE")
    if not tokens_file:
        tokens_file = os.path.join(
            os.environ.get("DATA_DIR", os.path.join(
                tempfile.gettempdir(), "torchft_tpu_torch_data")),
            f"synth_tokens_v{cfg.vocab_size}.npy")
        if not os.path.exists(tokens_file):
            # Per-group temp file, then an atomic rename: a peer starting
            # at the same time never memmaps a half-written file.
            rng = np.random.default_rng(0)
            tmp = f"{tokens_file}.{replica_group}.{os.getpid()}.tmp.npy"
            TokenFileDataset.write(
                tmp, rng.integers(0, cfg.vocab_size, size=4096 * seq_len)
                .astype(np.uint16 if cfg.vocab_size <= 65536 else np.int32))
            os.replace(tmp, tokens_file)
    dataset = TokenFileDataset(tokens_file, seq_len=seq_len)
    elastic = os.environ.get("ELASTIC_DATA") == "1"
    batches: Any = None  # the elastic loader needs the manager
    if not elastic:
        sampler = DistributedSampler(
            dataset_size=len(dataset), replica_group=replica_group,
            num_replica_groups=num_groups, batch_size=batch_size, seed=0)
        batches = StatefulLoader(dataset, sampler, prefetch=2)

    def loss_fn(m: Transformer, batch: Dict[str, Any]) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"]).to(device)
        hidden = m(tokens, return_hidden=True)
        return chunked_causal_lm_loss(hidden, m.lm_head_kernel(), tokens)

    trainer = FTTrainer(
        model=model, loss_fn=loss_fn,
        # optax.adamw(3e-4)'s hyperparameters (weight decay 1e-4).
        optimizer=torch.optim.AdamW(model.parameters(), lr=3e-4,
                                    weight_decay=1e-4, eps=1e-8),
        manager_factory=lambda load, save: Manager(
            comm=HostCommunicator(),
            load_state_dict=load, state_dict=save, min_replica_size=1,
            replica_id=f"train_lm_{replica_group}", overlap_steps=overlap))
    m = trainer.manager
    # The elastic draw's rows, read into the report after each step.
    drawn = [0]
    if elastic:
        batches = ElasticLoader(
            dataset, ElasticSampler(len(dataset), m, batch_size=batch_size,
                                    seed=0), prefetch=2, device=device)

    def draw() -> Dict[str, Any]:
        batch = batches()
        drawn[0] = int(batch["tokens"].shape[0])
        return batch

    logger.info("replica group %d/%d up (%s)", replica_group, num_groups,
                m.replica_id())

    report: Dict[str, Any] = {"group": replica_group, "seed": seed,
                              "overlap_steps": overlap, "elastic": elastic,
                              "losses": [], "committed": [], "step_s": [],
                              "hidden_ms": [], "drain_wait_ms": [],
                              "saved": [], "ckpt_saves": [],
                              "preempted": False}
    if elastic:
        report.update(samples=[], participating=[], num_participants=[],
                      capacity_fraction=[], rebalance_fraction=[])

    # Durable checkpoints: one directory per group. recover(), not the
    # newest name: the newest file may be torn or bit-rotted, and the scan
    # quarantines it and falls back to the previous good one.
    ckpt_dir = os.environ.get("CHECKPOINT_DIR")
    ckpt_every = int(os.environ.get("CHECKPOINT_EVERY", 10))
    # The elastic stream saves no loader state, and a load matches the
    # tree's structure strictly: each data mode has its own lineage.
    ckpt_name = (f"{replica_group}-elastic" if elastic
                 else str(replica_group))
    group_dir = os.path.join(ckpt_dir, ckpt_name) if ckpt_dir else None
    recover_stats: Dict[str, float] = {}
    # The loader's position after the last step: the drain's final save
    # runs inside train_step, after the next batch was drawn.
    loader_state = None if elastic else batches.state_dict()

    def durable_user_state() -> Dict[str, Any]:
        user: Dict[str, Any] = {"trainer": trainer.state_dict()}
        if not elastic:
            user["loader"] = loader_state
        return user

    if group_dir:
        t_rec = time.perf_counter()
        path = checkpoint_io.recover(group_dir, stats=recover_stats)
        t_load = time.perf_counter()
        if path:
            user, mgr_state = checkpoint_io.load(
                path, target=durable_user_state())
            trainer.load_state_dict(user["trainer"])
            if not elastic:
                batches.load_state_dict(user["loader"])
            # With the saved step's contribution: the elastic stream
            # resumes from batches_committed.
            m.load_durable_state(mgr_state, checkpoint_io.read_meta(path))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_done = time.perf_counter()
            report.update(
                resumed_from=path, resumed_step=m.current_step(),
                resumed_hash=state_hash(trainer)[0],
                resume={"recover_ms": round((t_load - t_rec) * 1e3, 1),
                        "load_ms": round((t_done - t_load) * 1e3, 1),
                        "bytes": os.path.getsize(path)})
            logger.info("resumed from %s at step %d", path,
                        m.current_step())

    ckpt_writer = (checkpoint_io.AsyncCheckpointer(keep=3) if group_dir
                   else None)
    if not elastic:
        loader_state = batches.state_dict()

    if ckpt_writer is not None:
        m.set_durable_target(ckpt_writer, group_dir,
                             user_state_fn=durable_user_state)

    # Each save's CUDA events (around the snapshot), read once done.
    save_events: Dict[int, Any] = {}

    def note_save(step: int, t0: float, ms0: float, events: Any,
                  fut: Any) -> None:
        """One save's record: its dispatch on this thread now; the
        writer's wall (its counter's delta since ``ms0``) and the wall
        until durable when the write lands; the snapshot's card time at
        the next report."""
        rec: Dict[str, Any] = {
            "step": step, "dispatch_ms": round(
                (time.perf_counter() - t0) * 1e3, 3)}

        def done(f: Any) -> None:
            rec["durable_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
            rec["write_ms"] = round(
                ckpt_writer.metrics()["ckpt_save_ms_total"] - ms0, 1)
            rec["ok"] = f.exception() is None

        if events is not None:
            save_events[len(report["ckpt_saves"])] = events
        report["ckpt_saves"].append(rec)
        fut.add_done_callback(done)

    def write_report(final: bool) -> None:
        for i, ev in list(save_events.items()):
            if ev[1].query():
                report["ckpt_saves"][i]["snapshot_card_ms"] = round(
                    ev[0].elapsed_time(ev[1]), 3)
                del save_events[i]
        if not report_file:
            return
        mx = m.metrics()
        report.update(
            step=m.current_step(), heal_count=int(mx["heal_count"]),
            heal_ms=round(mx["heal_ms_total"], 1),
            heal_bytes=mx["heal_bytes_total"],
            allreduce_ms=round(mx["allreduce_ms_total"], 1),
            allreduce_count=int(mx["allreduce_count"]),
            committed_steps=int(mx["committed_steps"]),
            aborted_steps=int(mx["aborted_steps"]),
            overlap_grads_dropped=int(mx["overlap_grads_dropped"]),
            heal_striped_donors=int(mx["heal_striped_donors"]),
            sdc={k: mx[k] for k in SDC_KEYS},
            ckpt={k: mx.get(k, 0.0) + recover_stats.get(k, 0.0)
                  for k in CKPT_KEYS},
            preempt={k: mx[k] for k in PREEMPT_KEYS},
            state_digest=m._last_state_digest,
            sdc_events=[{"event": e["event"], "step": e["step"]}
                        for e in m.history()
                        if e["event"].startswith("sdc")],
            launches={**fa.LAUNCHES, **attest.LAUNCHES},
            params_on_cpu=sum(p.device.type == "cpu"
                              for p in trainer.params.values())
            if device.type != "cpu" else 0,
            peak_card_bytes=(torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0))
        if final:
            report["state_hash"], host_digest = state_hash(trainer,
                                                           host_digest_check)
            if host_digest_check:
                leaves = [t for t in tree_flatten_with_path(
                    trainer.state_dict())[0] if isinstance(t[1], torch.Tensor)
                    and t[1].numel()]
                report["final_digest"] = {
                    "card": serialization.attest_combine(
                        attest.attest_words([t for _, t in leaves])),
                    "host": host_digest}
        tmp = f"{report_file}.tmp"
        with open(tmp, "w") as f:
            json.dump(report, f)
        os.replace(tmp, report_file)

    # The reclaim signal drains this run; the caller's handler is back
    # once main returns (a caller that goes on must not ignore SIGTERM).
    prev_sigterm = m.install_preemption_handler()
    try:
        while m.current_step() < total_steps:
            t0 = time.perf_counter()
            try:
                loss, committed = trainer.train_step(
                    draw if elastic else next(batches))
            except PreemptedExit:
                # The noticed-reclaim success path: farewell, final save
                # and withdrawal are done, and the manager is shut down.
                logger.info("gracefully preempted at step %d; exiting",
                            m.current_step())
                report["preempted"] = True
                break
            if not elastic:
                loader_state = batches.state_dict()
            step = m.current_step()
            saved = False
            if ckpt_writer is not None and committed \
                    and step % ckpt_every == 0:
                # Overlap keeps one exchange in flight across the
                # boundary, and save_durable refuses such a snapshot:
                # settle it first.
                trainer.flush()
                # The dispatch includes waiting out the previous write.
                ts = time.perf_counter()
                ckpt_writer.wait()
                ms0 = ckpt_writer.metrics()["ckpt_save_ms_total"]
                events = None
                if device.type == "cuda":
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                fut = m.save_durable(ckpt_writer, group_dir,
                                     user_state=durable_user_state())
                if events is not None:
                    events[1].record()
                if fut is not None:
                    note_save(step, ts, ms0, events, fut)
                    saved = True
            report["losses"].append(float(loss))
            report["committed"].append(bool(committed))
            report["saved"].append(saved)
            report["step_s"].append(round(time.perf_counter() - t0, 3))
            if elastic:
                report["samples"].append(drawn[0])
                report["participating"].append(m.is_participating())
                report["num_participants"].append(m.num_participants())
                report["capacity_fraction"].append(m.capacity_fraction())
                report["rebalance_fraction"].append(
                    m.rebalance_fraction())
            mx = m.metrics()
            report["hidden_ms"].append(
                round(mx["allreduce_hidden_ms_total"], 1))
            report["drain_wait_ms"].append(
                round(mx["allreduce_drain_wait_ms_total"], 1))
            logger.info("step=%d loss=%.4f committed=%s participants=%d "
                        "timings=%s", step, float(loss),
                        committed, m.num_participants(),
                        {k: round(v, 3)
                         for k, v in trainer.last_step_timings.items()})
            write_report(final=False)
            if hold is not None and m.current_step() >= int(hold):
                report["held"] = True
                write_report(final=False)
                logger.info("holding after step %d", m.current_step())
                while True:
                    time.sleep(1)
        if not report["preempted"]:
            # Overlap: the last step is still in flight; apply it before
            # the final state hash.
            trainer.flush()
            logger.info("done: %d steps, %d batches committed",
                        m.current_step(), m.batches_committed())
        if ckpt_writer is not None:
            # The last cadence save lands before the final report; a
            # failed write raises here.
            ckpt_writer.wait()
        write_report(final=True)
    finally:
        signal.signal(signal.SIGTERM, prev_sigterm)
        try:
            if ckpt_writer is not None:
                ckpt_writer.shutdown()
        finally:
            try:
                batches.shutdown()
            finally:
                trainer.shutdown()


if __name__ == "__main__":
    main()
