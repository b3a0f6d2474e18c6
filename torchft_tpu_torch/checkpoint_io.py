"""Durable (disk) checkpointing, step-consistent with the FT manager: the
port of the JAX package's ``torchft_tpu/checkpoint_io.py``, byte for byte
in its on-disk format.

Live healing covers a replica group dying; this module covers the failure
class healing cannot — a *correlated* failure (cluster preemption, power
event, every group killed at once) and a spot reclaim — with a
**verified, commit-coupled** on-disk format and a cold-start recovery
scan.

On-disk format (``tft-durable-2``)::

    [8B magic "TFTCKPT2"][u32 head_len][head json]
    [TFTPTREE payload  (torchft_tpu_torch.serialization stream)]
    [manifest json][u32 manifest_len][8B end magic "TFTCKEND"]

The head records provenance (format version, step, batches_committed, a
``committed`` marker set by the Manager's commit-coupled save path, and
quorum metadata); the trailing manifest carries a per-array-leaf crc32
digest (the same :func:`~torchft_tpu_torch.serialization.manifest_from`
spelling the heal transport serves over HTTP) plus head/preamble digests,
so *every* byte of the file is covered. The manifest trails the payload
so digests are computed in the same single pass that copies each leaf
to the host and streams its bytes out. A tree serializes to the same
bytes here as in the JAX package, so a file written by either package
loads and verifies in the other.

Durability: writes are atomic (temp file + ``os.replace``) AND the
containing **directory is fsynced after the rename** — a rename without a
directory fsync is not crash-durable on POSIX. ``load`` verifies each
leaf's digest BEFORE placing it on its target's device (corrupt bytes
never reach the card), :func:`verify` validates a file without loading
it, and :func:`recover` walks a directory newest-first, quarantines
torn/corrupt files, and returns the newest snapshot that is both verified
and committed.

Usage::

    ckpt.save(path, trainer.state_dict(), manager.state_dict())
    path = ckpt.recover(directory)          # newest verified+committed
    user, mgr = ckpt.load(path, target=trainer.state_dict())
    trainer.load_state_dict(user); manager.load_state_dict(mgr)
"""

from __future__ import annotations

import errno
import io
import json
import logging
import os
import tempfile
import threading
import time
import zlib
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable, Dict, Optional, Tuple

from torchft_tpu_torch import chaos, transport
from torchft_tpu_torch.checkpointing import _snapshot_tree
from torchft_tpu_torch.retry import RetryPolicy, RetryStats, call_with_retry
from torchft_tpu_torch.serialization import (
    DEFAULT_BATCH_BYTES,
    LeafDigestMismatch,
    _MAGIC as _TREE_MAGIC,
    _is_array_leaf,
    _iter_leaf_views,
    _leaf_nbytes,
    balanced_ranges,
    device_put_like,
    load_pytree_from,
    manifest_from,
    plan_pytree,
)
from torchft_tpu_torch.utils import tree_flatten, tree_unflatten

logger: logging.Logger = logging.getLogger(__name__)

_CKPT_MAGIC = b"TFTCKPT2"
_END_MAGIC = b"TFTCKEND"
_SET_MAGIC = b"TFTCKST1"
FORMAT = "tft-durable-2"
SET_FORMAT = "tft-shardset-1"
# Upper bound on the json head/manifest we will allocate for — both are
# ~100B per leaf; 256MiB covers millions of leaves while a corrupt
# length field cannot trigger a multi-GiB allocation.
_MAX_JSON = 256 * 1024 * 1024
_QUARANTINE_SUFFIX = ".corrupt"


class CheckpointCorruptError(ValueError):
    """The on-disk checkpoint is torn, truncated, or fails digest
    verification. :func:`recover` quarantines such files and falls back
    to the previous good snapshot; they are never loaded."""


class CheckpointUnverifiableError(ValueError):
    """The file is a legacy (bare ``TFTPTREE``) checkpoint with no
    digest manifest: it cannot be verified. :func:`load` still reads it
    (compat), but :func:`recover` skips it WITHOUT quarantining — it may
    be fine, we just cannot prove it."""


class CheckpointStallError(RuntimeError):
    """The background durable write made no progress for the stall
    timeout (``TORCHFT_CKPT_STALL_SEC``) — a wedged NFS mount or dead
    disk. The write is abandoned so ``save_async``/``shutdown`` return
    instead of hanging forever."""


# Corruption is fatal in the shared transport classification table too:
# a byte path that surfaces it (a 422-rejected RAM push, a torn durable
# image fetched over HTTP) must never burn retry budget re-sending the
# same provably-bad bytes.
transport.register_fatal(CheckpointCorruptError)


def _io_transient(exc: BaseException) -> bool:
    """Retryable filesystem errors for durable saves: interrupted/flaky
    IO on network filesystems (EIO, EAGAIN, ESTALE, ETIMEDOUT, EINTR).
    Deliberately narrow — ENOSPC/EACCES/EROFS must surface immediately."""
    transient = {errno.EIO, errno.EAGAIN, errno.ESTALE, errno.ETIMEDOUT,
                 errno.EINTR, errno.EBUSY}
    return (isinstance(exc, OSError) and exc.errno in transient)


def _io_fatal(exc: BaseException) -> bool:
    """The disk is FULL or read-only: retrying cannot help and every
    subsequent save will fail the same way. Callers surface these as a
    ``ckpt_save_fatal`` counter + last-error string (via
    :meth:`AsyncCheckpointer.metrics`) so the operator learns now, not
    when the job next cold-starts onto a stale snapshot."""
    return (isinstance(exc, OSError)
            and exc.errno in {errno.ENOSPC, errno.EROFS, errno.EDQUOT})


def _fsync_dir(directory: str) -> None:
    """fsync the directory so a just-renamed entry survives power loss
    (POSIX does not make ``os.replace`` durable without it). Swallows
    OSError: some filesystems refuse directory fsync, and the write
    itself already succeeded."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_publish(path: str, write_body: Callable[[Any], None]) -> None:
    """The ONE crash-durable publish sequence — temp file in the target
    directory, ``write_body(f)``, fsync, ``os.replace``, directory
    fsync, temp cleanup on failure — shared by the v2 single-file writer
    and the shard-set head (the head is the sharded save's commit point,
    so it must never carry weaker durability than the shards)."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt_tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            write_body(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic on POSIX
        # The rename itself must survive power loss: fsync the directory
        # (satellite: rename without dir fsync is not crash-durable).
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _build_head(plan: Any, manager_state: Optional[dict],
                meta: Optional[dict]) -> dict:
    mgr = manager_state or {}
    head = {
        "format": FORMAT,
        "step": int(mgr.get("step", 0)),
        "batches_committed": int(mgr.get("batches_committed", 0)),
        # True by default: a direct save() caller owns its own commit
        # semantics; Manager.save_durable overrides with real coupling
        # (and refuses to snapshot uncommitted state at all).
        "committed": True,
        "payload_len": int(plan.total_len),
        "time": time.time(),
    }
    if meta:
        head.update(meta)
    return head


def save(path: str, user_state: Any, manager_state: Optional[dict] = None,
         meta: Optional[dict] = None,
         _progress: Optional[Callable[[int], None]] = None) -> None:
    """Atomically write a verified ``{user, torchft}`` checkpoint to
    ``path``, streaming one leaf at a time (no full in-memory copy).

    ``meta`` merges extra provenance into the head (``committed``,
    ``quorum_id``, ``replica_id``, ...— see
    :meth:`Manager.save_durable`). ``_progress`` is called with the
    cumulative bytes written (the :class:`AsyncCheckpointer` stall
    watchdog's progress signal). Per-leaf digests are computed in the
    same pass that writes the bytes, so verification costs no extra
    device fetch. The file lands via temp + ``os.replace`` + directory
    fsync — crash-durable, never observable half-written."""
    # Default matches load()'s torchft target so a checkpoint saved without
    # a manager state still round-trips.
    tree = {
        "user": user_state,
        "torchft": manager_state or {"step": 0, "batches_committed": 0},
    }
    _write_v2(path, tree, manager_state, meta, _progress)


def _write_v2(path: str, tree: Any, manager_state: Optional[dict],
              meta: Optional[dict],
              _progress: Optional[Callable[[int], None]] = None) -> int:
    """The atomic single-file v2 write (shared by :func:`save` and the
    per-shard writes of :func:`save_sharded`): head + TFTPTREE payload +
    trailing digest manifest, via temp + ``os.replace`` + directory
    fsync. Returns the file's total byte size."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)

    fault = chaos.disk_fault(f"disk:{os.path.basename(path)}")

    plan = plan_pytree(tree)
    head_bytes = json.dumps(_build_head(plan, manager_state, meta)).encode()

    if fault is not None and fault.fault == "torn":
        # Simulated crash-before-rename whose rename was never made
        # durable: a partial file sits at the DESTINATION path. The
        # "crash" surfaces as a non-retryable error (a real crash would
        # not retry either).
        _write_torn(path, head_bytes, plan, fault.frac)
        raise OSError(
            f"[chaos] disk:{os.path.basename(path)}: torn write "
            "(crashed before rename was durable)")

    written = 0

    def body(f) -> None:
        nonlocal written
        written = _write_v2_stream(f, plan, head_bytes, _progress)

    _atomic_publish(path, body)

    if fault is not None and fault.fault == "flip":
        # Post-rename silent bit-flip: the save "succeeded", the bytes
        # rotted afterwards. Only digest verification can catch it.
        _flip_byte(path, fault.frac)
    return written


def _write_v2_stream(f, plan: Any, head_bytes: bytes,
                     _progress: Optional[Callable[[int], None]] = None
                     ) -> int:
    """Stream the v2 byte format — magic, head, TFTPTREE payload, and
    the trailing single-pass digest manifest — to ANY open binary
    stream. Shared by the on-disk writer (:func:`_write_v2`, under
    :func:`_atomic_publish`) and the RAM-tier image encoder
    (the JAX package's RAM tier writes the same stream into a
    ``BytesIO``). Returns the total bytes written."""
    written = 0

    def w(buf) -> None:
        nonlocal written
        f.write(buf)
        written += len(buf)
        if _progress is not None:
            _progress(written)

    w(_CKPT_MAGIC)
    w(len(head_bytes).to_bytes(4, "little"))
    w(head_bytes)
    w(plan.preamble)
    digests = []
    for _, mv in _iter_leaf_views(plan.array_leaves,
                                  DEFAULT_BATCH_BYTES):
        digests.append(zlib.crc32(mv))
        w(mv)
    mf = manifest_from(plan, digests)
    mf["head_crc32"] = zlib.crc32(head_bytes)
    mf["preamble_crc32"] = zlib.crc32(plan.preamble)
    mf_bytes = json.dumps(mf).encode()
    w(mf_bytes)
    w(len(mf_bytes).to_bytes(4, "little"))
    w(_END_MAGIC)
    return written


def save_sharded(path: str, user_state: Any,
                 manager_state: Optional[dict] = None,
                 meta: Optional[dict] = None, shards: int = 2,
                 _progress: Optional[Callable[[int], None]] = None) -> None:
    """Sharded durable save (docs/design/sharded_update.md): the
    ``{user, torchft}`` pytree's leaves are partitioned into ``shards``
    contiguous byte-balanced stripes, each written IN PARALLEL as its
    own self-verifying v2 file ``{path}.shard{k}``, then a small
    shard-set head lands at ``path`` stamping the stripe geometry, a
    per-save ``set_id`` binding the shards to this generation, and the
    usual commit/quorum provenance. The head write is the commit point:
    shards without a head are invisible orphans (their names never parse
    as step candidates), so a crash mid-save can never present a partial
    set as a checkpoint. :func:`recover`/:func:`verify` accept a set
    only when EVERY shard verifies and carries the head's ``set_id``;
    :func:`load` reassembles the stripes transparently.

    Splitting takes the monolithic single-file write off the commit
    critical path twice over: the shard writes overlap each other (and,
    under :class:`AsyncCheckpointer`, training), and each file is
    ~1/shards the size, so fsync/rename latency stops scaling with model
    size. ``shards=1`` degenerates to a one-shard set (still valid)."""
    import uuid as _uuid

    shards = max(int(shards), 1)
    tree = {
        "user": user_state,
        "torchft": manager_state or {"step": 0, "batches_committed": 0},
    }
    leaves, _treedef = tree_flatten(tree)
    sizes = [(_leaf_nbytes(leaf) if _is_array_leaf(leaf) else 0)
             for leaf in leaves]
    ranges = balanced_ranges(sizes, shards)
    set_id = _uuid.uuid4().hex
    base = os.path.basename(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)

    # Aggregate per-shard progress for the stall watchdog: any shard's
    # bytes advancing counts as progress.
    plock = threading.Lock()
    per_shard = [0] * shards

    def progress_for(k: int) -> Callable[[int], None]:
        def note(n: int) -> None:
            if _progress is None:
                return
            with plock:
                per_shard[k] = n
                total = sum(per_shard)
            _progress(total)
        return note

    infos: list = [None] * shards
    errors: list = []

    def write_shard(k: int, start: int, stop: int) -> None:
        try:
            sub = {_leaf_key(i): leaves[i] for i in range(start, stop)}
            m2 = dict(meta or {})
            m2.update(shard_index=k, shard_count=shards, set_id=set_id)
            size = _write_v2(_shard_path(path, k), sub, manager_state,
                             m2, progress_for(k))
            infos[k] = {"name": f"{base}.shard{k}",
                        "leaves": [start, stop], "size": size}
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    if shards == 1:
        write_shard(0, *ranges[0])
    else:
        ts = [threading.Thread(target=write_shard, args=(k, a, b),
                               name=f"ckpt-shard-{k}", daemon=True)
              for k, (a, b) in enumerate(ranges)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    if errors:
        raise errors[0]

    head = _build_head(plan_pytree(tree), manager_state, meta)
    head.update(format=SET_FORMAT, set_id=set_id, shard_count=shards,
                leaf_count=len(leaves), shards=infos)
    head.pop("payload_len", None)  # no single payload; sizes per shard
    body = json.dumps(head).encode()
    if len(body) > _MAX_JSON:
        raise ValueError("shard-set head implausibly large")
    payload = (_SET_MAGIC + len(body).to_bytes(4, "little") + body
               + zlib.crc32(body).to_bytes(4, "little"))

    fault = chaos.disk_fault(f"disk:{base}")
    if fault is not None and fault.fault == "torn":
        with open(path, "wb") as f:
            f.write(payload[:max(1, int(len(payload) * fault.frac))])
        raise OSError(
            f"[chaos] disk:{base}: torn write (crashed before rename "
            "was durable)")
    _atomic_publish(path, lambda f: f.write(payload))
    if fault is not None and fault.fault == "flip":
        _flip_byte(path, fault.frac)


def _leaf_key(i: int) -> str:
    """Zero-padded flat-leaf key inside a shard file: both the writer
    and the loader derive it from the leaf's flatten index, so the
    shard's ``_match_entries`` name cross-check stays meaningful."""
    return f"{i:08d}"


def _shard_path(path: str, k: int) -> str:
    return f"{path}.shard{k}"


def _read_set_head(path: str) -> Optional[dict]:
    """Parse a shard-set head file; None when ``path`` is not one
    (callers fall through to the v2 single-file path). Raises
    :class:`CheckpointCorruptError` for a torn/corrupt head."""
    with open(path, "rb") as f:
        magic = f.read(len(_SET_MAGIC))
        if magic != _SET_MAGIC:
            return None
        ln = int.from_bytes(_read_exact(f, 4, "set head length"), "little")
        if ln > _MAX_JSON:
            raise CheckpointCorruptError(
                f"shard-set head implausibly large ({ln}B)")
        body = _read_exact(f, ln, "set head")
        crc = int.from_bytes(_read_exact(f, 4, "set head crc"), "little")
    if zlib.crc32(body) != crc:
        raise CheckpointCorruptError(
            "shard-set head failed digest verification")
    try:
        head = json.loads(body)
    except ValueError as e:
        raise CheckpointCorruptError(f"unparsable shard-set head: {e}")
    if not isinstance(head, dict) or head.get("format") != SET_FORMAT:
        raise CheckpointCorruptError("invalid shard-set head")
    return head


def _verify_set(path: str, head: dict) -> dict:
    """Verify every member shard of a set: present, internally
    digest-clean (full v2 :func:`verify`), stamped with the head's
    ``set_id`` (a stale same-name shard from an older save generation
    must not pass), and jointly covering ``[0, leaf_count)``. Any
    failure condemns the WHOLE set."""
    d = os.path.dirname(os.path.abspath(path))
    n_leaves = int(head.get("leaf_count", -1))
    infos = head.get("shards")
    if n_leaves < 0 or not isinstance(infos, list) or not infos:
        raise CheckpointCorruptError("shard-set head missing geometry")
    expect = 0
    for s in infos:
        a, b = int(s["leaves"][0]), int(s["leaves"][1])
        if a != expect or b < a:
            raise CheckpointCorruptError(
                f"shard-set stripe geometry torn at leaf {a} "
                f"(expected {expect})")
        expect = b
        sp = os.path.join(d, s["name"])
        if not os.path.isfile(sp):
            raise CheckpointCorruptError(f"missing shard {s['name']}")
        sh = verify(sp)
        if sh.get("set_id") != head.get("set_id"):
            raise CheckpointCorruptError(
                f"shard {s['name']} belongs to a different save "
                "generation (set_id mismatch)")
    if expect != n_leaves:
        raise CheckpointCorruptError(
            f"shard-set covers {expect} leaves, head claims {n_leaves}")
    head["path"] = path
    return head


def _quarantine_set_members(path: str) -> float:
    """Move a condemned set's shard files aside with its head (best
    effort, by name pattern — the head may be unreadable). Returns how
    many were quarantined."""
    import glob as _glob

    moved = 0.0
    for sp in _glob.glob(_glob.escape(path) + ".shard*"):
        if sp.endswith(_QUARANTINE_SUFFIX):
            continue
        if _quarantine(sp) is not None:
            moved += 1
    return moved


def _write_torn(path: str, head_bytes: bytes, plan: Any,
                frac: float) -> None:
    """Write a ``frac``-prefix of the serialized checkpoint directly at
    ``path`` (chaos torn-write fault): the torn artifact recovery must
    quarantine."""
    limit = max(1, int((len(_CKPT_MAGIC) + 4 + len(head_bytes)
                        + plan.total_len) * frac))
    with open(path, "wb") as f:
        budget = limit

        def w(buf) -> int:
            nonlocal budget
            take = buf[:budget] if len(buf) > budget else buf
            f.write(take)
            budget -= len(take)
            return budget

        if w(_CKPT_MAGIC) <= 0:
            return
        if w(len(head_bytes).to_bytes(4, "little")) <= 0:
            return
        if w(head_bytes) <= 0:
            return
        if w(plan.preamble) <= 0:
            return
        for _, mv in _iter_leaf_views(plan.array_leaves,
                                      DEFAULT_BATCH_BYTES):
            if w(mv) <= 0:
                return


def _flip_byte(path: str, frac: float) -> None:
    size = os.path.getsize(path)
    if size == 0:
        return
    off = min(int(size * frac), size - 1)
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def _read_exact(f, n: int, what: str) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise CheckpointCorruptError(
            f"truncated checkpoint ({what}: wanted {n}B, got {len(buf)}B)")
    return buf


def _read_head(f) -> Tuple[dict, bytes]:
    """Parse magic + head json from an open file positioned at 0.
    Raises :class:`CheckpointUnverifiableError` for legacy TFTPTREE
    files and :class:`CheckpointCorruptError` for anything else that is
    not a well-formed v2 head."""
    magic = f.read(len(_CKPT_MAGIC))
    if magic == _TREE_MAGIC:
        raise CheckpointUnverifiableError(
            "legacy unversioned checkpoint (bare pytree stream, no "
            "digest manifest)")
    if magic != _CKPT_MAGIC:
        raise CheckpointCorruptError(
            f"not a durable checkpoint (magic {magic!r})")
    head_len = int.from_bytes(_read_exact(f, 4, "head length"), "little")
    if head_len > _MAX_JSON:
        raise CheckpointCorruptError(
            f"checkpoint head implausibly large ({head_len}B)")
    head_bytes = _read_exact(f, head_len, "head")
    try:
        head = json.loads(head_bytes)
    except ValueError as e:
        raise CheckpointCorruptError(f"unparsable checkpoint head: {e}")
    if not isinstance(head, dict):
        raise CheckpointCorruptError("checkpoint head is not an object")
    return head, head_bytes


def _read_trailer(f, file_size: int, payload_end: int) -> dict:
    """Parse the trailing ``[manifest][u32 len][end magic]``; the
    manifest must begin exactly at ``payload_end``."""
    if file_size < payload_end + 4 + len(_END_MAGIC):
        raise CheckpointCorruptError(
            f"truncated checkpoint (file {file_size}B, payload ends at "
            f"{payload_end}B — no room for the manifest trailer)")
    f.seek(file_size - 4 - len(_END_MAGIC))
    tail = _read_exact(f, 4 + len(_END_MAGIC), "trailer")
    if tail[4:] != _END_MAGIC:
        raise CheckpointCorruptError(
            "missing end marker (torn or still-being-written file)")
    mf_len = int.from_bytes(tail[:4], "little")
    mf_start = file_size - 4 - len(_END_MAGIC) - mf_len
    if mf_len > _MAX_JSON or mf_start != payload_end:
        raise CheckpointCorruptError(
            f"manifest geometry mismatch (manifest {mf_len}B at "
            f"{mf_start}, payload ends at {payload_end})")
    f.seek(mf_start)
    try:
        mf = json.loads(_read_exact(f, mf_len, "manifest"))
    except ValueError as e:
        raise CheckpointCorruptError(f"unparsable manifest: {e}")
    if not isinstance(mf, dict) or mf.get("digest") != "crc32":
        raise CheckpointCorruptError("invalid manifest")
    return mf


def _stream_size(f) -> int:
    """Total byte length of an open binary stream: ``fstat`` for real
    files, seek-to-end (position-restoring) for in-memory streams — the
    RAM checkpoint tier verifies/loads ``BytesIO`` images through the
    same code path as on-disk files."""
    try:
        return os.fstat(f.fileno()).st_size
    except (OSError, AttributeError, io.UnsupportedOperation):
        pos = f.tell()
        size = f.seek(0, os.SEEK_END)
        f.seek(pos)
        return size


def _open_verified(f) -> Tuple[dict, dict, int]:
    """Shared structural open for :func:`load`/:func:`verify`: parse +
    cross-check head and trailer manifest (head digest included).
    Returns ``(head, manifest, payload_start)`` with ``f`` positioned at
    the payload."""
    head, head_bytes = _read_head(f)
    payload_start = len(_CKPT_MAGIC) + 4 + len(head_bytes)
    payload_len = int(head.get("payload_len", -1))
    file_size = _stream_size(f)
    if payload_len < 0 or payload_start + payload_len > file_size:
        raise CheckpointCorruptError(
            f"truncated checkpoint (payload claims {payload_len}B, file "
            f"is {file_size}B)")
    mf = _read_trailer(f, file_size, payload_start + payload_len)
    if int(mf.get("total_len", -1)) != payload_len:
        raise CheckpointCorruptError(
            "head/manifest payload length mismatch")
    if "head_crc32" in mf and zlib.crc32(head_bytes) != int(
            mf["head_crc32"]):
        raise CheckpointCorruptError(
            "checkpoint head failed digest verification")
    f.seek(payload_start)
    return head, mf, payload_start


def read_meta(path: str) -> dict:
    """Head-only peek at a durable checkpoint (single-file v2 OR a
    shard-set head): format, step, batches_committed, commit marker,
    quorum metadata — sets additionally carry the stripe geometry. Cheap
    (no payload scan — use :func:`verify` to prove integrity)."""
    head = _read_set_head(path)
    if head is not None:
        head["path"] = path
        return head
    with open(path, "rb") as f:
        head, _ = _read_head(f)
    head["path"] = path
    return head


def verify(path: str) -> dict:
    """Validate a durable checkpoint WITHOUT loading it: structural
    (magic, head, trailer geometry) plus a full digest scan — head,
    payload preamble, and every array leaf's crc32 against the manifest.
    A shard-set head verifies every member shard (presence, digests,
    same-generation ``set_id``, stripe coverage) and fails the WHOLE set
    on any defect. No ``device_put`` is involved. Returns the head
    metadata on success; raises :class:`CheckpointCorruptError`
    (torn/bit-flipped/truncated/missing-shard) or
    :class:`CheckpointUnverifiableError` (legacy format)."""
    head = _read_set_head(path)
    if head is not None:
        return _verify_set(path, head)
    with open(path, "rb") as f:
        head = _verify_stream(f)
    head["path"] = path
    return head


def _verify_stream(f) -> dict:
    """Full digest scan of an open v2 stream (head, preamble, every
    array leaf's crc32 against the trailing manifest) — the body of
    :func:`verify`, shared with the RAM tier so a peer-pushed image is
    proven bitwise-correct before acceptance. Returns the head."""
    head, mf, _ = _open_verified(f)
    preamble = _read_exact(f, int(mf["preamble_len"]), "preamble")
    if "preamble_crc32" in mf and zlib.crc32(preamble) != int(
            mf["preamble_crc32"]):
        raise CheckpointCorruptError(
            "payload preamble failed digest verification")
    for e in mf["leaves"]:
        if e.get("kind") != "array":
            continue
        remaining = int(e["nbytes"])
        crc = 0
        while remaining > 0:
            chunk = f.read(min(remaining, 8 << 20))
            if not chunk:
                raise CheckpointCorruptError(
                    f"truncated checkpoint (leaf {e['key']!r})")
            crc = zlib.crc32(chunk, crc)
            remaining -= len(chunk)
        if crc != int(e["crc32"]):
            raise CheckpointCorruptError(
                f"leaf {e['key']!r} failed digest verification "
                f"(crc32 {crc:08x} != manifest {int(e['crc32']):08x})")
    return head


def load(path: str, target: Any, device_put: bool = True,
         ) -> Tuple[Any, dict]:
    """Read a checkpoint back into ``target``'s structure (and, when
    ``device_put``, onto each target tensor's device and dtype:
    :func:`~torchft_tpu_torch.serialization.device_put_like`). Returns
    ``(user_state, manager_state)``. Accepts all three on-disk
    spellings: a shard-set head (stripes reassembled transparently), a
    single-file v2, or a legacy bare-pytree file.

    v2 files (shards included) are digest-verified DURING the load: each
    leaf's crc32 is checked against the manifest after the read and
    before ``device_put`` — corrupt bytes never reach the device (the
    same discipline as the heal path). Legacy bare-pytree files still
    load, unverified, with a warning."""
    head = _read_set_head(path)
    if head is not None:
        return _load_set(path, head, target, device_put)
    wrapped = {"user": target,
               "torchft": {"step": 0, "batches_committed": 0}}
    dput = device_put_like if device_put else None
    try:
        tree = _load_v2_tree(path, wrapped, dput)
    except CheckpointUnverifiableError:
        logger.warning(
            "loading legacy unverified checkpoint %s (no digest "
            "manifest; re-save to upgrade)", path)
        with open(path, "rb") as f:
            tree = load_pytree_from(f, wrapped, device_put_fn=dput)
    return tree["user"], tree["torchft"]


def _load_v2_tree(path: str, target_tree: Any,
                  dput: Optional[Callable],
                  expect_set_id: Optional[str] = None) -> Any:
    """Digest-verified v2 load into an arbitrary target tree (shared by
    :func:`load` and the per-shard reads of :func:`_load_set`, which
    passes ``expect_set_id`` so a stale same-name shard from an older
    save generation fails the load instead of splicing in silently)."""
    with open(path, "rb") as f:
        return _load_v2_stream(f, target_tree, dput,
                               expect_set_id=expect_set_id,
                               what=os.path.basename(path))


def _load_v2_stream(f, target_tree: Any, dput: Optional[Callable],
                    expect_set_id: Optional[str] = None,
                    what: str = "stream") -> Any:
    """Digest-verified v2 load from an open binary stream — the body of
    :func:`_load_v2_tree`, reading any open binary stream."""
    head, mf, payload_start = _open_verified(f)
    if expect_set_id is not None and head.get("set_id") != \
            expect_set_id:
        raise CheckpointCorruptError(
            f"shard {what} belongs to a different "
            "save generation (set_id mismatch)")
    # The payload preamble json carries 'py'-kind leaf VALUES inline
    # (step counters, scalars): verify its digest too, or a bit flip
    # there would load silently while every array leaf checks out.
    preamble = _read_exact(f, int(mf["preamble_len"]), "preamble")
    if "preamble_crc32" in mf and zlib.crc32(preamble) != int(
            mf["preamble_crc32"]):
        raise CheckpointCorruptError(
            "payload preamble failed digest verification")
    f.seek(payload_start)
    digests = [int(e["crc32"]) for e in mf["leaves"]
               if e.get("kind") == "array"]
    try:
        return load_pytree_from(f, target_tree, device_put_fn=dput,
                                digests=digests)
    except LeafDigestMismatch as e:
        raise CheckpointCorruptError(str(e)) from e


def _load_set(path: str, head: dict, target: Any,
              device_put: bool) -> Tuple[Any, dict]:
    """Reassemble a sharded checkpoint: load each stripe file into its
    flat-leaf slots and unflatten once. The head's ``leaf_count`` must
    match the target's flatten (the untrusted-header discipline —
    a geometry/structure mismatch fails loudly, never permutes)."""
    wrapped = {"user": target,
               "torchft": {"step": 0, "batches_committed": 0}}
    leaves, treedef = tree_flatten(wrapped)
    if int(head.get("leaf_count", -1)) != len(leaves):
        raise ValueError(
            f"sharded checkpoint has {head.get('leaf_count')} leaves, "
            f"target has {len(leaves)}")
    dput = device_put_like if device_put else None
    out = list(leaves)
    d = os.path.dirname(os.path.abspath(path))
    for s in head.get("shards", []):
        a, b = int(s["leaves"][0]), int(s["leaves"][1])
        if b <= a:
            continue
        sub_target = {_leaf_key(i): leaves[i] for i in range(a, b)}
        sub = _load_v2_tree(os.path.join(d, s["name"]), sub_target, dput,
                            expect_set_id=head.get("set_id"))
        for i in range(a, b):
            out[i] = sub[_leaf_key(i)]
    full = tree_unflatten(treedef, out)
    return full["user"], full["torchft"]


def _legacy_intact(path: str) -> bool:
    """Cheap structural check of a legacy (bare ``TFTPTREE``) file: the
    header parses and the file holds exactly the body it declares. No
    digests exist to verify, but this catches the torn/truncated legacy
    artifacts a kill-all leaves behind — recover()'s legacy last resort
    must not hand load() a file that cannot even be read."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if f.read(len(_TREE_MAGIC)) != _TREE_MAGIC:
                return False
            hdr_len = int.from_bytes(f.read(4), "little")
            if hdr_len > _MAX_JSON:
                return False
            hdr = f.read(hdr_len)
            if len(hdr) != hdr_len:
                return False
            header = json.loads(hdr)
        body = 0
        for e in header.get("leaves", []):
            if e.get("kind") == "array":
                body = max(body, int(e["offset"]) + int(e["nbytes"]))
        return size == len(_TREE_MAGIC) + 4 + hdr_len + body
    except (OSError, ValueError, KeyError, TypeError):
        return False


def _quarantine(path: str) -> Optional[str]:
    """Move a corrupt checkpoint aside (``<name>.corrupt``) so no later
    scan reconsiders it, and fsync the directory so the quarantine
    itself is durable. Returns the new path (None when the rename
    failed)."""
    dst = path + _QUARANTINE_SUFFIX
    try:
        os.replace(path, dst)
    except OSError:
        logger.exception("failed to quarantine corrupt checkpoint %s",
                         path)
        return None
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    return dst


def recover(directory: str, prefix: str = "ckpt_",
            quarantine: bool = True, allow_legacy: bool = True,
            stats: Optional[Dict[str, float]] = None) -> Optional[str]:
    """Cold-start recovery scan: walk ``{prefix}{step}`` candidates
    NEWEST-FIRST, fully verify each (:func:`verify`), quarantine
    torn/corrupt files, and return the path of the newest snapshot that
    is both **verified** and **committed** (head ``committed`` marker) —
    or ``None`` when no usable snapshot exists.

    Corrupt files are renamed to ``<name>.corrupt`` (skipped by every
    later scan) so one torn newest file can never wedge recovery into
    re-examining it forever. Legacy (bare-pytree) files cannot be
    verified; they are skipped in favor of any v2 snapshot — but when NO
    verified snapshot exists at all and ``allow_legacy`` (default), the
    newest legacy file is returned as a last resort (``load`` still
    reads it), so upgrading a job does not silently restart training
    from scratch. ``stats``, when given, receives
    ``ckpt_corrupt_quarantined`` (files actually moved aside this scan),
    ``ckpt_recover_fallbacks`` (newer candidates skipped before the
    returned one), and ``ckpt_recover_legacy`` (1 when the legacy last
    resort was used)."""
    quarantined = 0.0
    fallbacks = 0.0
    legacy_used = 0.0
    chosen: Optional[str] = None
    newest_legacy: Optional[str] = None
    try:
        for _, name in reversed(_list_steps(directory, prefix)):
            path = os.path.join(directory, name)
            try:
                head = verify(path)
            except CheckpointUnverifiableError:
                logger.warning(
                    "recover: skipping legacy unverifiable checkpoint "
                    "%s", path)
                # Last-resort candidate only if it is at least
                # structurally whole — a torn legacy file would crash
                # the load this scan exists to protect.
                if newest_legacy is None and _legacy_intact(path):
                    newest_legacy = path
                fallbacks += 1
                continue
            except (CheckpointCorruptError, OSError, ValueError) as e:
                logger.warning(
                    "recover: quarantining corrupt checkpoint %s (%s)",
                    path, e)
                if quarantine:
                    if _quarantine(path) is not None:
                        quarantined += 1
                    # A condemned shard set takes its member files with
                    # it — one bad shard fails the WHOLE set, and its
                    # survivors must not shadow anything later.
                    quarantined += _quarantine_set_members(path)
                fallbacks += 1
                continue
            if not head.get("committed", True):
                logger.warning(
                    "recover: skipping uncommitted snapshot %s", path)
                fallbacks += 1
                continue
            chosen = path
            break
        if chosen is None and allow_legacy and newest_legacy is not None:
            logger.warning(
                "recover: no verified snapshot; falling back to the "
                "newest LEGACY (unverifiable) checkpoint %s — re-save "
                "to upgrade it to the digest-covered format",
                newest_legacy)
            chosen = newest_legacy
            legacy_used = 1.0
    finally:
        if stats is not None:
            stats["ckpt_corrupt_quarantined"] = (
                stats.get("ckpt_corrupt_quarantined", 0.0) + quarantined)
            stats["ckpt_recover_fallbacks"] = (
                stats.get("ckpt_recover_fallbacks", 0.0) + fallbacks)
            stats["ckpt_recover_legacy"] = (
                stats.get("ckpt_recover_legacy", 0.0) + legacy_used)
    if chosen is not None and not legacy_used:
        logger.info("recover: newest verified committed checkpoint: %s",
                    chosen)
    elif chosen is None:
        logger.warning("recover: no usable checkpoint under "
                       "%s (prefix %r)", directory, prefix)
    return chosen


class AsyncCheckpointer:
    """Durable checkpointing OFF the training loop's critical path.

    ``save_async`` captures an **on-device snapshot** of the state (every
    tensor cloned on its own device, one pass at HBM bandwidth —
    :func:`torchft_tpu_torch.checkpointing._snapshot_tree`, the snapshot
    the healing server takes), then a single background daemon thread
    does the device→host copy, the digests and the atomic write while
    training continues: the clones are ordered on the card's stream
    before the in-place optimizer update that follows, so the file holds
    exactly the state at the save. The loop pays the snapshot's dispatch,
    not the copy to the host or the disk. One snapshot is alive at a
    time: the state's size again on the card.

    One save is in flight at a time: a new ``save_async`` first waits for
    the previous write to finish (a durable checkpoint must never be
    overtaken by a newer one racing the same file family). A failed write
    surfaces on its Future AND re-raises on the next ``save_async``/
    ``wait`` call, so callers that never inspect futures still find out.

    **Stall watchdog**: a write that makes NO progress for
    ``stall_timeout_sec`` (env ``TORCHFT_CKPT_STALL_SEC``, default 60 —
    the wedged-NFS case) is abandoned: ``wait``/``save_async``/
    ``shutdown`` return within the timeout with a
    :class:`CheckpointStallError` instead of hanging forever; the
    abandoned daemon thread can no longer latch errors or block process
    exit. Progress (bytes hitting the file) resets the clock, so a slow
    but moving disk is never killed.

    **Fatal-but-reported errors**: ENOSPC/EROFS/EDQUOT cannot succeed on
    retry; they count into ``ckpt_save_fatal`` and :meth:`last_error`
    (surfaced through ``Manager.metrics()``/``/metrics.json``) in
    addition to re-raising on the next call.

    Args:
        keep: when > 0, prune all but the newest ``keep`` checkpoint files
            matching ``{prefix}{step}`` in the directory after each
            successful save. Pruning NEVER deletes the newest checkpoint
            that passes :func:`verify`, even when newer (corrupt) files
            exist — the last provably-good snapshot always survives; the
            verify doubles as a read-back check of the file just
            written.
        retry_policy: when given, transient filesystem errors (EIO /
            EAGAIN / ESTALE / ETIMEDOUT — the NFS-blip class) retry the
            whole atomic write under this policy. Safe because the write
            is temp-file + rename: a failed attempt leaves no partial
            checkpoint to collide with. ``None`` (default) keeps
            fail-on-first-error behavior.
        retry_stats: optional shared
            :class:`~torchft_tpu_torch.retry.RetryStats` the retries are
            counted into.
        stall_timeout_sec: no-progress watchdog, see above.
        shards: when > 1, every save is written via
            :func:`save_sharded` — per-stripe files in parallel plus a
            shard-set head (env ``TORCHFT_CKPT_SHARDS`` overrides the
            default). Recovery handles both formats transparently.
    """

    def __init__(self, keep: int = 0, prefix: str = "ckpt_",
                 retry_policy: Optional[RetryPolicy] = None,
                 retry_stats: Optional[RetryStats] = None,
                 stall_timeout_sec: Optional[float] = None,
                 shards: Optional[int] = None) -> None:
        if stall_timeout_sec is None:
            stall_timeout_sec = float(
                os.environ.get("TORCHFT_CKPT_STALL_SEC", 60.0))
        if shards is None:
            shards = int(os.environ.get("TORCHFT_CKPT_SHARDS", 0) or 0)
        self._shards = max(int(shards), 0)
        self._stall_sec = float(stall_timeout_sec)
        self._job: Optional[_SaveJob] = None
        self._error: Optional[BaseException] = None
        self._keep = keep
        self._prefix = prefix
        self._retry_policy = retry_policy
        self._retry_stats = retry_stats
        self._lock = threading.Lock()
        self._metrics: Dict[str, float] = {
            "ckpt_save_count": 0.0,
            "ckpt_save_errors": 0.0,
            "ckpt_save_fatal": 0.0,
            "ckpt_save_stalls": 0.0,
            "ckpt_save_bytes_total": 0.0,
            "ckpt_save_ms_total": 0.0,
        }
        self._last_error: Optional[str] = None

    def metrics(self) -> Dict[str, float]:
        """Counters: saves, errors (``ckpt_save_fatal`` = the
        ENOSPC/EROFS class), stalls, bytes, cumulative write ms.
        Merged into ``Manager.metrics()`` when attached via
        :meth:`Manager.save_durable`."""
        with self._lock:
            return dict(self._metrics)

    def last_error(self) -> Optional[str]:
        """Most recent save failure as a string (sticky; for
        dashboards), or None."""
        with self._lock:
            return self._last_error

    def _raise_pending_error(self) -> None:
        with self._lock:
            e, self._error = self._error, None
        if e is not None:
            raise RuntimeError(
                "previous async checkpoint save failed") from e

    def save_async(self, path: str, user_state: Any,
                   manager_state: Optional[dict] = None,
                   meta: Optional[dict] = None) -> Future:
        """Snapshot now, write in the background; returns a Future that
        resolves to ``path`` when the checkpoint is durable. ``meta``
        merges provenance into the file head (see :func:`save`)."""
        self.wait()  # serializes saves AND re-raises a latched error
        snap_user = _snapshot_tree(user_state)
        snap_mgr = dict(manager_state) if manager_state else None
        snap_meta = dict(meta) if meta else None

        job = _SaveJob(path)
        t = threading.Thread(
            target=self._write, args=(job, snap_user, snap_mgr, snap_meta),
            daemon=True, name="ckpt_writer")
        self._job = job
        t.start()
        return job.future

    def _write(self, job: "_SaveJob", user: Any, mgr: Optional[dict],
               meta: Optional[dict]) -> None:
        t0 = time.perf_counter()

        def op() -> None:
            if self._shards > 1:
                save_sharded(job.path, user, mgr, meta=meta,
                             shards=self._shards, _progress=job.note)
            else:
                save(job.path, user, mgr, meta=meta, _progress=job.note)

        try:
            if self._retry_policy is not None:
                call_with_retry(op, self._retry_policy,
                                classify=_io_transient,
                                stats=self._retry_stats, op="ckpt.save")
            else:
                op()
            if self._keep > 0:
                self._prune(os.path.dirname(os.path.abspath(job.path)))
            with self._lock:
                self._metrics["ckpt_save_count"] += 1
                self._metrics["ckpt_save_bytes_total"] += job.bytes_written
                self._metrics["ckpt_save_ms_total"] += (
                    time.perf_counter() - t0) * 1e3
            job.future.set_result(job.path)
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            with self._lock:
                self._metrics["ckpt_save_errors"] += 1
                if _io_fatal(e):
                    self._metrics["ckpt_save_fatal"] += 1
                self._last_error = f"{type(e).__name__}: {e}"
                # An abandoned (stalled) job must not latch: its owner
                # already recorded a CheckpointStallError and moved on.
                if not job.abandoned and self._error is None:
                    self._error = e
            try:
                job.future.set_exception(e)
            except BaseException:  # future abandoned mid-stall
                pass

    def _prune(self, directory: str) -> None:
        """Delete all but the newest ``keep`` checkpoints — but never
        the newest one that VERIFIES, even when newer corrupt files
        exist (deleting the last good snapshot because garbage outranks
        it would turn retention into data loss)."""
        steps = _list_steps(directory, self._prefix)
        protected = {name for _, name in steps[-self._keep:]}
        for _, name in reversed(steps):
            p = os.path.join(directory, name)
            try:
                verify(p)
            except (CheckpointUnverifiableError, CheckpointCorruptError,
                    OSError, ValueError) as e:
                if name in protected:
                    logger.warning(
                        "prune: retained checkpoint %s does not verify "
                        "(%s)", p, e)
                continue
            protected.add(name)
            break
        import glob as _glob

        for _, name in steps:
            if name in protected:
                continue
            p = os.path.join(directory, name)
            try:
                os.unlink(p)
            except OSError:
                pass
            # A pruned shard-set head takes its stripe files with it —
            # headless shards are invisible orphans that would otherwise
            # leak disk forever.
            for sp in _glob.glob(_glob.escape(p) + ".shard*"):
                try:
                    os.unlink(sp)
                except OSError:
                    pass

    def wait(self) -> None:
        """Block until the in-flight save (if any) is durable — or until
        the stall watchdog abandons it (no progress for
        ``stall_timeout_sec``)."""
        job, self._job = self._job, None
        if job is not None:
            while True:
                try:
                    job.future.result(timeout=0.05)
                    break
                except FutureTimeout:
                    if (time.monotonic() - job.last_progress
                            > self._stall_sec):
                        job.abandoned = True
                        e = CheckpointStallError(
                            f"durable checkpoint write to {job.path} "
                            f"made no progress for {self._stall_sec:.0f}s"
                            "; abandoning the writer")
                        with self._lock:
                            self._metrics["ckpt_save_stalls"] += 1
                            self._last_error = (
                                f"CheckpointStallError: {e}")
                            if self._error is None:
                                self._error = e
                        break
                except Exception:
                    # Recorded in _error by the writer; re-raised below.
                    # (KeyboardInterrupt/SystemExit raised in THIS
                    # thread while waiting must propagate, not be
                    # swallowed into a normal return.)
                    break
        self._raise_pending_error()

    def shutdown(self) -> None:
        """Drain (or abandon, if stalled) the in-flight save. Returns
        within the stall timeout even against a wedged filesystem; the
        writer thread is a daemon, so it can never block process exit."""
        self.wait()


class _SaveJob:
    """One background save: its Future, progress clock, and the
    abandoned latch the stall watchdog uses to disown it."""

    __slots__ = ("path", "future", "bytes_written", "last_progress",
                 "abandoned")

    def __init__(self, path: str) -> None:
        self.path = path
        self.future: Future = Future()
        self.bytes_written = 0
        self.last_progress = time.monotonic()
        self.abandoned = False

    def note(self, nbytes: int) -> None:
        self.bytes_written = nbytes
        self.last_progress = time.monotonic()


def _list_steps(directory: str, prefix: str) -> list:
    """``(step, name)`` pairs for files named ``{prefix}{step}``, sorted by
    step — the one scan shared by :func:`latest`, :func:`recover`, and
    retention pruning. Unparsable names (including quarantined
    ``*.corrupt`` files) and zero-byte files are never candidates — a
    torn empty file must not shadow the previous good checkpoint."""
    steps = []
    if not os.path.isdir(directory):
        return steps
    for name in os.listdir(directory):
        if not name.startswith(prefix):
            continue
        try:
            step = int(name[len(prefix):])
        except ValueError:
            continue
        try:
            if os.path.getsize(os.path.join(directory, name)) == 0:
                continue
        except OSError:
            continue  # vanished mid-scan
        steps.append((step, name))
    return sorted(steps)


def latest(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Highest-step checkpoint file ``{prefix}{step}`` in ``directory``.
    No integrity check — prefer :func:`recover`, which skips torn/corrupt
    files instead of handing them to ``load``."""
    steps = _list_steps(directory, prefix)
    return os.path.join(directory, steps[-1][1]) if steps else None
