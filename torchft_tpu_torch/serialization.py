"""Pytree (de)serialization for checkpoint transfer and host collectives.

The reference streams ``torch.save``/``torch.load`` state dicts over HTTP for
healing (torchft/checkpointing.py:50-103). Here state is a JAX
pytree (params / optimizer state / manager metadata), serialized with a small
self-describing binary format:

    [8B magic "TFTPTREE"][u32 header_len][header json][raw array bytes...]

The header carries the flattened key paths, dtypes, and shapes; leaves are
copied to the host (``Tensor.cpu()``) and written raw. Restoring goes
through ``.to(device)`` of the target leaf, so weights that arrive over the
network land directly on the healer's device.

The format, the key paths and the leaf order are the JAX package's
(``torchft_tpu/serialization.py``): state dicts flatten in sorted-key order
(:mod:`torchft_tpu_torch.utils`), so one tree serializes to the same bytes
and the same manifest in both packages. bfloat16 leaves, which numpy cannot
hold, cross the host as their raw 16-bit words and are named
``"bfloat16"`` in the header, as the JAX package names them; they restore
as bfloat16 tensors.

Both directions stream: the header is computed from array *metadata* (no
data fetched), then :func:`iter_pytree_chunks` materializes one leaf at a
time and yields zero-copy memoryview slices, and the heal client
(:mod:`torchft_tpu_torch.checkpointing`) fills preallocated buffers
leaf-by-leaf with per-leaf device placement. Peak extra host RAM on either
side is O(largest leaf + chunk), not O(checkpoint) — healing a large model
cannot double host RAM the way a monolithic ``bytes`` round-trip would (the
reference streams via ``torch.save`` directly to the socket for the same
reason, torchft/checkpointing.py:63-72).

No pickle anywhere — unlike ``torch.load``, a malicious checkpoint peer
cannot execute code on the healer.
"""

from __future__ import annotations

import json
import threading
import zlib
from typing import (Any, BinaryIO, Callable, Iterator, List, Optional,
                    Tuple)

import numpy as np
import torch

from torchft_tpu_torch.utils import (key_str, tree_flatten_with_path,
                                     tree_unflatten)

_MAGIC = b"TFTPTREE"
DEFAULT_CHUNK_BYTES = 8 * 1024 * 1024


class LeafDigestMismatch(ValueError):
    """A leaf's bytes failed crc32 verification against its manifest
    digest — corrupt or torn data that must never reach the device."""


_TORCH_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_BY_NAME = {v: k for k, v in _TORCH_NAMES.items()}


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        try:
            return _TORCH_NAMES[leaf.dtype]
        except KeyError:
            raise TypeError(f"no serialized name for {leaf.dtype}") from None
    return np.dtype(leaf.dtype).name


def _itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def _carrier(name: str) -> np.dtype:
    """numpy dtype of a leaf's host buffer: bfloat16 travels as uint16."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _host_array(leaf: Any) -> np.ndarray:
    """Contiguous host copy (or view) of an array leaf, as numpy; bfloat16
    tensors come out as their uint16 words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.cpu().contiguous().numpy()
        return arr.view(np.uint16) if leaf.dtype == torch.bfloat16 else arr
    return np.require(leaf, requirements="C")


def _from_carrier(arr: np.ndarray, name: str) -> Any:
    """A host buffer as the leaf it encodes: numpy, or a bfloat16 CPU
    tensor for ``"bfloat16"``."""
    if name == "bfloat16":
        if not arr.flags.writeable:  # a view onto an immutable buffer
            arr = arr.copy()
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr

# Non-array leaves (python ints/floats/strings/bools/None) are stored in the
# header directly; arrays are stored as raw bytes.


def _key_str(path) -> str:
    return key_str(path)


def _is_array_leaf(leaf: Any) -> bool:
    return isinstance(leaf, (np.ndarray, np.generic, torch.Tensor))


class PytreePlan:
    """Streaming plan for one serialized pytree: the preamble (magic +
    header), the total serialized length, the array leaves in body order,
    and the parsed header dict. Iterates/unpacks like the historical
    ``(preamble, total_len, array_leaves)`` tuple so existing callers keep
    working.

    Per-leaf content digests (:meth:`digests`) are computed LAZILY — the
    plan itself stays metadata-only (no device data fetched) until a
    caller (the checkpoint server's manifest endpoint) actually needs
    them, and the one digesting pass is cached so N healers / resumed
    attempts against the same snapshot pay for it once."""

    __slots__ = ("preamble", "total_len", "array_leaves", "header",
                 "_digests", "_digest_lock")

    def __init__(self, preamble: bytes, total_len: int,
                 array_leaves: list, header: dict) -> None:
        self.preamble = preamble
        self.total_len = total_len
        self.array_leaves = array_leaves
        self.header = header
        self._digests: Optional[List[int]] = None
        self._digest_lock = threading.Lock()

    # --- legacy (preamble, total_len, array_leaves) tuple protocol ------
    def __iter__(self):
        return iter((self.preamble, self.total_len, self.array_leaves))

    def __getitem__(self, i):
        return (self.preamble, self.total_len, self.array_leaves)[i]

    def __len__(self) -> int:
        return 3

    def digests(self, batch_bytes: int = 0) -> List[int]:
        """Per-array-leaf crc32 of the raw serialized bytes, in body
        order. Computed once (a batched ``device_get`` pass at O(batch)
        host RAM, like streaming) and cached; safe under concurrent
        manifest requests. crc32 is not cryptographic — it detects
        truncation/corruption in transit, and doubles as the runtime
        check of the cross-donor same-step bitwise-identity invariant
        (donors for one step must produce identical digests)."""
        with self._digest_lock:
            if self._digests is None:
                bb = batch_bytes or DEFAULT_BATCH_BYTES
                self._digests = [
                    zlib.crc32(mv)
                    for _, mv in _iter_leaf_views(self.array_leaves, bb)
                ]
            return list(self._digests)


def manifest_from(plan: PytreePlan,
                  digests: Optional[List[int]] = None) -> dict:
    """Digest manifest of one serialized pytree: the header's leaf
    entries with each array entry annotated with its ``crc32`` content
    digest, plus the stream geometry (``preamble_len``/``total_len``) a
    range-resuming or verifying reader needs. The shared spelling under
    the heal transport's ``/manifest`` endpoint and the durable
    checkpoint trailer (:mod:`torchft_tpu.checkpoint_io`). ``digests``
    reuses crcs already computed (e.g. fused into a write pass);
    otherwise :meth:`PytreePlan.digests` fetches and digests the
    leaves."""
    digs = iter(digests if digests is not None else plan.digests())
    leaves = []
    for e in plan.header["leaves"]:
        e = dict(e)
        if e["kind"] == "array":
            e["crc32"] = next(digs)
        leaves.append(e)
    return {
        "digest": "crc32",
        "preamble_len": len(plan.preamble),
        "total_len": int(plan.total_len),
        "leaves": leaves,
    }


def plan_pytree(tree: Any) -> PytreePlan:
    """Compute the serialized header from leaf *metadata* only — no device
    data is fetched. Returns a :class:`PytreePlan` (unpacks as the legacy
    ``(preamble_bytes, total_len, array_leaves)`` tuple) where
    ``preamble_bytes`` is magic+header, ``total_len`` the full serialized
    size (so HTTP can send Content-Length before streaming), and
    ``array_leaves`` the leaves whose raw bytes follow, in body order."""
    leaves_with_path = tree_flatten_with_path(tree)[0]
    header: dict = {"leaves": []}
    array_leaves: list = []
    offset = 0
    for path, leaf in leaves_with_path:
        key = _key_str(path)
        if _is_array_leaf(leaf):
            name = _dtype_name(leaf)
            shape = list(leaf.shape)
            nbytes = int(np.prod(shape, dtype=np.int64)) * _itemsize(name)
            header["leaves"].append({
                "key": key,
                "kind": "array",
                "dtype": name,
                "shape": shape,
                "offset": offset,
                "nbytes": nbytes,
            })
            array_leaves.append(leaf)
            offset += nbytes
        else:
            header["leaves"].append({"key": key, "kind": "py", "value": leaf})
    hdr = json.dumps(header).encode()
    preamble = _MAGIC + len(hdr).to_bytes(4, "little") + hdr
    return PytreePlan(preamble, len(preamble) + offset, array_leaves, header)


DEFAULT_BATCH_BYTES = 64 * 1024 * 1024


def _leaf_nbytes(leaf: Any) -> int:
    return int(np.prod(tuple(leaf.shape), dtype=np.int64)
               ) * _itemsize(_dtype_name(leaf))


def _iter_leaf_views(array_leaves: list, batch_bytes: int,
                     ) -> Iterator[Tuple[int, memoryview]]:
    """Host-materialize ``array_leaves`` in groups of up to
    ``batch_bytes`` and yield ``(leaf_index, uint8_memoryview)`` per leaf,
    in order — the shared fetch engine under streaming serialization and
    digest computation. Peak extra host RAM is O(batch), not
    O(checkpoint)."""
    group: list = []
    group_bytes = 0

    def flush():
        fetched = [_host_array(leaf) for _, leaf in group]
        for (i, _), arr in zip(group, fetched):
            yield i, arr.reshape(-1).view(np.uint8).data

    for i, leaf in enumerate(array_leaves):
        nbytes = _leaf_nbytes(leaf)
        if group and group_bytes + nbytes > batch_bytes:
            yield from flush()
            group, group_bytes = [], 0
        group.append((i, leaf))
        group_bytes += nbytes
    if group:
        yield from flush()


def iter_pytree_chunks(tree: Any,
                       chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                       plan: Optional[Any] = None,
                       batch_bytes: int = DEFAULT_BATCH_BYTES,
                       start: int = 0,
                       end: Optional[int] = None,
                       ) -> Iterator[memoryview]:
    """Stream-serialize: yields the preamble, then the array leaves' raw
    bytes in ``chunk_bytes`` slices. Leaves are host-materialized in
    groups of up to ``batch_bytes``, so peak extra host RAM is O(batch),
    not O(checkpoint). Slices are zero-copy memoryviews.
    ``plan`` reuses a precomputed :func:`plan_pytree` result (the HTTP
    server plans once for Content-Length and must stream that same plan).

    ``start``/``end`` select a byte range of the serialized stream
    (``end=None`` = to the end): leaves wholly outside the range are
    skipped WITHOUT fetching any device data, which is what makes a
    resumed heal transfer O(remaining bytes) on the donor side too, not
    just on the wire."""
    preamble, total_len, array_leaves = (
        plan if plan is not None else plan_pytree(tree))
    hi = total_len if end is None else min(int(end), total_len)
    lo = max(int(start), 0)
    if lo == 0 and hi >= total_len:
        # Full-stream fast path, bitwise-identical to the historical
        # behavior (including the single empty chunk a 0-size leaf
        # yields).
        yield memoryview(preamble)
        for _, mv in _iter_leaf_views(array_leaves, batch_bytes):
            for i in range(0, len(mv) or 1, chunk_bytes):
                yield mv[i:i + chunk_bytes]
        return
    if lo >= hi:
        return
    if lo < len(preamble):
        mv = memoryview(preamble)[lo:min(hi, len(preamble))]
        for i in range(0, len(mv), chunk_bytes):
            yield mv[i:i + chunk_bytes]
    # Select only the leaves overlapping [lo, hi); record the slice of
    # each so a range entering mid-leaf still serves exact bytes.
    off = len(preamble)
    wanted: list = []
    slices: dict = {}
    for idx, leaf in enumerate(array_leaves):
        nbytes = _leaf_nbytes(leaf)
        a, b = max(lo, off), min(hi, off + nbytes)
        if a < b:
            slices[len(wanted)] = (a - off, b - off)
            wanted.append(leaf)
        off += nbytes
    for j, mv in _iter_leaf_views(wanted, batch_bytes):
        s, e = slices[j]
        mv = mv[s:e]
        for i in range(0, len(mv), chunk_bytes):
            yield mv[i:i + chunk_bytes]


def save_pytree(tree: Any) -> bytes:
    """Serialize a pytree of arrays/scalars to one buffer. For O(batch)
    RAM streaming to a socket/file, use :func:`iter_pytree_chunks`
    directly."""
    return b"".join(iter_pytree_chunks(tree))


def _read_exact_into(fp: BinaryIO, mv: memoryview) -> None:
    got = 0
    while got < len(mv):
        if hasattr(fp, "readinto"):
            n = fp.readinto(mv[got:])
        else:  # file-likes without readinto (e.g. raw HTTPResponse wrappers)
            chunk = fp.read(len(mv) - got)
            n = len(chunk)
            mv[got:got + n] = chunk
        if not n:
            raise ValueError("truncated checkpoint stream")
        got += n


def _read_exact(fp: BinaryIO, n: int) -> bytes:
    buf = bytearray(n)
    _read_exact_into(fp, memoryview(buf))
    return bytes(buf)


def _match_entries(header: dict, target: Any):
    """Validate checkpoint entries against the flattened target: positional
    + name cross-check, array entries must meet an array target with equal
    shape AND dtype, py entries must meet a non-array target. The header is
    untrusted (a malicious/corrupt peer), so this is what bounds allocations
    to target size and guarantees a structural mismatch fails loudly instead
    of silently permuting or substituting weights. Returns
    ``(pairs, treedef)``."""
    tpaths, treedef = tree_flatten_with_path(target)
    entries = header["leaves"]
    if len(entries) != len(tpaths):
        raise ValueError(
            f"checkpoint has {len(entries)} leaves, target has {len(tpaths)}")
    pairs = []
    for entry, (path, tleaf) in zip(entries, tpaths):
        key = _key_str(path)
        if entry["key"] != key:
            raise ValueError(
                f"checkpoint leaf {entry['key']!r} does not match target "
                f"leaf {key!r}")
        if entry["kind"] == "array":
            if not _is_array_leaf(tleaf):
                raise ValueError(
                    f"checkpoint leaf {key!r} is an array but the target "
                    f"leaf is not")
            if tuple(entry["shape"]) != tuple(tleaf.shape):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape "
                    f"{tuple(entry['shape'])}, target expects "
                    f"{tuple(tleaf.shape)}")
            if entry["dtype"] != _dtype_name(tleaf):
                raise ValueError(
                    f"checkpoint leaf {key!r} has dtype {entry['dtype']}, "
                    f"target expects {_dtype_name(tleaf)}")
        elif _is_array_leaf(tleaf):
            raise ValueError(
                f"checkpoint leaf {key!r} is a py value but the target "
                f"leaf is an array")
        pairs.append((entry, tleaf))
    return pairs, treedef


def load_pytree_from(
    fp: BinaryIO,
    target: Any,
    device_put_fn: Optional[Callable[[Any, Any], Any]] = None,
    digests: Optional[List[int]] = None,
) -> Any:
    """Restore a pytree from a binary stream into the structure of
    ``target``, one leaf at a time: each array leaf is read into a fresh
    host buffer and handed to ``device_put_fn(leaf, target_leaf)``
    (e.g. :func:`device_put_like`) before the next is read, so peak extra
    host RAM is one leaf. Keys are matched positionally against the
    flattened target and cross-checked by name.

    ``digests``, when given, is the per-array-leaf crc32 list in body
    order: every leaf is verified after its read and BEFORE
    ``device_put_fn`` — corrupt bytes never reach the device — raising
    :class:`LeafDigestMismatch` on the first mismatch."""
    try:
        magic = _read_exact(fp, len(_MAGIC))
    except ValueError:
        raise ValueError("not a torchft_tpu pytree checkpoint")
    if magic != _MAGIC:
        raise ValueError("not a torchft_tpu pytree checkpoint")
    hdr_len = int.from_bytes(_read_exact(fp, 4), "little")
    # Untrusted length: cap before allocating.
    if hdr_len > 256 * 1024 * 1024:
        raise ValueError(f"checkpoint header implausibly large ({hdr_len}B)")
    header = json.loads(_read_exact(fp, hdr_len))

    pairs, treedef = _match_entries(header, target)
    digs = iter(digests) if digests is not None else None
    out_leaves = []
    for entry, tleaf in pairs:
        if entry["kind"] == "py":
            out_leaves.append(entry["value"])
            continue
        # Shape and dtype were checked against the target, so this
        # allocation is exactly the target leaf's size.
        arr = np.empty(entry["shape"], dtype=_carrier(entry["dtype"]))
        mv = arr.reshape(-1).view(np.uint8).data
        _read_exact_into(fp, mv)
        if digs is not None:
            try:
                want = int(next(digs))
            except StopIteration:
                raise LeafDigestMismatch(
                    f"digest list exhausted at leaf {entry['key']!r} — "
                    "manifest does not cover this stream") from None
            got = zlib.crc32(mv)
            if got != want:
                raise LeafDigestMismatch(
                    f"leaf {entry['key']!r} failed digest verification "
                    f"(crc32 {got:08x} != manifest {want:08x})")
        leaf = _from_carrier(arr, entry["dtype"])
        out_leaves.append(device_put_fn(leaf, tleaf)
                          if device_put_fn is not None else leaf)
    return tree_unflatten(treedef, out_leaves)


def load_pytree(
    data: Any,
    target: Any,
    device_put_fn: Optional[Callable[[np.ndarray, Any], Any]] = None,
) -> Any:
    """Restore from an in-memory buffer (bytes/bytearray/memoryview),
    zero-copy: without ``device_put_fn``, returned arrays are
    ``np.frombuffer`` views onto ``data`` — this is the per-step host
    collective path (``backends/host.py`` hands in the received bytearray).
    """
    if len(data) < len(_MAGIC) or bytes(data[:len(_MAGIC)]) != _MAGIC:
        raise ValueError("not a torchft_tpu pytree checkpoint")
    hdr_len = int.from_bytes(data[len(_MAGIC):len(_MAGIC) + 4], "little")
    body_start = len(_MAGIC) + 4 + hdr_len
    if len(data) < body_start:
        raise ValueError("truncated checkpoint stream")
    header = json.loads(bytes(data[len(_MAGIC) + 4:body_start]))

    pairs, treedef = _match_entries(header, target)
    out_leaves = []
    for entry, tleaf in pairs:
        if entry["kind"] == "py":
            out_leaves.append(entry["value"])
            continue
        count = int(np.prod(entry["shape"], dtype=np.int64))
        if body_start + entry["offset"] + entry["nbytes"] > len(data):
            raise ValueError("truncated checkpoint stream")
        arr = np.frombuffer(
            data, dtype=_carrier(entry["dtype"]), count=count,
            offset=body_start + entry["offset"],
        ).reshape(entry["shape"])
        leaf = _from_carrier(arr, entry["dtype"])
        if device_put_fn is not None:
            out_leaves.append(device_put_fn(leaf, tleaf))
        else:
            out_leaves.append(leaf)
    return tree_unflatten(treedef, out_leaves)


def device_put_like(arr: Any, target_leaf: Any) -> Any:
    """Place a restored host leaf like ``target_leaf``: a new tensor on the
    target's device and dtype for tensor targets, the host array
    otherwise."""
    if isinstance(target_leaf, torch.Tensor):
        if not isinstance(arr, torch.Tensor):
            # np.require keeps 0-d leaves 0-d (ascontiguousarray would not).
            arr = torch.from_numpy(np.require(arr, requirements="C"))
        t = arr
        return t.to(device=target_leaf.device, dtype=target_leaf.dtype,
                    copy=True)
    return arr


def balanced_ranges(sizes: list, n: int) -> list:
    """Contiguous byte-balanced ``[start, stop)`` index ranges, one per
    group (possibly empty), partitioning ``range(len(sizes))``: the JAX
    package's stripe partitioner, which the striped-heal fetch planner
    (``checkpointing._HealSession.stripes``) uses, so a healer splits a
    donor set exactly as a JAX healer would."""
    total = float(sum(sizes)) or 1.0
    ranges = []
    start = 0
    acc = 0.0
    g = 0
    for i, sz in enumerate(sizes):
        acc += sz
        while g < n - 1 and acc >= total * (g + 1) / n:
            ranges.append((start, i + 1))
            start = i + 1
            g += 1
    while len(ranges) < n:
        ranges.append((start, len(sizes)))
        start = len(sizes)
    return ranges


# --------------------------------------------------------------------------
# State attestation words (the JAX package's serialization.py:184-236).
# A committed state's fingerprint folds every array leaf's raw bytes, in
# pytree order, into four u32 words: the byte sum, the position-weighted
# byte sum, the byte-length chain and a rotate-xor mix. All arithmetic is
# u32 wraparound, exact everywhere, so the card's kernel
# (ops/attest.py, csrc/attest.cu) and this numpy reference agree bit for
# bit, and so do the two packages.

ATTEST_FNV_PRIME = 0x01000193
ATTEST_FNV_BASIS = 0x811C9DC5
_M32 = 0xFFFFFFFF
_ATTEST_CHUNK = 1 << 24  # bytes of one leaf read at a time


def _leaf_bytes(arr: Any) -> np.ndarray:
    """A leaf's raw bytes as a flat uint8 array: a tensor through
    ``.view(torch.uint8)`` (bool and bfloat16 included), numpy through
    its buffer (a ``communicator.BF16`` array is its uint16 words)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy()
    return np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8)


def attest_leaf_words(arr: Any) -> Tuple[int, int, int]:
    """``(w0, w1, nbytes mod 2^32)`` of one leaf's raw bytes: the numpy
    reference of the card kernel's per-leaf stage."""
    raw = _leaf_bytes(arr)
    n = raw.size
    w0 = w1 = 0
    # Only the sums mod 2^32 matter, so u32 arithmetic that wraps (the
    # card's) is exact; in chunks, so a large leaf's temporaries stay
    # bounded.
    for start in range(0, n, _ATTEST_CHUNK):
        b = raw[start:start + _ATTEST_CHUNK].astype(np.uint32)
        pos = (np.arange(b.size, dtype=np.uint32)
               + np.uint32((start + 1) & _M32))
        w0 += int(b.sum(dtype=np.uint32))
        w1 += int((pos * b).sum(dtype=np.uint32))
    return w0 & _M32, w1 & _M32, n & _M32


def attest_fold(acc: List[int], w0: int, w1: int, n32: int) -> List[int]:
    """Fold one leaf's words into the 4-word accumulator (u32
    wraparound multiply-add; the card kernel runs the same ops)."""
    p = ATTEST_FNV_PRIME
    rot = ((w1 << 1) | (w1 >> 31)) & _M32
    return [
        (acc[0] * p + w0) & _M32,
        (acc[1] * p + w1) & _M32,
        (acc[2] * p + n32) & _M32,
        ((acc[3] ^ w0 ^ rot) * p) & _M32,
    ]


def attest_combine(words: Any) -> str:
    """The 4 accumulator words as the 32-hex-char state digest every
    fleet digest carries (the card path hands its fetched words here)."""
    return "".join(f"{int(w) & _M32:08x}" for w in words)


def attest_fingerprint(leaves: List[Any]) -> str:
    """Numpy reference of the committed-state fingerprint: fold every
    array leaf (pytree order) and combine."""
    acc = [ATTEST_FNV_BASIS] * 4
    for leaf in leaves:
        acc = attest_fold(acc, *attest_leaf_words(leaf))
    return attest_combine(acc)
