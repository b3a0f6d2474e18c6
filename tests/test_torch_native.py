"""The port's control-plane core: a copy of the JAX package's C++ sources
(one file carries a recorded patch), built into the port's own build directory with message classes
generated from its proto (no protobuf runtime), and reachable through the
port's ctypes bridge."""

from __future__ import annotations

import filecmp
import os
import random
import shutil
import subprocess
import threading
import time

import pytest

from torchft_tpu_torch import _native
from torchft_tpu_torch import _protogen as protogen

pytestmark = pytest.mark.port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CORE = os.path.join(ROOT, "torchft_tpu", "_core")
PORT_CORE = os.path.join(ROOT, "torchft_tpu_torch", "_core")
SOURCES = ["capi.cc", "lighthouse.cc", "lighthouse.h", "manager.cc",
           "manager.h", "rpc.cc", "rpc.h", "store.cc", "store.h",
           os.path.join("proto", "torchft.proto")]


# Core files the port patches, each with its unified diff against the JAX
# package's file.
PATCHED = {"lighthouse.cc": os.path.join("patches", "fast_path_quorum.patch"),
           "lighthouse.h": os.path.join("patches", "fast_path_quorum_h.patch")}


def _apply_unified_diff(text: str, diff: str) -> str:
    """``text`` with the hunks of a one-file unified diff applied; every
    context and removed line must match where its hunk says."""
    src = text.splitlines(keepends=True)
    out: list = []
    pos = 0
    lines = diff.splitlines(keepends=True)
    assert lines[0].startswith("--- ") and lines[1].startswith("+++ ")
    i = 2
    while i < len(lines):
        head = lines[i]
        assert head.startswith("@@ -"), head
        start = int(head[4:].split(",")[0].split(" ")[0]) - 1
        assert start >= pos, head
        out += src[pos:start]
        pos = start
        i += 1
        while i < len(lines) and not lines[i].startswith("@@ "):
            tag, body = lines[i][0], lines[i][1:]
            if tag in " -":
                assert src[pos] == body, (pos + 1, body)
                pos += 1
            if tag in " +":
                out.append(body)
            i += 1
    return "".join(out + src[pos:])


@pytest.mark.parametrize("name", SOURCES)
def test_core_sources_are_byte_identical(name):
    """Every core file is the JAX package's, byte for byte; a patched one
    is the JAX package's file plus its recorded diff, byte for byte."""
    jax_path = os.path.join(JAX_CORE, name)
    port_path = os.path.join(PORT_CORE, name)
    if name not in PATCHED:
        assert filecmp.cmp(jax_path, port_path, shallow=False)
        return
    with open(jax_path, encoding="utf-8") as f:
        reference = f.read()
    with open(os.path.join(PORT_CORE, PATCHED[name]),
              encoding="utf-8") as f:
        diff = f.read()
    with open(port_path, encoding="utf-8") as f:
        assert _apply_unified_diff(reference, diff) == f.read()
    assert not filecmp.cmp(jax_path, port_path, shallow=False)


def test_fast_path_counts_every_member_at_its_step():
    """Two groups ask the lighthouse through their managers, one always
    50 ms after the other. Every answer counts both groups at max_step
    (``max_world_size == 2``), whoever asks first, and the steady rounds
    ride the fast path. Without the fan-in, the fast path answered the
    first asker from a cache in which its peer still carried the previous
    step, and that group divided the ring sum by 1."""
    lh = _native.Lighthouse(bind="127.0.0.1:0", min_replicas=2,
                            join_timeout_ms=2000, quorum_tick_ms=10,
                            heartbeat_fresh_ms=300)
    servers = [_native.ManagerServer(f"g{i}", lh.address(),
                                     store_addr=f"st{i}", bind="127.0.0.1:0")
               for i in range(2)]
    results: dict = {}
    try:
        def run(i):
            client = _native.ManagerClient(servers[i].address())
            for step in range(1, 7):
                if i == 1 and step > 1:
                    time.sleep(0.05)
                results[(i, step)] = client.quorum(
                    rank=0, step=step, checkpoint_server_addr=f"c{i}",
                    timeout_ms=20_000)

        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive(), "a group hung in the quorum"
        assert len(results) == 12
        got = {k: (q.max_step, q.max_world_size)
               for k, q in results.items()}
        assert all(v == (k[1], 2) for k, v in got.items()), got
        assert any(q.fast_path for q in results.values())
        assert lh.status()["fast_path_hits"] >= 2
    finally:
        for s in servers:
            s.shutdown()
        lh.shutdown()


@pytest.mark.parametrize("groups", [2, 4])
def test_every_member_reads_its_own_rounds_decision(groups):
    """Groups ask back to back, with no pause, for many steps. A served
    member asks at its next step at once, and so registers that step in
    the cached quorum, often before a peer of the round it just left has
    woken to read its answer. Every answer still counts all groups at the
    asker's step: a waiter of a fast round reads the decision its round
    was served, and a member parked in a slow round reads the cut that
    held it. Before, the late reader found the cache showing the quicker
    peer alone at max_step, took ``max_world_size == 1`` (a ring sum
    divided by 1), and on the fast path fell to the slow one and healed
    from that peer."""
    steps = 400
    lh = _native.Lighthouse(bind="127.0.0.1:0", min_replicas=groups,
                            join_timeout_ms=2000, quorum_tick_ms=10,
                            heartbeat_fresh_ms=300)
    servers = [_native.ManagerServer(f"g{i}", lh.address(),
                                     store_addr=f"st{i}", bind="127.0.0.1:0")
               for i in range(groups)]
    results: dict = {}
    try:
        def run(i):
            client = _native.ManagerClient(servers[i].address())
            for step in range(1, steps + 1):
                results[(i, step)] = client.quorum(
                    rank=0, step=step, checkpoint_server_addr=f"c{i}",
                    timeout_ms=20_000)

        ts = [threading.Thread(target=run, args=(i,))
              for i in range(groups)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive(), "a group hung in the quorum"
        assert len(results) == groups * steps
        # At step 1 every group but the primary heals from it, by design.
        bad = {k: (q.max_step, q.max_world_size, q.heal)
               for k, q in results.items()
               if (q.max_step, q.max_world_size) != (k[1], groups)
               or (q.heal and k[1] > 1)}
        assert not bad, sorted(bad.items())[:8]
        assert lh.status()["fast_path_hits"] >= groups * (steps - 2)
    finally:
        for s in servers:
            s.shutdown()
        lh.shutdown()


def test_farewell_cuts_a_waiting_fast_path_fan_in():
    """Two groups step together on the fast path; then group 1 says
    farewell while group 0 already waits in the fan-in for it at the next
    step. Group 0 gets the shrunken quorum (world 1) at once — the
    farewell breaks the fan-in to the slow path — well within the
    join timeout it would otherwise wait out."""
    join_timeout_ms = 6000
    lh = _native.Lighthouse(bind="127.0.0.1:0", min_replicas=1,
                            join_timeout_ms=join_timeout_ms,
                            quorum_tick_ms=10, heartbeat_fresh_ms=300)
    servers = [_native.ManagerServer(f"g{i}", lh.address(),
                                     store_addr=f"st{i}", bind="127.0.0.1:0")
               for i in range(2)]
    clients = [_native.ManagerClient(s.address()) for s in servers]
    results: dict = {}
    try:
        def ask(i, step):
            results[(i, step)] = clients[i].quorum(
                rank=0, step=step, checkpoint_server_addr=f"c{i}",
                timeout_ms=20_000)

        for step in range(1, 4):
            ts = [threading.Thread(target=ask, args=(i, step))
                  for i in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
                assert not t.is_alive(), "a group hung in the quorum"
            assert results[(0, step)].max_world_size == 2
        assert any(results[(0, s)].fast_path for s in (2, 3))

        t0 = time.monotonic()
        waiter = threading.Thread(target=ask, args=(0, 4))
        waiter.start()
        time.sleep(0.3)  # group 0 is now parked in the fan-in
        assert waiter.is_alive()
        t_bye = time.monotonic()
        servers[1].farewell()
        waiter.join(timeout=30)
        assert not waiter.is_alive()
        elapsed_ms = (time.monotonic() - t_bye) * 1e3
        q = results[(0, 4)]
        assert (q.replica_world_size, q.max_world_size) == (1, 1)
        assert not q.fast_path  # the slow path cut the new quorum
        assert q.quorum_id != results[(0, 3)].quorum_id
        assert elapsed_ms < join_timeout_ms / 4, elapsed_ms
        assert (time.monotonic() - t0) * 1e3 < join_timeout_ms / 2
    finally:
        for s in servers:
            s.shutdown()
        lh.shutdown()


def test_core_copy_has_no_cmake_build():
    """The port builds its core with g++ (``_native.py``), never cmake: the
    JAX core's CMakeLists.txt, which names its C++ test binary and
    libprotobuf, is not copied."""
    assert not os.path.exists(os.path.join(PORT_CORE, "CMakeLists.txt"))
    assert os.path.exists(os.path.join(JAX_CORE, "CMakeLists.txt"))
    with open(_native.__file__) as f:
        assert "cmake" not in f.read().lower()


def test_core_copy_is_complete():
    """Every C++ source of the JAX core is in the port, except the C++
    test binary's."""
    jax_files = {n for n in os.listdir(JAX_CORE)
                 if n.endswith((".cc", ".h"))} - {"core_test.cc"}
    port_files = {n for n in os.listdir(PORT_CORE)
                  if n.endswith((".cc", ".h"))}
    assert jax_files == port_files


PROTO = os.path.join(PORT_CORE, "proto", "torchft.proto")
with open(PROTO) as _f:
    MESSAGES = [m.name for m in protogen.parse(_f.read())[1]]


@pytest.fixture(scope="module")
def codec(tmp_path_factory):
    """``run(name, data) -> bytes | None``: the generated C++ class
    ``name`` parses ``data`` and writes itself back (None when the parse
    fails)."""
    d = tmp_path_factory.mktemp("codec")
    with open(PROTO) as f:
        (d / "torchft.pb.h").write_text(protogen.generate(f.read()))
    cases = "\n".join(
        f'  if (name == "{m}") {{ {m} m; ok = m.ParseFromString(in); '
        f"out = m.SerializeAsString(); }}" for m in MESSAGES)
    (d / "main.cc").write_text(
        '#include <iostream>\n#include <iterator>\n#include "torchft.pb.h"\n'
        "using namespace torchft_tpu;\n"
        "int main(int argc, char** argv) {\n"
        "  std::string name = argv[1], out;\n"
        "  std::string in((std::istreambuf_iterator<char>(std::cin)),\n"
        "                 std::istreambuf_iterator<char>());\n"
        "  bool ok = false;\n" + cases + "\n"
        "  if (!ok) return 3;\n"
        "  std::cout << out;\n  return 0;\n}\n")
    exe = str(d / "codec")
    subprocess.run(["g++", "-std=c++17", "-O1", "-Wall", "-Werror", "-o",
                    exe, str(d / "main.cc")], check=True)

    def run(name: str, data: bytes):
        proc = subprocess.run([exe, name], input=data, capture_output=True)
        assert proc.returncode in (0, 3), proc.stderr
        return proc.stdout if proc.returncode == 0 else None

    return run


@pytest.fixture(scope="module")
def protobuf_classes(tmp_path_factory):
    """The proto's message classes from protobuf itself: ``protoc``'s
    descriptors, Python protobuf's runtime."""
    pytest.importorskip("google.protobuf")
    from google.protobuf import descriptor_pb2, descriptor_pool
    from google.protobuf import message_factory

    protoc = shutil.which("protoc")
    if protoc is None:
        pytest.skip("no protoc to read the proto with")
    out = tmp_path_factory.mktemp("desc") / "torchft.desc"
    subprocess.run([protoc, f"--descriptor_set_out={out}", "-I",
                    os.path.dirname(PROTO), PROTO], check=True)
    fds = descriptor_pb2.FileDescriptorSet.FromString(out.read_bytes())
    pool = descriptor_pool.DescriptorPool()
    for fd in fds.file:
        pool.Add(fd)
    return {m: message_factory.GetMessageClass(
        pool.FindMessageTypeByName(f"torchft_tpu.{m}")) for m in MESSAGES}


def _fill(msg, rng: random.Random, depth: int = 0) -> None:
    """Random values in every field of ``msg``, zeros and empties
    included (proto3 leaves those off the wire)."""
    from google.protobuf.descriptor import FieldDescriptor as FD

    for fd in msg.DESCRIPTOR.fields:
        repeated = fd.is_repeated
        count = rng.randrange(4) if repeated else 1
        for _ in range(count):
            if fd.type == FD.TYPE_MESSAGE:
                sub = (getattr(msg, fd.name).add() if repeated
                       else getattr(msg, fd.name))
                sub.SetInParent()
                if depth < 3 and rng.random() < 0.8:
                    _fill(sub, rng, depth + 1)
                continue
            if rng.random() < 0.2:
                value = {FD.TYPE_STRING: "", FD.TYPE_BYTES: b"",
                         FD.TYPE_BOOL: False, FD.TYPE_DOUBLE: 0.0}.get(
                             fd.type, 0)
            elif fd.type == FD.TYPE_INT64:
                value = rng.choice([rng.randrange(-2**63, 2**63),
                                    rng.randrange(-300, 300)])
            elif fd.type == FD.TYPE_UINT64:
                value = rng.choice([rng.randrange(2**64), rng.randrange(300)])
            elif fd.type == FD.TYPE_BOOL:
                value = True
            elif fd.type == FD.TYPE_DOUBLE:
                value = rng.choice([rng.uniform(-1e6, 1e6), -0.0,
                                    float("inf"), 5e-324])
            elif fd.type == FD.TYPE_STRING:
                value = "".join(rng.choice("ab:é✓\n0")
                                for _ in range(rng.randrange(1, 200)))
            elif fd.type == FD.TYPE_BYTES:
                value = rng.randbytes(rng.randrange(1, 300))
            else:
                raise AssertionError(f"unhandled field type {fd.type}")
            if repeated:
                getattr(msg, fd.name).append(value)
            else:
                setattr(msg, fd.name, value)


@pytest.mark.parametrize("name", MESSAGES)
def test_generated_messages_write_protobufs_bytes(name, codec,
                                                  protobuf_classes):
    """What protobuf writes, the generated class reads and writes back
    byte for byte, for random contents of every field."""
    rng = random.Random(f"{name}-7")
    for _ in range(8):
        msg = protobuf_classes[name]()
        _fill(msg, rng)
        data = msg.SerializeToString()
        assert codec(name, data) == data
        assert protobuf_classes[name].FromString(codec(name, data)) == msg


def test_generated_parse_skips_unknown_fields(codec, protobuf_classes):
    msg = protobuf_classes["QuorumMember"](replica_id="g0", step=-5)
    data = msg.SerializeToString()
    unknown = (bytes([(9 << 3) | 0, 0x96, 0x01])       # varint
               + bytes([(10 << 3) | 1]) + bytes(8)      # fixed64
               + bytes([(11 << 3) | 2, 3]) + b"abc"     # length-delimited
               + bytes([(12 << 3) | 5]) + bytes(4)      # fixed32
               + bytes([(1 << 3) | 0, 7]))  # a known field, wrong wire type
    assert codec("QuorumMember", unknown + data) == data


@pytest.mark.parametrize("data", [b"\x0a\x05ab", b"\x20\x80", b"\x00\x01",
                                  b"\x0b", b"\x0a\xff\xff\xff\xff\x0f"],
                         ids=["short-string", "short-varint", "field-0",
                              "group", "huge-length"])
def test_generated_parse_rejects_malformed_bytes(data, codec):
    assert codec("QuorumMember", data) is None


@pytest.mark.parametrize("proto", [
    'syntax = "proto2"; message A { optional int64 x = 1; }',
    'syntax = "proto3"; enum E { Z = 0; }',
    'syntax = "proto3"; message A { int32 x = 1; }',
    'syntax = "proto3"; message A { repeated int64 x = 1; }',
    'syntax = "proto3"; message A { map<string, int64> x = 1; }',
    'syntax = "proto3"; message A { message B {} B b = 1; }',
    'syntax = "proto3"; message A { oneof o { int64 x = 1; } }',
    'syntax = "proto3"; message A { int64 x = 1 [deprecated = true]; }',
    'syntax = "proto3"; message A { int64 x = 1; bool y = 1; }',
    'syntax = "proto3"; message A { B b = 1; } message B { A a = 1; }',
], ids=["proto2", "enum", "int32", "repeated-scalar", "map", "nested",
        "oneof", "option", "duplicate-number", "cycle"])
def test_generator_refuses_what_it_does_not_cover(proto):
    with pytest.raises(ValueError):
        protogen.generate(proto)


def test_library_builds_outside_the_source_tree():
    path = _native.library_path()
    assert path.startswith(os.path.join(ROOT, "torchft_tpu_torch",
                                        "_build", "core"))
    assert not os.path.exists(os.path.join(PORT_CORE, "build"))


def test_quorum_and_vote_through_the_bridge():
    """Two single-rank groups meet at the port's lighthouse: the second
    heals at step 1, both vote, and the store round-trips a key."""
    lh = _native.Lighthouse(bind="127.0.0.1:0", min_replicas=2,
                            join_timeout_ms=200, quorum_tick_ms=20)
    stores = [_native.Store(bind="127.0.0.1:0") for _ in range(2)]
    servers = [_native.ManagerServer(f"g{i}:x", lh.address(),
                                     store_addr=stores[i].address(),
                                     bind="127.0.0.1:0")
               for i in range(2)]
    results = [None, None]
    try:
        def run(i):
            client = _native.ManagerClient(servers[i].address())
            q = client.quorum(rank=0, step=1, checkpoint_server_addr=f"c{i}",
                              timeout_ms=10_000)
            results[i] = (q, client.should_commit(0, 1, True,
                                                  timeout_ms=10_000))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        (q0, c0), (q1, c1) = results
        assert q0.quorum_id == q1.quorum_id > 0
        assert q0.replica_world_size == 2 and c0 and c1
        assert sorted([q0.heal, q1.heal]) == [False, True]
        sc = _native.StoreClient(stores[0].address())
        sc.set("k", b"v")
        assert sc.get("k") == b"v"
    finally:
        for s in servers:
            s.shutdown()
        for s in stores:
            s.shutdown()
        lh.shutdown()
