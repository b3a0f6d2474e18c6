"""Generates the control-plane core's protobuf message classes.

The core (``_core/``) encodes its RPCs as protobuf messages, through the
classes ``protoc --cpp_out`` generates from ``_core/proto/torchft.proto``
and the protobuf runtime they link. A machine with a GPU may have neither
``protoc`` nor the runtime, so the port needs neither: :func:`generate`
reads the ``.proto`` and writes one self-contained ``torchft.pb.h`` with the
same classes and the accessors the core calls, over a few lines of proto3
wire encoding. The bytes are protobuf's own (proto3 implicit presence,
fields in number order, unknown fields skipped on parse), so the port's
core reads and writes what a core built against protobuf does;
``tests/test_torch_native.py`` holds the two to the same bytes.

Only the part of proto3 the file uses is covered: messages whose fields
are ``int64``, ``uint64``, ``bool``, ``double``, ``string``, ``bytes`` or
another message, and ``repeated`` ``string``/``bytes``/message fields.
Anything else raises :class:`ValueError`, so a later edit of the ``.proto``
that needs more cannot be served by wrong code.

The bridge (:mod:`._native`) calls :func:`generate` at build time.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List

# proto type -> (C++ type, wire type). Varints are 0, fixed64 is 1,
# length-delimited is 2.
_SCALARS = {"int64": ("int64_t", 0), "uint64": ("uint64_t", 0),
            "bool": ("bool", 0), "double": ("double", 1)}
_BYTES = ("string", "bytes")


@dataclass
class Field:
    label: str  # "" or "repeated"
    type: str
    name: str
    number: int


@dataclass
class Message:
    name: str
    fields: List[Field]


_TOKEN = re.compile(r'"[^"]*"|[A-Za-z_][\w.]*|\d+|[{};=\[\]]')


def parse(text: str) -> tuple:
    """``(package, [Message])`` of a proto3 file in the covered subset."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", " ", text, flags=re.S)
    toks = _TOKEN.findall(text)
    rest = _TOKEN.sub(" ", text).split()
    if rest:
        raise ValueError(f"unsupported proto text: {rest[:5]}")
    pos, package, messages = 0, "", []

    def take(expect: str = "") -> str:
        nonlocal pos
        if pos >= len(toks):
            raise ValueError("unexpected end of proto")
        tok = toks[pos]
        if expect and tok != expect:
            raise ValueError(f"expected {expect!r}, got {tok!r}")
        pos += 1
        return tok

    while pos < len(toks):
        word = take()
        if word == "syntax":
            take("=")
            if take() != '"proto3"':
                raise ValueError("only proto3 is supported")
            take(";")
        elif word == "package":
            package = take()
            take(";")
        elif word == "message":
            name = take()
            take("{")
            fields = []
            while toks[pos:pos + 1] != ["}"]:
                label = take() if toks[pos:pos + 1] == ["repeated"] else ""
                ftype, fname = take(), take()
                take("=")
                number = int(take())
                take(";")
                fields.append(Field(label, ftype, fname, number))
            take("}")
            messages.append(Message(name, fields))
        else:
            raise ValueError(f"unsupported proto construct {word!r}")
    names = {m.name for m in messages}
    for m in messages:
        numbers = [f.number for f in m.fields]
        if len(set(numbers)) != len(numbers) or min(numbers, default=1) < 1:
            raise ValueError(f"{m.name}: bad field numbers {numbers}")
        for f in m.fields:
            if f.type not in _SCALARS and f.type not in _BYTES \
                    and f.type not in names:
                raise ValueError(f"{m.name}.{f.name}: unsupported type "
                                 f"{f.type!r}")
            if f.label == "repeated" and f.type in _SCALARS:
                raise ValueError(f"{m.name}.{f.name}: repeated scalars are "
                                 "not supported")
    return package, _dependency_order(messages)


def _dependency_order(messages: List[Message]) -> List[Message]:
    """Messages ordered so each follows every message it holds (messages
    are held by value, so a cycle is refused)."""
    by_name = {m.name: m for m in messages}
    done: Dict[str, bool] = {}  # name -> finished (False while visiting)
    out: List[Message] = []

    def visit(m: Message) -> None:
        if done.get(m.name) is False:
            raise ValueError(f"message cycle through {m.name}")
        if m.name in done:
            return
        done[m.name] = False
        for f in m.fields:
            if f.type in by_name:
                visit(by_name[f.type])
        done[m.name] = True
        out.append(m)

    for m in messages:
        visit(m)
    return out


_RUNTIME = r"""
namespace pbwire {

inline void put_varint(std::string* out, uint64_t v) {
  while (v >= 0x80) {
    out->push_back(static_cast<char>(v | 0x80));
    v >>= 7;
  }
  out->push_back(static_cast<char>(v));
}

inline void put_tag(std::string* out, uint32_t field, uint32_t wire) {
  put_varint(out, (uint64_t{field} << 3) | wire);
}

inline void put_fixed64(std::string* out, uint64_t v) {
  for (int i = 0; i < 8; i++) out->push_back(static_cast<char>(v >> (8 * i)));
}

inline void put_len(std::string* out, uint32_t field, const std::string& s) {
  put_tag(out, field, 2);
  put_varint(out, s.size());
  out->append(s);
}

inline uint64_t double_bits(double d) {
  uint64_t b;
  memcpy(&b, &d, 8);
  return b;
}

// A cursor over one message's bytes; every read fails on truncation.
struct Reader {
  const char* p;
  const char* end;

  bool varint(uint64_t* v) {
    uint64_t r = 0;
    for (int shift = 0; shift < 64; shift += 7) {
      if (p == end) return false;
      uint8_t b = static_cast<uint8_t>(*p++);
      r |= uint64_t{b & 0x7fu} << shift;
      if (!(b & 0x80)) {
        *v = r;
        return true;
      }
    }
    return false;
  }
  bool fixed64(uint64_t* v) {
    if (end - p < 8) return false;
    uint64_t r = 0;
    for (int i = 0; i < 8; i++) r |= uint64_t{static_cast<uint8_t>(p[i])} << (8 * i);
    p += 8;
    *v = r;
    return true;
  }
  bool sub(Reader* out) {
    uint64_t n;
    if (!varint(&n) || n > static_cast<uint64_t>(end - p)) return false;
    *out = Reader{p, p + n};
    p += n;
    return true;
  }
  bool bytes(std::string* s) {
    Reader r{};
    if (!sub(&r)) return false;
    s->assign(r.p, r.end);
    return true;
  }
  bool skip(uint32_t wire) {
    uint64_t v;
    Reader r{};
    switch (wire) {
      case 0: return varint(&v);
      case 1: return fixed64(&v);
      case 2: return sub(&r);
      case 5:
        if (end - p < 4) return false;
        p += 4;
        return true;
      default: return false;  // groups (3, 4) are not proto3
    }
  }
};

}  // namespace pbwire
"""


def _accessors(f: Field) -> List[str]:
    """protoc's accessors, as far as the core calls them."""
    n, t = f.name, f.type
    if f.label == "repeated":
        el = "std::string" if t in _BYTES else t
        add = (f"void add_{n}(std::string v) {{ {n}_.push_back(std::move(v)); }}"
               if t in _BYTES else
               f"{t}* add_{n}() {{ return &{n}_.emplace_back(); }}")
        return [
            f"int {n}_size() const {{ return static_cast<int>({n}_.size()); }}",
            f"const {el}& {n}(int i) const {{ return {n}_[i]; }}",
            f"const std::deque<{el}>& {n}() const {{ return {n}_; }}",
            f"std::deque<{el}>* mutable_{n}() {{ return &{n}_; }}", add]
    if t in _BYTES:
        return [f"const std::string& {n}() const {{ return {n}_; }}",
                f"void set_{n}(std::string v) {{ {n}_ = std::move(v); }}"]
    if t in _SCALARS:
        ct = _SCALARS[t][0]
        return [f"{ct} {n}() const {{ return {n}_; }}",
                f"void set_{n}({ct} v) {{ {n}_ = v; }}"]
    return [
        f"bool has_{n}() const {{ return has_{n}_; }}",
        f"const {t}& {n}() const {{ return {n}_; }}",
        f"{t}* mutable_{n}() {{ has_{n}_ = true; return &{n}_; }}",
    ]


def _members(f: Field) -> List[str]:
    n, t = f.name, f.type
    if f.label == "repeated":
        return [f"std::deque<{'std::string' if t in _BYTES else t}> {n}_;"]
    if t in _BYTES:
        return [f"std::string {n}_;"]
    if t in _SCALARS:
        return [f"{_SCALARS[t][0]} {n}_{{}};"]
    return [f"bool has_{n}_ = false;", f"{t} {n}_;"]


def _append(f: Field) -> List[str]:
    n, t, num = f.name, f.type, f.number
    if f.label == "repeated":
        if t in _BYTES:
            return [f"for (const auto& v : {n}_) pbwire::put_len(out, {num}, v);"]
        return [f"for (const auto& v : {n}_) {{",
                "  std::string sub;", "  v.AppendTo(&sub);",
                f"  pbwire::put_len(out, {num}, sub);", "}"]
    if t in _BYTES:
        return [f"if (!{n}_.empty()) pbwire::put_len(out, {num}, {n}_);"]
    if t == "double":
        # proto3 omits +0.0 only; -0.0 has other bits and is written.
        return [f"if (pbwire::double_bits({n}_) != 0) {{",
                f"  pbwire::put_tag(out, {num}, 1);",
                f"  pbwire::put_fixed64(out, pbwire::double_bits({n}_));",
                "}"]
    if t in _SCALARS:
        return [f"if ({n}_) {{", f"  pbwire::put_tag(out, {num}, 0);",
                f"  pbwire::put_varint(out, static_cast<uint64_t>({n}_));",
                "}"]
    return [f"if (has_{n}_) {{", "  std::string sub;",
            f"  {n}_.AppendTo(&sub);", f"  pbwire::put_len(out, {num}, sub);",
            "}"]


def _merge(f: Field) -> List[str]:
    """One ``case`` of the parse switch: ``continue`` once the field is
    read, ``break`` (to skip it as unknown) on a wire type it cannot have,
    ``return false`` on malformed bytes."""
    n, t = f.name, f.type
    wire = _SCALARS[t][1] if t in _SCALARS else 2
    out = [f"case {f.number}: {{", f"  if (wire != {wire}) break;"]
    if t in _BYTES:
        target = (f"&{n}_.emplace_back()" if f.label == "repeated"
                  else f"&{n}_")
        out.append(f"  if (!r.bytes({target})) return false;")
    elif t == "double":
        out += ["  uint64_t v;", "  if (!r.fixed64(&v)) return false;",
                f"  memcpy(&{n}_, &v, 8);"]
    elif t in _SCALARS:
        ct = _SCALARS[t][0]
        value = "v != 0" if t == "bool" else f"static_cast<{ct}>(v)"
        out += ["  uint64_t v;", "  if (!r.varint(&v)) return false;",
                f"  {n}_ = {value};"]
    else:
        target = (f"{n}_.emplace_back()" if f.label == "repeated"
                  else f"(*mutable_{n}())")
        out += ["  pbwire::Reader sub{};",
                f"  if (!r.sub(&sub) || !{target}.MergeFrom(sub)) "
                "return false;"]
    return out + ["  continue;", "}"]


def _message(m: Message) -> str:
    fields = sorted(m.fields, key=lambda f: f.number)
    lines = [f"class {m.name} {{", " public:"]
    for f in m.fields:
        lines += ["  " + s for s in _accessors(f)]
    lines += [
        f"  void Clear() {{ *this = {m.name}(); }}",
        "  std::string SerializeAsString() const {",
        "    std::string out;", "    AppendTo(&out);", "    return out;",
        "  }",
        "  bool ParseFromString(const std::string& data) {",
        "    Clear();",
        "    pbwire::Reader r{data.data(), data.data() + data.size()};",
        "    return MergeFrom(r);", "  }",
        "",
        "  // Wire format, fields in number order as protobuf writes them.",
        "  void AppendTo(std::string* out) const {",
    ]
    if not fields:
        lines.append("    (void)out;")
    for f in fields:
        lines += ["    " + s for s in _append(f)]
    lines += [
        "  }",
        "  bool MergeFrom(pbwire::Reader& r) {",
        "    while (r.p != r.end) {",
        "      uint64_t tag;",
        "      if (!r.varint(&tag) || (tag >> 3) == 0 || (tag >> 3) > "
        "0x1fffffff)",
        "        return false;",
        "      const uint32_t wire = static_cast<uint32_t>(tag & 7);",
    ]
    if fields:
        lines.append("      switch (tag >> 3) {")
        for f in fields:
            lines += ["        " + s for s in _merge(f)]
        lines.append("      }")
    lines += ["      if (!r.skip(wire)) return false;", "    }",
              "    return true;", "  }", "", " private:"]
    for f in m.fields:
        lines += ["  " + s for s in _members(f)]
    lines.append("};")
    return "\n".join(lines)


def generate(proto_text: str) -> str:
    """The C++ header for ``proto_text``."""
    package, messages = parse(proto_text)
    parts = [
        "// Generated by torchft_tpu_torch/_protogen.py. Do not edit.",
        "// Protobuf's wire format, with no protobuf runtime.",
        "#pragma once", "",
        "#include <stddef.h>", "#include <stdint.h>", "#include <string.h>",
        "", "#include <deque>", "#include <string>", "#include <utility>", "",
    ]
    spaces = package.split(".") if package else []
    parts += [f"namespace {s} {{" for s in spaces]
    parts.append(_RUNTIME)
    parts += [_message(m) + "\n" for m in messages]
    parts += [f"}}  // namespace {s}" for s in reversed(spaces)]
    return "\n".join(parts) + "\n"
