"""A YAML reader and writer for the subset of YAML the repo's configs use.

The card host has no PyYAML, so the port reads ``configs/`` with this
module. ``safe_load`` gives what ``yaml.safe_load`` gives on that subset:

- block mappings and block sequences nested by indentation;
- flow mappings and flow sequences, which may span lines;
- single- and double-quoted strings;
- comments, whole-line and trailing;
- plain scalars resolved by YAML 1.1's implicit rules as PyYAML applies
  them: null (``~``, ``null``, empty), bool (``true``, ``yes``, ``on``, ...),
  int (decimal, ``0x``, ``0b``, octal ``0...``, sexagesimal) and float.
  A float needs a dot (``16.``, ``0.00001``, ``1.0e-05``), so ``1e-5`` is a
  string, as PyYAML reads it.

Anything else (anchors, aliases, tags, block scalars ``|`` and ``>``,
multi-line plain scalars, tabs, several documents) raises ``YAMLError``
rather than being read differently from PyYAML. A plain scalar that
PyYAML would read as a timestamp raises too.

``safe_dump`` writes nested dicts, lists, tuples, strings, numbers,
bools and None as block YAML that ``yaml.safe_load`` and ``safe_load``
read back to an equal object.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YAMLError", "safe_load", "safe_dump"]


class YAMLError(ValueError):
    pass


# PyYAML's implicit resolvers (yaml/resolver.py), tried in this order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}


def _sexagesimal(value: str, cast) -> Any:
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar -> its value by YAML 1.1's implicit rules."""
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if _FLOAT.match(text):
        return _to_float(text)
    if _INT.match(text):
        return _to_int(text)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise YAMLError(f"timestamp {text!r} is outside the supported YAML subset")
    if text == "<<" or text == "=":
        raise YAMLError(f"{text!r} (merge/value key) is outside the supported YAML subset")
    return text


_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_LEN = {"x": 2, "u": 4, "U": 8}


def _fold(text: str) -> str:
    """Line folding of a quoted scalar that spans lines: each break and the
    blanks around it become one space (an empty line, a newline)."""
    if "\n" not in text:
        return text
    lines = text.split("\n")
    out = lines[0].rstrip(" \t")
    pending = ""
    for line in lines[1:-1]:
        s = line.strip(" \t")
        if not s:
            pending += "\n"
            continue
        out += (pending or " ") + s
        pending = ""
    last = lines[-1].lstrip(" \t")
    return out + (pending or " ") + last


class _Reader:
    """Scanner over the whole document for quoted and flow scalars."""

    def __init__(self, text: str):
        self.text = text
        self.i = 0

    def error(self, msg: str) -> YAMLError:
        line = self.text.count("\n", 0, self.i) + 1
        return YAMLError(f"{msg} (line {line})")

    def peek(self) -> str:
        return self.text[self.i] if self.i < len(self.text) else ""

    def skip_space(self) -> None:
        """Blanks, line breaks and comments inside a flow collection."""
        t = self.text
        while self.i < len(t):
            c = t[self.i]
            if c in " \n\r":
                self.i += 1
            elif c == "\t":
                raise self.error("tabs are outside the supported YAML subset")
            elif c == "#" and (self.i == 0 or t[self.i - 1] in " \n"):
                while self.i < len(t) and t[self.i] != "\n":
                    self.i += 1
            else:
                return

    def quoted(self) -> str:
        q = self.text[self.i]
        self.i += 1
        out: List[str] = []
        t = self.text
        while True:
            if self.i >= len(t):
                raise self.error("unterminated quoted scalar")
            c = t[self.i]
            if q == "'" and c == "'":
                if t[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return _fold("".join(out))
            if q == '"' and c == '"':
                self.i += 1
                return _fold("".join(out))
            if q == '"' and c == "\\":
                e = t[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_LEN:
                    n = _HEX_LEN[e]
                    digits = t[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                        raise self.error(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                else:
                    raise self.error(f"escape \\{e} is outside the supported YAML subset")
                continue
            out.append(c)
            self.i += 1

    def plain_flow(self) -> str:
        """A plain scalar inside a flow collection: up to ``,``, ``]``,
        ``}``, ``: `` or a comment, its line breaks folded."""
        t = self.text
        start = self.i
        while self.i < len(t):
            c = t[self.i]
            if c in ",[]{}":
                break
            if c == ":" and t[self.i + 1:self.i + 2] in (" ", "\n", ",", "]", "}", ""):
                break
            if c == "#" and t[self.i - 1] in " \n":
                break
            self.i += 1
        return " ".join(s.strip() for s in t[start:self.i].split("\n") if s.strip())

    def flow_node(self) -> Any:
        self.skip_space()
        c = self.peek()
        if c == "[":
            return self.flow_seq()
        if c == "{":
            return self.flow_map()
        if c in ("'", '"'):
            return self.quoted()
        if c in "&*!|>%@`":
            raise self.error(f"{c!r} is outside the supported YAML subset")
        return resolve_plain(self.plain_flow())

    def flow_seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip_space()
            if self.peek() == "]":
                self.i += 1
                return out
            item = self.flow_node()
            self.skip_space()
            if self.peek() == ":":
                raise self.error("single-pair mappings in a flow sequence are outside "
                                 "the supported YAML subset")
            out.append(item)
            self.skip_space()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.error("expected ',' or ']' in a flow sequence")

    def flow_map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.skip_space()
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.flow_node()
            self.skip_space()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.skip_space()
                if self.peek() not in (",", "}"):
                    value = self.flow_node()
            out[_hashable(key, self)] = value
            self.skip_space()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error("expected ',' or '}' in a flow mapping")


def _hashable(key: Any, reader: _Reader) -> Any:
    if isinstance(key, (list, dict)):
        raise reader.error("collection keys are outside the supported YAML subset")
    return key


class _Line:
    __slots__ = ("indent", "start", "end")

    def __init__(self, indent: int, start: int, end: int):
        self.indent, self.start, self.end = indent, start, end


class _BlockParser:
    """Block structure by indentation; each value's text is read by the
    scanner from its offset in the document, so flow collections and
    quoted scalars may run on over later lines."""

    def __init__(self, text: str):
        if "\t" in text:
            raise YAMLError("tabs are outside the supported YAML subset")
        self.r = _Reader(text)
        self.text = text

    def error(self, msg: str, pos: int) -> YAMLError:
        return YAMLError(f"{msg} (line {self.text.count(chr(10), 0, pos) + 1})")

    def _line_end(self, pos: int) -> int:
        end = self.text.find("\n", pos)
        return len(self.text) if end < 0 else end

    def _next_line(self, pos: int) -> Optional[_Line]:
        """The next line at or after ``pos`` that holds content."""
        t = self.text
        while pos < len(t):
            end = self._line_end(pos)
            line = t[pos:end]
            body = line.lstrip(" ")
            if body and not body.startswith("#"):
                if body.rstrip() in ("---", "..."):
                    if pos == 0 and body.rstrip() == "---":
                        pos = end + 1
                        continue
                    raise YAMLError("several documents are outside the supported YAML subset")
                return _Line(len(line) - len(body), pos, end)
            pos = end + 1
        return None

    def parse(self) -> Any:
        first = self._next_line(0)
        if first is None:
            return None
        value, pos = self._node(first, first.indent)
        rest = self._next_line(pos)
        if rest is not None:
            raise self.error("unexpected content", rest.start)
        return value

    def _node(self, line: _Line, indent: int) -> Tuple[Any, int]:
        """The block node whose first line is ``line`` (at ``indent``);
        returns (value, offset after it)."""
        body_at = line.start + line.indent
        if self._is_seq_item(body_at):
            return self._seq(line, indent)
        key_end = self._key_end(body_at, line.end)
        if key_end is not None:
            return self._map(line, indent)
        # a scalar or flow collection as a whole document
        return self._inline_value(body_at)

    def _is_seq_item(self, at: int) -> bool:
        return self.text[at] == "-" and self.text[at + 1:at + 2] in (" ", "\n", "")

    def _key_end(self, at: int, end: int) -> Optional[int]:
        """Offset of the ``:`` that ends a block mapping key starting at
        ``at``, or None when the line holds no key."""
        t = self.text
        if t[at] in ("'", '"'):
            self.r.i = at
            self.r.quoted()
            j = self.r.i
            while j < end and t[j] == " ":
                j += 1
            return j if j < end and t[j] == ":" and t[j + 1:j + 2] in (" ", "\n", "") else None
        if t[at] in "[{":
            return None
        j = at
        while j < end:
            c = t[j]
            if c == "#" and t[j - 1] == " ":
                return None
            if c == ":" and t[j + 1:j + 2] in (" ", "\n", ""):
                return j
            j += 1
        return None

    def _inline_value(self, at: int) -> Tuple[Any, int]:
        """A value that starts on its key's line (or as ``- value``):
        flow collection, quoted scalar or plain scalar to the line end."""
        t = self.text
        c = t[at]
        if c in "[{'\"":
            self.r.i = at
            value = self.r.flow_node()
            self._expect_line_end(self.r.i)
            return value, self._line_end(self.r.i) + 1
        if c in "&*!|>%@`":
            raise self.error(f"{c!r} is outside the supported YAML subset", at)
        end = self._line_end(at)
        j = at
        while j < end and not (t[j] == "#" and t[j - 1] == " "):
            j += 1
        text = t[at:j].strip()
        if ": " in text or text.endswith(":"):
            raise YAMLError(f"mapping values are not allowed here: {text!r}")
        nxt = self._next_line(end + 1)
        return resolve_plain(text), end + 1 if nxt is None else nxt.start

    def _expect_line_end(self, pos: int) -> None:
        t = self.text
        end = self._line_end(pos)
        rest = t[pos:end]
        stripped = rest.strip(" ")
        if stripped and not (stripped.startswith("#") and (rest[0] == " " or pos == 0)):
            raise self.error(f"unexpected {stripped!r} after a value", pos)

    def _child(self, pos: int, indent: int, allow_seq_at_indent: bool
               ) -> Tuple[Any, int]:
        """The value of a key (or ``-``) with nothing after it on its line:
        a block node on the following, deeper lines, or null."""
        nxt = self._next_line(pos)
        if nxt is not None and (nxt.indent > indent or (
                allow_seq_at_indent and nxt.indent == indent
                and self._is_seq_item(nxt.start + nxt.indent))):
            return self._node(nxt, nxt.indent)
        return None, pos if nxt is None else nxt.start

    def _map(self, line: _Line, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        cur: Optional[_Line] = line
        pos = line.start
        while cur is not None and cur.indent == indent:
            at = cur.start + cur.indent
            colon = self._key_end(at, cur.end)
            if colon is None:
                if self._is_seq_item(at):
                    break
                raise self.error("expected 'key: value'", at)
            if self.text[at] in ("'", '"'):
                self.r.i = at
                key: Any = self.r.quoted()
            else:
                key = resolve_plain(self.text[at:colon].strip())
            if isinstance(key, (list, dict)):
                raise YAMLError("collection keys are outside the supported YAML subset")
            v_at = colon + 1
            while v_at < cur.end and self.text[v_at] == " ":
                v_at += 1
            if v_at >= cur.end or (self.text[v_at] == "#"):
                value, pos = self._child(cur.end + 1, indent, allow_seq_at_indent=True)
            else:
                value, pos = self._inline_value(v_at)
            out[key] = value
            cur = self._next_line(pos)
        if cur is not None and cur.indent > indent:
            raise self.error("bad indentation", cur.start)
        return out, pos if cur is None else cur.start

    def _seq(self, line: _Line, indent: int) -> Tuple[list, int]:
        out: list = []
        cur: Optional[_Line] = line
        pos = line.start
        while (cur is not None and cur.indent == indent
               and self._is_seq_item(cur.start + cur.indent)):
            at = cur.start + cur.indent + 1
            while at < cur.end and self.text[at] == " ":
                at += 1
            if at >= cur.end or self.text[at] == "#":
                value, pos = self._child(cur.end + 1, indent, allow_seq_at_indent=False)
            else:
                # "- item": the item is a node that starts at its own column
                inner = _Line(at - cur.start, cur.start, cur.end)
                value, pos = self._node(inner, inner.indent)
            out.append(value)
            cur = self._next_line(pos)
        if cur is not None and cur.indent > indent:
            raise self.error("bad indentation", cur.start)
        return out, pos if cur is None else cur.start


def safe_load(stream) -> Any:
    """Parse one YAML document (a str or a text file)."""
    text = stream if isinstance(stream, str) else stream.read()
    return _BlockParser(text.replace("\r\n", "\n")).parse()


# --- writer -----------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"^[A-Za-z_/][A-Za-z0-9_./+-]*$")


def _quote(s: str) -> str:
    out = ['"']
    for ch in s:
        o = ord(ch)
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif 0x20 <= o < 0x7F:
            out.append(ch)
        elif o <= 0xFF:
            out.append(f"\\x{o:02x}")
        elif o <= 0xFFFF:
            out.append(f"\\u{o:04x}")
        else:
            out.append(f"\\U{o:08x}")
    out.append('"')
    return "".join(out)


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v)
        if "." not in s:  # 1e-05 -> 1.0e-05: YAML 1.1 floats need a dot
            s = s.replace("e", ".0e") if "e" in s else s + ".0"
        return s
    if isinstance(v, str):
        if _PLAIN_SAFE.match(v):
            try:
                if resolve_plain(v) == v:
                    return v
            except YAMLError:
                pass
        return _quote(v)
    raise TypeError(f"cannot write a {type(v).__name__} as YAML")


def _is_scalar(v: Any) -> bool:
    return not isinstance(v, (dict, list, tuple))


def _emit(v: Any, indent: int, lines: List[str], prefix: str) -> None:
    """Write ``v`` as the value after ``prefix`` (``key:`` or ``-``)."""
    pad = " " * indent
    if _is_scalar(v):
        lines.append(f"{pad}{prefix} {_scalar(v)}")
    elif isinstance(v, dict):
        if not v:
            lines.append(f"{pad}{prefix} {{}}")
            return
        lines.append(f"{pad}{prefix}")
        _emit_map(v, indent + 2, lines)
    else:
        if all(_is_scalar(x) for x in v):
            lines.append(f"{pad}{prefix} [{', '.join(_scalar(x) for x in v)}]")
            return
        lines.append(f"{pad}{prefix}")
        for x in v:
            _emit(x, indent + 2, lines, "-")


def _emit_map(d: dict, indent: int, lines: List[str]) -> None:
    for k, v in d.items():
        if not _is_scalar(k):
            raise TypeError("collection keys cannot be written as YAML")
        _emit(v, indent, lines, f"{_scalar(k)}:")


def safe_dump(obj: Any, stream=None) -> Optional[str]:
    """Write ``obj`` (a dict, as a config is) as block YAML; return the
    text, or write it to ``stream`` when one is given."""
    lines: List[str] = []
    if isinstance(obj, dict) and obj:
        _emit_map(obj, 0, lines)
    elif isinstance(obj, (list, tuple)) and obj and not all(_is_scalar(x) for x in obj):
        for x in obj:
            _emit(x, 0, lines, "-")
    else:
        lines.append(_scalar(obj) if _is_scalar(obj) else
                     ("{}" if isinstance(obj, dict) else
                      f"[{', '.join(_scalar(x) for x in obj)}]"))
    text = "\n".join(lines) + "\n"
    if stream is None:
        return text
    stream.write(text)
    return None
