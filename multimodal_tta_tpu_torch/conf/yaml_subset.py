"""A reader and a writer of the YAML the configs use, without PyYAML.

``load(text)`` gives what ``yaml.safe_load(text)`` gives for the subset that
``configs/**/*.yaml`` and the command-line override values use, YAML 1.1's
scalar rules included (so a dot-less ``1e-4`` stays the string ``'1e-4'``,
``yes``/``on`` are booleans and ``010`` is 8):

  - block mappings and block sequences (a sequence may sit at its key's
    indentation), nested by indentation;
  - flow sequences and flow mappings (``{ET: [3], TC: [1, 3]}``), also over
    several lines;
  - plain, single-quoted and double-quoted scalars; ``null``/``~``,
    booleans, ints (binary, octal, hex, base 60), floats (``.inf``,
    ``.nan``), dates and timestamps;
  - ``#`` comments.

Anchors, aliases, tags, block scalars (``|``, ``>``), complex keys (``?``),
merge keys, directives and multi-document streams raise ``YAMLSubsetError``,
as does any text that is not YAML.

``dump(data)`` writes a container of dicts, lists and scalars as block YAML
(lists of scalars in flow style) that ``load`` and ``yaml.safe_load`` read
back to an equal container.
"""

from __future__ import annotations

import datetime
import math
import re
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

__all__ = ["YAMLSubsetError", "load", "dump", "resolve_plain"]


class YAMLSubsetError(ValueError):
    """The text is not YAML, or uses a feature outside the subset."""


# ---------------------------------------------------------------------------
# YAML 1.1 plain-scalar resolution (PyYAML's implicit resolvers, in their
# order: bool, float, int, merge, null, timestamp, value)
# ---------------------------------------------------------------------------

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_NULL = {"", "~", "null", "Null", "NULL"}
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?
    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
    -(?P<month>[0-9][0-9]?)
    -(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)
    (?P<hour>[0-9][0-9]?)
    :(?P<minute>[0-9][0-9])
    :(?P<second>[0-9][0-9])
    (?:\.(?P<fraction>[0-9]*))?
    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
    (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)


def _base60(value: str) -> float:
    total, base = 0.0, 1
    for part in reversed(value.split(":")):
        total += float(part) * base
        base *= 60
    return total


def _construct_int(value: str) -> int:
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
        return sign * int(_base60(value))
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _base60(value)
    return sign * float(value)


def _construct_timestamp(value: str):
    m = _TIMESTAMP_PARTS.match(value)
    year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
    if not m["hour"]:
        return datetime.date(year, month, day)
    fraction = 0
    if m["fraction"]:
        fraction = int(m["fraction"][:6].ljust(6, "0"))
    tzinfo = None
    if m["tz_sign"]:
        delta = datetime.timedelta(hours=int(m["tz_hour"]), minutes=int(m["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
    elif m["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(m["hour"]), int(m["minute"]), int(m["second"]),
                             fraction, tzinfo=tzinfo)


def resolve_plain(text: str) -> Any:
    """The value of a plain (unquoted) scalar under YAML 1.1's rules."""
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT_RE.match(text):
        return _construct_float(text)
    if _INT_RE.match(text):
        return _construct_int(text)
    if text == "<<" or text == "=":
        raise YAMLSubsetError(f"merge and value keys are outside the subset: {text!r}")
    if text in _NULL:
        return None
    if _TIMESTAMP_RE.match(text):
        return _construct_timestamp(text)
    return text


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
            "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_UNSUPPORTED_START = "&*!|>%@`"
_FLOW_END = ",[]{}"


@dataclass
class _Line:
    indent: int
    text: str  # content after the indentation, comment and trailing blanks removed
    number: int  # 1-based, for messages


def _quoted_end(s: str, i: int) -> int:
    """Index just past the quoted scalar that starts at ``s[i]``."""
    q = s[i]
    j = i + 1
    while j < len(s):
        if q == "'" and s[j] == "'":
            if j + 1 < len(s) and s[j + 1] == "'":
                j += 2
                continue
            return j + 1
        if q == '"':
            if s[j] == "\\":
                j += 2
                continue
            if s[j] == '"':
                return j + 1
        j += 1
    raise YAMLSubsetError(f"unterminated quoted scalar: {s[i:]!r}")


def _token_start(s: str, i: int) -> bool:
    """Whether a quote at ``s[i]`` opens a quoted scalar (it follows the line
    start, an indicator or a flow delimiter) rather than sitting inside a
    plain scalar."""
    if i == 0 or s[i - 1] in "[{,":
        return True
    if s[i - 1] not in " \t":
        return False
    prev = s[:i].rstrip()
    return prev == "" or prev[-1] in ":-[{,?"


def _strip_comment(s: str) -> str:
    i = 0
    while i < len(s):
        c = s[i]
        if c in "'\"" and _token_start(s, i):
            i = _quoted_end(s, i)
            continue
        if c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


def _lines(text: str) -> List[_Line]:
    out = []
    for n, raw in enumerate(text.replace("\r\n", "\n").replace("\r", "\n").split("\n"), 1):
        body = raw.lstrip(" ")
        indent = len(raw) - len(body)
        if body.startswith("\t") and _strip_comment(body.lstrip(" \t")):
            raise YAMLSubsetError(f"line {n}: a tab in the indentation")
        body = _strip_comment(body)
        if not body.strip():
            continue
        if indent == 0 and (body.startswith("%") or body in ("---", "...")
                            or body.startswith(("--- ", "... "))):
            raise YAMLSubsetError(f"line {n}: directives and document markers are outside the subset")
        out.append(_Line(indent, body, n))
    return out


def _double_unquote(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1] if i + 1 < len(body) else ""
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _ESCAPE_CODES:
            n = _ESCAPE_CODES[e]
            digits = body[i + 2:i + 2 + n]
            if len(digits) != n or not all(ch in "0123456789abcdefABCDEF" for ch in digits):
                raise YAMLSubsetError(f"bad escape in double-quoted scalar: {body[i:i + 2 + n]!r}")
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            raise YAMLSubsetError(f"unknown escape in double-quoted scalar: \\{e}")
    return "".join(out)


def _quoted_value(s: str, i: int) -> Tuple[str, int]:
    end = _quoted_end(s, i)
    body = s[i + 1:end - 1]
    if s[i] == "'":
        return body.replace("''", "'"), end
    return _double_unquote(body), end


def _skip_blank(s: str, i: int) -> int:
    while i < len(s) and s[i] in " \t":
        i += 1
    return i


class _Flow:
    """Recursive descent over one flow collection (its lines joined)."""

    def __init__(self, s: str):
        self.s = s

    def error(self, i: int, what: str):
        raise YAMLSubsetError(f"{what} at column {i + 1} of flow text {self.s!r}")

    def node(self, i: int) -> Tuple[Any, int]:
        i = _skip_blank(self.s, i)
        if i >= len(self.s):
            self.error(i, "unexpected end")
        c = self.s[i]
        if c == "[":
            return self.seq(i + 1)
        if c == "{":
            return self.mapping(i + 1)
        if c in "'\"":
            return _quoted_value(self.s, i)
        if c in _UNSUPPORTED_START or c == "?":
            self.error(i, f"{c!r} is outside the subset")
        return self.plain(i)

    def plain(self, i: int) -> Tuple[Any, int]:
        j = i
        s = self.s
        while j < len(s):
            c = s[j]
            if c in ",?[]{}":
                break
            if c == ":" and (j + 1 == len(s) or s[j + 1] in " \t" + _FLOW_END):
                break
            j += 1
        text = s[i:j].strip()
        if not text:
            self.error(i, "empty plain scalar")
        return resolve_plain(text), j

    def _value_follows(self, i: int) -> Optional[int]:
        i = _skip_blank(self.s, i)
        if i < len(self.s) and self.s[i] == ":":
            return i + 1
        return None

    def seq(self, i: int) -> Tuple[list, int]:
        out = []
        while True:
            i = _skip_blank(self.s, i)
            if i >= len(self.s):
                self.error(i, "unclosed '['")
            if self.s[i] == "]":
                return out, i + 1
            item, i = self.node(i)
            after = self._value_follows(i)
            if after is not None:  # a single-pair mapping inside a sequence
                value, i = self.node(after) if self._more(after) else (None, after)
                item = {item: value}
            i = _skip_blank(self.s, i)
            if i < len(self.s) and self.s[i] == ",":
                i += 1
            elif i < len(self.s) and self.s[i] != "]":
                self.error(i, "expected ',' or ']'")
            out.append(item)

    def _more(self, i: int) -> bool:
        i = _skip_blank(self.s, i)
        return i < len(self.s) and self.s[i] not in ",]}"

    def mapping(self, i: int) -> Tuple[dict, int]:
        out = {}
        while True:
            i = _skip_blank(self.s, i)
            if i >= len(self.s):
                self.error(i, "unclosed '{'")
            if self.s[i] == "}":
                return out, i + 1
            key, i = self.node(i)
            after = self._value_follows(i)
            value = None
            if after is not None:
                i = after
                if self._more(i):
                    value, i = self.node(i)
            _check_key(key)
            out[key] = value
            i = _skip_blank(self.s, i)
            if i < len(self.s) and self.s[i] == ",":
                i += 1
            elif i < len(self.s) and self.s[i] != "}":
                self.error(i, "expected ',' or '}'")


def _check_key(key: Any) -> None:
    if isinstance(key, (list, dict)):
        raise YAMLSubsetError(f"a collection as a mapping key is outside the subset: {key!r}")


def _flow_depth(s: str) -> int:
    depth, i = 0, 0
    while i < len(s):
        c = s[i]
        if c in "'\"" and _token_start(s, i):
            i = _quoted_end(s, i)
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return depth


class _Block:
    def __init__(self, lines: List[_Line]):
        self.lines = lines

    def error(self, k: int, what: str):
        n = self.lines[k].number if k < len(self.lines) else "end"
        raise YAMLSubsetError(f"line {n}: {what}")

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == "-" or text.startswith(("- ", "-\t"))

    @staticmethod
    def split_key(text: str) -> Optional[Tuple[Any, str]]:
        """``(key, rest)`` when ``text`` is a block mapping entry."""
        if text[0] in "[{" or _Block._is_item(text) or text.startswith(("? ", "?\t")) or text == "?":
            if text[0] == "?":
                raise YAMLSubsetError(f"complex keys are outside the subset: {text!r}")
            return None
        if text[0] in "'\"":
            key, j = _quoted_value(text, 0)
            j = _skip_blank(text, j)
            if j < len(text) and text[j] == ":" and (j + 1 == len(text) or text[j + 1] in " \t"):
                return key, text[j + 1:].strip()
            return None
        for j, c in enumerate(text):
            if c == ":" and (j + 1 == len(text) or text[j + 1] in " \t"):
                raw = text[:j].strip()
                if raw[0] in _UNSUPPORTED_START:
                    raise YAMLSubsetError(f"{raw[0]!r} is outside the subset: {text!r}")
                return resolve_plain(raw), text[j + 1:].strip()
        return None

    def node(self, k: int, floor: int) -> Tuple[Any, int]:
        """The node that starts at line ``k``; lines of its own sit deeper
        than ``floor``, the indentation of what encloses it."""
        text = self.lines[k].text
        if self._is_item(text):
            return self.seq(k)
        if self.split_key(text) is not None:
            return self.mapping(k)
        value, k = self.inline(k, text)
        if k < len(self.lines) and self.lines[k].indent > floor:
            self.error(k, "a scalar that continues over several lines is outside the subset")
        return value, k

    def inline(self, k: int, text: str) -> Tuple[Any, int]:
        """A value written on the line of its key or item (and, for a flow
        collection, on the lines that follow until it closes)."""
        c = text[0]
        if c in "[{":
            start = k
            while _flow_depth(text) > 0:
                k += 1
                if k >= len(self.lines):
                    self.error(start, "unclosed flow collection")
                text = text + " " + self.lines[k].text
            value, j = _Flow(text).node(0)
            if text[j:].strip():
                self.error(start, f"unexpected text after a flow collection: {text[j:]!r}")
            return value, k + 1
        if c in "'\"":
            value, j = _quoted_value(text, 0)
            if text[j:].strip():
                self.error(k, f"unexpected text after a quoted scalar: {text[j:]!r}")
            return value, k + 1
        if c in _UNSUPPORTED_START:
            self.error(k, f"{c!r} (anchor, alias, tag, block scalar or reserved) is outside the subset")
        for j, ch in enumerate(text):
            if ch == ":" and (j + 1 == len(text) or text[j + 1] in " \t"):
                self.error(k, "mapping values are not allowed here")
        return resolve_plain(text), k + 1

    def mapping(self, k: int) -> Tuple[dict, int]:
        indent = self.lines[k].indent
        out = {}
        while k < len(self.lines) and self.lines[k].indent == indent:
            entry = self.split_key(self.lines[k].text)
            if entry is None:
                self.error(k, "expected a 'key: value' entry")
            key, rest = entry
            _check_key(key)
            if rest:
                if self._is_item(rest):
                    self.error(k, "a block sequence cannot start on its key's line")
                value, k = self.inline(k, rest)
                if k < len(self.lines) and self.lines[k].indent > indent:
                    self.error(k, "unexpected indentation (a multi-line scalar is outside the subset)")
            else:
                k += 1
                if k < len(self.lines) and self.lines[k].indent > indent:
                    value, k = self.node(k, indent)
                elif k < len(self.lines) and self.lines[k].indent == indent and self._is_item(self.lines[k].text):
                    value, k = self.seq(k)
                else:
                    value = None
            out[key] = value
        if k < len(self.lines) and self.lines[k].indent > indent:
            self.error(k, "unexpected indentation")
        return out, k

    def seq(self, k: int) -> Tuple[list, int]:
        indent = self.lines[k].indent
        out = []
        while k < len(self.lines) and self.lines[k].indent == indent and self._is_item(self.lines[k].text):
            line = self.lines[k]
            rest = line.text[1:]
            body = rest.lstrip(" \t")
            if not body:
                k += 1
                if k < len(self.lines) and self.lines[k].indent > indent:
                    value, k = self.node(k, indent)
                else:
                    value = None
            else:
                # the item's content as a line of its own at its column
                self.lines[k] = _Line(indent + 1 + len(rest) - len(body), body, line.number)
                value, k = self.node(k, indent)
            out.append(value)
        if k < len(self.lines) and self.lines[k].indent > indent:
            self.error(k, "unexpected indentation")
        return out, k


def load(text: str) -> Any:
    """Parse ``text`` as ``yaml.safe_load`` would; ``None`` for an empty
    document. Raises ``YAMLSubsetError`` outside the subset."""
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value, k = block.node(0, -1)
    if k < len(lines):
        block.error(k, "unexpected content after the document's top-level node")
    return value


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

# a string is written plain only when it is made of these characters and
# reads back as itself; every other string is double-quoted
_PLAIN_RE = re.compile(r"[A-Za-z0-9_$^(/.][A-Za-z0-9_$^()|/.+=<>~-]*")


def _quote(s: str) -> str:
    out = []
    for c in s:
        o = ord(c)
        if c == "\\" or c == '"':
            out.append("\\" + c)
        elif o < 0x20 or 0x7F <= o <= 0x9F or c in "\u2028\u2029\ufeff":
            out.append(f"\\x{o:02x}" if o <= 0xFF else f"\\u{o:04x}")
        else:
            out.append(c)
    return '"' + "".join(out) + '"'


def _plain_ok(s: str) -> bool:
    if not _PLAIN_RE.fullmatch(s):
        return False
    try:
        value = resolve_plain(s)
    except YAMLSubsetError:
        return False
    return isinstance(value, str) and value == s


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
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    if isinstance(v, str):
        return v if _plain_ok(v) else _quote(v)
    raise YAMLSubsetError(f"cannot write a {type(v).__name__} as YAML")


def _flowable(v: Any) -> bool:
    if isinstance(v, dict):
        return not v
    if isinstance(v, (list, tuple)):
        return all(_flowable(x) for x in v)
    return True


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_inline(x) for x in v) + "]"
    return _scalar(v)


def _emit(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for key, val in v.items():
            head = f"{pad}{_scalar(key)}:"
            if _flowable(val):
                out.append(f"{head} {_inline(val)}")
            else:
                out.append(head)
                _emit(val, indent + 2, out)
    elif isinstance(v, (list, tuple)):
        for item in v:
            if _flowable(item):
                out.append(f"{pad}- {_inline(item)}")
                continue
            sub: List[str] = []
            _emit(item, indent + 2, sub)
            out.append(f"{pad}- {sub[0][indent + 2:]}")
            out.extend(sub[1:])
    else:
        out.append(pad + _scalar(v))


def dump(data: Any) -> str:
    """Block YAML for ``data`` (dicts, lists, tuples and scalars)."""
    if _flowable(data):
        return _inline(data) + "\n"
    out: List[str] = []
    _emit(data, 0, out)
    return "\n".join(out) + "\n"
