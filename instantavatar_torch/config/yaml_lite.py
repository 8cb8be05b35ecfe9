"""The YAML the conf tree uses, read and written without PyYAML.

PyYAML is not among the installs the port may count on (torch, numpy,
scipy). ``safe_load`` reads the subset
that ``confs/`` and command-line overrides use: block mappings and block
sequences (a sequence may sit at its parent key's indent), flow sequences
and mappings, comments, single- and double-quoted scalars on one line, and
plain scalars. Plain scalars resolve exactly as PyYAML's ``SafeLoader``
(YAML 1.1) resolves them: ``yes``/``on`` are booleans, ``010`` is octal,
``1:30`` is sexagesimal, and ``1e-2`` is a *string* (a YAML 1.1 float needs
a dot). Anything outside the subset (anchors, tags, block scalars,
multi-line scalars, timestamps, merge keys) raises ``YAMLError`` instead
of reading differently. ``safe_dump`` writes block style that PyYAML reads
back to the same data (floats as PyYAML's representer writes them).
"""
from __future__ import annotations

import json
import math
import re
from typing import Any

__all__ = ["YAMLError", "safe_load", "safe_dump", "resolve_plain"]


class YAMLError(ValueError):
    pass


# -- PyYAML's implicit resolvers (resolver.py, YAML 1.1) ----------------------

_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
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
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[\ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)


def _sexagesimal(value: str, cast) -> Any:
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
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
        return sign * _sexagesimal(value, int)
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
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar -> its value, as PyYAML's SafeLoader."""
    if _BOOL_RE.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT_RE.match(text):
        return _construct_float(text)
    if _INT_RE.match(text):
        return _construct_int(text)
    if text == "<<":
        raise YAMLError("merge keys (<<) are not supported")
    if _NULL_RE.match(text):
        return None
    if _TIMESTAMP_RE.match(text):
        raise YAMLError(f"timestamps are not supported: {text!r}")
    if text == "=":
        raise YAMLError("the value key (=) is not supported")
    return text


# -- reader ------------------------------------------------------------------

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_LEN = {"x": 2, "u": 4, "U": 8}


def _strip_comment(line: str) -> str:
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote == "'":
            if ch == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _quoted(text: str, pos: int) -> tuple[str, int]:
    """The quoted scalar starting at text[pos]; returns (value, end)."""
    q = text[pos]
    out = []
    i = pos + 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc in _HEX_LEN:
                n = _HEX_LEN[esc]
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            if esc not in _ESCAPES:
                raise YAMLError(f"unknown escape \\{esc} in {text!r}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise YAMLError(f"unterminated or multi-line quoted scalar: {text!r}")


class _Flow:
    """Recursive-descent reader of one flow node ([...], {...}, scalars)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def node(self, in_flow: bool) -> Any:
        self._skip()
        ch = self.text[self.pos:self.pos + 1]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in ("'", '"'):
            val, self.pos = _quoted(self.text, self.pos)
            return val
        if ch and ch in "&*!|>%@`":
            raise YAMLError(f"unsupported YAML indicator {ch!r} in "
                            f"{self.text!r}")
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if in_flow and c in ",[]{}":
                break
            if c == ":" and (self.pos + 1 == len(self.text)
                             or self.text[self.pos + 1] in " \t"
                             or (in_flow and self.text[self.pos + 1] in ",]}")):
                break
            self.pos += 1
        return resolve_plain(self.text[start:self.pos].strip())

    def _expect(self, ch: str) -> None:
        self._skip()
        if self.text[self.pos:self.pos + 1] != ch:
            raise YAMLError(f"expected {ch!r} at {self.pos} in {self.text!r}")
        self.pos += 1

    def _seq(self) -> list:
        self._expect("[")
        out = []
        while True:
            self._skip()
            if self.text[self.pos:self.pos + 1] == "]":
                self.pos += 1
                return out
            out.append(self.node(True))
            self._sep("]")

    def _map(self) -> dict:
        self._expect("{")
        out = {}
        while True:
            self._skip()
            if self.text[self.pos:self.pos + 1] == "}":
                self.pos += 1
                return out
            key = self.node(True)
            self._skip()
            val = None
            if self.text[self.pos:self.pos + 1] == ":":
                self.pos += 1
                self._skip()
                if self.text[self.pos:self.pos + 1] not in (",", "}"):
                    val = self.node(True)
            out[key] = val
            self._sep("}")

    def _sep(self, close: str) -> None:
        """After a flow item: a comma, or the closing bracket next."""
        self._skip()
        ch = self.text[self.pos:self.pos + 1]
        if ch == ",":
            self.pos += 1
        elif ch != close:
            raise YAMLError(f"expected ',' or {close!r} at {self.pos} in "
                            f"{self.text!r}")


def _inline(text: str) -> Any:
    """One complete node written on one line."""
    f = _Flow(text)
    val = f.node(False)
    f._skip()
    if f.pos != len(text):
        raise YAMLError(f"unexpected text after a value: {text!r}")
    return val


def _split_key(content: str) -> tuple[Any, str] | None:
    """``key: rest`` -> (key, rest); None when the line is not a mapping
    entry."""
    if content[0] in "'\"":
        key, end = _quoted(content, 0)
        rest = content[end:].lstrip(" \t")
        if not rest.startswith(":") or rest[1:2] not in ("", " ", "\t"):
            return None
        return key, rest[1:].strip()
    if content[0] in "[{":
        return None
    for m in re.finditer(r":(?:[ \t]|$)", content):
        return resolve_plain(content[:m.start()].rstrip()), \
            content[m.end():].strip()
    return None


def _is_seq_item(content: str) -> bool:
    return content == "-" or content.startswith(("- ", "-\t"))


class _Block:
    def __init__(self, text: str):
        self.lines: list[tuple[int, str, int]] = []
        for no, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YAMLError(f"line {no}: tab in indentation")
            line = _strip_comment(raw)
            if not line.strip():
                continue
            if line.strip() in ("---", "...") and not line[0].isspace():
                if self.lines:
                    raise YAMLError(f"line {no}: one document per file")
                continue
            indent = len(line) - len(line.lstrip(" "))
            self.lines.append((indent, line.strip(), no))
        self.i = 0

    def document(self) -> Any:
        if not self.lines:
            return None
        val = self.node(self.lines[0][0])
        if self.i != len(self.lines):
            ind, content, no = self.lines[self.i]
            raise YAMLError(f"line {no}: unexpected indentation: {content!r}")
        return val

    def node(self, indent: int) -> Any:
        ind, content, no = self.lines[self.i]
        if _is_seq_item(content):
            return self.seq(ind)
        if _split_key(content) is not None:
            return self.mapping(ind)
        if content[0] in "|>":
            raise YAMLError(f"line {no}: block scalars are not supported")
        self.i += 1
        val = _inline(content)
        self._no_continuation(ind, no)
        return val

    def _no_continuation(self, indent: int, no: int) -> None:
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise YAMLError(f"line {no}: multi-line scalars are not "
                            f"supported")

    def _value(self, indent: int, rest: str, no: int,
               seq_at_indent: bool) -> Any:
        if rest:
            if rest[0] in "|>":
                raise YAMLError(f"line {no}: block scalars are not "
                                f"supported")
            val = _inline(rest)
            self._no_continuation(indent, no)
            return val
        if self.i < len(self.lines):
            nind, ncontent, _ = self.lines[self.i]
            if nind > indent:
                return self.node(nind)
            if seq_at_indent and nind == indent and _is_seq_item(ncontent):
                return self.seq(nind)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, content, no = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent or _is_seq_item(content):
                raise YAMLError(f"line {no}: bad indentation: {content!r}")
            kv = _split_key(content)
            if kv is None:
                raise YAMLError(f"line {no}: expected 'key: value', got "
                                f"{content!r}")
            self.i += 1
            key, rest = kv
            out[key] = self._value(indent, rest, no, True)
        return out

    def seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, content, no = self.lines[self.i]
            if ind != indent or not _is_seq_item(content):
                if ind > indent:
                    raise YAMLError(f"line {no}: bad indentation: "
                                    f"{content!r}")
                break
            rest = content[1:].lstrip(" \t")
            if not rest:
                self.i += 1
                out.append(self._value(indent, "", no, False))
                continue
            # "- key: v" / "- - x": the item is a node that starts at the
            # column of ``rest``
            col = indent + len(content) - len(rest)
            self.lines[self.i] = (col, rest, no)
            out.append(self.node(col))
        return out


def safe_load(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    return _Block(text).document()


# -- writer ------------------------------------------------------------------

_PLAIN_FIRST_BAD = set("-?:,[]{}#&*!|>'\"%@` \t")


def _reads_back(s: str) -> bool:
    """Whether ``s`` written plain reads back as this string."""
    try:
        return resolve_plain(s) == s
    except YAMLError:
        return False


def _str(s: str) -> str:
    if (s and s == s.strip() and s[0] not in _PLAIN_FIRST_BAD
            and ": " not in s and " #" not in s and not s.endswith(":")
            and s.isprintable() and _reads_back(s)):
        return s
    if s.isprintable():
        return "'" + s.replace("'", "''") + "'"
    return json.dumps(s)


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        return _str(v)
    if isinstance(v, dict) and not v:
        return "{}"
    if isinstance(v, (list, tuple)) and not v:
        return "[]"
    raise YAMLError(f"cannot write a {type(v).__name__} as YAML")


def _emit(obj: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, (dict, list, tuple)) and v:
                out.append(f"{pad}{_scalar(k)}:")
                _emit(v, indent + 2, out)
            else:
                out.append(f"{pad}{_scalar(k)}: {_scalar(v)}")
    else:
        for v in obj:
            if isinstance(v, (dict, list, tuple)) and v:
                sub: list[str] = []
                _emit(v, indent + 2, sub)
                out.append(f"{pad}- {sub[0][indent + 2:]}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_scalar(v)}")


def safe_dump(obj: Any) -> str:
    """Block-style YAML of plain data (dicts, lists, scalars), keys in
    insertion order."""
    if isinstance(obj, (dict, list, tuple)) and obj:
        out: list[str] = []
        _emit(obj, 0, out)
        return "\n".join(out) + "\n"
    return _scalar(obj) + "\n"
