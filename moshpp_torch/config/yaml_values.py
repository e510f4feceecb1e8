"""Values written the way YAML writes them, read without PyYAML.

The machine with the card has no PyYAML, yet the config's `-o key=value`
overrides and its interpolated list values are YAML. `parse_value` reads
one such value as `yaml.safe_load` does (PyYAML's YAML 1.1 rules; held to
it in tests/test_torch_config.py): plain scalars resolve to null, bool,
int, float, timestamp or str (`1e-3` stays a string, `1.0e-3` is a float;
`yes`/`on`/`NO`/`off` are booleans; `0x10`, `0o`-less octal `010`, `0b1`,
`1_000` and sexagesimal `1:30` are ints; `~` is null), single- and
double-quoted scalars are strings, and flow sequences `[a, b]` and flow
mappings `{a: 1}` nest. Anything else (block collections, anchors, tags,
aliases, block scalars) raises ValueError.
"""

from __future__ import annotations

import datetime
import re

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
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
_TIMESTAMP = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
# the resolver's own pattern: a date, or a date and a time
_TIMESTAMP_RESOLVE = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
     (?:[Tt]|[ \t]+)[0-9][0-9]?
     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW = ",[]{}"


def _sexagesimal(text: str, num):
    value = 0
    for part in text.split(":"):
        value = value * 60 + num(part)
    return value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _timestamp(text: str):
    v = _TIMESTAMP.match(text).groupdict()
    date = (int(v["year"]), int(v["month"]), int(v["day"]))
    if not v["hour"]:
        return datetime.date(*date)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0"))
    tz = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]),
                                   minutes=int(v["tz_minute"] or 0))
        tz = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(*date, int(v["hour"]), int(v["minute"]),
                             int(v["second"]), fraction, tzinfo=tz)


def resolve_plain(text: str):
    """A plain (unquoted) scalar's value under PyYAML's implicit
    resolvers."""
    if text in ("=", "<<"):
        raise ValueError(f"{text!r} is a YAML value or merge key")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if _TIMESTAMP_RESOLVE.match(text):
        return _timestamp(text)
    return text


class _Parser:
    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def fail(self, what: str):
        raise ValueError(f"{what} at column {self.i} of {self.s!r} (a value "
                         "here is a YAML scalar, flow list or flow mapping)")

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def skip_space(self) -> None:
        while self.peek() in (" ", "\t") and self.peek():
            self.i += 1
        if self.peek() == "#" and (self.i == 0 or self.s[self.i - 1] in " \t"):
            self.i = len(self.s)      # a comment runs to the end

    def end(self) -> None:
        self.skip_space()
        if self.i != len(self.s):
            self.fail("unexpected text")

    def node(self, flow: bool):
        self.skip_space()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            return self.quoted()
        if c and c in "&*!|>%@`":
            self.fail(f"unsupported YAML indicator {c!r}")
        if c in ("-", "?", ":") and self.s[self.i + 1:self.i + 2] in (" ", "\t", ""):
            if not (flow and c == "-" and self.s[self.i + 1:self.i + 2] == ""):
                self.fail(f"unsupported YAML indicator {c!r}")
        return resolve_plain(self.plain(flow))

    def plain(self, flow: bool) -> str:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1:self.i + 2]
            if flow and c in _FLOW:
                break
            if c == ":" and (nxt in (" ", "\t", "") or (flow and nxt in _FLOW)):
                break
            if c == "#" and self.i > start and self.s[self.i - 1] in " \t":
                break
            self.i += 1
        return self.s[start:self.i].strip()

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                self.fail("unterminated quoted scalar")
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.s[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not re.fullmatch(r"[0-9A-Fa-f]+",
                                                            digits):
                        self.fail("bad escape")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                else:
                    self.fail("bad escape")
                continue
            out.append(c)
            self.i += 1

    def items(self, close: str, item):
        """Comma-separated items up to `close`, a trailing comma allowed."""
        self.i += 1
        out = []
        while True:
            self.skip_space()
            if self.peek() == close:
                self.i += 1
                return out
            out.append(item())
            self.skip_space()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != close:
                self.fail(f"expected ',' or {close!r}")

    def sequence(self) -> list:
        def item():
            if self.peek() == ",":
                self.fail("an empty item")
            v = self.node(flow=True)
            self.skip_space()
            if self.peek() == ":":
                self.fail("a mapping in a sequence")
            return v
        return self.items("]", item)

    def mapping(self) -> dict:
        out = {}

        def item():
            key = self.node(flow=True)
            self.skip_space()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.skip_space()
                value = (None if self.peek() in (",", "}") else
                         self.node(flow=True))
            out[key] = value
        self.items("}", item)
        return out


def parse_value(text: str):
    """`yaml.safe_load(text)` for a one-line value: a scalar, a flow
    sequence or a flow mapping."""
    if "\n" in text or "\r" in text:
        raise ValueError(f"a value here is one line: {text!r}")
    p = _Parser(text)
    v = p.node(flow=False)
    p.end()
    return v
