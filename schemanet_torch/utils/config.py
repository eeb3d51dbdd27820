"""Compositional config loading (port of ``schemanet_tpu/utils/config.py``).

A config file is loaded into a plain dict; values that are paths to other
config files (the ``dataset:`` and ``model:`` keys of the experiment configs)
are read by ``resolve_subconfig``, and ``apply_overrides`` applies dotted-path
overrides from the command line, descending through such references and list
indices.

The port never imports PyYAML, so a config reads the same on every machine
(the card's has none). A file in JSON syntax is read with ``json``; anything
else with ``load_yaml``, a reader of the YAML the repository's configs use:
block mappings, block sequences of scalars and of mappings, flow sequences
(``[0, 1]``), full-line and trailing comments, single- and double-quoted
strings, and empty values (None). Plain scalars are typed by the implicit
resolvers of PyYAML's ``SafeLoader`` (YAML 1.1's bool, int, float and null),
so ``1.0e-05`` is a float, ``1e-3`` a string and ``yes`` a bool, as
``yaml.safe_load`` gives them. Anything else (anchors and aliases, tags, block
scalars, flow mappings, document markers, timestamps, a scalar continued on
the next line) raises ``ValueError`` naming the file and the line. Override
values (``-o key=value``) are typed by the same rules.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

# The implicit resolvers of PyYAML's SafeLoader (yaml/resolver.py, PyYAML
# 6.0), with the first characters each is tried for, in PyYAML's order.
#
# PyYAML: Copyright (c) 2017-2021 Ingy döt Net, Copyright (c) 2006-2016
# Kirill Simonov. Permission is hereby granted, free of charge, to any person
# obtaining a copy of this software and associated documentation files (the
# "Software"), to deal in the Software without restriction, including without
# limitation the rights to use, copy, modify, merge, publish, distribute,
# sublicense, and/or sell copies of the Software, and to permit persons to
# whom the Software is furnished to do so, subject to the following
# conditions: The above copyright notice and this permission notice shall be
# included in all copies or substantial portions of the Software. THE
# SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND, EXPRESS OR
# IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF MERCHANTABILITY,
# FITNESS FOR A PARTICULAR PURPOSE AND NONINFRINGEMENT. IN NO EVENT SHALL THE
# AUTHORS OR COPYRIGHT HOLDERS BE LIABLE FOR ANY CLAIM, DAMAGES OR OTHER
# LIABILITY, WHETHER IN AN ACTION OF CONTRACT, TORT OR OTHERWISE, ARISING
# FROM, OUT OF OR IN CONNECTION WITH THE SOFTWARE OR THE USE OR OTHER DEALINGS
# IN THE SOFTWARE.
_RESOLVERS = (
    ("bool", re.compile(r'''^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$''', re.X), "yYnNtTfFoO"),
    ("float", re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X), "-+0123456789."),
    ("int", re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X), "-+0123456789"),
    ("merge key", re.compile(r'^(?:<<)$'), "<"),
    ("null", re.compile(r'''^(?: ~
                    |null|Null|NULL
                    | )$''', re.X), "~nN"),
    ("timestamp", re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''', re.X), "0123456789"),
    ("value key", re.compile(r'^(?:=)$'), "="),
)
# double-quoted escapes (yaml/scanner.py)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0A",
            "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B", " ": " ", '"': '"', "\\": "\\",
            "/": "/", "N": "\x85", "_": "\xA0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# what a plain scalar may not start with, and why
_REFUSED_STARTS = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                   ">": "block scalars", "{": "flow mappings", "%": "directives",
                   "@": "reserved indicators", "`": "reserved indicators"}


def _sexagesimal(value: str, kind):
    total = kind(0)
    for part in value.split(":"):
        total = total * 60 + kind(part)
    return total


def _construct(kind: str, value: str):
    """SafeConstructor's ``construct_yaml_{bool,int,float}``."""
    if kind == "bool":
        return value.lower() in ("yes", "true", "on")
    if kind == "null":
        return None
    value = value.replace("_", "")
    if kind == "float":
        value = value.lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if kind == "float":
        if value == ".inf":
            return sign * float("inf")
        if value == ".nan":
            return float("nan")
        return sign * (_sexagesimal(value, float) if ":" in value else float(value))
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    return sign * (_sexagesimal(value, int) if ":" in value else int(value))


class _Reader:
    """One document of the YAML subset, line by line."""

    def __init__(self, text: str, source: str):
        self.source = source
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        for number, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw:
                self.fail(number, "tabs are not supported")
            content = raw.strip(" ")
            if not content or content.startswith("#"):
                continue
            indent = len(raw) - len(raw.lstrip(" "))
            if indent == 0 and (content in ("---", "...") or content.startswith(("--- ", "... "))):
                self.fail(number, "document markers (several documents) are not supported")
            self.lines.append((number, indent, content))
        self.number = self.lines[0][0] if self.lines else 1

    def fail(self, number: int, what: str):
        raise ValueError(f"{self.source}, line {number}: {what}")

    def document(self):
        if not self.lines:
            return None
        value, i = self.node(0)
        if i < len(self.lines):
            self.fail(self.lines[i][0], "unexpected indentation")
        return value

    # scalars

    def scalar(self, text: str):
        """A plain scalar (stripped) typed by the resolvers."""
        candidates = [r for r in _RESOLVERS if text[:1] in r[2]] if text else [_RESOLVERS[4]]
        for kind, pattern, _ in candidates:
            if pattern.match(text):
                if kind not in ("bool", "int", "float", "null"):
                    self.fail(self.number, f"{kind}s are not supported ({text!r})")
                try:
                    return _construct(kind, text)
                except ValueError as exc:
                    self.fail(self.number, f"bad {kind} {text!r} ({exc})")
        return text

    def check_plain(self, text: str, flow: bool = False, after: str = ""):
        """Refuse what cannot start or sit inside a plain scalar (``after``:
        the character that follows it on its line)."""
        first, second = text[0], text[1:2] or after
        if first in _REFUSED_STARTS:
            self.fail(self.number, f"{_REFUSED_STARTS[first]} are not supported ({text!r})")
        if (first in ",[]}#'\"" or (flow and first in "?:")
                or (first in "-?:" and second in ("", " "))):
            self.fail(self.number, f"unexpected {first!r} at the start of {text!r}")
        full = text + after
        for k, ch in enumerate(text):
            nxt = full[k + 1:k + 2]
            if ch == ":" and (nxt in ("", " ") or (flow and nxt in ",[]{}")):
                self.fail(self.number, f"a mapping value inside the scalar {text!r}")
            if flow and ch in "[]{}?":
                self.fail(self.number, f"unexpected {ch!r} in the flow sequence item {text!r}")

    def quoted(self, text: str, pos: int) -> Tuple[str, int]:
        """The quoted scalar at ``text[pos]`` and the position after it."""
        quote, pos, out = text[pos], pos + 1, []
        while True:
            if pos >= len(text):
                self.fail(self.number, "a quoted string must close on its line")
            ch = text[pos]
            if quote == "'":
                if ch == "'":
                    if text[pos + 1:pos + 2] != "'":
                        return "".join(out), pos + 1
                    pos += 1
                out.append(ch)
                pos += 1
            elif ch == '"':
                return "".join(out), pos + 1
            elif ch == "\\":
                esc = text[pos + 1:pos + 2]
                if esc in _ESCAPES and esc:
                    out.append(_ESCAPES[esc])
                    pos += 2
                elif esc in _ESCAPE_CODES:
                    digits = text[pos + 2:pos + 2 + _ESCAPE_CODES[esc]]
                    if (len(digits) != _ESCAPE_CODES[esc]
                            or not all(c in "0123456789abcdefABCDEF" for c in digits)):
                        self.fail(self.number, f"bad escape \\{esc}{digits}")
                    out.append(chr(int(digits, 16)))
                    pos += 2 + len(digits)
                else:
                    self.fail(self.number, f"unsupported escape \\{esc}")
            else:
                out.append(ch)
                pos += 1

    def flow_sequence(self, text: str, pos: int) -> Tuple[list, int]:
        """The flow sequence at ``text[pos] == '['`` and the position after it."""
        pos, items = pos + 1, []
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text) or text[pos] == "#":
                self.fail(self.number, "a flow sequence must close on its line")
            ch = text[pos]
            if ch == "]":
                return items, pos + 1
            if ch == "[":
                item, pos = self.flow_sequence(text, pos)
            elif ch in "'\"":
                item, pos = self.quoted(text, pos)
            else:
                end = pos
                while end < len(text) and text[end] not in ",]":
                    if text[end] == "#" and text[end - 1] == " ":
                        self.fail(self.number, "a flow sequence must close on its line")
                    end += 1
                plain = text[pos:end].strip(" ")
                if not plain:
                    self.fail(self.number, "an empty flow sequence item")
                self.check_plain(plain, flow=True, after=text[end:end + 1])
                item, pos = self.scalar(plain), end
            items.append(item)
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text):
                self.fail(self.number, "a flow sequence must close on its line")
            if text[pos] == ",":
                pos += 1
            elif text[pos] != "]":
                self.fail(self.number, "expected ',' or ']' in a flow sequence")

    def rest_is_blank(self, text: str, pos: int) -> None:
        rest = text[pos:].strip(" ")
        if rest and not rest.startswith("#"):
            self.fail(self.number, f"unexpected text after a value: {rest!r}")

    def value(self, text: str):
        """An inline value (stripped): a quoted scalar, a flow sequence or a
        plain scalar, with an optional trailing comment."""
        if not text or text.startswith("#"):
            return None
        if text[0] in "'\"":
            value, pos = self.quoted(text, 0)
        elif text[0] == "[":
            value, pos = self.flow_sequence(text, 0)
        else:
            cut = re.search(r" #", text)
            plain = (text[:cut.start()] if cut else text).rstrip(" ")
            self.check_plain(plain)
            return self.scalar(plain)
        self.rest_is_blank(text, pos)
        return value

    # block structure

    def key_of(self, content: str) -> Optional[Tuple[Any, str]]:
        """``(key, rest)`` where ``content`` is a mapping entry, else None."""
        if content[0] in "'\"":
            key, pos = self.quoted(content, 0)
            rest = content[pos:].lstrip(" ")
            if not rest.startswith(":") or rest[1:2] not in ("", " "):
                return None
            return key, rest[1:].strip(" ")
        if content[0] == "[":
            return None
        if content[0] == "?" and content[1:2] in ("", " "):
            self.fail(self.number, "complex mapping keys are not supported")
        cut = re.search(r" #", content)
        head = content[:cut.start()] if cut else content
        colon = re.search(r":( |$)", head)
        if colon is None:
            return None
        key = head[:colon.start()].rstrip(" ")
        if not key:
            self.fail(self.number, "an empty mapping key")
        self.check_plain(key, after=":")
        return self.scalar(key), content[colon.end():].strip(" ")

    @staticmethod
    def is_entry(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def node(self, i: int):
        """The node whose first line is ``lines[i]``, at that line's indent."""
        number, indent, content = self.lines[i]
        self.number = number
        if self.is_entry(content):
            return self.sequence(i, indent)
        if self.key_of(content) is not None:
            return self.mapping(i, indent)
        value = self.value(content)
        if i + 1 < len(self.lines) and self.lines[i + 1][1] >= indent:
            self.fail(self.lines[i + 1][0], "a scalar continued on the next line is not "
                                            "supported")
        return value, i + 1

    def nested(self, i: int, indent: int, allow_entries: bool):
        """The value of an entry with nothing after its indicator: the block
        below it, a sequence at the same indent (for a mapping key), or None."""
        if i < len(self.lines):
            below = self.lines[i]
            if below[1] > indent:
                return self.node(i)
            if allow_entries and below[1] == indent and self.is_entry(below[2]):
                return self.sequence(i, indent)
        return None, i

    def mapping(self, i: int, indent: int):
        out: Dict[Any, Any] = {}
        while i < len(self.lines) and self.lines[i][1] == indent:
            number, _, content = self.lines[i]
            self.number = number
            entry = self.key_of(content)
            if entry is None:
                self.fail(number, f"expected 'key: value', got {content!r}")
            key, rest = entry
            if rest and not rest.startswith("#"):
                out[key] = self.value(rest)
                i += 1
                if i < len(self.lines) and self.lines[i][1] > indent:
                    self.fail(self.lines[i][0], "unexpected indentation (a value continued on "
                                                "the next line is not supported)")
            else:
                out[key], i = self.nested(i + 1, indent, allow_entries=True)
        return out, i

    def sequence(self, i: int, indent: int):
        out: list = []
        while (i < len(self.lines) and self.lines[i][1] == indent
               and self.is_entry(self.lines[i][2])):
            number, _, content = self.lines[i]
            self.number = number
            rest = content[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                item, i = self.nested(i + 1, indent, allow_entries=False)
            else:  # the rest of the line is a node at its own column
                self.lines[i] = (number, indent + len(content) - len(rest), rest)
                item, i = self.node(i)
            out.append(item)
        return out, i


def load_yaml(text: str, source: str = "<string>"):
    """One YAML document of the subset the module docstring names, as
    ``yaml.safe_load`` reads it; ``source`` names it in errors."""
    return _Reader(text, source).document()


def get_cfg(path: str) -> Dict[str, Any]:
    """Load a config file into a dict (expanding ~ and environment variables):
    JSON syntax with ``json``, anything else with ``load_yaml``."""
    path = os.path.expandvars(os.path.expanduser(str(path)))
    with open(path, "r") as f:
        text = f.read()
    try:
        cfg = json.loads(text)
    except json.JSONDecodeError:
        cfg = load_yaml(text, path)
    return {} if cfg is None else cfg


def resolve_subconfig(value: Any, base_dir: Optional[str] = None) -> Dict[str, Any]:
    """An inline config block, or the config file it names (tried as given,
    then under ``base_dir``, so configs are usable from any directory)."""
    if isinstance(value, dict):
        return value
    if not isinstance(value, str):
        raise TypeError(f"expected dict or path, got {type(value)}")
    candidates = [value]
    if base_dir is not None:
        candidates.append(os.path.join(base_dir, value))
    for cand in candidates:
        expanded = os.path.expandvars(os.path.expanduser(cand))
        if os.path.isfile(expanded):
            return get_cfg(expanded)
    raise FileNotFoundError(f"sub-config not found: {value!r} (tried {candidates})")


def apply_overrides(cfg: Dict[str, Any], overrides: Dict[str, Any],
                    base_dir: Optional[str] = None) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` dotted-path overrides, returning a copy.

    A path may descend through a sub-config file reference (e.g.
    ``dataset.num_classes`` where the config has ``dataset:
    configs/datasets/synthetic.yaml``): the reference is read inline first,
    and a file that wraps its payload under the same key (the ``model:``
    convention) is unwrapped. Integer segments index into lists
    (``training.param_groups.0.cfg.nu_dtype=bfloat16``)."""
    out = copy.deepcopy(cfg)
    for dotted, value in overrides.items():
        node = out
        parts = dotted.split(".")
        for key in parts[:-1]:
            if isinstance(node, list):
                node = node[int(key)]
                continue
            child = node.get(key) if isinstance(node, dict) else None
            if isinstance(child, str):
                resolved = resolve_subconfig(child, base_dir)
                node[key] = resolved.get(key, resolved)
            node = node.setdefault(key, {})
        if isinstance(node, list):
            node[int(parts[-1])] = value
        else:
            node[parts[-1]] = value
    return out


def parse_override_strings(pairs) -> Dict[str, Any]:
    """Parse ``key=value`` strings; each value is a YAML document of the
    subset ``load_yaml`` reads, typed as ``yaml.safe_load`` types it
    (``bfloat16`` a string, ``3`` an int, ``[0, 1]`` a list, ``1e-3`` a
    string)."""
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        out[key.strip()] = load_yaml(raw, f"override {pair!r}")
    return out
