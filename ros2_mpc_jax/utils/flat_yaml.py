"""Reader for the flat YAML files of the reference's formats.

``params.yaml`` (config/params.yaml) and map_server map files (maps/*.yaml)
are flat mappings of ``key: scalar`` and ``key: list``, the list written
either inline (``key: [a, b]``) or as a block of ``- item`` lines. This
module reads exactly that subset, so the controller and the nav
stack need no YAML library. Anything outside it (nested mappings, multi-line
strings, anchors) raises ``ValueError`` instead of being misread.
"""

from __future__ import annotations


def _scalar(text: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("", "~", "null"):
        return None
    for kind in (int, float):
        try:
            return kind(t)
        except ValueError:
            pass
    return t


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at line start or after whitespace, outside
    quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def loads(text: str) -> dict:
    """Parse a flat YAML mapping (see the module docstring)."""
    out: dict = {}
    key = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        item = line.strip()
        if not item or item == "---":
            continue
        if item == "-" or item.startswith("- "):
            if key is None or not (out[key] is None or isinstance(out[key], list)):
                raise ValueError(f"line {n}: list item outside a list: {raw!r}")
            out[key] = (out[key] or []) + [_scalar(item[1:])]
            continue
        if line[0].isspace():
            raise ValueError(f"line {n}: nested mappings are not supported: {raw!r}")
        k, sep, v = line.partition(":")
        if not sep:
            raise ValueError(f"line {n}: expected 'key: value': {raw!r}")
        key, v = k.strip(), v.strip()
        if v.startswith("["):
            if not v.endswith("]"):
                raise ValueError(f"line {n}: unterminated inline list: {raw!r}")
            inner = v[1:-1].strip()
            out[key] = [_scalar(x) for x in inner.split(",")] if inner else []
        else:
            out[key] = _scalar(v)
    return out


def load(path: str) -> dict:
    with open(path, "r") as fh:
        return loads(fh.read())
