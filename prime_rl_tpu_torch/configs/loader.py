"""TOML + CLI config composition.

Mirrors the UX of the reference's pydantic-config loader
(reference: docs/configuration.md:24-273): defaults < TOML files (given as
``@ path.toml``, deep-merged left to right) < dotted kebab-case CLI flags.
The literal string ``"None"`` on the CLI means null. Discriminated unions
select their variant via a ``type = "..."`` field.

Implementation is original: a ~150-line stdlib ``tomllib`` + argv walker in
front of pydantic v2 model validation.
"""

from __future__ import annotations

import sys
import tomllib
from pathlib import Path
from typing import Any, TypeVar

from pydantic import BaseModel

T = TypeVar("T", bound=BaseModel)


def deep_merge(base: dict[str, Any], overlay: dict[str, Any]) -> dict[str, Any]:
    """Recursively merge ``overlay`` into ``base`` (overlay wins). Lists are
    replaced, not concatenated — matching TOML re-declaration semantics —
    EXCEPT when the overlay is a dict of numeric indices
    (``--train-envs.0.name x`` CLI overrides merge into list elements)."""
    out = dict(base)
    for key, value in overlay.items():
        if (
            key in out
            and isinstance(out[key], list)
            and isinstance(value, dict)
            and value
            and all(k.isdigit() for k in value)
        ):
            items = list(out[key])
            for idx_str, item_overlay in value.items():
                idx = int(idx_str)
                while len(items) <= idx:
                    items.append({})
                if isinstance(items[idx], dict) and isinstance(item_overlay, dict):
                    items[idx] = deep_merge(items[idx], item_overlay)
                else:
                    items[idx] = item_overlay
            out[key] = items
        elif key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def load_toml(path: str | Path) -> dict[str, Any]:
    with open(path, "rb") as f:
        return tomllib.load(f)


def _coerce_scalar(raw: str) -> Any:
    """Parse a CLI string into a python scalar (bool/int/float/None/str)."""
    if raw == "None":
        return None
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    if raw.startswith("[") and raw.endswith("]"):
        inner = raw[1:-1].strip()
        if not inner:
            return []
        return [_coerce_scalar(part.strip()) for part in inner.split(",")]
    return raw


def _set_dotted(cfg: dict[str, Any], dotted: str, value: Any) -> None:
    """Set ``a.b.c`` in a nested dict, creating intermediate dicts."""
    keys = dotted.split(".")
    node = cfg
    for key in keys[:-1]:
        nxt = node.get(key)
        if not isinstance(nxt, dict):
            nxt = {}
            node[key] = nxt
        node = nxt
    node[keys[-1]] = value


def parse_argv(argv: list[str]) -> dict[str, Any]:
    """Turn ``@file.toml`` references and ``--dotted.kebab-flags`` into one
    merged config dict."""
    merged: dict[str, Any] = {}
    overrides: dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "@":
            i += 1
            merged = deep_merge(merged, load_toml(argv[i]))
        elif arg.startswith("@"):
            merged = deep_merge(merged, load_toml(arg[1:]))
        elif arg.startswith("--"):
            key, eq, raw = arg[2:].partition("=")
            key = key.replace("-", "_")
            if eq:
                value: Any = _coerce_scalar(raw)
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                i += 1
                value = _coerce_scalar(argv[i])
            else:
                value = True  # bare flag
            _set_dotted(overrides, key, value)
        else:
            raise ValueError(f"unexpected argument: {arg!r} (expected '@file.toml' or '--flag')")
        i += 1
    return deep_merge(merged, overrides)


def parse_config(config_cls: type[T], argv: list[str] | None = None) -> T:
    """Compose a pydantic config from argv (defaults to ``sys.argv[1:]``)."""
    if argv is None:
        argv = sys.argv[1:]
    return config_cls.model_validate(parse_argv(argv))


def to_toml(data: dict[str, Any], indent_path: str = "") -> str:
    """Serialize a plain dict to TOML (used by --dry-run resolved-config dumps
    and launcher subconfig splitting). Supports the subset we generate:
    scalars, lists of scalars, nested tables, and lists of tables."""
    lines: list[str] = []
    scalars: dict[str, Any] = {}
    tables: dict[str, dict] = {}
    table_arrays: dict[str, list[dict]] = {}
    for key, value in data.items():
        if isinstance(value, dict):
            tables[key] = value
        elif isinstance(value, list) and value and all(isinstance(v, dict) for v in value):
            table_arrays[key] = value
        elif value is not None:
            scalars[key] = value
    for key, value in scalars.items():
        lines.append(f"{key} = {_toml_value(value)}")
    for key, value in tables.items():
        path = f"{indent_path}.{key}" if indent_path else key
        body = to_toml(value, path)
        lines.append(f"\n[{path}]")
        lines.append(body)
    for key, items in table_arrays.items():
        path = f"{indent_path}.{key}" if indent_path else key
        for item in items:
            lines.append(f"\n[[{path}]]")
            lines.append(to_toml(item, path))
    return "\n".join(lines)


def _toml_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        return '"' + value.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(value, list):
        return "[" + ", ".join(_toml_value(v) for v in value) + "]"
    raise TypeError(f"cannot TOML-serialize {type(value)}")
