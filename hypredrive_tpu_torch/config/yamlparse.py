"""YAML loading, include expansion, CLI overrides, and effective-config echo.

The reference implements a hand-written YAML subset (ref: src/internal/yaml.c);
here PyYAML does the tokenizing while we keep the reference semantics that
matter:

  * YAML 1.1 booleans (``on/off/yes/no``) — PyYAML's SafeLoader already
    honors these,
  * ``include:`` expansion with cycle detection
    (ref: hypredrv_YAMLtreeExpandIncludes, yaml.c:2458),
  * CLI overrides ``-a sect:sub:key value``
    (ref: ApplyCLIOverrides, args.c:1435),
  * effective-config echo in the reference's style
    (see examples/refOutput/ex1.txt header block).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, List, Optional, Tuple

from ..core.errors import ConfigError, ErrorCode

MAX_INCLUDE_DEPTH = 16
MAX_INCLUDE_BYTES = 16 * 1024 * 1024


def _construct_mapping(loader, node, deep=False):
    mapping = {}
    for key_node, value_node in node.value:
        key = loader.construct_object(key_node, deep=deep)
        if isinstance(key, dict):
            raise ConfigError(
                f"line {key_node.start_mark.line + 1}: mapping key must be scalar"
            )
        if key in mapping:
            raise ConfigError(
                f"line {key_node.start_mark.line + 1}: duplicate key {key!r}"
            )
        mapping[key] = loader.construct_object(value_node, deep=deep)
    return mapping


@functools.lru_cache(maxsize=None)
def _yaml():
    """(PyYAML, duplicate-rejecting loader), imported on first use so the
    options-dict path runs without PyYAML."""
    import yaml

    class _UniqueKeyLoader(yaml.SafeLoader):
        """SafeLoader that rejects duplicate mapping keys."""

    _UniqueKeyLoader.add_constructor(
        yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, _construct_mapping
    )
    return yaml, _UniqueKeyLoader


def load_yaml_text(text: str) -> dict:
    """Parse YAML text into a plain tree (dicts/lists/scalars)."""
    yaml, loader = _yaml()
    try:
        tree = yaml.load(text, Loader=loader)
    except yaml.YAMLError as exc:
        raise ConfigError(f"YAML parse error: {exc}", ErrorCode.YAML) from None
    if tree is None:
        tree = {}
    if not isinstance(tree, dict):
        raise ConfigError("top-level YAML must be a mapping", ErrorCode.YAML)
    return tree


def load_yaml_file(path: str) -> dict:
    if not os.path.isfile(path):
        # directories and missing files both fail typed (the
        # file-vs-string heuristic can route odd inputs here)
        raise ConfigError(f"config file not found: {path}", ErrorCode.FILE_NOT_FOUND)
    try:
        with open(path, "r") as f:
            text = f.read()
    except OSError as exc:
        raise ConfigError(f"cannot read config {path}: {exc}",
                          ErrorCode.IO) from None
    tree = load_yaml_text(text)
    return expand_includes(tree, base_dir=os.path.dirname(os.path.abspath(path)))


def expand_includes(tree: dict, base_dir: str = ".",
                    _seen: Optional[Tuple[str, ...]] = None,
                    _budget: Optional[List[int]] = None) -> dict:
    """Recursively expand ``include:`` keys.

    An ``include:`` value (scalar path or list of paths) merges the included
    file's mapping into the containing node; sibling keys override included
    ones.  Cycles and oversized expansions are rejected
    (ref: yaml.c:2458 cycle guard + size caps).
    """
    _seen = _seen or ()
    _budget = _budget if _budget is not None else [MAX_INCLUDE_BYTES]
    if len(_seen) > MAX_INCLUDE_DEPTH:
        raise ConfigError("include: nesting too deep", ErrorCode.YAML)

    def load_one(rel):
        path = os.path.normpath(
            rel if os.path.isabs(str(rel)) else os.path.join(base_dir, str(rel))
        )
        if path in _seen:
            raise ConfigError(f"include cycle detected at {path}", ErrorCode.YAML)
        if not os.path.isfile(path):
            # a directory (include: .) or missing file both fail typed
            raise ConfigError(
                f"included file not found: {path}", ErrorCode.FILE_NOT_FOUND
            )
        _budget[0] -= os.path.getsize(path)
        if _budget[0] < 0:
            raise ConfigError("include expansion exceeds size cap", ErrorCode.YAML)
        try:
            with open(path) as f:
                text = f.read()
        except OSError as exc:
            raise ConfigError(
                f"cannot read include {path}: {exc}", ErrorCode.IO
            ) from None
        yaml, loader = _yaml()
        try:
            sub = yaml.load(text, Loader=loader)
        except yaml.YAMLError as exc:
            raise ConfigError(
                f"YAML parse error in {path}: {exc}", ErrorCode.YAML
            ) from None
        if isinstance(sub, dict):
            sub = expand_includes(sub, os.path.dirname(path), _seen + (path,), _budget)
        return sub

    def expand_node(node):
        if isinstance(node, list):
            return [expand_node(item) for item in node]
        if not isinstance(node, dict):
            return node
        # A mapping consisting solely of `include:` with MULTIPLE files is a
        # *variant list*: each file becomes one list element (this is how the
        # reference sweeps preconditioner variants, ref: args.c:805-978 and
        # examples/ex8-multi-*.yml).  Single-file includes merge in place.
        if (len(node) == 1 and str(next(iter(node))).lower() == "include"
                and isinstance(next(iter(node.values())), list)
                and len(next(iter(node.values()))) > 1):
            out: List[Any] = []
            for rel in next(iter(node.values())):
                sub = load_one(rel)
                if isinstance(sub, list):
                    out.extend(sub)
                else:
                    out.append(sub)
            return out
        merged: Dict[str, Any] = {}
        for key, value in node.items():
            if str(key).lower() == "include":
                paths = value if isinstance(value, list) else [value]
                for rel in paths:
                    sub = load_one(rel)
                    if not isinstance(sub, dict):
                        raise ConfigError(
                            f"included file {rel} must contain a mapping when "
                            "merged with sibling keys",
                            ErrorCode.YAML,
                        )
                    _deep_merge(merged, sub)
            else:
                value = expand_node(value)
                if (key in merged and isinstance(merged[key], dict)
                        and isinstance(value, dict)):
                    _deep_merge(merged[key], value)
                else:
                    merged[key] = value
        return merged

    return expand_node(tree)


def _deep_merge(dst: dict, src: dict):
    for key, value in src.items():
        if key in dst and isinstance(dst[key], dict) and isinstance(value, dict):
            _deep_merge(dst[key], value)
        else:
            dst[key] = value


def apply_overrides(tree: dict, overrides: List[Tuple[str, str]]) -> dict:
    """Apply CLI ``-a path:to:key value`` overrides
    (ref: ApplyCLIOverrides, args.c:1435).

    Paths are colon-separated; intermediate mappings are created.  Values
    are parsed as YAML scalars (so ``-a solver:pcg:max_iter 50`` yields an
    int and ``-a general:warmup on`` a bool).
    """
    for path, raw_value in overrides:
        path = path.lstrip("-")
        parts = [p for p in path.split(":") if p]
        if not parts:
            raise ConfigError(f"empty override path {path!r}", ErrorCode.INVALID_ARG)
        node = tree
        for part in parts[:-1]:
            child = node.get(part)
            if not isinstance(child, dict):
                child = {}
                node[part] = child
            node = child
        yaml, loader = _yaml()
        try:
            value = yaml.load(raw_value, Loader=loader)
        except yaml.YAMLError:
            value = raw_value
        node[parts[-1]] = value
    return tree


# ---------------------------------------------------------------------------
# effective-config echo
# ---------------------------------------------------------------------------

def _scalar_repr(value: Any) -> str:
    if isinstance(value, bool):
        return "on" if value else "off"
    if value is None:
        return ""
    return str(value)


def echo_tree(tree: dict, indent: int = 0) -> str:
    """Reproduce the reference's effective-config echo block
    (see examples/refOutput/ex1.txt lines 6-13)."""
    lines: List[str] = []

    def walk(node, depth):
        pad = "  " * depth
        if isinstance(node, dict):
            for key, value in node.items():
                if isinstance(value, dict):
                    lines.append(f"{pad}{key}: ")
                    walk(value, depth + 1)
                elif isinstance(value, list):
                    if all(not isinstance(v, (dict, list)) for v in value):
                        inner = ", ".join(_scalar_repr(v) for v in value)
                        lines.append(f"{pad}{key}: [{inner}]")
                    else:
                        lines.append(f"{pad}{key}: ")
                        for item in value:
                            lines.append(f"{pad}  -")
                            walk(item, depth + 2)
                else:
                    lines.append(f"{pad}{key}: {_scalar_repr(value)}")
        else:
            lines.append(f"{pad}{_scalar_repr(node)}")

    walk(tree, indent)
    return "\n".join(lines)
