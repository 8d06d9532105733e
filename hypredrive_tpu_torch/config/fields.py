"""Declarative schema engine.

The reference generates per-section field tables (name → offset, setter,
default) from X-macros (ref: include/internal/gen_macros.h:198-263) and
validates YAML nodes against per-key valid-value maps
(ref: src/internal/yaml.c:412 YAMLnodeValidateSchema).  Here a
:class:`Schema` is a dict of :class:`F` field specs (kind, default,
choices, help); parsing returns an :class:`Args` namespace and collects
error messages with full ``section:sub:key`` paths.
"""

from __future__ import annotations

import difflib
from typing import Any, Dict, List, Optional, Union


def normalize_name(name: str) -> str:
    """Case-insensitive key/enum normalization (ref: presets.c name
    normalization; YAML matching is case-insensitive for enum values)."""
    return str(name).strip().lower()


class Choices:
    """A string↔int valid-value map (ref: StrIntMap, containers.h)."""

    def __init__(self, mapping: Dict[str, int]):
        self.mapping = dict(mapping)
        self.by_name = {normalize_name(k): v for k, v in mapping.items()}
        self.values = set(mapping.values())
        # First name wins for reverse lookup (reference maps list the
        # canonical spelling first).
        self._names_by_code: Dict[int, str] = {}
        for k, v in mapping.items():
            self._names_by_code.setdefault(v, k)

    def lookup(self, value: Any) -> Optional[int]:
        """Return the int code for a name or raw int code, else None."""
        if isinstance(value, bool):
            value = int(value)
        if isinstance(value, int):
            return value if value in self.values else None
        if isinstance(value, float) and value.is_integer():
            return self.lookup(int(value))
        return self.by_name.get(normalize_name(value))

    def name_of(self, code: int) -> str:
        return self._names_by_code.get(code, str(code))

    def names(self) -> List[str]:
        return list(self.mapping.keys())


ON_OFF = Choices({"off": 0, "on": 1, "no": 0, "yes": 1, "false": 0, "true": 1})


class Args(dict):
    """Attribute-accessible parsed arguments."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __setattr__(self, key, value):
        self[key] = value

    def copy(self) -> "Args":
        out = Args()
        for k, v in self.items():
            out[k] = v.copy() if isinstance(v, Args) else v
        return out


class F:
    """Field spec: kind, default, optional choices, help text."""

    __slots__ = ("kind", "default", "choices", "help")

    KINDS = (
        "int",
        "float",
        "bool",
        "str",
        "enum",
        "int_list",
        "float_list",
        "str_list",
        "any",
    )

    def __init__(self, kind: str, default: Any = None, choices: Optional[Choices] = None,
                 help: str = ""):
        assert kind in self.KINDS, kind
        self.kind = kind
        self.default = default
        self.choices = choices
        self.help = help

    def parse(self, value: Any, path: str, errors: List[str]) -> Any:
        try:
            return self._parse(value, path, errors)
        except (TypeError, ValueError):
            errors.append(f"{path}: invalid value {value!r} for {self.kind} field")
            return self.default

    def _parse(self, value, path, errors):
        kind = self.kind
        if kind == "int":
            if isinstance(value, bool):
                return int(value)
            if isinstance(value, str):
                return int(value.strip(), 0)
            return int(value)
        if kind == "float":
            return float(value)
        if kind == "bool":
            code = ON_OFF.lookup(value)
            if code is None:
                errors.append(
                    f"{path}: invalid boolean {value!r} (use on/off/yes/no/true/false)"
                )
                return bool(self.default)
            return bool(code)
        if kind == "str":
            return str(value)
        if kind == "enum":
            code = self.choices.lookup(value)
            if code is None:
                valid = ", ".join(self.choices.names())
                errors.append(f"{path}: invalid value {value!r} (valid: {valid})")
                return self.default
            return code
        if kind in ("int_list", "float_list", "str_list"):
            elt = {"int_list": int, "float_list": float, "str_list": str}[kind]
            items = _as_list(value)
            return [elt(v) for v in items]
        return value  # any


def _as_list(value) -> list:
    """Accept YAML lists and ``[1, 2, 3]``-style strings
    (ref: src/internal/containers.c string→array parsers)."""
    if isinstance(value, (list, tuple)):
        return list(value)
    if isinstance(value, str):
        s = value.strip()
        if s.startswith("[") and s.endswith("]"):
            s = s[1:-1]
        return [p for p in (x.strip() for x in s.split(",")) if p]
    return [value]


class Schema:
    """A named mapping of field specs and sub-schemas."""

    def __init__(self, name: str, fields: Dict[str, Union[F, "Schema"]],
                 help: str = "", open_keys: bool = False):
        self.name = name
        # store field keys normalized so mixed-case schema names
        # (P12_trunc_factor) match the normalized lookup in parse()
        self.fields = {normalize_name(k): v for k, v in fields.items()}
        self.help = help
        self.open_keys = open_keys  # allow unknown keys (e.g. mgr level.N)

    def defaults(self) -> Args:
        out = Args()
        for key, spec in self.fields.items():
            out[key] = spec.defaults() if isinstance(spec, Schema) else spec.default
        return out

    def parse(self, node: Any, path: str, errors: List[str],
              base: Optional[Args] = None) -> Args:
        """Parse a YAML mapping into Args, collecting path-tagged errors."""
        out = self.defaults() if base is None else base
        if node is None:
            return out
        if not isinstance(node, dict):
            errors.append(f"{path}: expected a mapping, got {type(node).__name__}")
            return out
        for raw_key, value in node.items():
            key = normalize_name(raw_key)
            spec = self.fields.get(key)
            if spec is None:
                if self.open_keys:
                    # Open sections (mgr level.N, dof_labels) keep raw keys;
                    # numeric keys become ints.
                    if isinstance(raw_key, str) and raw_key.lstrip("-").isdigit():
                        out[int(raw_key)] = value
                    else:
                        out[raw_key if isinstance(raw_key, int) else key] = value
                    continue
                hint = ""
                match = difflib.get_close_matches(key, self.fields.keys(), n=1)
                if match:
                    hint = f" (did you mean '{match[0]}'?)"
                errors.append(f"{path}: unknown key '{raw_key}'{hint}")
                continue
            sub_path = f"{path}:{key}" if path else key
            if isinstance(spec, Schema):
                prev = out.get(key)
                out[key] = spec.parse(
                    value, sub_path, errors,
                    base=prev if isinstance(prev, Args) else None,
                )
            else:
                out[key] = spec.parse(value, sub_path, errors)
        return out

    def valid_keys(self) -> List[str]:
        return list(self.fields.keys())

    def help_lines(self, prefix: str = "", depth: int = 0) -> List[str]:
        """Self-describing help, generated from the schema
        (reference equivalent: src/internal/help.c topic tree)."""
        lines = []
        indent = "  " * depth
        for key, spec in self.fields.items():
            topic = f"{prefix}:{key}" if prefix else key
            if isinstance(spec, Schema):
                lines.append(f"{indent}{key}:  [section] {spec.help}")
                lines.extend(spec.help_lines(topic, depth + 1))
            else:
                default = spec.default
                if spec.kind == "enum" and spec.choices is not None:
                    valid = "|".join(spec.choices.names())
                    default = spec.choices.name_of(default)
                    lines.append(
                        f"{indent}{key}: {valid}  (default: {default})"
                        + (f"  — {spec.help}" if spec.help else "")
                    )
                else:
                    lines.append(
                        f"{indent}{key}: <{spec.kind}>  (default: {default})"
                        + (f"  — {spec.help}" if spec.help else "")
                    )
        return lines

    def find_topic(self, parts: List[str]):
        """Resolve a help topic path like solver:pcg:max_iter
        (ref: hypredrv_HelpPrint, help.c:1585)."""
        if not parts:
            return self
        key = normalize_name(parts[0])
        spec = self.fields.get(key)
        if spec is None:
            return None
        if isinstance(spec, Schema):
            return spec.find_topic(parts[1:])
        return spec if len(parts) == 1 else None
