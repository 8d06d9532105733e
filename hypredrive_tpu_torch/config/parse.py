"""Top-level input parsing: text/file → InputArgs.

Mirrors the reference pipeline (ref: src/internal/args.c:1464
hypredrv_InputArgsParseWithObjectName): load text → build tree → expand
includes → apply CLI overrides → parse sections → validate → optional echo.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

from ..core.errors import ConfigError, ErrorCode
from .fields import Args, normalize_name
from .sections import (
    GENERAL_SCHEMA,
    LINEAR_SYSTEM_SCHEMA,
    SOLVER_SCHEMAS,
    SCALING_SCHEMA,
    PRECON_SCHEMAS,
    REUSE_SCHEMA,
    InputArgs,
    SolverConfig,
    PreconConfig,
)
from . import vocab as V
from .yamlparse import load_yaml_text, load_yaml_file, expand_includes, apply_overrides


def looks_like_yaml_text(s: str) -> bool:
    """Heuristic file-vs-inline-YAML detection
    (ref: src/internal/utils.c:479 YAML-filename detection)."""
    if "\n" in s or s.lstrip().startswith("{"):
        return True
    if s.endswith((".yml", ".yaml")):
        return False
    return ":" in s and not os.path.exists(s)


def parse_input(
    source: str,
    overrides: Optional[List[Tuple[str, str]]] = None,
    precon_preset: Optional[str] = None,
    object_name: str = "",
) -> InputArgs:
    """Parse a YAML file path or in-memory YAML text into InputArgs."""
    if looks_like_yaml_text(source):
        tree = expand_includes(load_yaml_text(source))
    else:
        tree = load_yaml_file(source)
    return parse_tree(tree, overrides, precon_preset, object_name)


def config_from_dict(options: dict) -> InputArgs:
    """Build InputArgs from a Python dict (the reference Python binding's
    options-dict path, ref: interfaces/python/src/options.py)."""
    return parse_tree(expand_includes(dict(options)))


def parse_tree(
    tree: dict,
    overrides: Optional[List[Tuple[str, str]]] = None,
    precon_preset: Optional[str] = None,
    object_name: str = "",
) -> InputArgs:
    if overrides:
        tree = apply_overrides(tree, overrides)
    if precon_preset:
        tree["preconditioner"] = {"preset": precon_preset}

    errors: List[str] = []
    known_sections = {"general", "linear_system", "solver", "preconditioner"}
    for key in tree:
        if normalize_name(key) not in known_sections:
            errors.append(f"unknown top-level section '{key}'")

    sections = {normalize_name(k): v for k, v in tree.items()}

    general = GENERAL_SCHEMA.parse(sections.get("general"), "general", errors)
    if object_name:
        general["name"] = object_name

    if "linear_system" not in sections:
        errors.append("missing required section 'linear_system'")
    linear_system = LINEAR_SYSTEM_SCHEMA.parse(
        sections.get("linear_system"), "linear_system", errors
    )

    if "solver" not in sections:
        errors.append("missing required section 'solver'")
    solver = parse_solver_node(sections.get("solver"), "solver", errors)

    if "preconditioner" not in sections:
        errors.append("missing required section 'preconditioner'")
    variants = parse_precon_node(
        sections.get("preconditioner"), "preconditioner", errors
    )

    if errors:
        raise ConfigError(errors, ErrorCode.YAML)

    return InputArgs(
        general=general,
        linear_system=linear_system,
        solver=solver,
        precon_variants=variants or [PreconConfig()],
        raw_tree=tree,
    )


# ---------------------------------------------------------------------------
# solver section (bare string or nested map; ref: args.c ParseSolver:295)
# ---------------------------------------------------------------------------

def parse_solver_node(node: Any, path: str, errors: List[str]) -> SolverConfig:
    if node is None:
        return SolverConfig()
    if isinstance(node, str):
        method = normalize_name(node)
        if method not in SOLVER_SCHEMAS:
            errors.append(
                f"{path}: unknown solver '{node}' "
                f"(valid: {', '.join(SOLVER_SCHEMAS)})"
            )
            return SolverConfig()
        return SolverConfig(method=method, args=SOLVER_SCHEMAS[method].defaults())
    if not isinstance(node, dict):
        errors.append(f"{path}: expected solver name or mapping")
        return SolverConfig()

    method = None
    args = None
    scaling = SCALING_SCHEMA.defaults()
    for raw_key, value in node.items():
        key = normalize_name(raw_key)
        if key == "scaling":
            scaling = SCALING_SCHEMA.parse(value, f"{path}:scaling", errors)
        elif key in SOLVER_SCHEMAS:
            if method is not None:
                errors.append(f"{path}: multiple solver methods given")
            method = key
            args = SOLVER_SCHEMAS[key].parse(value, f"{path}:{key}", errors)
        else:
            errors.append(f"{path}: unknown key '{raw_key}'")
    if method is None:
        errors.append(f"{path}: no solver method given")
        return SolverConfig(scaling=scaling)
    return SolverConfig(method=method, args=args, scaling=scaling)


# ---------------------------------------------------------------------------
# preconditioner section: string | map | variants list | preset
# (ref: args.c ParsePrecon:978, variants :805-978, presets :749)
# ---------------------------------------------------------------------------

def parse_precon_node(node: Any, path: str, errors: List[str]) -> List[PreconConfig]:
    reuse = REUSE_SCHEMA.defaults()
    variants = _parse_precon_inner(node, path, errors, reuse)
    for v in variants:
        v.reuse = reuse
    return variants


def _parse_precon_inner(node, path, errors, reuse) -> List[PreconConfig]:
    if node is None:
        return [PreconConfig(method="none")]
    if isinstance(node, str):
        return [_precon_from_name(node, path, errors)]
    if isinstance(node, list):
        out: List[PreconConfig] = []
        for i, item in enumerate(node):
            out.extend(_parse_precon_inner(item, f"{path}[{i}]", errors, reuse))
        return out
    if not isinstance(node, dict):
        errors.append(f"{path}: expected preconditioner name, mapping, or list")
        return [PreconConfig(method="none")]

    out = []
    for raw_key, value in node.items():
        key = normalize_name(raw_key)
        if key == "preset":
            from .presets import get_preset

            preset = get_preset(str(value), kind="precon")
            if preset is None:
                errors.append(f"{path}: unknown preset '{value}'")
                continue
            sub = expand_includes(load_yaml_text(preset.text)) \
                if "\n" in preset.text or ":" in preset.text \
                else preset.text
            out.extend(_parse_precon_inner(sub, f"{path}:preset({value})",
                                           errors, reuse))
        elif key == "reuse":
            reuse.update(REUSE_SCHEMA.parse(value, f"{path}:reuse", errors))
        elif key in PRECON_SCHEMAS:
            if isinstance(value, list):
                # A method key whose value is a list defines variants
                # (ref: examples/ex8.yml).
                for i, item in enumerate(value):
                    args = PRECON_SCHEMAS[key].parse(
                        item, f"{path}:{key}[{i}]", errors
                    )
                    out.append(PreconConfig(method=key, args=args))
            else:
                args = PRECON_SCHEMAS[key].parse(value, f"{path}:{key}", errors)
                out.append(PreconConfig(method=key, args=args))
        else:
            hint = ""
            import difflib

            match = difflib.get_close_matches(key, PRECON_SCHEMAS.keys(), n=1)
            if match:
                hint = f" (did you mean '{match[0]}'?)"
            errors.append(f"{path}: unknown preconditioner '{raw_key}'{hint}")
    return out or [PreconConfig(method="none")]


def _precon_from_name(name: str, path: str, errors: List[str]) -> PreconConfig:
    method = normalize_name(name)
    if method not in PRECON_SCHEMAS:
        errors.append(
            f"{path}: unknown preconditioner '{name}' "
            f"(valid: {', '.join(PRECON_SCHEMAS)})"
        )
        return PreconConfig(method="none")
    return PreconConfig(method=method, args=PRECON_SCHEMAS[method].defaults())
