"""Self-describing ``--help [topic]`` system.

The reference maintains a hand-written topic tree mirroring the schema
(ref: src/internal/help.c).  Here help is *generated* from the schema
objects themselves, so keys/defaults/valid values can never drift.
Topics use the same ``solver:pcg:max_iter`` path grammar
(ref: hypredrv_HelpPrint, help.c:1585).
"""

from __future__ import annotations

from typing import List, Optional

from .fields import F, Schema
from .sections import (
    GENERAL_SCHEMA,
    LINEAR_SYSTEM_SCHEMA,
    SOLVER_SCHEMAS,
    SCALING_SCHEMA,
    PRECON_SCHEMAS,
    REUSE_SCHEMA,
)

_TOPIC_ROOTS = {
    "general": GENERAL_SCHEMA,
    "linear_system": LINEAR_SYSTEM_SCHEMA,
    "solver": Schema("solver", dict(SOLVER_SCHEMAS, scaling=SCALING_SCHEMA),
                     help="Krylov solver selection"),
    "preconditioner": Schema("preconditioner",
                             dict(PRECON_SCHEMAS, reuse=REUSE_SCHEMA),
                             help="preconditioner selection"),
}


def help_text(topic: Optional[str] = None) -> str:
    """Render help for a topic path like ``solver:pcg`` or the overview."""
    if not topic:
        lines = [
            "hypredrive-tpu configuration sections:",
            "",
        ]
        for name, schema in _TOPIC_ROOTS.items():
            lines.append(f"  {name:<16} {schema.help}")
        lines += [
            "",
            "Use --help <topic> for details, e.g.:",
            "  --help solver",
            "  --help solver:pcg:max_iter",
            "  --help preconditioner:amg:coarsening",
        ]
        return "\n".join(lines)

    parts = [p for p in topic.split(":") if p]
    root = _TOPIC_ROOTS.get(parts[0].lower())
    if root is None:
        return (f"unknown help topic '{topic}'. "
                f"Top-level topics: {', '.join(_TOPIC_ROOTS)}")
    found = root.find_topic(parts[1:]) if len(parts) > 1 else root
    if found is None:
        return f"unknown help topic '{topic}'"
    if isinstance(found, Schema):
        lines = [f"{topic}: {found.help}", ""]
        lines.extend(found.help_lines(topic))
        return "\n".join(lines)
    # single field
    assert isinstance(found, F)
    lines = [f"{topic}:"]
    if found.help:
        lines.append(f"  {found.help}")
    if found.kind == "enum" and found.choices is not None:
        lines.append(f"  valid values: {', '.join(found.choices.names())}")
        lines.append(f"  default: {found.choices.name_of(found.default)}")
    else:
        lines.append(f"  type: {found.kind}")
        lines.append(f"  default: {found.default}")
    return "\n".join(lines)


def all_topics() -> List[str]:
    topics = []

    def walk(schema: Schema, prefix: str):
        topics.append(prefix)
        for key, spec in schema.fields.items():
            p = f"{prefix}:{key}"
            if isinstance(spec, Schema):
                walk(spec, p)
            else:
                topics.append(p)

    for name, schema in _TOPIC_ROOTS.items():
        walk(schema, name)
    return topics
