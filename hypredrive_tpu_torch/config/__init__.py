"""YAML-driven configuration front-end.

Rebuilds the reference config layer (ref: src/internal/{yaml,field,args,
presets,help}.c + include/internal/gen_macros.h) as a declarative Python
schema: every section is a :class:`~hypredrive_tpu.config.fields.Schema`
whose field specs carry defaults, valid-value maps, and help text — the
same single-source-of-truth property as the reference's X-macro codegen.
"""

from .fields import Args, Schema, F, Choices
from .sections import (
    InputArgs,
    SolverConfig,
    PreconConfig,
    GENERAL_SCHEMA,
    LINEAR_SYSTEM_SCHEMA,
    SOLVER_SCHEMAS,
    PRECON_SCHEMAS,
)
from .yamlparse import (
    load_yaml_text,
    load_yaml_file,
    expand_includes,
    apply_overrides,
    echo_tree,
)
from .parse import parse_input, config_from_dict
from .presets import get_preset, register_precon_preset, register_solver_preset

__all__ = [
    "Args",
    "Schema",
    "F",
    "Choices",
    "InputArgs",
    "SolverConfig",
    "PreconConfig",
    "GENERAL_SCHEMA",
    "LINEAR_SYSTEM_SCHEMA",
    "SOLVER_SCHEMAS",
    "PRECON_SCHEMAS",
    "load_yaml_text",
    "load_yaml_file",
    "expand_includes",
    "apply_overrides",
    "echo_tree",
    "parse_input",
    "config_from_dict",
    "get_preset",
    "register_precon_preset",
    "register_solver_preset",
]
