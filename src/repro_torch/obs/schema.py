"""Minimal JSON-schema validator for benchmark artifacts.

A copy of the JAX package's ``obs/schema.py`` (pure Python).

The serving benchmark's JSON (``results/serve_latency.json``) is diffed
across runs by ``scripts/trend_serve_latency.py``; a renamed or
mistyped section would silently diff *nothing* and the trend would look
flat. Validating against the checked-in schema
(``results/serve_latency.schema.json``) makes that failure loud at both
ends — the writer refuses to emit a malformed artifact, the differ refuses
to compare one.

Deliberately tiny (no external dependency): supports the subset of JSON
Schema the artifact needs — ``type`` (string or list of strings),
``properties``, ``required``, ``items``, ``enum``, ``minimum`` /
``maximum``. Unknown keywords are ignored, unknown properties allowed
(forward compatibility: new sections may appear before the schema learns
them; *renaming* an existing required section still fails).
"""
from __future__ import annotations

import json
from typing import Any, List

__all__ = ["SchemaError", "validate", "validate_or_raise", "load_schema"]

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}


class SchemaError(ValueError):
    """Raised by :func:`validate_or_raise` with every violation listed."""


def _type_ok(value: Any, t: str) -> bool:
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    py = _TYPES.get(t)
    return py is not None and isinstance(value, py)


def validate(instance: Any, schema: dict, path: str = "$") -> List[str]:
    """Return a list of human-readable violations (empty = valid)."""
    errors: List[str] = []
    t = schema.get("type")
    if t is not None:
        allowed = [t] if isinstance(t, str) else list(t)
        if not any(_type_ok(instance, a) for a in allowed):
            errors.append(
                f"{path}: expected type {'/'.join(allowed)}, "
                f"got {type(instance).__name__}"
            )
            return errors  # child checks would only cascade noise
    if "enum" in schema and instance not in schema["enum"]:
        errors.append(f"{path}: {instance!r} not in enum {schema['enum']}")
    if isinstance(instance, (int, float)) and not isinstance(instance, bool):
        if "minimum" in schema and instance < schema["minimum"]:
            errors.append(
                f"{path}: {instance} < minimum {schema['minimum']}"
            )
        if "maximum" in schema and instance > schema["maximum"]:
            errors.append(
                f"{path}: {instance} > maximum {schema['maximum']}"
            )
    if isinstance(instance, dict):
        for req in schema.get("required", ()):
            if req not in instance:
                errors.append(f"{path}: missing required key {req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in instance:
                errors.extend(validate(instance[key], sub, f"{path}.{key}"))
    if isinstance(instance, list) and "items" in schema:
        for i, item in enumerate(instance):
            errors.extend(validate(item, schema["items"], f"{path}[{i}]"))
    return errors


def validate_or_raise(instance: Any, schema: dict, name: str = "payload"):
    errors = validate(instance, schema)
    if errors:
        raise SchemaError(
            f"{name} does not match schema ({len(errors)} violation(s)):\n"
            + "\n".join(f"  - {e}" for e in errors)
        )


def load_schema(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
