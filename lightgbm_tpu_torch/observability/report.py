"""JSON telemetry report: schema loading, validation, writing.

Port of ``lightgbm_tpu/observability/report.py``.  The schema
(``schema.json``, checked in next to this module, byte for byte the JAX
package's) is the contract the serving reports (``stats``, ``stats_out``,
``telemetry_out``) validate against.  The validator implements the JSON-Schema subset the schema
actually uses — ``type`` (including type lists), ``required``,
``properties``, ``additionalProperties``-as-schema and ``items`` — so no
external dependency is needed in the container.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

_SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "schema.json")

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}


def load_schema() -> Dict[str, Any]:
    with open(_SCHEMA_PATH) as fh:
        return json.load(fh)


def _type_ok(value: Any, t: str) -> bool:
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    py = _TYPES.get(t)
    return py is not None and isinstance(value, py)


def validate_report(report: Any, schema: Dict[str, Any] = None,
                    path: str = "$") -> List[str]:
    """Returns a list of violation strings (empty = valid)."""
    if schema is None:
        schema = load_schema()
    errs: List[str] = []
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        if not any(_type_ok(report, ti) for ti in types):
            errs.append(f"{path}: expected type {t}, got "
                        f"{type(report).__name__}")
            return errs
    if isinstance(report, dict):
        for key in schema.get("required", ()):
            if key not in report:
                errs.append(f"{path}: missing required key {key!r}")
        props = schema.get("properties", {})
        addl = schema.get("additionalProperties")
        for key, value in report.items():
            if key in props:
                errs.extend(validate_report(value, props[key],
                                            f"{path}.{key}"))
            elif isinstance(addl, dict):
                errs.extend(validate_report(value, addl, f"{path}.{key}"))
    if isinstance(report, list) and "items" in schema:
        for i, item in enumerate(report):
            errs.extend(validate_report(item, schema["items"],
                                        f"{path}[{i}]"))
    return errs


def write_report(report: Dict[str, Any], path: str) -> None:
    """Validate-and-write; a schema violation raises rather than shipping
    a malformed report for a reader to choke on later.  The write is
    atomic (tmp + ``os.replace``) so a crash mid-dump never leaves a
    truncated report for that reader to trip over."""
    errs = validate_report(report)
    if errs:
        raise ValueError("telemetry report violates schema.json: "
                         + "; ".join(errs[:5]))
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
