"""Compositional config loading (port of ``schemanet_tpu/utils/config.py``).

A config file is loaded into a plain dict; values that are paths to other
config files (the ``dataset:`` and ``model:`` keys of the experiment configs)
are read by ``resolve_subconfig``, and ``apply_overrides`` applies dotted-path
overrides from the command line, descending through such references and list
indices.

YAML is read with PyYAML, imported where a file is read. The machine with the
card has no PyYAML: there a config is written in JSON syntax (JSON is a
subset of YAML, so the JAX package's ``get_cfg`` reads the same file), which
``get_cfg`` reads with ``json``; a YAML file there raises ``ImportError``.
Override values go through YAML's typing where PyYAML is present and through
JSON where it is not; a value that is not JSON then raises, since YAML types
some strings otherwise (``True``, ``1e-3``).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Optional


def get_cfg(path: str) -> Dict[str, Any]:
    """Load a config file into a dict (expanding ~ and environment variables):
    JSON syntax with ``json``, anything else with PyYAML."""
    path = os.path.expandvars(os.path.expanduser(str(path)))
    with open(path, "r") as f:
        text = f.read()
    try:
        cfg = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError as exc:
            raise ImportError("reading a YAML config needs PyYAML; without it, write the "
                              "config in JSON syntax") from exc
        cfg = yaml.safe_load(text)
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


def _parse_value(raw: str):
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(raw)
        except json.JSONDecodeError as exc:
            raise ValueError(f"override value {raw!r} is not JSON, and without PyYAML only "
                             "JSON values are read (quote strings: '\"name\"')") from exc
    return yaml.safe_load(raw)


def parse_override_strings(pairs) -> Dict[str, Any]:
    """Parse ``key=value`` strings; values are typed by YAML, or by JSON
    where PyYAML is missing."""
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        out[key.strip()] = _parse_value(raw)
    return out
