"""Typed CLI configs: dataclass defaults < ``--config`` YAML < CLI flags.

JAX counterpart: ``diffusion_uncertainty_tpu/utils/config.py``
(``parse_config``, ``save_config`` and what they need); a copy of its rules,
so that flags, YAML files and ``args.yaml`` read the same in both packages.
``save_config`` writes one ``key: value`` line per field with JSON scalars,
which is valid YAML and needs no YAML package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from pathlib import Path
from typing import Any, Optional, Sequence, Type, TypeVar

T = TypeVar("T")

__all__ = ["parse_config", "from_dict", "save_config"]


def _unwrap_optional(tp: Any) -> Any:
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(tp: Any, value: Any) -> Any:
    tp = _unwrap_optional(tp)
    if value is None:
        return None
    if tp is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes", "on")
    if typing.get_origin(tp) in (list, tuple) or tp in (list, tuple):
        args = typing.get_args(tp)
        elem = args[0] if args else str
        seq = value if isinstance(value, (list, tuple)) else str(value).split(",")
        out = [_coerce(elem, v) for v in seq]
        return tuple(out) if (typing.get_origin(tp) or tp) is tuple else out
    if tp in (int, float, str):
        return tp(value)
    return value


def from_dict(cls: Type[T], data: dict[str, Any]) -> T:
    """``cls`` from a dict of (string or typed) values; unknown keys raise."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**{k: _coerce(hints.get(k, str), v) for k, v in data.items()})


def parse_config(cls: Type[T], argv: Optional[Sequence[str]] = None, defaults: Optional[dict[str, Any]] = None) -> T:
    """Build ``cls`` from defaults < ``--config`` YAML < explicit CLI flags
    (``--num-steps 20``; booleans as ``--random-init true``)."""
    hints = typing.get_type_hints(cls)
    parser = argparse.ArgumentParser(description=cls.__doc__)
    parser.add_argument("--config", type=str, default=None, help="YAML config file")
    for f in dataclasses.fields(cls):
        metavar = "BOOL" if _unwrap_optional(hints.get(f.name, str)) is bool else None
        parser.add_argument("--" + f.name.replace("_", "-"), type=str, default=None, metavar=metavar)
    ns = parser.parse_args(argv)
    merged: dict[str, Any] = dict(defaults or {})
    if ns.config:
        import yaml  # only a --config file needs it

        with open(ns.config) as fh:
            merged.update(yaml.safe_load(fh) or {})
    for f in dataclasses.fields(cls):
        v = getattr(ns, f.name, None)
        if v is not None:
            merged[f.name] = v
    return from_dict(cls, merged)


def save_config(cfg: Any, path, **extra: Any) -> None:
    """Run metadata as ``args.yaml``: the dataclass's fields (or a dict's
    items) and ``extra``, sorted, one ``key: <JSON scalar>`` line each."""
    values = {**(dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)), **extra}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in sorted(values.items())))
