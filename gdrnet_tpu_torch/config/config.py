"""Layered python-file config system.

Same ergonomics as the reference's mmcv configs (configs/_base_/common_base.py,
core/gdrn_modeling/main_gdrn.py:39-41 of the reference): a config is a
python file whose module-level UPPER_CASE names form a nested dict; `_base_`
names one or more parent files merged underneath; a `_delete_=True` key inside
a dict replaces the inherited dict instead of merging; CLI `--opts`-style
`a.b.c=value` strings deep-merge on top. Implemented standalone (no mmcv) so
reference experiment configs port 1:1.
"""

from __future__ import annotations

import ast
import copy
import os
import os.path as osp
from typing import Any, Iterable


_DELETE_KEY = "_delete_"
_BASE_KEY = "_base_"


class Config(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d: dict | None = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __deepcopy__(self, memo):
        return Config(copy.deepcopy(dict(self), memo))

    def get_path(self, dotted: str, default: Any = None) -> Any:
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        cur = self
        for part in parts[:-1]:
            if part not in cur or not isinstance(cur[part], dict):
                cur[part] = Config()
            cur = cur[part]
        cur[parts[-1]] = _wrap(value)

    def to_dict(self) -> dict:
        return _unwrap(self)

    def dump(self, path: str) -> None:
        import json

        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, dict):
        return Config(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def _unwrap(v: Any) -> Any:
    if isinstance(v, dict):
        return {k: _unwrap(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_unwrap(x) for x in v)
    return v


def merge_dict(base: dict, override: dict) -> dict:
    """Deep merge `override` onto `base` with mmcv `_delete_` semantics."""
    out = dict(base)
    for k, v in override.items():
        if k == _DELETE_KEY:
            continue
        if (
            isinstance(v, dict)
            and isinstance(out.get(k), dict)
            and not v.get(_DELETE_KEY, False)
        ):
            out[k] = merge_dict(out[k], v)
        elif isinstance(v, dict):
            out[k] = merge_dict({}, v)  # strip nested _delete_ markers
        else:
            out[k] = v
    return out


def _exec_config_file(path: str) -> dict:
    """Execute a python config file, returning its module-level namespace."""
    with open(path) as f:
        src = f.read()
    ns: dict[str, Any] = {"__file__": osp.abspath(path), "osp": osp, "os": os}
    exec(compile(src, path, "exec"), ns)
    return {
        k: v
        for k, v in ns.items()
        if not k.startswith("__") and k not in ("osp", "os") and not callable(v) or k == _BASE_KEY
    }


def load_config(path: str, opts: Iterable[str] | None = None) -> Config:
    """Load a python config file, resolving `_base_` chains then `opts`."""
    d = _load_with_bases(path)
    cfg = Config(d)
    if opts:
        apply_opts(cfg, opts)
    return cfg


def _load_with_bases(path: str) -> dict:
    ns = _exec_config_file(path)
    bases = ns.pop(_BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        bpath = b if osp.isabs(b) else osp.join(osp.dirname(osp.abspath(path)), b)
        merged = merge_dict(merged, _load_with_bases(bpath))
    return merge_dict(merged, ns)


def _parse_value(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def apply_opts(cfg: Config, opts: Iterable[str]) -> Config:
    """Apply `KEY.PATH=value` override strings (the reference's --opts
    DictAction, core/utils/default_args_setup.py:66)."""
    it = list(opts)
    # also accept the detectron2 style: alternating KEY VALUE pairs
    if it and "=" not in it[0]:
        pairs = [(it[i], it[i + 1]) for i in range(0, len(it) - 1, 2)]
    else:
        pairs = [tuple(o.split("=", 1)) for o in it]
    for key, val in pairs:
        cfg.set_path(key, _parse_value(val))
    return cfg
