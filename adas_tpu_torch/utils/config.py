"""Python-file config system with inheritance (the port's copy of
``adas_tpu/utils/config.py``, plain Python).

Capability parity with the reference's mmcv-style ``Config``
(exportLib/ultrafastLaneV2/configs/config.py:54-352): load a ``.py`` (or
``.json``) file as a dict, ``_base_`` multi-inheritance with
``_delete_`` override markers, attribute access, dotted-key merging from
the command line (``DictAction``).  Self-contained — no addict/mmcv.  The
port's UFLDv2 configs are ``adas_tpu_torch/configs/ufldv2/*.py``
(:data:`CONFIG_DIR`); a ``_base_`` path is read relative to the file that
names it.
"""
from __future__ import annotations

import argparse
import ast
import copy
import json
import os
from typing import Any, Dict, Optional

#: the port's own UFLDv2 training configs (copies of the JAX package's)
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "ufldv2")

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"


class ConfigDict(dict):
    """Dict with attribute access and missing-key AttributeError."""

    def __getattr__(self, name: str):
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'"
            )
        return value

    def __setattr__(self, name: str, value) -> None:
        self[name] = value

    @classmethod
    def deep(cls, d: dict) -> "ConfigDict":
        out = cls()
        for k, v in d.items():
            out[k] = cls.deep(v) if isinstance(v, dict) else v
        return out


def _exec_py_file(filename: str) -> Dict[str, Any]:
    with open(filename) as f:
        source = f.read()
    # validate it parses before exec'ing for a clearer error
    ast.parse(source, filename=filename)
    namespace: Dict[str, Any] = {"__file__": filename}
    exec(compile(source, filename, "exec"), namespace)
    return {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
    }


def _merge_dict(base: dict, override: dict) -> dict:
    """Recursive merge; an override subtree with ``_delete_: True``
    replaces the base subtree instead of merging into it."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if (
            isinstance(v, dict)
            and k in out
            and isinstance(out[k], dict)
            and not v.get(DELETE_KEY, False)
        ):
            out[k] = _merge_dict(out[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            out[k] = copy.deepcopy(v)
    return out


class Config:
    """Immutable-ish config wrapper around a ConfigDict."""

    def __init__(
        self, cfg_dict: Optional[dict] = None, filename: Optional[str] = None
    ):
        object.__setattr__(
            self, "_cfg_dict", ConfigDict.deep(cfg_dict or {})
        )
        object.__setattr__(self, "_filename", filename)

    # ---- loading ----

    @staticmethod
    def _file2dict(filename: str) -> Dict[str, Any]:
        filename = os.path.abspath(os.path.expanduser(filename))
        if filename.endswith(".py"):
            cfg = _exec_py_file(filename)
        elif filename.endswith(".json"):
            with open(filename) as f:
                cfg = json.load(f)
        else:
            raise IOError("Only .py / .json configs are supported")

        if BASE_KEY in cfg:
            bases = cfg.pop(BASE_KEY)
            if isinstance(bases, str):
                bases = [bases]
            merged: Dict[str, Any] = {}
            for b in bases:
                merged = _merge_dict(
                    merged,
                    Config._file2dict(
                        os.path.join(os.path.dirname(filename), b)
                    ),
                )
            cfg = _merge_dict(merged, cfg)
        return cfg

    @classmethod
    def fromfile(cls, filename: str) -> "Config":
        return cls(cls._file2dict(filename), filename=filename)

    # ---- access ----

    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name: str):
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name: str):
        return self._cfg_dict[name]

    def __setattr__(self, name: str, value) -> None:
        self._cfg_dict[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._cfg_dict

    def __repr__(self) -> str:
        return f"Config [path: {self._filename}]: {dict(self._cfg_dict)}"

    def to_dict(self) -> dict:
        return copy.deepcopy(dict(self._cfg_dict))

    # ---- CLI merging ----

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge dotted keys: ``{"model.backbone": "34"}``."""
        nested: Dict[str, Any] = {}
        for key, value in options.items():
            node = nested
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
        merged = _merge_dict(self.to_dict(), nested)
        object.__setattr__(self, "_cfg_dict", ConfigDict.deep(merged))


class DictAction(argparse.Action):
    """argparse action parsing ``KEY=VALUE`` pairs with literal eval."""

    @staticmethod
    def _parse(value: str):
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        if value.lower() in ("true", "false"):
            return value.lower() == "true"
        return value

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, _, value = kv.partition("=")
            options[key] = self._parse(value)
        setattr(namespace, self.dest, options)
