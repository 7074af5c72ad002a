"""Weight persistence: nested variable trees <-> ``.npz`` archives (the
port's copy of ``adas_tpu/tools/params_io.py``).

The flat form joins each leaf's path with ``::``
(``params::net::stem::conv::kernel``); :func:`save_params` writes it with
``np.savez_compressed``.  An archive either package writes loads in the
other's ``load_params``.  ``weights.load_flax_variables`` loads the flat
form into a port module and ``weights.flax_variables`` gives it back.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_SEP = "::"


def flatten_variables(variables: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in variables.items():
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten_variables(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_variables(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        keys = path.split(_SEP)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def save_params(path: str, variables: dict) -> None:
    np.savez_compressed(path, **flatten_variables(variables))


def load_params(path: str) -> dict:
    with np.load(path) as archive:
        return unflatten_variables({k: archive[k] for k in archive.files})
