"""Tracker base: class-colour management (the port's copy of
``adas_tpu/tracking/core.py``).  The cv2 render helpers of the JAX copy
(direction arrows, lock-on box, trajectory dots, tinted boxes) are not
ported: they wait for the cv2-free renderer (``ROADMAP.md`` §1)."""
from __future__ import annotations

from abc import ABCMeta, abstractmethod
from typing import Any, Dict, List, Union

import numpy as np


class ObjectTrackBase(metaclass=ABCMeta):
    """Shared tracker surface: per-class colors."""

    def __init__(self, names: Union[List[str], Dict[str, tuple]]):
        self.names = names
        if isinstance(names, dict):
            self.class_colors = names
            self.names = {k: k for k in names}
        else:
            rng = np.random.default_rng()
            self.class_colors = [
                rng.integers(0, 255, size=3, dtype=np.uint8).tolist()
                for _ in names
            ]

    @abstractmethod
    def update(self, *args, **kwargs) -> List[Any]:
        """Advance tracker state by one frame of detections."""
