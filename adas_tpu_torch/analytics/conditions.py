"""ADAS decision state machine: FCWS / LDWS / LKAS signals + BEV
auto-recalibration triggers (port of ``adas_tpu/analytics/conditions.py``,
unchanged numpy logic: that module cannot be imported without JAX, since
``adas_tpu/analytics/__init__.py`` imports the JAX ``perspective.py``).

Behavior parity with reference taskConditions.py:88-312:
* collision: median of 5 distances vs thresholds → WARNING/PROMPT/NORMAL
* offset: median of 5 offsets vs 0.65 m with a curvature-consistency gate
* curvature: mode direction + median radius of 10 samples vs 500 m
* recalibration: sustained one-sided offset → "Top"; sustained curve near
  center → "Bottom"; smooth road (R ≥ 15000 for > 3 frames) → "Default";
  CheckStatus() flags when the consumer should updateTransformParams.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.limited import LimitedList
from ..utils.types import CollisionType, CurvatureType, OffsetType


class TaskConditions:
    """Temporal smoothing + hysteresis over per-frame geometry estimates."""

    def __init__(self) -> None:
        self.collision_msg = CollisionType.UNKNOWN
        self.offset_msg = OffsetType.UNKNOWN
        self.curvature_msg = CurvatureType.UNKNOWN
        self.vehicle_collision_record = LimitedList(5)
        self.vehicle_offset_record = LimitedList(5)
        self.vehicle_curvature_record = LimitedList(10)
        self.transform_status: Optional[str] = None

        self.toggle_status: Optional[str] = "Default"
        self.toggle_oscillator_status = [False, False]
        self.toggle_status_counter = {
            "Offset": 0, "Curvae": 0, "BirdViewAngle": 0,
        }

    # ---- internal helpers ----

    def _calibration_curve(
        self, vehicle_curvature, frequency: int = 3,
        curvae_thres: float = 15000,
    ) -> None:
        """Sustained smooth road resets the BEV back to 'Default'."""
        if self.toggle_status_counter["BirdViewAngle"] <= frequency:
            if vehicle_curvature >= curvae_thres:
                self.toggle_status_counter["BirdViewAngle"] += 1
            else:
                self.toggle_status_counter["BirdViewAngle"] = 0
        else:
            self.toggle_status_counter["BirdViewAngle"] = 0
            self.toggle_status = "Default"

    def _calc_deviation(self, offset: float, offset_thres: float) -> OffsetType:
        """Offset status, gated so a curve in the same direction doesn't
        raise a departure warning."""
        if abs(offset) > offset_thres:
            if offset > 0 and self.curvature_msg not in {
                CurvatureType.HARD_LEFT, CurvatureType.EASY_LEFT,
            }:
                return OffsetType.RIGHT
            if offset < 0 and self.curvature_msg not in {
                CurvatureType.HARD_RIGHT, CurvatureType.EASY_RIGHT,
            }:
                return OffsetType.LEFT
            return OffsetType.UNKNOWN
        return OffsetType.CENTER

    def _calc_direction(
        self, curvature: float, curvae_dir: str, curvae_thres: float
    ) -> CurvatureType:
        if curvature <= curvae_thres:
            if (
                curvae_dir == "L"
                and self.curvature_msg != CurvatureType.EASY_RIGHT
            ):
                return CurvatureType.HARD_LEFT
            if (
                curvae_dir == "R"
                and self.curvature_msg != CurvatureType.EASY_LEFT
            ):
                return CurvatureType.HARD_RIGHT
            return CurvatureType.UNKNOWN
        if curvae_dir == "L":
            return CurvatureType.EASY_LEFT
        if curvae_dir == "R":
            return CurvatureType.EASY_RIGHT
        return CurvatureType.STRAIGHT

    # ---- public API ----

    def CheckStatus(self) -> bool:
        """True when the BEV transform should be re-estimated now."""
        if (
            self.curvature_msg == CurvatureType.UNKNOWN
            and self.offset_msg == OffsetType.UNKNOWN
        ):
            self.toggle_oscillator_status = [False, False]
        if self.toggle_status != self.transform_status:
            self.transform_status = self.toggle_status
            self.toggle_status = None
            return True
        return False

    def UpdateOffsetStatus(
        self, vehicle_offset: Optional[float], offset_thres: float = 0.65
    ) -> None:
        if vehicle_offset is None:
            self.offset_msg = OffsetType.UNKNOWN
            self.vehicle_offset_record.clear()
            return
        self.vehicle_offset_record.append(vehicle_offset)
        if not self.vehicle_offset_record.full():
            self.offset_msg = OffsetType.UNKNOWN
            return
        avg_offset = float(np.median(self.vehicle_offset_record.copy()))
        self.offset_msg = self._calc_deviation(avg_offset, offset_thres)

        record = self.vehicle_offset_record.copy()
        plus = [v for v in record if v > 0.2]
        minus = [v for v in record if v < -0.2]
        if self.toggle_status_counter["Offset"] >= 10:
            if len(plus) == len(record):
                self.toggle_oscillator_status[0] = True
                self.toggle_status_counter["Offset"] = 0
            if len(minus) == len(record):
                self.toggle_oscillator_status[1] = True
                self.toggle_status_counter["Offset"] = 0
            if all(self.toggle_oscillator_status):
                self.toggle_status = "Top"
                self.toggle_oscillator_status = [False, False]
            else:
                self.toggle_status_counter["Offset"] = 0
        else:
            self.toggle_status_counter["Offset"] += 1

    def UpdateRouteStatus(
        self,
        vehicle_direction: Optional[str],
        vehicle_curvature: Optional[float],
        curvae_thres: float = 500,
    ) -> None:
        if vehicle_curvature is None:
            self.vehicle_curvature_record.clear()
            self.curvature_msg = CurvatureType.UNKNOWN
            return
        if vehicle_direction is None or self.offset_msg != OffsetType.CENTER:
            self.vehicle_curvature_record.clear()
            self.curvature_msg = CurvatureType.UNKNOWN
        else:
            self.vehicle_curvature_record.append(
                (vehicle_direction, float(vehicle_curvature))
            )
            if self.vehicle_curvature_record.full():
                record = self.vehicle_curvature_record.copy()
                dirs = [d for d, _ in record]
                avg_direction = max(set(dirs), key=dirs.count)
                avg_curvature = float(np.median([c for _, c in record]))
                self.curvature_msg = self._calc_direction(
                    avg_curvature, avg_direction, curvae_thres
                )
                if self.toggle_status_counter["Curvae"] >= 10:
                    if (
                        self.curvature_msg != CurvatureType.STRAIGHT
                        and len(self.vehicle_offset_record) > 0
                        and abs(self.vehicle_offset_record[-1]) < 0.2
                        and not any(self.toggle_oscillator_status)
                    ):
                        self.toggle_status = "Bottom"
                    else:
                        self.toggle_status_counter["Curvae"] = 0
                else:
                    self.toggle_status_counter["Curvae"] += 1
            else:
                self.curvature_msg = CurvatureType.UNKNOWN
        self._calibration_curve(vehicle_curvature)

    def UpdateCollisionStatus(
        self,
        vehicle_distance: Optional[list],
        lane_area: bool,
        distance_thres: float = 1.5,
    ) -> None:
        if vehicle_distance is not None:
            _, _, d = vehicle_distance
            self.vehicle_collision_record.append(d)
            if self.vehicle_collision_record.full():
                avg = float(np.median(self.vehicle_collision_record.copy()))
                if avg <= distance_thres:
                    self.collision_msg = CollisionType.WARNING
                elif avg <= 2 * distance_thres:
                    self.collision_msg = CollisionType.PROMPT
                else:
                    self.collision_msg = CollisionType.NORMAL
        else:
            self.collision_msg = (
                CollisionType.NORMAL if lane_area else CollisionType.UNKNOWN
            )
            self.vehicle_collision_record.clear()
