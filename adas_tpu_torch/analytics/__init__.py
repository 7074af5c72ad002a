"""Host analytics of the serving path: FCWS distance, BEV geometry, the ADAS
decision state machine (numpy; counterparts of ``adas_tpu/analytics``)."""
from .conditions import TaskConditions
from .distance import SingleCamDistanceMeasure
from .perspective import PerspectiveTransformation

__all__ = [
    "TaskConditions",
    "SingleCamDistanceMeasure",
    "PerspectiveTransformation",
]
