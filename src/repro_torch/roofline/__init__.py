"""The production dry run's roofline: one rank's work, collective bytes
and memory of the ε-NNG engines counted in closed form from the shapes
(``rank_stats``; the port has no HLO to read), the three-term H100
roofline they give (``model``) and the report table (``report``, also
``python -m repro_torch.roofline.report``)."""
from .model import HW, roofline_terms  # noqa: F401
from .rank_stats import (RankStats, landmark_rank_stats,  # noqa: F401
                         systolic_rank_stats)
