"""slam2d_tpu — a 2D LIDAR SLAM engine built on JAX/XLA.

Re-implements, array-first, the full capability set of the reference
`xiaofeng419/SLAM-2D-LIDAR-SCAN` (see SURVEY.md; the reference mount was
empty at survey time, so citations refer to SURVEY.md sections rather than
reference file:line):

- correlative scan matching over multi-resolution occupancy grids
  (SURVEY.md §4.1),
- log-odds occupancy-grid mapping (SURVEY.md §4.2),
- FastSLAM particle-filter localization with likelihood-field weighting and
  low-variance resampling (SURVEY.md §4.3),
- Gauss-Newton pose-graph backend with loop closure (SURVEY.md §4.4).

Design: static shapes everywhere, `lax.scan` over scan chunks, `vmap` over
particles, `shard_map` over a device mesh for particle/keyframe sharding,
plain XLA gathers/scatters on the hot paths (the package name is
historical: the system was first written for a TPU).
"""

from slam2d_tpu import config  # noqa: F401
from slam2d_tpu.config import (  # noqa: F401
    FrontendConfig,
    GraphConfig,
    GridConfig,
    MatcherConfig,
    PFConfig,
    SensorConfig,
)

__version__ = "0.1.0"
