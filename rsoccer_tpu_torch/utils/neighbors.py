"""Host-side nearest-neighbour utility.

A copy of ``rsoccer_tpu/utils/neighbors.py`` (importing any ``rsoccer_tpu``
module loads JAX); ``tests/test_torch_frame_render.py`` holds it equal.
Capability-parity with the reference's ``Utils/kdtree.py`` (used for spawn
rejection sampling, vss_gym.py:214-231).  The reference implements a 2-D
KD-tree whose descent picks the same branch in both comparison arms
(kdtree.py:58-63), degrading it toward linear scans anyway — and at the
N <= 13 points these environments ever place, a vectorised brute-force
nearest is both simpler and faster.  The device-side equivalent (used by the
actual envs) is ``rsoccer_tpu_torch.envs.spawn``; this class exists for host-side
custom-env authors who ported reference code.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


class NearestNeighbors:
    """Incremental 2-D nearest-neighbour set (reference ``KDTree`` API)."""

    def __init__(self):
        self._points: List[Tuple[float, float]] = []

    def insert(self, values: Sequence[float]) -> None:
        self._points.append((float(values[0]), float(values[1])))

    def get_nearest(self, values: Sequence[float]):
        """Returns (nearest_point, distance) like the reference
        (kdtree.py:86-88); raises if empty."""
        if not self._points:
            raise ValueError("no points inserted")
        pts = np.asarray(self._points)
        q = np.asarray([values[0], values[1]], dtype=float)
        d2 = np.sum((pts - q) ** 2, axis=1)
        i = int(np.argmin(d2))
        return tuple(pts[i]), math.sqrt(float(d2[i]))


# alias for drop-in use by code written against the reference name
KDTree = NearestNeighbors
