"""The one place that chooses how rays meet primitives.

The choice depends only on what the scene shows (its triangle count and
whether it has curves), never on which device JAX runs on: every backend
runs the same plain ``jax.numpy`` traversal.

  * triangles: the threaded BVH (``ops/bvh.py``) above
    ``BVH_MIN_TRIANGLES``; below it the brute-force sweep
    (``ops/intersect.py``), whose one dense pass beats a divergent
    traversal loop on cornell-class scenes;
  * curves: the blocked round-cone sweep (``ops/curves.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

# below this many triangles the brute-force sweep is used (no BVH built)
BVH_MIN_TRIANGLES = 1024

TRIANGLES_BVH = "bvh"
TRIANGLES_BRUTEFORCE = "bruteforce"
CURVES_SWEEP = "cone_sweep"


class Intersectors(NamedTuple):
    triangles: Optional[str]  # None when the scene has no triangles
    curves: Optional[str]  # None when the scene has no curves


def choose_intersectors(num_triangles: int, has_curves: bool) -> Intersectors:
    """Intersector per primitive kind for a scene of this size."""
    if num_triangles <= 0:
        tri = None
    elif num_triangles > BVH_MIN_TRIANGLES:
        tri = TRIANGLES_BVH
    else:
        tri = TRIANGLES_BRUTEFORCE
    return Intersectors(triangles=tri, curves=CURVES_SWEEP if has_curves else None)


def describe(scene) -> Intersectors:
    """What a built DeviceScene traces with (for logs and the smoke test)."""
    tri = None
    if scene.num_triangles > 0:
        tri = TRIANGLES_BVH if scene.bvh is not None else TRIANGLES_BRUTEFORCE
    return Intersectors(triangles=tri, curves=CURVES_SWEEP if scene.cones is not None else None)
