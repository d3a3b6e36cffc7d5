"""The work of the two-level triangle walk (B4, ``csrc/intersect_big.cu``)
and the least time an H100 could take for it: the arithmetic behind
``b4_roofline``, in the manner of :mod:`benchmark.work`.

Counted from the inputs alone, never from how a kernel walks: each lane
that needs a walk (a lane live on the bounce, which B2 shades) reads its
ray, writes its hit record and pays at least one box test, the root's; a
launch reads the root's record at least once. A walk visits far more
nodes and tests triangles, but how many depends on the tree and the walk,
so the count stops at what any walk must do and is low: the share never
reads above what the kernel achieved. Lanes a kernel walks though they
are dead cost it time and count nothing.
"""
from __future__ import annotations

from benchmark.work import least_seconds

#: a ray's reads, o and d as float32 rows, and its hit record's writes, t,
#: u, v float32 and idx int32 (``IntersectBigArgs`` in
#: ``csrc/intersect_big.cu``)
B4_RAY_BYTES = 12 + 12
B4_HIT_BYTES = 4 * 4
#: a node record, lo xyz and a link word then hi xyz and a link word, two
#: float4 (``csrc/intersect_big.cu``, the tables' layout)
B4_NODE_BYTES = 32
#: the slab test of one box (``csrc/tri_bvh.cuh:slab_core``): six
#: subtractions and six products, five min and max for the entry and five
#: for the exit, the floor at t_min and two comparisons
OPS_SLAB = 12 + 5 + 5 + 1 + 2
#: the reciprocals of a ray's direction (``csrc/bounce_core.cuh:safe_inv``
#: on each axis), counted as one division each
OPS_RAY = 3


def b4(*, lanes: int, launches: int) -> tuple[float, str]:
    """B4 over a render: ``lanes`` live lane-bounces that needed a walk,
    in ``launches`` launches; the least seconds and what bounds them."""
    n_bytes = (lanes * (B4_RAY_BYTES + B4_HIT_BYTES)
               + launches * B4_NODE_BYTES)
    return least_seconds(n_bytes, lanes * (OPS_SLAB + OPS_RAY))
