"""Operations of one served frame that its inputs need.

- budget fit and cut: each node's granularity (box diagonal and distance,
  ``NODE_SIZE_OPS``) once, and ``NODE_TEST_OPS`` per ladder rung, for
  the 16 rungs, the hysteresis limit and the cut itself;
- interpolation: ``LERP_OPS`` per cut splat (59 attributes lerped, the
  quaternion's sign test);
- projection: ``PROJECT_OPS`` per cut splat (transforms, covariance,
  conic, radius, degree-3 SH colour);
- blend: K1's operations (``blend_fwd``).
Binning is a sort and counts no operations."""

from . import blend_fwd

NODE_SIZE_OPS = 20
NODE_TEST_OPS = 3
LADDER_TESTS = 18
LERP_OPS = 185
PROJECT_OPS = 320


def ops(nodes: int, cut: int, pairs: int) -> float:
    return (nodes * (NODE_SIZE_OPS + NODE_TEST_OPS * LADDER_TESTS)
            + cut * (LERP_OPS + PROJECT_OPS)
            + blend_fwd.OPS_PER_PAIR * pairs)
