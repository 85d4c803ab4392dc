"""Operations of one flat training step that its inputs need: live rows
only (the fixed-capacity rows that hold no Gaussian need nothing).

- projection forward ``PROJECT_OPS`` and backward ``PROJECT_BWD_OPS`` per
  live row;
- K1 and K2 (``blend_fwd``, ``blend_bwd``);
- the loss: L1 and SSIM (five separable 11-tap blurs and the map) forward
  and backward, ``LOSS_OPS`` per channel pixel; the exposure 24 per pixel;
- the update per live row: gradient locking and statistics
  ``STATS_OPS``, Adam ``ADAM_OPS`` on each of its 59 parameters, the
  shrink test ``SHRINK_OPS``."""

from . import blend_bwd, blend_fwd

PROJECT_OPS = 320
PROJECT_BWD_OPS = 640
LOSS_OPS = 400
EXPOSURE_OPS = 24
STATS_OPS = 12
ADAM_OPS = 12
PARAMS_PER_ROW = 59
SHRINK_OPS = 6


def ops(live_rows: int, pixels: int, k1_pairs: int, k2_pairs: int,
        k2_contrib: int) -> float:
    return (live_rows * (PROJECT_OPS + PROJECT_BWD_OPS + STATS_OPS
                         + ADAM_OPS * PARAMS_PER_ROW + SHRINK_OPS)
            + pixels * (3 * LOSS_OPS + EXPOSURE_OPS)
            + blend_fwd.OPS_PER_PAIR * k1_pairs
            + blend_bwd.OPS_PER_PAIR * k2_pairs
            + blend_bwd.OPS_PER_CONTRIB * k2_contrib)
