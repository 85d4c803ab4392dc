"""Operations of one post-training step that its inputs need.

- cut: each node's granularity (``frame.NODE_SIZE_OPS``) and one test;
- interpolation of each cut splat forward (``frame.LERP_OPS``) and
  backward (twice as many);
- projection forward and backward per rendered splat (cut and sky), K1
  and K2, the loss per channel pixel and the exposure per pixel, as for
  the flat step (``train_step``);
- Adam on each parameter of the rows that are not locked."""

from . import blend_bwd, blend_fwd, frame, train_step


def ops(nodes: int, cut: int, splats: int, unlocked: int, pixels: int,
        k1_pairs: int, k2_pairs: int, k2_contrib: int) -> float:
    return (nodes * (frame.NODE_SIZE_OPS + frame.NODE_TEST_OPS)
            + cut * 3 * frame.LERP_OPS
            + splats * (train_step.PROJECT_OPS + train_step.PROJECT_BWD_OPS)
            + pixels * (3 * train_step.LOSS_OPS + train_step.EXPOSURE_OPS)
            + unlocked * train_step.ADAM_OPS * train_step.PARAMS_PER_ROW
            + blend_fwd.OPS_PER_PAIR * k1_pairs
            + blend_bwd.OPS_PER_PAIR * k2_pairs
            + blend_bwd.OPS_PER_CONTRIB * k2_contrib)
