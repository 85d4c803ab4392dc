"""Work of the blend backward (K2) on one image, from its inputs.

Operations: every (pixel, splat) pair up to the pixel's last contributing
entry at ``OPS_PER_PAIR`` (the forward's recomputation), and each
contributing pair at ``OPS_PER_CONTRIB`` more (the gradient of alpha, its
chain through the power to the means and the conic, and the ten
accumulations). Bytes: the inputs read once (per splat 40, per entry 4,
per tile 8; per pixel: final transmittance 4, last entry 4, and the
cotangents of colour, inverse depth and transmittance 20) and the
gradients written once (per splat: means 8, conic 12, colour 12, opacity
4, inverse depth 4)."""

OPS_PER_PAIR = 20
OPS_PER_CONTRIB = 40
SPLAT_BYTES = 40
GRAD_BYTES = 40
ENTRY_BYTES = 4
TILE_BYTES = 8
PIXEL_BYTES = 28


def work(pairs: int, contrib: int, splats: int, entries: int, pixels: int,
         tile: int = 16):
    """(operations, bytes) of one backward blend."""
    tiles = -(-pixels // (tile * tile))
    ops = OPS_PER_PAIR * pairs + OPS_PER_CONTRIB * contrib
    nbytes = ((SPLAT_BYTES + GRAD_BYTES) * splats + ENTRY_BYTES * entries
              + TILE_BYTES * tiles + PIXEL_BYTES * pixels)
    return ops, nbytes
