"""Work of the blend forward (K1) on one image, from its inputs.

Operations: every (pixel, splat) pair the reference evaluates up to the
pixel's termination, at ``OPS_PER_PAIR`` (the Gaussian's power: 2 offsets,
3 products, 3 adds, scale; exp; opacity product; the two tests; the
transmittance update and four accumulations). Bytes: each input read once
(per splat: means 8, conic 12, colour 12, opacity 4, inverse depth 4; per
entry: its index 4; per tile: start and count 8) and each output written
once (per pixel: colour 12, inverse depth 4, final transmittance 4, last
entry 4). Nothing here depends on how a kernel is written."""

OPS_PER_PAIR = 20
SPLAT_BYTES = 40
ENTRY_BYTES = 4
TILE_BYTES = 8
PIXEL_BYTES = 24


def work(pairs: int, splats: int, entries: int, pixels: int,
         tile: int = 16):
    """(operations, bytes) of one forward blend."""
    tiles = -(-pixels // (tile * tile))
    ops = OPS_PER_PAIR * pairs
    nbytes = (SPLAT_BYTES * splats + ENTRY_BYTES * entries
              + TILE_BYTES * tiles + PIXEL_BYTES * pixels)
    return ops, nbytes
