"""The views' JPEG writer against libjpeg (the file ``cv2.imwrite``
writes), and the reference's decode of its coefficients against PIL's
and the port's decoders, at sizes that are and are not whole MCUs."""
from __future__ import annotations

import io

import numpy as np
import pytest
import torch

import _tiny  # noqa: F401  (puts the repository on the path)

SIZES = [(48, 64), (29, 37), (90, 160), (17, 8), (1, 1)]


def _view(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c)
                     * np.cos(yy / 5.0 + 2 * c) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("quality", [95, 75])
@pytest.mark.parametrize("hw", SIZES)
def test_writer_is_libjpeg(hw, quality):
    cv2 = pytest.importorskip("cv2")
    from benchmark.core import jpeg
    img = _view(*hw)
    ok, want = cv2.imencode(".jpg", img[..., ::-1],
                            [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    assert jpeg.jpeg_bytes(torch.from_numpy(img), quality) == want.tobytes()


@pytest.mark.parametrize("hw", SIZES)
def test_reference_decode_is_the_decoders(hw):
    from benchmark.core import jpeg
    from benchmark.reference import jpeg as rjpeg
    from h3dgs_tpu_torch.io.jpeg import decode_jpeg
    img = torch.from_numpy(_view(*hw, seed=1))
    data = jpeg.jpeg_bytes(img, 95)
    mine = rjpeg.pixels(jpeg.coefficients(img, 95)).numpy()
    assert np.array_equal(decode_jpeg(data), mine)
    image = pytest.importorskip("PIL.Image")
    pil = np.asarray(image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(pil, mine)
