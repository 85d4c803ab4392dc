"""GPS tags and the orientation from a JPEG's EXIF block, without PIL.

The JAX package reads GPS positions through PIL's ``_getexif``; the card's
machine has no PIL. This reader follows PIL's rules wherever they decide
what comes back:

- the EXIF block is the body of the first APP1 segment that starts with
  ``Exif\\0\\0``, with the bodies of later such segments appended, read
  as a TIFF file in either byte order;
- an IFD is read entry by entry and ends early, keeping the entries
  before, at an entry that runs past the block or whose data (more than
  4 bytes, at an offset) runs past it; entries of a type PIL does not
  know are skipped;
- the GPS IFD is the one at IFD0's tag 0x8825 when that tag holds one
  integer.

Only IFD0's 0x8825 and 0x0112 (Orientation) and the GPS IFD's tags
1-4 (latitude and longitude with their references) are decoded, as PIL
presents them: ASCII as ``str`` without its trailing NUL, BYTE and
UNDEFINED as ``bytes``, rationals as floats (num / den; NaN for a zero
denominator), other numbers as ints, each a tuple when it has more than
one value. Where PIL would warn of corrupt EXIF data (a header that is
not ``II`` / ``MM``, an IFD cut short), this reader warns naming the file
and reads on as PIL does; the JAX package's blanket ``except`` returns
no GPS where PIL raises (a bad header), and so does this reader, without
an ``except``.
"""
from __future__ import annotations

import struct
import warnings
from typing import Dict, Optional, Tuple

GPS_IFD_TAG = 0x8825
ORIENTATION_TAG = 0x0112
# GPSLatitudeRef, GPSLatitude, GPSLongitudeRef, GPSLongitude
GPS_TAGS = (1, 2, 3, 4)
# TIFF type -> (struct code, bytes per value): the types PIL loads
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("s", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8)}


def _exif_block(data: bytes) -> Optional[bytes]:
    """The TIFF bytes of the APP1 Exif segments, or ``None``."""
    pos, block = 2, None
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xD9, 0xDA):      # end of image, start of scan
            break
        if marker == 0xFF:              # fill byte
            pos += 1
            continue
        (length,) = struct.unpack_from(">H", data, pos + 2)
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            block = body[6:] if block is None else block + body[6:]
        pos += 2 + length
    return block


def _value(typ: int, count: int, body: bytes, order: str):
    code, _ = _TYPES[typ]
    if typ in (1, 7):
        return body
    if typ == 2:
        return (body[:-1] if body.endswith(b"\x00") else body).decode(
            "latin-1", "replace")
    nums = struct.unpack(order + code * count, body)
    if typ in (5, 10):
        nums = tuple(a / b if b else float("nan")
                     for a, b in zip(nums[::2], nums[1::2]))
    return nums[0] if count == 1 else tuple(nums)


def _ifd(tiff: bytes, offset: int, order: str, wanted, path: str) -> dict:
    """The ``wanted`` tags of the IFD at ``offset``: {tag: value}."""
    out = {}
    if offset + 2 > len(tiff):
        warnings.warn(f"{path}: EXIF IFD at {offset} is past the block")
        return out
    (n,) = struct.unpack_from(order + "H", tiff, offset)
    for i in range(n):
        at = offset + 2 + 12 * i
        if at + 12 > len(tiff):
            warnings.warn(f"{path}: EXIF IFD at {offset} is cut short "
                          f"after {i} of {n} entries")
            break
        tag, typ, count, field = struct.unpack_from(order + "HHI4s", tiff,
                                                    at)
        if typ not in _TYPES:
            continue
        nbytes = _TYPES[typ][1] * count
        if nbytes > 4:
            (data_at,) = struct.unpack(order + "I", field)
            if data_at + nbytes > len(tiff):
                warnings.warn(f"{path}: EXIF tag {tag:#x} runs past the "
                              "block; its IFD ends there")
                break
            body = tiff[data_at:data_at + nbytes]
        else:
            body = field[:nbytes]
        if body and tag in wanted:
            out[tag] = _value(typ, count, body, order)
    return out


def _tiff(path: str) -> Optional[Tuple[bytes, str, int]]:
    """The EXIF block of a JPEG file, its byte order (a struct prefix) and
    IFD0's offset; ``None`` when the file is not a JPEG or has no readable
    EXIF block."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"\xff\xd8"):
        return None
    tiff = _exif_block(data)
    if tiff is None or len(tiff) < 8:
        return None
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        warnings.warn(f"{path}: EXIF block with byte order {tiff[:2]!r}, "
                      "not a TIFF header")
        return None
    (ifd0,) = struct.unpack_from(order + "I", tiff, 4)
    return tiff, order, ifd0


def read_gps_ifd(path: str) -> Optional[Dict[int, object]]:
    """GPS tags 1-4 of a JPEG file ({tag: value}, possibly empty), or
    ``None`` when the file is not a JPEG or has no readable EXIF block
    or no GPS IFD."""
    found = _tiff(path)
    if found is None:
        return None
    tiff, order, ifd0 = found
    gps_at = _ifd(tiff, ifd0, order, (GPS_IFD_TAG,), path).get(GPS_IFD_TAG)
    if type(gps_at) is not int:
        return None
    return _ifd(tiff, gps_at, order, GPS_TAGS, path)


def orientation(path: str) -> int:
    """IFD0's Orientation tag (0x0112) of a JPEG file as it is stored
    (1-8 in a valid file: how the stored rows map to the upright view);
    1 when the file is not a JPEG or has no readable EXIF block or no
    such tag holding one integer."""
    found = _tiff(path)
    if found is None:
        return 1
    tiff, order, ifd0 = found
    value = _ifd(tiff, ifd0, order, (ORIENTATION_TAG,),
                 path).get(ORIENTATION_TAG)
    return value if type(value) is int else 1
