"""Baseline JPEG files of the views, written from the standard (ITU-T T.81)
with libjpeg's integer formulas: JFIF, YCbCr with chroma subsampled 2x2
(4:2:0, what cameras write), the Annex K quantisation tables scaled to a
quality as ``jpeg_set_quality`` scales them, and the Annex K Huffman
tables. The file is the one ``cv2.imwrite`` writes at that quality.

Everything after the headers runs in torch on the views' device, in
integers, so the same view gives the same coefficients on any device and
in any call: ``coefficients`` is what the reference decodes
(``reference/jpeg.py``) to the pixels the program reads from the file.
"""
from __future__ import annotations

import torch


def _zigzag():
    """Zigzag index -> natural (row-major) index of an 8x8 block."""
    out = []
    for s in range(15):
        rows = range(min(s, 7), max(0, s - 7) - 1, -1)
        if s % 2:
            rows = reversed(list(rows))
        out += [r * 8 + (s - r) for r in rows]
    return out


ZIGZAG = _zigzag()

# Annex K.1: the basic quantisation tables, natural order.
LUMA_QUANT = [
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
CHROMA_QUANT = [
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32

# Annex K.3: the Huffman tables as DHT bodies (16 code counts, then the
# symbols): DC luma, AC luma, DC chroma, AC chroma.
HUFF_TABLES = tuple(bytes.fromhex(h) for h in (
    "00010501010101010100000000000000000102030405060708090a0b",
    "0002010303020403050504040000017d01020300041105122131410613516107"
    "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
    "292a3435363738393a434445464748494a535455565758595a63646566676869"
    "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
    "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
    "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    "00030101010101010101010000000000000102030405060708090a0b",
    "0002010204040304070504040001027700010203110405213106124151076171"
    "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
    "2728292a35363738393a434445464748494a535455565758595a636465666768"
    "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
    "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
    "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# jfdctint.c's constants, FIX(x) at 13 bits.
_C = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def quant_tables(quality: int, device="cpu") -> torch.Tensor:
    """[2, 64] int64, natural order: luma and chroma tables of
    ``jpeg_set_quality(quality, force_baseline=TRUE)``."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    t = (torch.tensor([LUMA_QUANT, CHROMA_QUANT], dtype=torch.int64)
         * scale + 50) // 100
    return t.clamp(1, 255).to(device)


def huffman_codes(table: bytes):
    """(code [256], length [256]) of each symbol of a DHT body: the
    canonical codes of T.81 annex C (length 0: no code)."""
    code_of, size_of = [0] * 256, [0] * 256
    code, k = 0, 16
    for length in range(1, 17):
        for _ in range(table[length - 1]):
            code_of[table[k]] = code
            size_of[table[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, size_of


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _ycc(img: torch.Tensor):
    """jccolor.c's rgb_ycc_convert of [H, W, 3] uint8: int64 planes."""
    r, g, b = (img[..., i].long() for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + offset + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + offset + half - 1) >> 16
    return y, cb, cr


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Edge replication at the bottom and the right up to [rows, cols]."""
    ri = torch.arange(rows, device=x.device).clamp(max=x.shape[0] - 1)
    ci = torch.arange(cols, device=x.device).clamp(max=x.shape[1] - 1)
    return x[ri][:, ci]


def _downsample(x: torch.Tensor, out_cols: int) -> torch.Tensor:
    """jcsample.c's h2v2_downsample to ``out_cols`` columns (rows padded
    to an even count first)."""
    x = _pad(x, x.shape[0] + x.shape[0] % 2, 2 * out_cols)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    bias = 1 + torch.arange(out_cols, device=x.device) % 2
    return (s + bias) >> 2


def _fdct_pass(d: torch.Tensor, first: bool) -> torch.Tensor:
    """One pass of jfdctint.c's jpeg_fdct_islow along the last axis of
    ``d`` [..., 8] int64: rows (``first``) or columns."""
    c = _C

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0], out[4] = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2
        n = 13 - 2
    else:
        out[0], out[4] = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2)
        n = 13 + 2
    z1 = (tmp12 + tmp13) * c["f0541"]
    out[2] = descale(z1 + tmp13 * c["f0765"], n)
    out[6] = descale(z1 - tmp12 * c["f1847"], n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * c["f1175"]
    tmp4, tmp5 = tmp4 * c["f0298"], tmp5 * c["f2053"]
    tmp6, tmp7 = tmp6 * c["f3072"], tmp7 * c["f1501"]
    z1, z2 = z1 * -c["f0899"], z2 * -c["f2562"]
    z3, z4 = z3 * -c["f1961"] + z5, z4 * -c["f0390"] + z5
    out[7] = descale(tmp4 + z1 + z3, n)
    out[5] = descale(tmp5 + z2 + z4, n)
    out[3] = descale(tmp6 + z2 + z3, n)
    out[1] = descale(tmp7 + z1 + z4, n)
    return torch.stack(out, -1)


def _blocks(plane: torch.Tensor, bh: int, bw: int,
            quant: torch.Tensor) -> torch.Tensor:
    """The [bh, bw] blocks of ``plane``: forward DCT and quantisation as
    jcdctmgr.c does them, [bh, bw, 64] natural order."""
    x = plane[:bh * 8, :bw * 8].reshape(bh, 8, bw, 8).permute(0, 2, 1, 3)
    x = _fdct_pass(x - 128, True)                                # rows
    x = _fdct_pass(x.transpose(-1, -2), False).transpose(-1, -2)  # columns
    x = x.reshape(bh, bw, 64)
    q = 8 * quant
    return torch.sign(x) * ((x.abs() + q // 2) // q)


def _with_dummies(blocks: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Luma's [bh, bw, 64] blocks on its MCU grid [2 mh, 2 mw]: the
    blocks past its own are zero with the DC of the block before them in
    the MCU (jccoefct.c compress_data)."""
    bh, bw = blocks.shape[:2]
    out = torch.zeros((2 * mh, 2 * mw, 64), dtype=blocks.dtype,
                      device=blocks.device)
    out[:bh, :bw] = blocks
    out[:bh, bw:, 0] = blocks[:, bw - 1:bw, 0]
    if 2 * mh > bh:
        out[bh:, :, 0] = out[bh - 1, 1::2, 0].repeat_interleave(2)[None, :]
    return out


def coefficients(img: torch.Tensor, quality: int) -> dict:
    """The quantised coefficients of an [H, W, 3] uint8 view as the file
    holds them: ``y`` [2 mh, 2 mw, 64] (dummy blocks included), ``cb``
    and ``cr`` [mh, mw, 64], natural order, int64; ``quant`` [2, 64]."""
    h, w = img.shape[:2]
    quant = quant_tables(quality, img.device)
    y, cb, cr = _ycc(img)
    mh, mw = -(-h // 16), -(-w // 16)
    bh, bw = -(-h // 8), -(-w // 8)
    luma = _with_dummies(_blocks(_pad(y, bh * 8, bw * 8), bh, bw, quant[0]),
                         mh, mw)
    chroma = [_blocks(_pad(_downsample(p, mw * 8), mh * 8, mw * 8), mh, mw,
                      quant[1]) for p in (cb, cr)]
    return {"y": luma, "cb": chroma[0], "cr": chroma[1], "quant": quant,
            "width": w, "height": h}


def _category(v: torch.Tensor) -> torch.Tensor:
    """Bits of |v| (0 for 0), for |v| < 2**12."""
    pow2 = 1 << torch.arange(12, device=v.device)
    return (v.abs()[..., None] >= pow2).sum(-1)


def _extra(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.where(v < 0, v - 1, v) & ((1 << s) - 1)


def _tables(device):
    codes, sizes = zip(*map(huffman_codes, HUFF_TABLES))
    return (torch.tensor(codes, dtype=torch.int64, device=device),
            torch.tensor(sizes, dtype=torch.int64, device=device))


def entropy(coef: dict) -> bytes:
    """The entropy-coded segment (byte-stuffed) of the coefficients in
    scan order: per MCU four luma blocks, then Cb and Cr. Each block is 65
    slots (DC, each AC position with the ZRLs before it, EOB) of at most
    59 bits, so the bits come out in order without a sort."""
    y, cb, cr = coef["y"], coef["cb"], coef["cr"]
    mh, mw = cb.shape[:2]
    dev = y.device
    mcus = torch.cat([y.reshape(mh, 2, mw, 2, 64).permute(0, 2, 1, 3, 4)
                      .reshape(mh, mw, 4, 64), cb[:, :, None],
                      cr[:, :, None]], 2)
    blocks = mcus.reshape(-1, 64)[:, ZIGZAG]
    n = blocks.shape[0]
    comp = torch.tensor([0, 0, 0, 0, 1, 2], device=dev).repeat(mh * mw)
    tab = comp.clamp(max=1)
    codes, sizes = _tables(dev)
    dc = blocks[:, 0]
    diff = torch.empty_like(dc)
    for c in range(3):
        at = comp == c
        d = dc[at]
        diff[at] = d - torch.cat([d.new_zeros(1), d[:-1]])
    s = _category(diff)
    dc_val = (codes[2 * tab, s] << s) | _extra(diff, s)
    dc_len = sizes[2 * tab, s] + s

    ac = blocks[:, 1:]
    nz = ac != 0
    k = torch.arange(1, 64, device=dev).expand(n, 63)
    kn = torch.where(nz, k, 0)
    prev = torch.cat([kn.new_zeros(n, 1),
                      torch.cummax(kn, dim=1).values[:, :-1]], 1)
    run = k - prev - 1
    sz = _category(ac)
    t_ac = (2 * tab + 1)[:, None].expand(n, 63)
    sym = ((run % 16) << 4) | sz
    code, length = codes[t_ac, sym], sizes[t_ac, sym]
    zrl, zrl_len = codes[t_ac, 0xF0], sizes[t_ac, 0xF0]
    pre = torch.zeros_like(ac)
    pre_len = torch.zeros_like(ac)
    for j in range(3):
        on = run // 16 > j
        pre = torch.where(on, (pre << zrl_len) | zrl, pre)
        pre_len = torch.where(on, pre_len + zrl_len, pre_len)
    ac_val = torch.where(nz, (((pre << length) | code) << sz)
                         | _extra(ac, sz), 0)
    ac_len = torch.where(nz, pre_len + length + sz, 0)
    eob = kn.amax(dim=1) < 63
    eob_val = codes[2 * tab + 1, 0]
    eob_len = torch.where(eob, sizes[2 * tab + 1, 0], 0)

    vals = torch.cat([dc_val[:, None], ac_val, eob_val[:, None]], 1)
    lens = torch.cat([dc_len[:, None], ac_len, eob_len[:, None]], 1)
    vals, lens = vals.reshape(-1), lens.reshape(-1)
    total = int(lens.sum())
    starts = torch.cumsum(lens, 0) - lens
    owner = torch.repeat_interleave(torch.arange(lens.numel(), device=dev),
                                    lens, output_size=total)
    at = torch.arange(total, device=dev) - starts[owner]
    bits = (vals[owner] >> (lens[owner] - 1 - at)) & 1
    bits = torch.cat([bits, bits.new_ones(-total % 8)])
    weights = 1 << torch.arange(7, -1, -1, device=dev)
    data = (bits.reshape(-1, 8) * weights).sum(1)
    ff = (data == 0xFF).long()
    pos = torch.arange(data.numel(), device=dev) + torch.cumsum(ff, 0) - ff
    out = torch.zeros(data.numel() + int(ff.sum()), dtype=torch.uint8,
                      device=dev)
    out[pos] = data.to(torch.uint8)
    return out.cpu().numpy().tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def headers(width: int, height: int, quant: torch.Tensor) -> bytes:
    """SOI through SOS, as libjpeg's jcmarker.c writes them."""
    q = quant.cpu().tolist()
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                 b"\x00\x00")]
    for t in range(2):
        out.append(_segment(0xDB, bytes([t] + [q[t][i] for i in ZIGZAG])))
    comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    out.append(_segment(0xC0, bytes([8]) + height.to_bytes(2, "big")
                        + width.to_bytes(2, "big") + bytes([3])
                        + b"".join(bytes(c) for c in comps)))
    for t in range(2):
        out.append(_segment(0xC4, bytes([t]) + HUFF_TABLES[2 * t]))
        out.append(_segment(0xC4, bytes([0x10 | t]) + HUFF_TABLES[2 * t + 1]))
    out.append(_segment(0xDA, bytes([3]) + b"".join(
        bytes([cid, (tq << 4) | tq]) for cid, _, tq in comps)
        + b"\x00\x3f\x00"))
    return b"".join(out)


def jpeg_bytes(img: torch.Tensor, quality: int) -> bytes:
    """The baseline JPEG file of an [H, W, 3] uint8 view."""
    coef = coefficients(img, quality)
    return (headers(coef["width"], coef["height"], coef["quant"])
            + entropy(coef) + b"\xff\xd9")
