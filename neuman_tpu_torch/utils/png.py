"""PNG codec in numpy and zlib: the port reads and writes the scene's
images, masks and mono depth maps, and the trainers' validation images,
with no image library.

`decode_png` returns what `imageio.v2.imread` returns for the same file:
- 8-bit RGB: [H, W, 3] uint8; 8-bit RGBA: [H, W, 4] uint8;
- 8-bit grayscale: [H, W] uint8; 16-bit grayscale: [H, W] uint16 (stored
  big-endian, returned in the machine's order).
Every row filter (none, sub, up, average, Paeth) is undone. Anything else
(palettes, transparency keys, other bit depths, 16-bit colour, interlaced
files, a file that is not a PNG) raises ValueError.

`encode_png` writes the same formats (filter 0 on every row, one IDAT
chunk).
"""

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> channels of the formats read and written
_FORMATS = {(8, 0): 1, (16, 0): 1, (8, 2): 3, (8, 6): 4}


def _chunks(data):
    """(tag, body) of every chunk, each chunk's CRC checked."""
    if data[:8] != _MAGIC:
        raise ValueError("not a PNG file")
    at = 8
    while at < len(data):
        (n,), tag = struct.unpack(">I", data[at:at + 4]), data[at + 4:at + 8]
        body = data[at + 8:at + 8 + n]
        if struct.unpack(">I", data[at + 8 + n:at + 12 + n])[0] != zlib.crc32(tag + body):
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        yield tag, body
        at += 12 + n
        if tag == b"IEND":
            return


def _header(body):
    w, h, depth, colour, compression, filt, interlace = struct.unpack(">IIBBBBB", body)
    if (depth, colour) not in _FORMATS:
        raise ValueError(f"unsupported PNG format: bit depth {depth}, colour type {colour}")
    if (compression, filt, interlace) != (0, 0, 0):
        raise ValueError("unsupported PNG: interlaced, or an unknown compression or filter "
                         "method")
    return w, h, depth, colour


def png_size(path):
    """(width, height) of a PNG file, from its header."""
    with open(path, "rb") as f:
        head = f.read(33)
    tag, body = next(_chunks(head))
    if tag != b"IHDR":
        raise ValueError(f"{path}: the first PNG chunk is {tag!r}, not IHDR")
    w, h, _, _ = _header(body)
    return w, h


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filters, raw, bpp):
    """Reconstructed bytes [H, W * bpp] of the filtered rows `raw` (uint8
    [H, W * bpp]) with their filter types `filters` [H]. Rows of filters
    0-2 go one row at a time; average and Paeth read the reconstructed
    left pixel, so an image with either goes one anti-diagonal of pixels
    at a time (the pixels of an anti-diagonal do not depend on each other)."""
    h = raw.shape[0]
    w = raw.shape[1] // bpp
    if filters.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(filters.max())}")
    if not np.isin(filters, (3, 4)).any():
        out = raw.copy()
        for r in range(h):
            if filters[r] == 1:
                out[r] = np.cumsum(raw[r].reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif filters[r] == 2 and r > 0:
                out[r] = raw[r] + out[r - 1]
        return out
    x = raw.reshape(h, w, bpp).astype(np.int32)
    # one zero row above and one zero pixel to the left, as the filters read them
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    f = filters.astype(np.int64)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a, b, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        pred = np.choose(f[r][:, None], [np.zeros_like(a), a, b, (a + b) >> 1, _paeth(a, b, ul)])
        out[r + 1, c + 1] = (x[r, c] + pred) & 255
    return out[1:, 1:].astype(np.uint8).reshape(h, w * bpp)


def decode_png(data):
    """The image of a PNG file's bytes; see the module docstring."""
    header, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = _header(body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag in (b"PLTE", b"tRNS"):
            raise ValueError(f"unsupported PNG: a {tag.decode()} chunk")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour = header
    channels = _FORMATS[(depth, colour)]
    bpp = channels * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data holds {rows.size} bytes, not {h * (1 + w * bpp)}")
    rows = rows.reshape(h, 1 + w * bpp)
    pixels = _unfilter(rows[:, 0], rows[:, 1:], bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    shape = (h, w) if channels == 1 else (h, w, channels)
    return pixels.reshape(shape)


def read_png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


def encode_png(img):
    """PNG bytes of an image: [H, W, 3] or [H, W, 4] uint8 (RGB, RGBA),
    [H, W] uint8 or uint16 (grayscale); filter 0 on every row."""
    img = np.ascontiguousarray(img)
    colour = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}.get(img.dtype)
    if colour is None or depth is None or (depth, colour) not in _FORMATS:
        raise ValueError(f"encode_png takes [H, W, 3|4] uint8 or [H, W] uint8|uint16, "
                         f"not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if depth == 16:
        img = img.astype(">u2")
    data = img.reshape(h, -1).view(np.uint8)

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), data], axis=1)
    return (_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path, img):
    with open(path, "wb") as f:
        f.write(encode_png(img))
