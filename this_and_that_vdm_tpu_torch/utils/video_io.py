"""Frame export and evaluation metrics of the entry points (the port's copy
of the parts of ``this_and_that_vdm_tpu/utils/video_io.py`` they use), with
the standard library and numpy only.

- ``write_png`` / ``read_png``: 8-bit PNG (``zlib``); the reader takes
  greyscale, RGB and RGBA at 8 bits, every row filter, no interlace.
- ``read_image``: RGB uint8 by the file's signature (``cv2.imread`` also
  reads by content): PNG through ``read_png``; JPEG through ``cv2`` or
  ``PIL``, whichever is installed, else an error naming both.
- ``export_gif``: GIF89a with a fixed 3-3-2 palette and its own LZW coder.
- ``export_mp4``: mp4 through imageio where it has a writer, else a GIF.
- ``psnr``, ``ssim`` (11x11 Gaussian window, sigma 1.5, the window's
  ``valid`` part only), ``per_frame_metrics``, ``load_frames_dir``.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Sequence

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


# ------------------------------------------------------------------- PNG

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> str:
    """Write an ``[H, W, 3]`` uint8 RGB image, or an ``[H, W]`` grayscale
    one (as ``cv2.imwrite`` writes a 2-D array), every row unfiltered."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim == 2:
        rgb = rgb[..., None]
    h, w, c = rgb.shape
    if c not in (1, 3):
        raise ValueError(f"write_png takes [H, W, 3] RGB or [H, W] gray, got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 0, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_chunk(b"IEND", b""))
    return path


def _unfilter_row(kind: int, raw: bytearray, prior: bytearray, bpp: int) -> bytearray:
    if kind == 0:
        return raw
    if kind == 1:  # each byte plus the one bpp to its left: a running sum per channel
        x = np.frombuffer(raw, np.uint8).reshape(-1, bpp).astype(np.int64)
        return bytearray((x.cumsum(axis=0) & 0xFF).astype(np.uint8).tobytes())
    if kind == 2:
        return bytearray((np.frombuffer(raw, np.uint8) + np.frombuffer(prior, np.uint8))
                         .astype(np.uint8).tobytes())
    out = raw
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if kind == 3:
            pred = (a + prior[i]) >> 1
        elif kind == 4:
            b, c = prior[i], (prior[i - bpp] if i >= bpp else 0)
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[i] = (out[i] + pred) & 0xFF
    return out


def read_png(path: str) -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB of an 8-bit greyscale, RGB or RGBA PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type {color}, interlace "
                         f"{interlace} is not supported (8-bit grey, RGB or RGBA only)")
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    prior, rows = bytearray(stride), []
    for y in range(h):
        start = y * (stride + 1)
        prior = _unfilter_row(raw[start], bytearray(raw[start + 1:start + 1 + stride]), prior,
                              channels)
        rows.append(bytes(prior))
    img = np.frombuffer(b"".join(rows), np.uint8).reshape(h, w, channels)
    if channels == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_image(path: str) -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB of a PNG or JPEG file, told apart by the
    file's signature, not its name."""
    with open(path, "rb") as f:
        sig = f.read(8)
    if sig == _PNG_SIG:
        return read_png(path)
    if sig[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: neither PNG nor JPEG")
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path} is a JPEG file: decoding it needs cv2 or PIL, and neither "
                           "is installed (PNG bytes are read without either)") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_frames_dir(path: str, ext: str = ".png") -> List[np.ndarray]:
    """Read ``0.png .. N.png`` (an inference output folder) as RGB."""
    out = []
    while os.path.exists(os.path.join(path, f"{len(out)}{ext}")):
        out.append(read_image(os.path.join(path, f"{len(out)}{ext}")))
    return out


# ------------------------------------------------------------------- GIF

def _palette_332() -> np.ndarray:
    i = np.arange(256)
    return np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7, (i & 3) * 85],
                    axis=1).astype(np.uint8)


def _lzw(indices: bytes, min_size: int = 8) -> bytes:
    """GIF LZW code stream (LSB-first) of 8-bit palette indices."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0
    size, nxt, table = min_size + 1, eoi + 1, {}

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear, size)
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, size)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            # the decoder adds this entry one code later: widen once the
            # entry past the current width has been made
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear, size)
            size, nxt, table = min_size + 1, eoi + 1, {}
        prefix = k
    emit(prefix, size)
    emit(eoi, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def export_gif(frames_uint8: Sequence[np.ndarray], path: str, fps: int = 4) -> str:
    """Write ``[H, W, 3]`` uint8 RGB frames as a looping GIF89a."""
    frames = [np.asarray(f, np.uint8) for f in frames_uint8]
    h, w = frames[0].shape[:2]
    delay = max(1, round(100 / fps))
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _palette_332().tobytes(),
             b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames:
        idx = ((f[..., 0] >> 5) << 5) | ((f[..., 1] >> 5) << 2) | (f[..., 2] >> 6)
        code = _lzw(idx.astype(np.uint8).tobytes())
        parts += [b"!\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                  b"," + struct.pack("<HHHHB", 0, 0, w, h, 0), b"\x08"]
        parts += [bytes([len(code[i:i + 255])]) + code[i:i + 255]
                  for i in range(0, len(code), 255)]
        parts.append(b"\x00")
    parts.append(b";")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
    return path


def export_mp4(frames_uint8: Sequence[np.ndarray], path: str, fps: int = 4) -> str:
    """Write an mp4 through imageio; where imageio or its ffmpeg / pyav
    backend is missing, a GIF beside it (``<stem>.gif``).  Returns the path
    written."""
    frames = [np.asarray(f, np.uint8) for f in frames_uint8]
    try:
        import imageio

        imageio.mimsave(path, frames, fps=fps)
        return path
    except Exception:  # noqa: BLE001 -- any missing package or writer: fall back
        if os.path.exists(path):  # no partial file left behind
            os.remove(path)
    return export_gif(frames, os.path.splitext(path)[0] + ".gif", fps=fps)


# --------------------------------------------------------------- metrics

def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_window(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` as a 1-D array."""
    x = np.arange(ksize) - (ksize - 1) / 2.0
    g = np.exp(-x * x / (2.0 * sigma * sigma))
    return g / g.sum()


def _filter_valid(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """x correlated with ``outer(g, g)``, only where the window fits (the
    ``[5:-5, 5:-5]`` crop of a same-size filter with an 11-tap window)."""
    k = len(g)
    h, w = x.shape
    rows = sum(g[i] * x[i:h - k + 1 + i] for i in range(k))
    return sum(g[i] * rows[:, i:w - k + 1 + i] for i in range(k))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Single-scale SSIM (11x11 Gaussian window, standard constants)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], data_range)
                              for c in range(a.shape[-1])]))
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    g = _gaussian_window()
    mu_a, mu_b = _filter_valid(a, g), _filter_valid(b, g)
    s_aa = _filter_valid(a * a, g) - mu_a**2
    s_bb = _filter_valid(b * b, g) - mu_b**2
    s_ab = _filter_valid(a * b, g) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * s_ab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (s_aa + s_bb + c2)
    return float(np.mean(num / den))


def per_frame_metrics(frames_a, frames_b, data_range: float = 255.0) -> dict:
    """PSNR/SSIM per frame + means (the acceptance gate: PSNR >= 35)."""
    ps = [psnr(a, b, data_range) for a, b in zip(frames_a, frames_b)]
    ss = [ssim(a, b, data_range) for a, b in zip(frames_a, frames_b)]
    return {"psnr": ps, "ssim": ss,
            "psnr_mean": float(np.mean(ps)), "ssim_mean": float(np.mean(ss))}
