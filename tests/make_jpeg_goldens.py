"""Make the JPEG goldens of the port's codec (``tests/torch_goldens/jpeg/``).

Run from the repo root, where cv2 and PIL are installed:

    python tests/make_jpeg_goldens.py

Every source image is made from a seed with numpy alone
(:func:`source_image`), so a machine without cv2 remakes it exactly.  The
script writes:

- ``<name>.jpg``: the source encoded by cv2 (baseline or progressive; or
  PIL; or spliced from a cv2 file: an Adobe marker in place of the JFIF one;
  or by the port's encoder in its one-component-a-scan test mode, a kind of
  file no writer here makes otherwise), one file a case of
  :data:`DECODE_CASES`;
- ``pixels.npz``: ``cv2.imread``'s pixels (RGB) of every small file;
- ``manifest.json``: each case's parameters, the sha256 of cv2's pixels
  (the only record kept of the 480x640 files'), for every source of
  :data:`ENCODE_CASES` the sha256 of the bytes ``cv2.imwrite`` writes for
  it at its defaults, and the files of :data:`REFUSED` with the marker the
  decoder names when it refuses them.

``tests/test_torch_jpeg.py`` and ``chip_smoke.py`` (phase 12, on a machine
with no cv2) read the same files.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_goldens", "jpeg")

# cv2.IMWRITE_JPEG_SAMPLING_FACTOR values
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111,
            "411": 0x411111}

# name -> (seed, height, width, how the file is made)
DECODE_CASES = {
    "q50_420": (1, 48, 64, dict(writer="cv2", quality=50, sampling="420")),
    "q75_420": (2, 48, 64, dict(writer="cv2", quality=75, sampling="420")),
    "q95_420": (3, 48, 64, dict(writer="cv2", quality=95, sampling="420")),
    "q100_420": (4, 48, 64, dict(writer="cv2", quality=100, sampling="420")),
    "q90_444_odd": (5, 61, 93, dict(writer="cv2", quality=90, sampling="444")),
    "q90_422_odd": (6, 61, 93, dict(writer="cv2", quality=90, sampling="422")),
    "q90_420_odd": (7, 61, 93, dict(writer="cv2", quality=90, sampling="420")),
    "q90_440_odd": (8, 61, 93, dict(writer="cv2", quality=90, sampling="440")),
    "q90_411_odd": (9, 37, 45, dict(writer="cv2", quality=90, sampling="411")),
    "grey": (10, 61, 93, dict(writer="cv2", quality=95, grey=True)),
    "restart": (11, 37, 53, dict(writer="cv2", quality=95, sampling="420", restart=2)),
    "one_pixel": (12, 1, 1, dict(writer="cv2", quality=95, sampling="420")),
    "three_by_two": (13, 2, 3, dict(writer="cv2", quality=95, sampling="420")),
    "adobe_ycc": (14, 37, 53, dict(writer="cv2", quality=95, sampling="420", adobe=1)),
    "adobe_rgb": (15, 37, 53, dict(writer="cv2", quality=95, sampling="420", adobe=0)),
    "exif_rotate90": (16, 37, 53, dict(writer="pil", quality=85, subsampling=2, orientation=6)),
    "pil_422_optimized": (17, 45, 67, dict(writer="pil", quality=80, subsampling=1,
                                           optimize=True)),
    "frame_480x640": (18, 480, 640, dict(writer="cv2", quality=95, sampling="420")),
    "progressive": (30, 37, 53, dict(writer="cv2", quality=95, sampling="420",
                                     progressive=True)),
    "progressive_444_odd": (31, 61, 93, dict(writer="cv2", quality=90, sampling="444",
                                             progressive=True)),
    "progressive_422_optimized": (32, 45, 67, dict(writer="cv2", quality=80, sampling="422",
                                                   progressive=True, optimize=True)),
    "progressive_grey": (33, 61, 93, dict(writer="cv2", quality=95, grey=True,
                                          progressive=True)),
    "progressive_restart": (34, 37, 53, dict(writer="cv2", quality=95, sampling="420",
                                             progressive=True, restart=2)),
    "progressive_frame_480x640": (35, 480, 640, dict(writer="cv2", quality=95, sampling="420",
                                                     progressive=True)),
    "one_scan_per_component": (36, 61, 93, dict(writer="port_scans")),
}
PIXELS_IN_NPZ_MAX = 100 * 100  # larger files keep only the sha256 of their pixels

# sources whose cv2.imwrite bytes are recorded: (seed, height, width, grey)
ENCODE_CASES = [(21, 1, 1, False), (22, 2, 3, False), (23, 8, 8, False), (24, 17, 33, False),
                (25, 31, 17, False), (26, 61, 93, False), (27, 61, 93, True),
                (28, 480, 640, False)]

# refused by the decoder: a cv2 file with its SOF0 marker patched to this
# frame type, checked to raise naming it; name -> (seed, height, width, marker)
REFUSED = {"arithmetic": (37, 37, 53, 0xC9)}


def source_image(seed: int, height: int, width: int, grey: bool = False) -> np.ndarray:
    """``[H, W, 3]`` (or ``[H, W]``) uint8: a seeded coarse grid of levels,
    interpolated linearly, plus seeded noise; numpy only."""
    rng = np.random.RandomState(seed)
    c = 1 if grey else 3
    gy, gx = height // 12 + 2, width // 12 + 2
    grid = rng.rand(gy, gx, c) * 255.0
    ys, xs = np.linspace(0, gy - 1, height), np.linspace(0, gx - 1, width)
    y0, x0 = np.minimum(ys.astype(int), gy - 2), np.minimum(xs.astype(int), gx - 2)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = (grid[y0][:, x0] * (1 - fy) * (1 - fx) + grid[y0][:, x0 + 1] * (1 - fy) * fx
           + grid[y0 + 1][:, x0] * fy * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fy * fx)
    img = img + rng.randn(height, width, c) * 6.0
    img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def pixels_sha256(rgb: np.ndarray) -> str:
    """sha256 of an ``[H, W, 3]`` uint8 array's C-order bytes."""
    return sha256(np.ascontiguousarray(rgb, np.uint8).tobytes())


def encode_case(seed, height, width, how) -> bytes:
    """The file of one decode case (the source given to cv2 as BGR)."""
    import cv2

    grey = how.get("grey", False)
    src = source_image(seed, height, width, grey)
    if how["writer"] == "port_scans":
        from this_and_that_vdm_tpu_torch.utils import host_native

        return host_native.encode_jpeg(src, scan_per_component=True)
    if how["writer"] == "pil":
        from PIL import Image

        kw = dict(quality=how["quality"], subsampling=how["subsampling"],
                  optimize=how.get("optimize", False))
        if "orientation" in how:
            exif = Image.Exif()
            exif[0x0112] = how["orientation"]
            kw["exif"] = exif.tobytes()
        bio = io.BytesIO()
        Image.fromarray(src).save(bio, "JPEG", **kw)
        return bio.getvalue()
    params = [cv2.IMWRITE_JPEG_QUALITY, how["quality"]]
    if not grey:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[how["sampling"]]]
    if "restart" in how:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, how["restart"]]
    if how.get("progressive"):
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if how.get("optimize"):
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    ok, buf = cv2.imencode(".jpg", src if grey else src[..., ::-1], params)
    assert ok
    data = buf.tobytes()
    if "adobe" in how:  # the 18-byte JFIF APP0 after SOI -> an Adobe APP14
        assert data[2:4] == b"\xff\xe0" and data[6:11] == b"JFIF\x00"
        adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([how["adobe"]])
        data = data[:2] + adobe + data[20:]
    return data


def refused_file(seed, height, width, marker) -> bytes:
    """A cv2 baseline file with its SOF0 marker patched to ``marker``."""
    import cv2

    ok, buf = cv2.imencode(".jpg", source_image(seed, height, width)[..., ::-1])
    data = bytearray(buf.tobytes())
    data[data.index(b"\xff\xc0") + 1] = marker
    return bytes(data)


def cv2_pixels(data: bytes) -> np.ndarray:
    import cv2

    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None
    return np.ascontiguousarray(bgr[..., ::-1])


def cv2_encoded(seed, height, width, grey) -> bytes:
    import cv2

    src = source_image(seed, height, width, grey)
    ok, buf = cv2.imencode(".jpg", src if grey else src[..., ::-1])
    assert ok
    return buf.tobytes()


def check_goldens(decode, encode, folder: str = HERE):
    """Hold a decoder (``decode(bytes, name)`` -> ``[H, W, 3]`` uint8 RGB)
    and an encoder (``encode(image)`` -> bytes) to the goldens in
    ``folder``, with numpy alone.  Returns one ``(kind, name, ok, detail)``
    row a case: every decode case bit-equal to cv2's pixels (the stored
    array, and its sha256), every encode case's bytes of sha256 equal to
    cv2's, and every refused file raising ``ValueError``."""
    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)
    stored = np.load(os.path.join(folder, "pixels.npz"))
    rows = []
    for name, case in sorted(manifest["decode"].items()):
        with open(os.path.join(folder, f"{name}.jpg"), "rb") as f:
            got = decode(f.read(), name)
        ok = list(got.shape) == case["shape"] and pixels_sha256(got) == case["pixels_sha256"]
        detail = f"{got.shape}"
        if case["in_npz"]:
            want = stored[name]
            ok = ok and np.array_equal(got, want)
            if got.shape == want.shape:
                diff = np.abs(got.astype(int) - want.astype(int))
                detail += f" max|diff| {diff.max()}, share differing {np.mean(diff > 0):.6f}"
        rows.append(("decode", name, bool(ok), detail))
    for case in manifest["encode"]:
        src = source_image(case["seed"], case["height"], case["width"], case["grey"])
        data = encode(src)
        name = f"{case['height']}x{case['width']}" + (" grey" if case["grey"] else "")
        rows.append(("encode", name, sha256(data) == case["bytes_sha256"], f"{len(data)} bytes"))
    for name, case in sorted(manifest["refused"].items()):
        with open(os.path.join(folder, f"{name}.jpg"), "rb") as f:
            data = f.read()
        try:
            decode(data, name)
            rows.append(("refuse", name, False, "decoded"))
        except ValueError as e:
            rows.append(("refuse", name, case["marker"] in str(e), str(e)))
    return rows


def main():
    import cv2

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.makedirs(HERE, exist_ok=True)
    manifest = {"cv2": cv2.__version__, "decode": {}, "encode": [], "refused": {}}
    pixels = {}
    for name, (seed, h, w, how) in DECODE_CASES.items():
        data = encode_case(seed, h, w, how)
        with open(os.path.join(HERE, f"{name}.jpg"), "wb") as f:
            f.write(data)
        px = cv2_pixels(data)
        manifest["decode"][name] = dict(seed=seed, height=h, width=w, how=how,
                                        shape=list(px.shape), pixels_sha256=pixels_sha256(px),
                                        in_npz=h * w <= PIXELS_IN_NPZ_MAX)
        if h * w <= PIXELS_IN_NPZ_MAX:
            pixels[name] = px
    for seed, h, w, grey in ENCODE_CASES:
        manifest["encode"].append(dict(seed=seed, height=h, width=w, grey=grey,
                                       bytes_sha256=sha256(cv2_encoded(seed, h, w, grey))))
    for name, (seed, h, w, marker) in REFUSED.items():
        with open(os.path.join(HERE, f"{name}.jpg"), "wb") as f:
            f.write(refused_file(seed, h, w, marker))
        manifest["refused"][name] = dict(seed=seed, height=h, width=w,
                                         marker=f"SOF{marker - 0xC0}")
    np.savez_compressed(os.path.join(HERE, "pixels.npz"), **pixels)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in os.listdir(HERE))
    print(f"wrote {len(os.listdir(HERE))} files, {total} bytes, to {HERE}")


if __name__ == "__main__":
    main()
