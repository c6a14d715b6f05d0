"""The port's own JPEG codec (``csrc/jpeg_decode.cpp``, ``jpeg_encode.cpp``
through ``utils/host_native``, built here with the host compiler) against
cv2 as the oracle, on the CPU.

- Decoder: bit-equal to ``cv2.imread(...)[..., ::-1]`` (max |diff| 0) over a
  seeded corpus made here with ``cv2.imwrite`` / PIL: qualities 50, 75, 95,
  100; 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1; greyscale; a restart interval;
  odd and tiny sizes (61x93, 1x1, 2x3, 5x4); Adobe markers (transform 1
  and 0); an EXIF orientation; PIL's optimised tables; progressive files
  (cv2's and PIL's scan scripts: spectral selection, successive
  approximation, EOB runs, restart intervals, optimised tables); baseline
  files with one component a scan (the port's encoder in its test mode).
- Refused: arithmetic, lossless and 12-bit streams, and a progressive
  stream cut after its first scans (where libjpeg smooths the blocks),
  raise ``ValueError`` naming the file and the marker; a truncated file raises
  (where cv2.imread returns None or fills the rest with grey); a Huffman
  table whose codes do not fit their lengths raises; a missing file raises
  ``FileNotFoundError``.
- Encoder: bytes equal to ``cv2.imencode('.jpg', bgr)`` at its defaults for
  seeded images at several sizes, odd ones and greyscale included.
- The committed goldens (``tests/torch_goldens/jpeg/``, made by
  ``tests/make_jpeg_goldens.py``) hold for the port and are what cv2 makes.
- ``read_image`` decodes JPEG with cv2 and PIL unimportable (it needed one
  of them before), and ``write_image`` writes by extension.
"""

import io
import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

import make_jpeg_goldens as goldens

from this_and_that_vdm_tpu_torch.utils import host_native, video_io


def _cv2_rgb(data: bytes):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[..., ::-1]


def _cv2_file(src, quality=95, sampling="420", restart=0, grey=False, progressive=False,
              optimize=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if not grey:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, goldens.SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if optimize:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    ok, buf = cv2.imencode(".jpg", src if grey else src[..., ::-1], params)
    assert ok
    return buf.tobytes()


def _pil_file(src, **kw):
    bio = io.BytesIO()
    Image.fromarray(src).save(bio, "JPEG", **kw)
    return bio.getvalue()


def _with_adobe(data, transform):
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])
    return data[:2] + adobe + data[20:]


def _exif(orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif.tobytes()


_SRC = goldens.source_image
_CORPUS = {
    **{f"q{q}_{s}": (lambda q=q, s=s: _cv2_file(_SRC(q + len(s), 61, 93), q, s))
       for q in (50, 75, 95, 100) for s in ("444", "422", "420")},
    "q85_440": lambda: _cv2_file(_SRC(1, 61, 93), 85, "440"),
    "q85_411": lambda: _cv2_file(_SRC(2, 45, 70), 85, "411"),
    "grey": lambda: _cv2_file(_SRC(3, 61, 93, grey=True), 90, grey=True),
    "restart_interval": lambda: _cv2_file(_SRC(4, 61, 93), 90, "420", restart=3),
    "one_by_one": lambda: _cv2_file(_SRC(5, 1, 1)),
    "two_by_three": lambda: _cv2_file(_SRC(6, 2, 3)),
    "five_by_four_422": lambda: _cv2_file(_SRC(7, 5, 4), 95, "422"),
    "adobe_ycbcr": lambda: _with_adobe(_cv2_file(_SRC(8, 37, 53)), 1),
    "adobe_rgb": lambda: _with_adobe(_cv2_file(_SRC(9, 37, 53)), 0),
    "exif_orientation_8": lambda: _pil_file(_SRC(10, 37, 53), quality=90, exif=_exif(8)),
    "pil_optimized_422": lambda: _pil_file(_SRC(11, 45, 67), quality=80, subsampling=1,
                                           optimize=True),
    "frame_240x320": lambda: _cv2_file(_SRC(12, 240, 320)),
    **{f"progressive_q{q}_{s}": (lambda q=q, s=s: _cv2_file(_SRC(q + len(s) + 40, 61, 93), q, s,
                                                            progressive=True))
       for q in (50, 95) for s in ("444", "422", "420")},
    "progressive_q85_411_odd": lambda: _cv2_file(_SRC(20, 45, 70), 85, "411", progressive=True),
    "progressive_grey": lambda: _cv2_file(_SRC(21, 61, 93, grey=True), 90, grey=True,
                                          progressive=True),
    "progressive_restart_interval": lambda: _cv2_file(_SRC(22, 61, 93), 90, "420", restart=3,
                                                      progressive=True),
    "progressive_optimized": lambda: _cv2_file(_SRC(23, 37, 53), 80, "420", progressive=True,
                                               optimize=True),
    "progressive_five_by_four": lambda: _cv2_file(_SRC(24, 5, 4), 95, "422", progressive=True),
    "pil_progressive_444": lambda: _pil_file(_SRC(25, 45, 67), quality=85, subsampling=0,
                                             progressive=True),
    "pil_progressive_420_optimized": lambda: _pil_file(_SRC(26, 61, 93), quality=75,
                                                       subsampling=2, progressive=True,
                                                       optimize=True),
    **{f"one_scan_per_component_{h}x{w}": (
        lambda h=h, w=w: host_native.encode_jpeg(_SRC(h + w, h, w), scan_per_component=True))
       for h, w in ((1, 1), (17, 33), (61, 93))},
}


@pytest.mark.parametrize("case", sorted(_CORPUS))
def test_decoder_bit_equal_to_cv2(case):
    data = _CORPUS[case]()
    want = _cv2_rgb(data)
    got = host_native.decode_jpeg(data, case)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() == 0, f"{case}: max|diff| {diff.max()}, share {np.mean(diff > 0):.6f}"


def _sof_patched(marker=None, precision=None):
    data = bytearray(_cv2_file(_SRC(13, 24, 32)))
    at = data.index(b"\xff\xc0")
    if marker is not None:
        data[at + 1] = marker
    if precision is not None:
        data[at + 4] = precision
    return bytes(data)


def _progressive_cut(scans):
    """A cv2 progressive file cut after its first ``scans`` scans, then EOI:
    cv2 decodes it, smoothing the blocks whose coefficients stay inexact."""
    data = _cv2_file(_SRC(14, 24, 32), progressive=True)
    at = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"][scans]
    assert _cv2_rgb(data[:at] + b"\xff\xd9") is not None
    return data[:at] + b"\xff\xd9"


@pytest.mark.parametrize("kind,make,needle", [
    ("progressive_incomplete", lambda: _progressive_cut(3), "block smoothing"),
    ("arithmetic", lambda: _sof_patched(marker=0xC9), "arithmetic-coded sequential (SOF9)"),
    ("lossless", lambda: _sof_patched(marker=0xC3), "lossless (SOF3)"),
    ("twelve_bit", lambda: _sof_patched(precision=12), "12-bit JPEG is not supported"),
])
def test_refused_streams_raise_naming_file_and_marker(tmp_path, kind, make, needle):
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(make())
    with pytest.raises(ValueError) as e:
        video_io.read_image(str(path))
    assert str(path) in str(e.value) and needle in str(e.value), e.value


def _first_dht_replaced(data, counts):
    """``data`` with its first Huffman table given the code-length
    ``counts`` (its symbols kept, padded with 0, 1, 2, ...)."""
    at = data.index(b"\xff\xc4")
    end = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    old = data[at + 4:end]
    n_old = sum(old[1:17])
    counts = list(counts) + [0] * (16 - len(counts))
    values = (old[17:17 + n_old] + bytes(range(256)))[:sum(counts)]
    body = old[:1] + bytes(counts) + values + old[17 + n_old:]
    return data[:at] + b"\xff\xc4" + (2 + len(body)).to_bytes(2, "big") + body + data[end:]


@pytest.mark.parametrize("counts", [[3], [200], [1, 2], [0, 3, 6]],
                         ids=["three_1bit_codes", "two_hundred_1bit_codes", "all_ones_code",
                              "oversubscribed_3bit"])
def test_bad_huffman_table_raises(tmp_path, counts):
    """A DHT whose codes do not fit their lengths (or leave an all-ones
    code) is refused before any table is filled, as libjpeg's
    jpeg_make_d_derived_tbl refuses it: cv2 returns None for it too."""
    data = _first_dht_replaced(_cv2_file(_SRC(16, 24, 32)), counts)
    assert _cv2_rgb(data) is None
    path = tmp_path / "bad_dht.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="bad Huffman table") as e:
        video_io.read_image(str(path))
    assert str(path) in str(e.value)


@pytest.mark.parametrize("cut", ["no_eoi", "mid_scan", "in_header"])
def test_truncated_file_raises(tmp_path, cut):
    """A truncated file raises, naming it, where ``cv2.imread`` does not
    match one answer: it returns None for a cut header, but for a cut scan
    it warns ("Premature end of JPEG file") and fills the rest with grey
    (128), and ``cv2.imdecode`` returns None for all three cuts.  The decoder
    takes the refusing answer, so no frame trains on filler."""
    data = _cv2_file(_SRC(15, 61, 93))
    end = {"no_eoi": len(data) - 2, "mid_scan": len(data) // 2, "in_header": 300}[cut]
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:end])
    assert _cv2_rgb(data[:end]) is None
    filled = cv2.imread(str(path))
    assert (filled is None) == (cut == "in_header")
    if cut == "mid_scan":
        assert (filled[-8:] == 128).all()
    with pytest.raises(ValueError, match="truncated JPEG") as e:
        video_io.read_image(str(path))
    assert str(path) in str(e.value)


def test_missing_and_foreign_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        video_io.read_image(str(tmp_path / "absent.jpg"))
    (tmp_path / "x.jpg").write_bytes(b"GIF89a not a frame")
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        video_io.read_image(str(tmp_path / "x.jpg"))


@pytest.mark.parametrize("hw,grey", [((1, 1), False), ((2, 3), False), ((7, 5), False),
                                     ((16, 16), False), ((17, 33), False), ((61, 93), False),
                                     ((120, 160), False), ((33, 47), True)])
def test_encoder_bytes_equal_cv2(hw, grey):
    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    for src in (_SRC(hw[0] + hw[1], *hw, grey=grey),
                rng.randint(0, 256, hw if grey else hw + (3,)).astype(np.uint8)):
        ok, want = cv2.imencode(".jpg", src if grey else src[..., ::-1])
        assert host_native.encode_jpeg(src) == want.tobytes()


def test_committed_goldens_hold_for_the_port():
    rows = goldens.check_goldens(host_native.decode_jpeg, host_native.encode_jpeg)
    bad = [r for r in rows if not r[2]]
    assert not bad and len(rows) >= 25, bad


def test_committed_goldens_are_what_cv2_makes():
    """The goldens were made by this cv2 (and PIL): remade from their seeds,
    every file, pixel array and encoded-bytes digest is the same."""
    import json

    with open(os.path.join(goldens.HERE, "manifest.json")) as f:
        manifest = json.load(f)
    stored = np.load(os.path.join(goldens.HERE, "pixels.npz"))
    for name, (seed, h, w, how) in goldens.DECODE_CASES.items():
        data = goldens.encode_case(seed, h, w, how)
        with open(os.path.join(goldens.HERE, f"{name}.jpg"), "rb") as f:
            assert f.read() == data, name
        px = goldens.cv2_pixels(data)
        assert goldens.pixels_sha256(px) == manifest["decode"][name]["pixels_sha256"], name
        if name in stored.files:
            assert np.array_equal(stored[name], px), name
    for case in manifest["encode"]:
        data = goldens.cv2_encoded(case["seed"], case["height"], case["width"], case["grey"])
        assert goldens.sha256(data) == case["bytes_sha256"], case
    assert sum(os.path.getsize(os.path.join(goldens.HERE, n))
               for n in os.listdir(goldens.HERE)) < 1 << 20


def test_read_image_decodes_jpeg_without_cv2_or_pil(tmp_path, monkeypatch):
    """JPEG is decoded by the port's own decoder wherever it runs: with cv2
    and PIL unimportable (as on the card's machine) the pixels are cv2's."""
    data = _cv2_file(_SRC(16, 45, 67), 90, "420")
    want = _cv2_rgb(data)
    path = tmp_path / "im_0.jpg"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    np.testing.assert_array_equal(video_io.read_image(str(path)), want)


def test_write_image_picks_the_format_by_extension(tmp_path):
    src = _SRC(17, 29, 41)
    for ext in (".jpg", ".jpeg", ".JPG"):
        path = str(tmp_path / f"a{ext}")
        assert video_io.write_image(path, src) == path
        cv2.imwrite(str(tmp_path / f"cv2{ext}"), src[..., ::-1])
        assert open(path, "rb").read() == open(tmp_path / f"cv2{ext}", "rb").read()
    video_io.write_image(str(tmp_path / "a.png"), src)
    np.testing.assert_array_equal(video_io.read_png(str(tmp_path / "a.png")), src)
    assert video_io.write_jpeg(str(tmp_path / "g.jpg"), src[..., 1]) == str(tmp_path / "g.jpg")
    np.testing.assert_array_equal(video_io.read_image(str(tmp_path / "g.jpg")),
                                  cv2.imread(str(tmp_path / "g.jpg"))[..., ::-1])
    with pytest.raises(ValueError, match="no image writer"):
        video_io.write_image(str(tmp_path / "a.bmp"), src)
