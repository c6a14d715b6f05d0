"""The port's safetensors reader and writer (weights/safetensors_io.py)
against the ``safetensors`` package, both ways, bit for bit; metadata, zero-
size tensors, and the loader's recursive glob over nested shards."""

import os

import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load, save_file as st_save
from safetensors import safe_open

from this_and_that_vdm_tpu_torch.weights import loader, safetensors_io as sio

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64}


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        make = lambda *s: (torch.randn(s, generator=g) * 3).to(dtype)  # noqa: E731
    else:
        make = lambda *s: torch.randint(-2**40, 2**40, s, generator=g, dtype=dtype)  # noqa: E731
    # odd sizes, so later tensors start at offsets that are not multiples of 8
    return {"a.weight": make(3, 5), "b": make(7), "c.bias": make(1), "d": make(2, 3, 3),
            "scalar": make(1).reshape(())}


def _bits(t):
    """The tensor's raw bits as integers (NaN-safe, -0.0 != 0.0)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def _assert_bit_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.parametrize("name", list(DTYPES))
def test_port_writer_reads_back_in_safetensors(tmp_path, name):
    ts = _tensors(DTYPES[name])
    path = str(tmp_path / "x.safetensors")
    sio.save_file(ts, path)
    _assert_bit_equal(st_load(path), ts)


@pytest.mark.parametrize("name", list(DTYPES))
def test_port_reader_reads_safetensors_files(tmp_path, name):
    ts = _tensors(DTYPES[name], seed=1)
    path = str(tmp_path / "x.safetensors")
    st_save(ts, path)
    _assert_bit_equal(sio.load_file(path), ts)


def test_mixed_dtypes_and_metadata_both_ways(tmp_path):
    ts = {f"{n}.{i}": t for n, dt in DTYPES.items() for i, t in _tensors(dt).items()}
    ts["u8"] = torch.arange(11, dtype=torch.uint8)
    ts["i32"] = torch.arange(-5, 4, dtype=torch.int32)
    meta = {"format": "pt", "note": "seeded"}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    sio.save_file(ts, ours, metadata=meta)
    with safe_open(ours, framework="pt") as f:
        assert f.metadata() == meta
    _assert_bit_equal(st_load(ours), ts)
    st_save(ts, theirs, metadata=meta)
    assert sio.read_metadata(theirs) == meta
    _assert_bit_equal(sio.load_file(theirs), ts)


def test_zero_size_tensors(tmp_path):
    ts = {"empty": torch.empty(0, 3), "empty_bf16": torch.empty(4, 0, dtype=torch.bfloat16),
          "after": torch.arange(3, dtype=torch.int64)}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    sio.save_file(ts, ours)
    _assert_bit_equal(st_load(ours), ts)
    st_save(ts, theirs)
    _assert_bit_equal(sio.load_file(theirs), ts)


def test_loader_glob_finds_nested_shards_and_upcasts_fp16(tmp_path):
    root = tmp_path / "unet"
    (root / "a" / "b").mkdir(parents=True)
    sio.save_file({"top": torch.ones(2, dtype=torch.float16)}, str(root / "x.safetensors"))
    sio.save_file({"mid": torch.ones(3)}, str(root / "a" / "y.safetensors"))
    sio.save_file({"deep": torch.full((2,), 0.1, dtype=torch.float16),
                   "ids": torch.arange(2)}, str(root / "a" / "b" / "z.safetensors"))
    state = loader._load_dir(str(root))
    assert set(state) == {"top", "mid", "deep", "ids"}
    assert state["deep"].dtype == torch.float32 and state["ids"].dtype == torch.int64
    assert torch.equal(state["deep"], torch.full((2,), 0.1, dtype=torch.float16).float())
    with pytest.raises(FileNotFoundError):
        loader._load_dir(str(tmp_path / "missing"))


def test_reader_rejects_a_span_that_does_not_fit_its_shape(tmp_path):
    path = str(tmp_path / "x.safetensors")
    sio.save_file({"a": torch.zeros(4)}, path)
    header, base = sio.read_header(path)
    raw = open(path, "rb").read()
    bad = raw[:8 + raw[8:base].index(b"[4]")] + b"[5]" + raw[8 + raw[8:base].index(b"[4]") + 3:]
    with open(path, "wb") as f:
        f.write(bad)
    with pytest.raises(ValueError, match="spans"):
        sio.load_file(path)
    assert np.array_equal(np.frombuffer(raw[base:], np.float32), np.zeros(4, np.float32))
