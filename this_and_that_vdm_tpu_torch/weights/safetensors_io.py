"""Read and write the safetensors format with the standard library and torch
(counterpart of ``load_safetensors`` in ``weights/convert.py`` and of the
writers in ``weights/export.py``; no ``safetensors`` package needed).

A file is an 8-byte little-endian header length, a JSON header, then the
raw little-endian bytes of every tensor.  The header maps each name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets relative to
the end of the header) and may carry a ``__metadata__`` map of strings.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Optional

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8}
NAMES = {v: k for k, v in DTYPES.items()}


def read_header(path: str):
    """(header dict, byte offset of the data) of a safetensors file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors in the file's dtype.

    Each tensor's bytes are copied out of the file map into a buffer of its
    own before ``torch.frombuffer``: offsets in the file are not aligned to
    the dtype's width in general."""
    header, base = read_header(path)
    out = {}
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        view = memoryview(mm)
        try:
            for name, info in header.items():
                if name == "__metadata__":
                    continue
                if info["dtype"] not in DTYPES:
                    raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
                dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
                begin, end = info["data_offsets"]
                numel = 1
                for s in shape:
                    numel *= s
                if end - begin != numel * dtype.itemsize:
                    raise ValueError(f"{path}: {name} spans {end - begin} bytes for {shape} "
                                     f"{info['dtype']}")
                if numel == 0:
                    out[name] = torch.empty(shape, dtype=dtype)
                    continue
                buf = bytearray(view[base + begin:base + end])
                out[name] = torch.frombuffer(buf, dtype=dtype).reshape(shape)
        finally:
            view.release()
    return out


def read_metadata(path: str) -> Dict[str, str]:
    return read_header(path)[0].get("__metadata__", {})


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> str:
    """Write ``tensors`` (any device; copied to the host) to ``path``, in
    name order, the header padded with spaces to a multiple of 8 bytes."""
    header, chunks, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name in sorted(tensors):
        t = tensors[name].detach()
        if t.dtype not in NAMES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        t = t.to("cpu").contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        chunks.append(t)
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in chunks:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    return path
