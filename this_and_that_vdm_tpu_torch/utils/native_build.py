"""Build a shared library from the port's sources at first use and load it
with ``ctypes``: the policy that ``ops/_native`` (the Hopper kernels, built
with ``nvcc``) and ``utils/host_native`` (the host codec and frame loader,
built with the host C++ compiler) share.

- The library is ``build/lib<stem>_<hash>.so`` at the repo root.  The hash
  covers the sources, the flags, and the compiler's resolved path and
  ``--version`` output, so an edited source or another compiler (a library
  built on another machine and copied with the tree) is never loaded.
- It is built under a temporary name and renamed into place while a file
  lock is held, because several test workers may build it at once.
- A missing compiler or a failed build raises with the compiler's output.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

BUILD = Path(__file__).resolve().parent.parent.parent / "build"


def find_compiler(candidates: Sequence[str], what: str) -> str:
    """The first of ``candidates`` (names on PATH or paths) that exists."""
    for cand in candidates:
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError(f"{' / '.join(map(repr, candidates))} not found: {what}")


class NativeLibrary:
    """One library: ``sources()`` lists its files (globbed from ``csrc`` by
    ``patterns``), ``compiler()`` resolves its compiler, and
    ``build(compiler, sources, out)`` writes the library to ``out``."""

    def __init__(self, stem: str, csrc: Path, patterns: Sequence[str], flags: Sequence[str],
                 compiler: Callable[[], str],
                 build: Callable[[str, list, Path], None],
                 signatures: dict, build_dir: Path = BUILD):
        self.stem, self.csrc, self.patterns, self.flags = stem, csrc, patterns, list(flags)
        self.compiler, self._build, self.signatures = compiler, build, signatures
        self.build_dir = build_dir
        self.lib = None
        self.path = None
        self._lock = threading.Lock()

    def sources(self) -> list:
        return [p for pat in self.patterns for p in sorted(self.csrc.glob(pat))]

    def digest(self, compiler: str) -> str:
        version = subprocess.run([compiler, "--version"], capture_output=True, text=True).stdout
        h = hashlib.sha256("\0".join([compiler, version] + self.flags).encode())
        for p in self.sources():
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return h.hexdigest()[:16]

    def library(self) -> ctypes.CDLL:
        """The loaded library, built on first call."""
        with self._lock:
            if self.lib is not None:
                return self.lib
            compiler = self.compiler()
            target = self.build_dir / f"lib{self.stem}_{self.digest(compiler)}.so"
            if not target.exists():
                self.build_dir.mkdir(parents=True, exist_ok=True)
                with open(self.build_dir / f"lib{self.stem}.lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not target.exists():
                        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
                        try:
                            self._build(compiler, self.sources(), tmp)
                            os.replace(tmp, target)  # a concurrent loader never sees half a file
                        finally:
                            if tmp.exists():
                                tmp.unlink()
            lib = ctypes.CDLL(str(target))
            for name, (restype, argtypes) in self.signatures.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            self.lib, self.path = lib, target
            return lib
