"""Compiles one native source into a shared library named by a hash of its
inputs, for the port's two native builds: the CUDA kernels
(``anet_torch/kernels/build.py``, nvcc) and the networking core
(``anet_torch/net/native.py``, g++).

A library is ``<build_dir>/<stem>-<hash>.so``, where ``<hash>`` covers every
input file and the flags, so an edited input rebuilds and an unchanged one
loads at once. The compiler writes a ``.<pid>.tmp`` file that an atomic
rename publishes, so a concurrent loader sees all of the library or
nothing. Stdlib only: the host edge imports it without the kernels.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterable, Optional, Sequence


def hashed_path(build_dir: Path, stem: str, inputs: Iterable[Path], flags: Sequence[str]) -> Path:
    """Where the library built from ``inputs`` with ``flags`` lives."""
    digest = hashlib.sha256()
    for part in inputs:
        digest.update(Path(part).read_bytes())
    digest.update(" ".join(flags).encode())
    return Path(build_dir) / f"{stem}-{digest.hexdigest()[:12]}.so"


class Compile:
    """One compiler process building ``out`` from ``source``, started at
    once so that several can run together."""

    def __init__(self, compiler: str, flags: Sequence[str], source: Path, out: Path) -> None:
        out.parent.mkdir(parents=True, exist_ok=True)
        self.out = out
        self._tmp = out.with_suffix(f".{os.getpid()}.tmp")
        self._proc = subprocess.Popen(
            [compiler, *flags, "-o", str(self._tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )

    def finish(self, timeout: Optional[float] = None) -> Optional[str]:
        """Wait for the compiler and publish the library: None, or why it
        failed (exit code and the compiler's output)."""
        try:
            log, _ = self._proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            log, _ = self._proc.communicate()
            self._tmp.unlink(missing_ok=True)
            return f"timed out after {timeout} s\n{log.decode(errors='replace')}"
        if self._proc.returncode != 0:
            self._tmp.unlink(missing_ok=True)
            return f"exit {self._proc.returncode}\n{log.decode(errors='replace')}"
        os.replace(self._tmp, self.out)
        return None
