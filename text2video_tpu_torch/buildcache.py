"""Build a shared library once per checkout and set of inputs.

The port compiles its native code at first use: the CUDA kernels with
``nvcc`` (``kernels.py``) and the frontend's speech library with ``g++``
(``frontend/native.py``). Both go through :func:`build_library`: the
library lands in ``<root>/<hash of the inputs and flags>/``, so an
unchanged tree reuses it and a changed one builds anew; an ``fcntl`` lock
makes concurrent processes (test workers) build it once, and an atomic
rename publishes it whole. A failed build raises with the compiler's
output; nothing falls back.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, List, Sequence, Tuple


def build_library(
    root: Path,
    name: str,
    inputs: Sequence[Path],
    flags: Sequence[str],
    command: Callable[[Path], List[str]],
) -> Tuple[Path, str]:
    """(library path, compiler log) of ``name`` built by ``command(out)``
    (the compiler's argv writing ``out``), unless this exact build exists.
    The log is empty for a reused build."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(inputs):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = root / digest.hexdigest()[:16]
    lib = out_dir / name
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while this one waited
            return lib, ""
        tmp = out_dir / f"{name}.{os.getpid()}.tmp"
        argv = command(tmp)
        proc = subprocess.run(argv, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            errors = "\n".join(ln for ln in log.splitlines() if "error" in ln)
            raise RuntimeError(
                f"{os.path.basename(argv[0])} failed building {name} "
                f"(rc {proc.returncode}):\n{errors[:4000]}\n...\n"
                f"{log[-2000:]}")
        os.replace(tmp, lib)
        (out_dir / "build.log").write_text(log)
    return lib, log
