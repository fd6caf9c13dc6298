"""Build the port's copy of the batched host env engine with g++.

The sources (env_engine.cpp/.h) are this package's own copy of the JAX
package's engine. The library goes to the package's ``_build/`` directory
(git ignores it), is named by a hash of the sources and flags, and is built
at first use. Built without ALE: the engine's ToyCatch backend serves the
Atari path.

    python -m deep_neuroevolution_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in ("env_engine.cpp", "env_engine.h"):
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libnevo_env-{h.hexdigest()[:16]}.so"


def ensure_built() -> Path:
    """Compile the engine unless the library for these sources exists. The
    output is written under a temporary name and renamed, so processes that
    build at the same time never load a half-written file."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(SRC_DIR / "env_engine.cpp"), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"engine build failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


if __name__ == "__main__":
    print(ensure_built())
