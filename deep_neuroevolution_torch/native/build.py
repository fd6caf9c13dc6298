"""Build the port's copy of the batched host env engine with g++.

The sources (env_engine.cpp/.h, ale_stub/ale_interface.hpp and
engine_stress_test.cpp) are this package's own copy of the JAX package's.
Every output goes to the package's ``_build/`` directory (git ignores it),
named by a hash of its sources and flags, is written under a temporary
name and renamed, and is built only when missing:

* ``build(with_ale=None)`` / ``ensure_built()``: the engine library. With
  an ALE install prefix (headers under ``include/ale``, ``lib/libale.so``;
  ``ensure_built`` reads it from ``NEVO_ALE_PREFIX``) the ALE backend is
  compiled in and ``AtariEnv`` runs real games; without one, the engine's
  ToyCatch backend serves the Atari path;
* ``build_ale_stub()``: the engine with the ALE backend compiled against
  the header-only stub of ALE's API (``ale_stub/``; not ALE), a library of
  its own, which checks that the ALE path builds and steps;
* ``build_stress(tsan=True)``: the engine's concurrency stress binary,
  under ThreadSanitizer unless ``tsan=False``.

    python -m deep_neuroevolution_torch.native.build [--with-ale PREFIX]
    python -m deep_neuroevolution_torch.native.build --stress [--no-tsan]

The second builds the stress binary and runs it (it prints ``stress ok``),
exiting with its code.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional, Sequence

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")
ENGINE = ("env_engine.cpp", "env_engine.h")


def _ale_flags(prefix: str) -> tuple:
    return ("-DHAVE_ALE", f"-I{prefix}/include/ale", f"-L{prefix}/lib", "-lale", f"-Wl,-rpath,{prefix}/lib")


def _output(stem: str, suffix: str, flags: Sequence[str], sources: Sequence[str]) -> Path:
    """``_build/<stem>-<hash of flags and sources><suffix>``."""
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{suffix}"


def _compile(out: Path, flags: Sequence[str], sources: Sequence[str]) -> Path:
    """g++ ``flags`` ``sources`` → ``out`` unless it exists. The output is
    written under a temporary name and renamed, so processes that build at
    the same time never load a half-written file."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *flags, *(str(SRC_DIR / s) for s in sources if s.endswith(".cpp")), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"build failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _engine_flags(with_ale: Optional[str]) -> tuple:
    # ALE's flags before the source, as the JAX package's build orders them
    return (*CXX_FLAGS[:1], *(_ale_flags(with_ale) if with_ale else ()), *CXX_FLAGS[1:])


def lib_path(with_ale: Optional[str] = None) -> Path:
    """The engine library for these sources (and ALE prefix)."""
    return _output("libnevo_env", ".so", _engine_flags(with_ale), ENGINE)


def build(with_ale: Optional[str] = None) -> Path:
    """The engine library, with the ALE backend when ``with_ale`` names an
    ALE install prefix."""
    flags = _engine_flags(with_ale)
    return _compile(_output("libnevo_env", ".so", flags, ENGINE), flags, ENGINE)


def ensure_built() -> Path:
    """The engine that ``HostBatchEnv`` loads by default: with ALE when
    ``NEVO_ALE_PREFIX`` names an install (the JAX package's
    ``ensure_built``), else ToyCatch only."""
    return build(with_ale=os.environ.get("NEVO_ALE_PREFIX") or None)


def build_ale_stub() -> Path:
    """The engine with its ALE backend compiled against the API stub in
    ``ale_stub/`` (a scripted counter game with 3 lives, not ALE): a library
    of its own, for ``HostBatchEnv("ale", ..., lib_path=...)``."""
    flags = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall", "-DHAVE_ALE", f"-I{SRC_DIR / 'ale_stub'}")
    sources = (*ENGINE, "ale_stub/ale_interface.hpp")
    return _compile(_output("libnevo_env_alestub", ".so", flags, sources), flags, sources)


def build_stress(tsan: bool = True) -> Path:
    """The concurrency stress binary (engine_stress_test.cpp and the
    engine), with ``-fsanitize=thread`` when ``tsan``."""
    flags = ("-O1", "-g", "-std=c++17", "-pthread", "-Wall", *(("-fsanitize=thread",) if tsan else ()))
    sources = (*ENGINE, "engine_stress_test.cpp")
    return _compile(_output("stress_tsan" if tsan else "stress", "", flags, sources), flags, sources)


def main(argv: Sequence[str]) -> int:
    if "--stress" in argv:
        binary = build_stress(tsan="--no-tsan" not in argv)
        print(binary, flush=True)
        return subprocess.run([str(binary)]).returncode
    ale = argv[argv.index("--with-ale") + 1] if "--with-ale" in argv else None
    print(build(with_ale=ale))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
