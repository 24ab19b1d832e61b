"""Build the package's native sources and load them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc, on first use, into
`build/torch_kernels/lib<name>-<hash>.so` at the repository root, a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  The hash covers the source, every header it includes
(`#include "..."`, followed through nested includes) and the flags, so an
edited source or header rebuilds and an unchanged one is reused.

`build_host` compiles a host-only C++ source with g++ the same way (the
SAH BVH builder shared with the JAX package, `csrc/bvh_builder.cpp` at the
repository root, with csrc/Makefile's flags).  A failed build raises with
the compiler's output.  Only this repository's sources are ever compiled.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
REPO_CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: the kernel's float sequence matches its plain
    # PyTorch version operation by operation
    "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
# csrc/Makefile's CXXFLAGS, so that the port's builder library is the one
# the JAX package builds (same leaf order, same winner on exact ties)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def source_digest(src, flags):
    """sha256 over the source, its quoted includes (recursively) and the
    compiler flags."""
    h = hashlib.sha256()
    seen = set()
    todo = [Path(src)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        todo.extend(path.parent / inc for inc in _INCLUDE.findall(text.decode()))
    h.update(" ".join(flags).encode())
    return h.hexdigest()


def _compile(cmd, src, flags):
    """Run `cmd + flags -o <lib> src` unless an up-to-date library exists.
    Returns (library path, the compiler's output or "" when cached)."""
    out = BUILD_DIR / f"lib{src.stem}-{source_digest(src, flags)[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cmd, *flags, "-o", tmp, str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd} failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def build(name, src_dir=SRC_DIR):
    """Compile <src_dir>/<name>.cu with nvcc unless an up-to-date library
    exists.  Returns (library path, nvcc's output or "" when cached)."""
    return _compile(nvcc_path(), Path(src_dir) / f"{name}.cu", NVCC_FLAGS)


def ptxas_lines(log):
    """ptxas's per-instance lines of an nvcc log: the entry function, its
    registers and its stack and spill."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def load(name):
    """The built library for csrc/<name>.cu (building it if needed)."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))


def load_host(name):
    """The g++ build of the repository's csrc/<name>.cpp (building it if
    needed)."""
    path, _ = _compile("g++", REPO_CSRC / f"{name}.cpp", CXX_FLAGS)
    return ctypes.CDLL(str(path))


def main(argv=None):
    import argparse
    from concurrent.futures import ThreadPoolExecutor

    ap = argparse.ArgumentParser(description="build the kernel sources, print ptxas's lines")
    ap.add_argument("--src", default=str(SRC_DIR))
    src = Path(ap.parse_args(argv).src)
    names = sorted(p.stem for p in src.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(lambda n: build(n, src)[1], names)))
    for name in names:
        print(f"== {src / name}.cu")
        for ln in ptxas_lines(logs[name]) or ["(cached build: no ptxas output)"]:
            print(ln)


if __name__ == "__main__":
    main()
