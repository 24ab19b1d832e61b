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
    Returns (library path, the compiler's output: kept beside the library,
    so a cached build returns it too)."""
    out = BUILD_DIR / f"lib{src.stem}-{source_digest(src, flags)[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
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
        log.write_text(proc.stdout + proc.stderr)
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


_ENTRY = re.compile(r"entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_KERNEL = re.compile(r"_cu_[0-9a-f]{8}(\d+)")  # the kernel's name follows, that long
_TARGS = re.compile(r"L([bi])(\d+)E")
# template arguments an instance that predates them took by default
_DEFAULT_ARGS = {("b", "0"), ("i", "64")}


def instances(lines):
    """{(kernel, template arguments): (registers, stack, spill stores,
    spill loads)} of ptxas_lines: an entry's own frame is the first frame
    line after it (its out-of-line callees' follow)."""
    out, cur, framed = {}, None, False
    for ln in lines:
        m = _ENTRY.search(ln)
        if m:
            name = m.group(1)
            k = _KERNEL.search(name)
            kernel = name[k.end():k.end() + int(k.group(1))]
            cur = (kernel, tuple(_TARGS.findall(name[k.end():])))
            out[cur], framed = [0, 0, 0, 0], False
        elif cur is not None and not framed and _FRAME.search(ln):
            out[cur][1:] = [int(x) for x in _FRAME.search(ln).groups()]
            framed = True
        elif cur is not None and _REGS.search(ln):
            out[cur][0] = int(_REGS.search(ln).group(1))
    return {k: tuple(v) for k, v in out.items()}


def compare(new, old):
    """Lines comparing the instances of `new` with those of `old` (each an
    `instances` dict of one source): an old instance matches the new one
    whose template arguments extend its own by default values only."""
    lines, matched = [], set()
    for (kernel, args), vals in sorted(old.items()):
        match = [k for k in new if k[0] == kernel and k[1][:len(args)] == args
                 and set(k[1][len(args):]) <= _DEFAULT_ARGS]
        if len(match) != 1:
            lines.append(f"{kernel}{args}: no single match")
            continue
        matched.add(match[0])
        state = "same" if new[match[0]] == vals else f"was {vals}"
        lines.append(f"{kernel}{match[0][1]}: registers / stack / spill st, ld "
                     f"{new[match[0]]} {state}")
    lines += [f"{k[0]}{k[1]}: {new[k]} new" for k in sorted(set(new) - matched)]
    return lines


_LOADED = {}  # (name, nvcc flags) -> the loaded library of this package's csrc/


def load(name):
    """The built library for csrc/<name>.cu (building it if needed), loaded
    once a process: later calls with the same flags return it without
    hashing the sources again.  (walk_ab builds another tree's csrc/, or
    a variant's, and loads it in a process of that tree.)"""
    key = (name, NVCC_FLAGS)
    if key not in _LOADED:
        path, _ = build(name)
        _LOADED[key] = ctypes.CDLL(str(path))
    return _LOADED[key]


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
    ap.add_argument("--against", help="another csrc/ directory: compare every instance "
                                      "the two builds share")
    args = ap.parse_args(argv)
    srcs = [Path(args.src)] + ([Path(args.against)] if args.against else [])
    jobs = [(s, n) for s in srcs for n in sorted(p.stem for p in s.glob("*.cu"))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(lambda j: build(j[1], j[0])[1], jobs)))
    src = srcs[0]
    for name in sorted(p.stem for p in src.glob("*.cu")):
        print(f"== {src / name}.cu")
        lines = ptxas_lines(logs[(src, name)]) or ["(cached build: no ptxas output)"]
        if args.against and (srcs[1], name) in logs:
            lines = compare(instances(lines), instances(ptxas_lines(logs[(srcs[1], name)])))
        for ln in lines:
            print(ln)


if __name__ == "__main__":
    main()
