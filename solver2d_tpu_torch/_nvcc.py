"""Build the port's CUDA sources with nvcc into shared libraries.

Each source under `csrc/` compiles on its own (one nvcc process per source,
all started together) into `_build/`, which is git-ignored: a checkout holds
only sources, and the first use on a machine with a card builds them. A
library is named by a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded. There is no fallback: a failed
build raises with nvcc's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD = os.path.join(HERE, "_build")

# sm_90a: Hopper. No fast math and no FMA contraction: the kernels must
# round as their plain PyTorch twins do (see csrc/narrow.cu).
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# the nvcc report of each library built in this process (registers, spills)
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels build only where the CUDA toolkit is")


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD, f"lib{os.path.splitext(source)[0]}_{h}.so")


def build(sources: list[str]) -> dict[str, str]:
    """Build every source that has no current library, in parallel. Returns
    {source: library path}."""
    os.makedirs(BUILD, exist_ok=True)
    paths = {s: _lib_path(s) for s in sources}
    todo = [s for s in sources if not os.path.exists(paths[s])]
    if todo:
        nvcc = nvcc_path()
        procs = {}
        for s in todo:
            tmp = paths[s] + f".tmp{os.getpid()}"
            procs[s] = (tmp, subprocess.Popen(
                [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failed = []
        for s, (tmp, p) in procs.items():
            out, _ = p.communicate()
            build_log[s] = out
            if p.returncode != 0:
                failed.append(f"nvcc failed on {s} (rc {p.returncode}):\n{out}")
            else:
                os.replace(tmp, paths[s])
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths
