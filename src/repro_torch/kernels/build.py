"""Build of the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source becomes its own library with a plain C interface, compiled
by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3`` into
``build/repro_torch/`` at the root of the checkout (listed in
.gitignore) at first use, and loaded with ``ctypes`` by the module that
binds it.  The sources share device helpers through ``csrc/*.cuh``.  A
library's file name carries a hash of its source, those headers and the
flags, so an edited source or header is rebuilt.  :func:`build_all` starts one
``nvcc`` per source, all at once.  Nothing is built at import, and a
failed build raises.  :func:`sass_counts` reads a built library's
machine code (``cuobjdump -sass``) for the instructions it holds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: Build directory (listed in .gitignore): <checkout>/build/repro_torch.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Seconds each source's last nvcc build in this process took, by name.
build_seconds: dict[str, float] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """Path of ``nvcc`` (PATH, then the toolkit's default prefix)."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built from source at first use")


def library_path(source: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}-{digest[:16]}.so"


def build_all(names=None, verbose: bool = False) -> dict[str, Path]:
    """Compile every source in ``csrc/`` (or those named, by stem) whose
    library is not on disk, one ``nvcc`` process per source, all started
    together.  Returns name → library path; raises if any build fails."""
    srcs = [s for s in sources() if names is None or s.stem in names]
    if names is not None and len(srcs) != len(set(names)):
        raise FileNotFoundError(f"no CUDA source for {sorted(names)} in "
                                f"{CSRC}")
    paths = {s.stem: library_path(s) for s in srcs}
    todo = [s for s in srcs if not paths[s.stem].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    flags = (("-Xptxas", "-v") if verbose else ()) + NVCC_FLAGS
    procs = []
    t0 = time.perf_counter()
    for s in todo:
        tmp = paths[s.stem].with_suffix(f".{os.getpid()}.tmp")
        procs.append((s, tmp, subprocess.Popen(
            [nvcc, *flags, "-o", str(tmp), str(s)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for s, tmp, proc in procs:
        out, _ = proc.communicate()
        build_seconds[s.stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{s.name}: nvcc failed ({proc.returncode}):\n{out}")
            continue
        if verbose:
            print(f"nvcc {s.name}:\n{out}", flush=True)
        os.replace(tmp, paths[s.stem])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built if missing)."""
    return ctypes.CDLL(str(build_all([name])[name]))


def sass_counts(name: str, opcodes=("HMMA", "HGMMA")) -> dict:
    """Per device function of ``csrc/<name>.cu``'s library (by mangled
    name), how many instructions of each of ``opcodes`` its SASS holds,
    read with ``cuobjdump -sass`` from nvcc's toolkit (HMMA: ``mma.sync``
    on the tensor cores; HGMMA: ``wgmma``)."""
    lib = build_all([name])[name]
    tool = Path(find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            counts[cur] = dict.fromkeys(opcodes, 0)
        elif cur is not None:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
            if m and m.group(1) in counts[cur]:
                counts[cur][m.group(1)] += 1
    return counts
