"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

At first use every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, under ``build/repro_torch/``
at the root of the checkout (listed in ``.gitignore``), named by a hash
of the sources so an edit rebuilds.  The library is then loaded with
``ctypes``.  Each C entry point returns the
``cudaError_t`` of its launches; ``check`` raises on anything but 0.  A
failed build or launch raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

P = ctypes.c_void_p
I = ctypes.c_int

# C signatures: name -> argtypes (every function returns int = cudaError_t)
SIGNATURES = {
    "dg_ring_push": [P] * 5 + [I] * 4 + [P],
    "dg_ring_gather": [P] * 3 + [I] * 4 + [P],
    "dg_nic_deliver": [P] * 20 + [I] * 7 + [P],
    "dg_switch_step": [P] * 28 + [I] * 14 + [P],
    "dg_rpc_pack": [P] * 9 + [I] * 3 + [P],
    "dg_hash_steer": [P] * 2 + [I] * 4 + [P] * 2,
    "dg_kv_probe": [P] * 6 + [I] * 4 + [P],
    "dg_decode_attention": [P] * 5 + [I] * 6 + [P],
}

_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin)"
                       " — the CUDA kernels cannot be built")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source hash is not built yet) and
    return the library's path.  ``build/repro_torch/nvcc.log`` keeps every
    command and its output (``-Xptxas -v``: registers, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    lib = BUILD_DIR / f"libdagger_{digest}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    objdir = BUILD_DIR / f"obj_{digest}.{os.getpid()}"
    objdir.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    compiles = []
    for src in sources():
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", str(CSRC), "-c",
               "-o", str(objdir / f"{src.stem}.o"), str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, proc in compiles:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out}")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(objdir / f"{src.stem}.o") for src in sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stdout}"
                          f"{res.stderr}")
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    shutil.rmtree(objdir, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {rc}")


def require(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous int32 tensor on
    ``device`` — what the C entry points take."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected int32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def require_float(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous float32 or bfloat16
    tensor on ``device``, all of one dtype — what the float kernels
    take."""
    dtypes = set()
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: {key} is {t.dtype}, expected float32 "
                             f"or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        dtypes.add(t.dtype)
    if len(dtypes) > 1:
        raise ValueError(f"{name}: inputs mix {sorted(map(str, dtypes))}")


def require_shapes(name: str, **pairs) -> None:
    """Raise unless each ``key=(tensor, shape)`` pair matches."""
    for key, (t, shape) in pairs.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
