"""Helpers shared by every kernel wrapper of the port.

* **Device resolution.** The port's entry points run on the card unless the
  caller asks for the CPU: ``None`` resolves to ``"cuda"``, and a CUDA
  device on a machine without one raises instead of carrying on quietly.
* **Plain version vs kernel.** A wrapper runs its plain PyTorch version only
  for tensors that lie on the CPU.  For CUDA tensors it launches the
  hand-written kernel or raises: there is no fallback.
* **No padding.** The Pallas kernels needed operands padded to the TPU's
  tile multiples; the CUDA kernels compute their own offsets and mask the
  ragged edge themselves, so the wrappers pass tensors as they are.
* **Kernel loader.** Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for
  Hopper (``sm_90a``) into a shared library with a plain C interface, at
  first use, into ``build/kernels/`` at the repository root, and bound with
  ``ctypes``.  The library's file name carries a hash of its source and of
  the ``csrc`` headers it includes, so an edited source or header is
  rebuilt.  Every C entry point returns
  ``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.
* **Chunking.** The plain versions that gather padded leaf slabs work in
  power-of-two chunks of about :data:`CHUNK_BYTES` (:func:`pow2_chunk`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Union

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

Device = Union[str, torch.device, None]

#: gathered working set per chunk (bytes of f32 rows) of the slab passes
CHUNK_BYTES = 256 << 20


def resolve_device(device: Device) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card "
                "unless the caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (→ the plain version runs)."""
    return all(t.device.type == "cpu" for t in tensors)


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def pow2_chunk(per_item_bytes: int, cap: int,
               budget: int = CHUNK_BYTES) -> int:
    """Power-of-two chunk keeping ``chunk · per_item_bytes`` near
    ``budget`` (capped at ``cap``)."""
    chunk = max(budget // max(per_item_bytes, 1), 1)
    return min(1 << (int(chunk).bit_length() - 1), cap)


# ---------------------------------------------------------------------------
# nvcc + ctypes loader
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes (``#include
    "…"``, followed through the headers), each once, in include order."""
    seen = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return seen


def _lib_path(name: str) -> pathlib.Path:
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in _sources(name))
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named ``csrc`` sources, one ``nvcc`` each, all started
    together; returns each build's compiler log (``-Xptxas -v``), empty for
    a library that was already built."""
    logs: Dict[str, str] = {}
    nvcc = _nvcc()
    with _LOCK:
        running = []
        for name in names:
            out = _lib_path(name)
            if out.exists():
                logs[name] = ""
                continue
            if not os.path.exists(nvcc):
                raise RuntimeError(f"nvcc not found at {nvcc}: the CUDA "
                                   "kernels build only where CUDA is")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((name, proc, tmp, out))
        for name, proc, tmp, out in running:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)
            logs[name] = log
    return logs


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and bind ``csrc/<name>.cu``; ``signatures`` maps
    each C entry point to its ``argtypes``.  Every entry returns ``int``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """The kernels take contiguous tensors of one dtype on one card."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
