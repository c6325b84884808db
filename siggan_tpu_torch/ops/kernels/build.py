"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for ``sm_90a`` at first use into ``build/siggan_tpu_torch/`` beside
the package (a directory ``.gitignore`` lists). The library's file name
carries a hash of its source and of every ``.cuh`` header, so an edited
source is rebuilt and an unchanged one is loaded as it is. ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

Every C entry returns ``cudaGetLastError()`` after its launches; ``check``
turns a non-zero code into a ``RuntimeError`` with CUDA's message.

``load_host`` builds host C++ sources (the image decoders of
``data/native/``) into one library the same way with ``g++``, which needs no
CUDA toolkit, so it runs on the CPU as well as on the card's host; the
library's name carries a hash of every source it is built from.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "siggan_tpu_torch"
SOURCES = ("upsample", "generator_fwd", "pack_tail", "train_tail")
HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "host with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The shared library ``csrc/<name>.cu`` builds into, named by a hash of
    its sources."""
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _spawn(cmd: List[str], out: Path) -> Tuple[subprocess.Popen, Path, Path] | None:
    """Start ``cmd + ["-o", tmp]`` unless ``out`` exists; the library is
    written under a temporary name carrying the pid (concurrent test workers
    build the same library) and renamed when the build succeeds."""
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one source unless its library exists."""
    out = library_path(name)
    if out.exists():
        return None
    return _spawn([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), str(CSRC / f"{name}.cu")], out)


def _finish(name: str, started: Tuple[subprocess.Popen, Path, Path] | None) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(proc.args[0]).name} failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def host_library_path(sources: Sequence[Path]) -> Path:
    """The shared library the host sources build into, named after the first
    and by a hash of every source's name and bytes (an edit to any of them
    builds a new library)."""
    digest = hashlib.sha256(b"".join(s.name.encode() + b"\0" + s.read_bytes() for s in sources))
    return BUILD_DIR / f"lib{sources[0].stem}_{digest.hexdigest()[:12]}.so"


def load_host(sources: Sequence[Path], signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of the host C++ ``sources`` (one ``g++`` call
    compiles and links them all), built on first use; ``signatures`` maps
    each C entry to ``(argtypes, restype)``. Raises ``RuntimeError`` when
    ``g++`` is missing or fails."""
    srcs = list(sources)
    key = "|".join(map(str, srcs))
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: {srcs[0].name} (the port's host "
                                   "image decoder) is built with the host C++ compiler")
            out = host_library_path(srcs)
            _finish(srcs[0].name, _spawn([gxx, *HOST_FLAGS, *map(str, srcs)], out))
            lib = ctypes.CDLL(str(out))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[key] = lib
        return lib


def build_all(names: List[str] | None = None) -> Dict[str, str]:
    """Build every source at once (one ``nvcc`` each); returns the compiler
    logs by source name (empty for a library that was already built)."""
    names = list(names or SOURCES)
    with _lock:
        procs = {n: _start(n) for n in names}
        return {n: _finish(n, p) for n, p in procs.items()}


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C entry to its ``argtypes``; every entry
    returns an ``int`` (a ``cudaError_t``). Once loaded, a library is
    returned without taking the lock.
    """
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.siggan_error_string.argtypes = [ctypes.c_int]
            lib.siggan_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def call(lib: ctypes.CDLL, fn, args, device: torch.device, what: str) -> None:
    """``fn(*args)``, a C entry of ``lib``, with ``device`` current (the
    device guard is entered only when another device is), then ``check``."""
    if device.index == torch._C._cuda_getDevice():
        code = fn(*args)
    else:
        with torch.cuda.device(device):
            code = fn(*args)
    if code:
        check(lib, code, what)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.siggan_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``device``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def require(name: str, t: torch.Tensor, dtype: torch.dtype, device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor
    on ``device`` (of ``shape`` where given). A tensor that passes costs one
    combined test; the detailed checks below only name what failed."""
    if (t.dtype == dtype and t.device == device and t.data_ptr() % 16 == 0
            and t.is_contiguous() and (shape is None or t.shape == tuple(shape))):
        return
    if t.device != torch.device(device):
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


_counters: List["LaunchCounter"] = []


class LaunchCounter:
    """Counts one kernel wrapper's launches on the card. Every counter is
    registered, so that a CUDA graph's capture can take back the launches
    it recorded and each replay add them (``launch_counts``,
    ``add_launches``)."""

    def __init__(self) -> None:
        self.count = 0
        _counters.append(self)

    def add(self, n: int = 1) -> None:
        self.count += n

    def reset(self) -> None:
        self.count = 0


def launch_counts() -> List[int]:
    """The count of every registered ``LaunchCounter``, in registration order."""
    return [c.count for c in _counters]


def add_launches(counts: List[int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (as ``launch_counts`` orders them) to the
    counters: what ``times`` replays of a graph that recorded ``counts``
    launched."""
    for c, n in zip(_counters, counts):
        c.add(n * times)
