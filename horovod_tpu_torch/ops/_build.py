"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` into ``build/horovod_tpu_torch/lib<name>_<hash>.so``
(the hash covers the source, every ``csrc`` header it includes and the
flags, so an edited source or header builds anew) and loaded with
``ctypes``. Several sources build in parallel, one
``nvcc`` each, all started together. A failed build raises; nothing
falls back to a CPU path.

The wrappers of both kernel modules share the routing rule
(:func:`on_card`) and the operand checks (:func:`check_operands`) below.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
SOURCES = ("decode_attention", "flash_attention")
# --split-compile=0: optimise and assemble the kernels of one source on
# every core (the decode source's 48 instantiations build in half the
# time on the card's host).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of horovod_tpu_torch build from source at first use")
    return path


_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def inputs(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header it includes with quotes, the
    headers' own includes too, in the order first met."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found or not path.exists():
            continue
        found.append(path)
        todo += [(path.parent / inc).resolve()
                 for inc in _QUOTED_INCLUDE.findall(path.read_text())]
    return found


def target(name: str) -> Path:
    """Content-addressed path of the shared library built from ``name``:
    the hash covers every file of :func:`inputs` and ``NVCC_FLAGS``."""
    digest = hashlib.sha256()
    for path in inputs(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def log_path(name: str) -> Path:
    """The compiler's output of the last build of ``name`` (ptxas
    register and spill report)."""
    return BUILD_DIR / f"{name}.log"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` each, all started together; return name -> library path."""
    names = list(names)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs: List[tuple] = []
        for name in names:
            so = target(name)
            if so.exists():
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for name, so, tmp, proc in jobs:
            output, _ = proc.communicate()
            log_path(name).write_text(output)
            if proc.returncode != 0:
                errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n"
                              f"{output}")
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("building the CUDA kernels failed:\n"
                               + "\n".join(errors))
    return {name: target(name) for name in names}


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` set from ``signatures`` (function -> ctypes types; each
    C entry point returns an int error code, which
    :func:`check` turns into an exception)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.hvd_error_string.argtypes = [ctypes.c_int]
            lib.hvd_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def on_card(name: str, *tensors: torch.Tensor) -> bool:
    """The wrappers' routing rule: True when every tensor lies on one CUDA
    device (the kernel runs), False when all lie on the CPU (the plain
    version runs); anything else raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) == 1:
        (device,) = devices
        if device.type == "cuda":
            return True
    raise ValueError(
        f"{name} needs all its tensors on one device, got "
        + ", ".join(sorted(str(d) for d in devices)))


KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head_dim and H/Hkv the decode kernels are instantiated for
#: (``csrc/decode_attention.cu``): every width and group of the repo's
#: configurations.
DECODE_WIDTHS = (16, 32, 64, 128)
DECODE_GROUPS = (1, 2, 4, 8, 16)
#: The head_dim the flash kernels (``csrc/flash_attention.cu``) are
#: instantiated for; they take any H/Hkv. ``ops/attention.py`` zero-pads
#: a narrower head_dim up to one of these widths.
FLASH_WIDTHS = (64, 128)


def check_operands(name: str, group: int, widths: Sequence[int],
                   groups: Optional[Sequence[int]],
                   **tensors: torch.Tensor) -> None:
    """Raise unless the attention kernels take these operands: float32 or
    bfloat16 in one dtype, head_dim (the last dim) in ``widths``, H/Hkv
    in ``groups`` (None: any), contiguous and 16-byte aligned."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or not dtypes <= set(KERNEL_DTYPES):
        raise TypeError(
            f"{name}: the CUDA kernel takes float32 or bfloat16 with all "
            "operands in one dtype, got "
            + ", ".join(f"{k} {t.dtype}" for k, t in tensors.items()))
    d = next(iter(tensors.values())).shape[-1]
    if d not in widths:
        raise ValueError(
            f"{name}: the CUDA kernel takes head_dim in {tuple(widths)}, "
            f"got {d}")
    if groups is not None and group not in groups:
        raise ValueError(
            f"{name}: the CUDA kernel takes H/Hkv in {tuple(groups)}, "
            f"got {group}")
    for label, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {label} must be contiguous and 16-byte aligned "
                "for the kernel's vector loads")


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as the int a C entry point
    takes."""
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, fn: str, code: int) -> None:
    """Raise if a C entry point reported an error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.hvd_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{fn} failed: CUDA error {code} ({msg})")
