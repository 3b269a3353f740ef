"""Build the CUDA sources of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface, for ``sm_90a`` (Hopper), and loaded with
``ctypes``.  No source includes PyTorch's headers, so a build takes
seconds rather than the minutes a ``torch.utils.cpp_extension`` build
takes; the wrappers pass raw pointers (``tensor.data_ptr()``) and the
current stream (``torch.cuda.current_stream().cuda_stream``).

Libraries go to ``build/torch_kernels/`` at the root of the checkout (git
ignores ``build/``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source is rebuilt and an
unchanged one is loaded as it is.  ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("decode_step", "decode_chunk", "attention_block", "attn_tail", "window_attention",
           "causal_product", "ffn_block", "latency_decode", "decode_aug")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels of this package are built from source")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or
    None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: concurrent builders never see half a file


def build_all() -> Dict[str, str]:
    """Build every source in parallel (one nvcc each); returns
    {name: path of the library}."""
    with _LOCK:
        started = {n: _start(n) for n in SOURCES}
        for n, st in started.items():
            if st is not None:
                _finish(n, st)
    return {n: str(_target(n)) for n in SOURCES}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    library's last build, or '' if it was built by an earlier process."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            st = _start(name)
            if st is not None:
                _finish(name, st)
            lib = _LIBS.setdefault(name, ctypes.CDLL(str(_target(name))))
    return lib
