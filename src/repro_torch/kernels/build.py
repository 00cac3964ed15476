"""Build and load the port's CUDA kernels: ``nvcc`` → one shared library →
``ctypes``.

The sources under ``repro_torch/csrc/`` are compiled at first use — each
``.cu`` by its own ``nvcc`` process, all started together, then linked into
one ``.so`` with a plain C interface.  Nothing includes PyTorch's headers,
which keeps the build to seconds.  The library's directory is named by a
hash of the sources and flags, so a stale build is never loaded; it lives
under the repository's git-ignored ``build/`` directory.

Every source is compiled with ``-fmad=false`` (see ``csrc/common.cuh``): the
kernels are bitwise equal to their plain PyTorch versions only without FMA
contraction.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes; each returns cudaGetLastError() as int
SIGNATURES = {
    "geo_score_launch": [_P] * 5 + [_L, _L, _I, _P],
    "sweep_score_launch": [_P] * 7 + [_I] * 3 + [_L, _I, _I, _P],
    "sweep_score_pruned_launch": [_P] * 11 + [_I] * 5 + [_L, _I, _I, _I, _P],
    "text_probe_launch": [_P, _I] + [_P] * 7 + [_F, _P, _P] + [_I] * 5 + [_P],
    "bitmap_and_popcount_launch": [_P] * 5 + [_I, _L, _P],
}

_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _sources() -> list[Path]:
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = Path(tmp, src.stem + ".o")
            log = open(Path(tmp, src.stem + ".log"), "w")
            procs.append((src, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT,
            )))
            objs.append(obj)
        failed = []
        for src, log, proc in procs:
            proc.wait()
            log.close()
            if proc.returncode:
                failed.append(f"{src.name}:\n{Path(log.name).read_text()}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        lib = Path(tmp, "libgeokernels.so")
        subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(lib), *map(str, objs)],
            check=True, capture_output=True,
        )
        staged = Path(tmp, "out")
        staged.mkdir()
        shutil.move(str(lib), staged / lib.name)
        with open(staged / "ptxas.log", "w") as f:
            for src, log, _ in procs:
                f.write(Path(log.name).read_text())
        try:
            os.replace(staged, out_dir)
        except OSError:  # another process finished the same build first
            if not (out_dir / "libgeokernels.so").is_file():
                raise


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call; argtypes set."""
    with _build_lock:
        out_dir = build_dir()
        if not (out_dir / "libgeokernels.so").is_file():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            _compile(out_dir)
        lib = ctypes.CDLL(str(out_dir / "libgeokernels.so"))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def raw_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it but without
    building a ``Stream`` object, which costs several microseconds of host
    time per launch (the accessor PyTorch's own generated kernels call)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check_tensor(name: str, t, dtypes, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` with one of
    ``dtypes`` and ``shape`` (``None`` entries match any size)."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
