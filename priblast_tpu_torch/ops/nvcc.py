"""The CUDA kernels' common ground: `build` compiles one CUDA source of the
port with nvcc into a shared library under build/kernels/ at the
repository root, once per version of the source and flags (the file name
carries a hash of both; a failed build raises); `check_tensor` is the
check a kernel's wrapper makes on each tensor before it passes a pointer."""

from __future__ import annotations

import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def build(src: Path, flags) -> Path:
    """nvcc `flags` on `src` -> build/kernels/lib<stem>_<hash>.so; the
    write is atomic, so concurrent builds are safe."""
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = Path(td) / out.name
        r = subprocess.run([nvcc, *flags, "-o", str(tmp), str(src)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
        tmp.replace(out)
    return out


def check_tensor(t: torch.Tensor, name: str, shape, dtype, device,
                 contiguous: bool = True) -> None:
    """Raise ValueError unless `t` is a tensor on `device` of `shape` (1-D
    where no shape is given), of `dtype` where given, contiguous where
    asked."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if shape is None and t.dim() != 1:
        raise ValueError(f"{name} must be 1-D")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
