"""Build, load and launch the port's CUDA kernels.

The sources in ``sradsgan_tpu_torch/csrc`` are compiled at first use by
``nvcc``, one process per source, all started together, and linked into one
shared library with a plain C interface, which is loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The library lands in
``sradsgan_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused.

Each exported C function takes device pointers, sizes, an element-type code
and the CUDA stream, launches one kernel on that stream and returns the
``cudaError_t`` of the launch; :func:`launch` raises on anything but 0.  A
build failure raises too: nothing here falls back to the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libsradsgan_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Element-type codes, as in csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each exported launch function (all return cudaError_t).
_SIGNATURES = {
    "sg_avg_max_pool": [_P, _P, _P, _I, _I, _I, _P],
    "sg_spatial_gate": [_P] * 4 + [_I] * 6 + [_P],
    "sg_spatial_gate_plan": [_I] * 5 + [_P],
    "sg_spatial_gate_bwd": [_P] * 7 + [_I] * 10 + [_P],
    "sg_spatial_gate_bwd_plan": [_I] * 5 + [_P],
    "sg_position_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sg_position_attention_bwd": [_P] * 10 + [_I] * 5 + [_P],
    "sg_rab_tail": [_P] * 14 + [_I] * 10 + [_P],
    "sg_rab_tail_plan": [_I] * 6 + [_P],
}
# What each planner writes, in order.
_STRIP_PLAN = ("bands", "stats_strips", "stream_strips", "slices",
               "shared_bytes", "partial_rows")
PLAN_FIELDS = {"sg_spatial_gate": ("rows", "strips", "shared_bytes"),
               "sg_spatial_gate_bwd": _STRIP_PLAN, "sg_rab_tail": _STRIP_PLAN}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA kernels need nvcc, and no CUDA toolkit "
                           "was found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; return their joined output, or raise
    with it if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log, failed = [], False
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        failed |= proc.returncode != 0
    text = "\n".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{text}")
    return text


def build(out_dir: Path) -> Path:
    """Compile every source into ``out_dir/LIB_NAME``: one ``nvcc`` per
    source, all at once, then one link.  The compiler's output (including
    ptxas register and shared-memory use) goes to build.log."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    tag = os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]
    try:
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(sources(), objs)])
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        log += _run_all([[_nvcc(), "-shared", "-o", str(tmp),
                          *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built on first call in this checkout."""
    out_dir = BUILD_DIR / source_hash()
    path = out_dir / LIB_NAME
    if not path.exists():
        build(out_dir)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sg_error_string.argtypes = [ctypes.c_int]
    lib.sg_error_string.restype = ctypes.c_char_p
    return lib


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd will have to differentiate an op of these
    inputs, so the op goes through its ``autograd.Function``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_like(op: str, t: torch.Tensor, ref: torch.Tensor,
               name: str) -> None:
    """``t`` must match ``ref`` in shape, dtype and device, contiguous."""
    if (t.shape != ref.shape or t.dtype != ref.dtype
            or t.device != ref.device or not t.is_contiguous()):
        raise ValueError(
            f"{op}: {name} must be a contiguous {ref.dtype} tensor of shape "
            f"{tuple(ref.shape)} on {ref.device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def check_input(op: str, t: torch.Tensor, ndim: int) -> None:
    """What every kernel takes: a non-empty contiguous f32/bf16 CUDA tensor
    whose element count fits the kernels' 32-bit size arguments."""
    if t.device.type != "cuda":
        raise ValueError(f"{op}: the kernel needs a CUDA tensor, got one on "
                         f"{t.device}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{op}: the kernel takes float32 or bfloat16, got "
                        f"{t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{op}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: the kernel needs a contiguous tensor")
    if not 0 < t.numel() < 2 ** 31:
        raise ValueError(f"{op}: {t.numel()} elements is outside the "
                         "kernel's range")


@functools.lru_cache(maxsize=256)
def plan(name: str, device: torch.device, dims: tuple,
         dtype: torch.dtype) -> dict:
    """The launches a row-strip kernel (``name``: "sg_spatial_gate" or
    "sg_spatial_gate_bwd" with dims (B, C, H, W), or "sg_rab_tail" with
    (B, C, hidden, H, W)) takes at this shape, as the C side chooses them
    from the card's SM count and a block's shared memory (the keys are
    ``PLAN_FIELDS[name]``).  The gate forward: rows a strip, strips an
    image, shared bytes a block.  The other two: bands an image of the
    stencils' launch, strips an image of the statistics launch and of the
    outputs' launch, channel slices, the most shared bytes a block asks
    for, and the rows of partial sums the caller provides room for.  Asked
    once a shape and kept.  Raises where the kernel takes no such shape."""
    fields = PLAN_FIELDS[name]
    out = (ctypes.c_int * len(fields))()
    with torch.cuda.device(device):
        err = getattr(library(), name + "_plan")(*dims, DTYPE_CODES[dtype],
                                                 out)
    if err != 0:
        raise ValueError(f"{name}: no launch fits a {dtype} tensor of dims "
                         f"{dims} (a row of the image has to fit a block's "
                         "shared memory)")
    return dict(zip(fields, out))


def plan_args(p: dict) -> tuple:
    """What a row-strip kernel's launch function takes of its plan."""
    return p["bands"], p["stats_strips"], p["stream_strips"], p["slices"]


def launch(name: str, device: torch.device, *args) -> None:
    """Call one exported launch function on ``device``'s current stream and
    raise if the launch was refused."""
    if device.index != torch.cuda.current_device():
        # the kernel runs on the thread's current device; switching costs
        # host time, so only a tensor on another device pays for it
        with torch.cuda.device(device):
            return launch(name, device, *args)
    lib = library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.sg_error_string(err).decode()})")
