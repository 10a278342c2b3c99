"""Build and load the CUDA kernels: nvcc into a shared library, ctypes.

``csrc/*.cu`` compile with ``nvcc -gencode arch=compute_90a,code=sm_90a``
(one nvcc per source, all started together) and link into one shared
library with a plain C interface, at the first CUDA call.  The library
lands in ``build/torch_kernels/`` at the repository root, named by a hash
of the sources, so an edited source rebuilds.  A failed build raises with
nvcc's output.  Nothing here runs at import: the CPU tests import every
module of the package.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# C signatures: "p" pointer (contiguous CUDA tensor), "r" pointer (CUDA tensor
# whose rows are contiguous, the row stride passed beside it), "h" pointer to
# host bytes, "u32", "u64", "i64"; every function takes the CUDA stream last and returns a CUDA
# error code (of the launch, or of setting a kernel attribute) as int.
SIGNATURES = {
    "cls_ntt_pass": ("p", "p", "p", "p", *("i64",) * 13, "u32", "u32", "u32"),
    "cls_ntt_rows": ("p", "p", "p", *("i64",) * 6, "u32"),
    "cls_ntt_levels": ("p", "p", "p", "p", "p", *("i64",) * 4),
    "cls_ntt_newton": ("p", "p", "p", "p", *("i64",) * 5, "u32", "u32"),
    "cls_gated_rowsum_p": ("p", "p", "i64", "i64", "p", "p", "p"),
    "cls_gated_rowsums_p": ("p", "r", *("i64",) * 4, "p", "p", "p"),
    "cls_matvec_mod_p": ("p", "p", "i64", "i64", "i64", "p", "p", "p"),
    "cls_matvec_at_s_mod_p": ("p", "p", "i64", "i64", "i64", "p", "p", "p"),
    "cls_powers_mod_p": ("p", "p", "u32", "i64", "p"),
    "cls_carry_fold": ("p", "u32", "i64", "i64", "i64", "p"),
    "cls_carry_fold_b_rows": ("p", "p", "p", "p", "i64", "p"),
    "cls_carry_fold_mac": ("p", "p", "i64", "i64", "p"),
    "cls_carry_fold_smudge": ("p", "i64", "i64", "i64", "p", "i64", "i64", "u32", "u32"),
    "cls_keystream_blocks": ("p", "h", "u32", "u32", "u64", "i64", "p"),
    "cls_keystream_fold_p": ("p", "h", "u32", "u32", "u64", "i64", "p"),
    "cls_eval_mac_planes": (
        "p", "h", "u32", "u32", "u64", "p", "i64", "i64", "i64", "p"),
    "cls_eval_mac_lanes": (
        "p", "h", "u32", "u32", "u64", "p", "i64", "i64", "i64", "h", "i64", "p"),
    "cls_encrypt_b_fused": (
        "p", "h", "u32", "u32", "u64", "p", "i64", "i64", "p", "p"),
    "cls_keystream_blocks_v1": ("p", "u32", "u32", "u64", "i64", "p"),
    "cls_decrypt": ("p", "i64", "p", "i64", "p", "p", "p"),
    "cls_verify": (*("p",) * 6, "i64", "p", "p", "i64", "p", "p", "p", "i64", *("p",) * 5),
}

_lib = None
BUILD_INFO: dict = {}  # seconds, library path and nvcc's output of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> pathlib.Path:
    """Compile the kernels if the library for these sources is missing."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode() + f.read_bytes())
    lib = BUILD_DIR / f"libcls_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("path", str(lib))
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{f.stem}.{tag}.o" for f in srcs]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f, o in zip(srcs, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    try:
        for f, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on {f.name}:\n{log}")
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        tmp.replace(lib)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(lib), log="".join(logs))
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        import ctypes

        types = {"p": ctypes.c_void_p, "r": ctypes.c_void_p, "h": ctypes.c_char_p, "u32": ctypes.c_uint32,
                 "u64": ctypes.c_uint64, "i64": ctypes.c_int64}
        lib = ctypes.CDLL(str(build()))
        for name, sig in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [types[s] for s in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_tensor(t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless t is a contiguous tensor of this dtype/shape/device."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != torch.device(device) or not t.is_contiguous():
        raise ValueError(f"expected a contiguous tensor on {device}, got {t.device}")


def bits32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def words64(bits: torch.Tensor) -> torch.Tensor:
    """int32 kernel output read as uint32 -> int64 words in [0, 2^32)."""
    return bits.to(torch.int64) & 0xFFFFFFFF


def launch(name: str, *args) -> None:
    """Call one kernel launcher on the current stream; raise on a launch error."""
    sig = SIGNATURES[name]
    assert len(args) == len(sig), (name, len(args))
    cargs = []
    for kind, a in zip(sig, args):
        if kind == "p":
            if not (isinstance(a, torch.Tensor) and a.is_cuda and a.is_contiguous()):
                raise ValueError(f"{name}: pointer arguments must be contiguous CUDA tensors")
            cargs.append(a.data_ptr())
        elif kind == "r":
            if not (isinstance(a, torch.Tensor) and a.is_cuda and a.stride(-1) == 1):
                raise ValueError(f"{name}: row arguments must be CUDA tensors with contiguous rows")
            cargs.append(a.data_ptr())
        elif kind == "h":
            if not isinstance(a, bytes):
                raise ValueError(f"{name}: host arguments must be bytes")
            cargs.append(a)
        else:
            cargs.append(int(a))
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(), name)(*cargs, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
