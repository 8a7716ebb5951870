"""Binding of ``score_matmul.cu`` and its plain PyTorch version.

``score_matmul`` picks by the tensors' device alone: CPU tensors take the
plain version (the CPU tests run it), CUDA tensors launch a kernel or
raise. Which kernel is decided by shape and alignment (``uses_tma``): the
TMA + wgmma kernel where TMA can describe the operands, else the staged
WMMA kernel. ``score_matmul.launches`` counts kernel launches, so a run can
show that its main path went through a kernel, and ``score_matmul.last_path``
names the kernel of the latest launch (``"tma"`` or ``"staged"``).
"""

from __future__ import annotations

import ctypes

import torch

from chessboard_vision_tpu_torch.kernels import load

_INT_MAX = 2**31 - 1
_lib = None


def score_matmul_reference(basis: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 x (N, K) bf16 -> (M, N) f32: f32 products, f32 sums."""
    return basis.float() @ pf.float().T


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("score_matmul")
        for fn in (lib.cbv_score_matmul_tma, lib.cbv_score_matmul_staged):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.cbv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cbv_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(basis: torch.Tensor, pf: torch.Tensor) -> None:
    for name, t in (("basis", basis), ("pf", pf)):
        if t.device.type != "cuda":
            raise ValueError(f"score_matmul: {name} is on {t.device}, expected CUDA")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"score_matmul: {name} is {t.dtype}, expected bfloat16")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"score_matmul: {name} must be a contiguous 2-D tensor")
    if basis.device != pf.device:
        raise ValueError(f"score_matmul: basis on {basis.device}, pf on {pf.device}")
    if basis.shape[1] != pf.shape[1]:
        raise ValueError(
            f"score_matmul: K mismatch, basis {tuple(basis.shape)} vs pf {tuple(pf.shape)}"
        )
    if max(basis.shape[0], pf.shape[0], basis.shape[1]) > _INT_MAX:
        raise ValueError("score_matmul: dimension exceeds int32")


def uses_tma(basis: torch.Tensor, pf: torch.Tensor) -> bool:
    """Whether TMA can describe both operands: 16-byte row strides (K % 8
    == 0 for bf16) and 16-byte aligned base addresses."""
    return (basis.shape[1] % 8 == 0 and basis.data_ptr() % 16 == 0
            and pf.data_ptr() % 16 == 0)


def score_matmul(basis: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """scores[m, n] = sum_k basis[m, k] * pf[n, k], bf16 in, f32 out."""
    if basis.device.type == "cpu" and pf.device.type == "cpu":
        return score_matmul_reference(basis, pf)
    _check(basis, pf)
    lib = _library()
    M, K = basis.shape
    N = pf.shape[0]
    path = "tma" if uses_tma(basis, pf) else "staged"
    launch = lib.cbv_score_matmul_tma if path == "tma" else lib.cbv_score_matmul_staged
    out = torch.empty((M, N), dtype=torch.float32, device=basis.device)
    with torch.cuda.device(basis.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(basis.data_ptr(), pf.data_ptr(), out.data_ptr(), M, N, K, stream)
    if rc != 0:
        msg = lib.cbv_cuda_error_string(rc).decode()
        raise RuntimeError(f"score_matmul ({path}) launch failed: {msg} ({rc})")
    score_matmul.launches += 1
    score_matmul.last_path = path
    return out


score_matmul.launches = 0
score_matmul.last_path = None
