"""Binding of ``score_matmul.cu`` and its plain PyTorch version.

``score_matmul`` picks by the tensors' device alone: CPU tensors take the
plain version (the CPU tests run it), CUDA tensors launch the kernel or
raise. The kernel reads both operands through TMA, so K must be a multiple
of 8 and both operands 16-byte aligned (``check_tma``): the card's Hough
plans pad K to that (``ConvHoughPlan.build``'s ``k_align``). Every CTA
walks all of K, and its tile is a pure function of the shape
(``tile_shape``: 64-row warpgroups and 64-column sub-tiles), which changes
no score's bits. ``score_matmul.launches`` counts kernel launches, so a run
can show that its main path went through the kernel,
``score_matmul.last_path`` names the latest launch's path (``"tma"``, the
one kernel) and ``score_matmul.last_shape`` gives its (M, N, K).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from chessboard_vision_tpu_torch.kernels import load

_INT_MAX = 2**31 - 1
ROWS, COLS = 64, 64  # a CTA's rows; a sub-tile's columns
MAX_SUBTILES = 4
_lib = None


def score_matmul_reference(basis: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 x (N, K) bf16 -> (M, N) f32: f32 products, f32 sums."""
    return basis.float() @ pf.float().T


def tile_shape(m: int, n: int, sms: int) -> tuple:
    """(64-row warpgroups, 64-column sub-tiles) of a CTA: 64 x 64 for
    N <= 64, else the largest of 128 x 256, 128 x 128, 64 x 256, 64 x 128
    that still gives three quarters of the SMs a CTA, else the smallest.
    A function of (M, N) and the card; the shape changes no score's bits."""
    subtiles = -(-n // COLS)
    if subtiles == 1:
        return 1, 1
    for wg, nt in ((2, 4), (2, 2), (1, 4), (1, 2)):
        tiles = -(-subtiles // nt)
        nt = -(-subtiles // tiles)
        if 4 * -(-m // (ROWS * wg)) * tiles >= 3 * sms:
            break
    return wg, nt


def check_tma(basis: torch.Tensor, pf: torch.Tensor) -> None:
    """Raises unless TMA can describe both operands: 16-byte row strides (K
    % 8 == 0 for bf16) and 16-byte aligned base addresses."""
    if basis.shape[1] % 8:
        raise ValueError(
            f"score_matmul: K = {basis.shape[1]} is not a multiple of 8, which TMA needs; "
            "build the plan with k_align=8"
        )
    for name, t in (("basis", basis), ("pf", pf)):
        if t.data_ptr() % 16:
            raise ValueError(f"score_matmul: {name} is not 16-byte aligned, which TMA needs")


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("score_matmul")
        lib.cbv_score_matmul.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.cbv_score_matmul.restype = ctypes.c_int
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
    check_tma(basis, pf)


def score_matmul(basis: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """scores[m, n] = sum_k basis[m, k] * pf[n, k], bf16 in, f32 out."""
    if basis.device.type == "cpu" and pf.device.type == "cpu":
        return score_matmul_reference(basis, pf)
    _check(basis, pf)
    lib = _library()
    M, K = basis.shape
    N = pf.shape[0]
    wg, nt = tile_shape(M, N, _sms(basis.device))
    out = torch.empty((M, N), dtype=torch.float32, device=basis.device)
    with torch.cuda.device(basis.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cbv_score_matmul(basis.data_ptr(), pf.data_ptr(), out.data_ptr(), M, N, K,
                                  nt, wg, stream)
    if rc != 0:
        msg = lib.cbv_cuda_error_string(rc).decode()
        raise RuntimeError(f"score_matmul (tma) launch failed: {msg} ({rc})")
    score_matmul.launches += 1
    score_matmul.last_path = "tma"
    score_matmul.last_shape = (M, N, K)
    return out


score_matmul.launches = 0
score_matmul.last_path = None
score_matmul.last_shape = None
