"""Binding of ``resample.cu``: the bilinear resample of planned samples, every
board and channel of a call in one launch.

``resample_u8`` takes (n, C, Hf, Wf) u8 frames on a card (planar, or the
planar view of HWC frames: any strides whose rows are Wf pixels apart) and
a ``MatmulResamplePlan`` with a board axis of n (``stack_plans``; a plan of
one board without the axis for n = 1), and returns the (n, C, 64, Qr, Qc)
u8 samples, bit-equal to the plain ops of ops/matmul_resample.py on the
same card (``resample.cu`` says why). It reads the plan's compact fields
(``src_index`` i32, ``fx``, ``fy``, ``tap_flags``: 13 bytes a sample) and
allocates only its output; it never synchronises, so a CUDA graph may
capture it. Checks raise before any launch; there is no fallback: a CPU
tensor is refused here and takes the plain ops in ops/matmul_resample.py.
``resample_u8.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from chessboard_vision_tpu_torch.kernels import load

_lib = None
MAX_BOARDS = 65535  # boards a launch: the grid's y extent


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a built ``resample.cu`` library."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cbv_resample.argtypes = [P, L, L, L, I, I, I, P, P, P, P, I, P, P]
    lib.cbv_resample.restype = I
    lib.cbv_cuda_error_string.argtypes = [I]
    lib.cbv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(load("resample"))
    return _lib


def _check(frames: torch.Tensor, plan, dims) -> tuple:
    """Raise unless the frames and the plan fit each other and the kernel;
    (boards, samples a board)."""
    if frames.device.type != "cuda":
        raise ValueError(f"resample_u8: frames on {frames.device}: the kernel runs on a card "
                         "(the plain ops of ops/matmul_resample.py run on the CPU)")
    if frames.dtype != torch.uint8 or frames.dim() != 4:
        raise ValueError(f"resample_u8: expected (n, C, Hf, Wf) uint8 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    n, c, h, w = frames.shape
    if (h, w) != (dims.src_h, dims.src_w):
        raise ValueError(f"resample_u8: frames of {h}x{w}, the plan samples "
                         f"{dims.src_h}x{dims.src_w}")
    if frames.stride(-2) != w * frames.stride(-1):
        raise ValueError(f"resample_u8: frame rows {frames.stride(-2)} bytes apart, not "
                         f"{w} pixels of {frames.stride(-1)}")
    if not 1 <= n <= MAX_BOARDS or c < 1:
        raise ValueError(f"resample_u8: {n} boards of {c} channels, the kernel takes 1 to "
                         f"{MAX_BOARDS} boards of at least one")
    samples = 64 * dims.q_rows * dims.q_cols
    for name, dtype in (("src_index", torch.int32), ("fx", torch.float32),
                        ("fy", torch.float32), ("tap_flags", torch.uint8)):
        field = getattr(plan, name)
        if field.dtype != dtype or field.device != frames.device or not field.is_contiguous():
            raise ValueError(f"resample_u8: the plan's {name} must be contiguous {dtype} on "
                             f"{frames.device}, got {field.dtype} on {field.device}")
        if field.numel() != n * samples or field.shape[-3:] != (64, dims.q_rows, dims.q_cols):
            raise ValueError(f"resample_u8: the plan's {name} {tuple(field.shape)} is not "
                             f"{n} board(s) of (64, {dims.q_rows}, {dims.q_cols})")
    if math.prod(plan.src_index.shape[:-3]) != n:
        raise ValueError(f"resample_u8: a plan of {tuple(plan.src_index.shape[:-3])} boards "
                         f"for {n} frames")
    return n, samples


def resample_u8(frames: torch.Tensor, plan, dims) -> torch.Tensor:
    """(n, C, Hf, Wf) u8 frames on a card, each board with its own plan (a
    board axis of n) -> (n, C, 64, Qr, Qc) u8 samples, rounded half to even
    and clipped, in one launch."""
    n, samples = _check(frames, plan, dims)
    c = frames.shape[1]
    lib = _library()
    out = torch.empty((n, c, 64, dims.q_rows, dims.q_cols), dtype=torch.uint8,
                      device=frames.device)
    sb, sc, _, sp = frames.stride()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cbv_resample(frames.data_ptr(), sb, sc, sp, n, c, dims.src_w,
                              plan.src_index.data_ptr(), plan.fx.data_ptr(), plan.fy.data_ptr(),
                              plan.tap_flags.data_ptr(), samples, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"resample launch failed: {lib.cbv_cuda_error_string(rc).decode()} "
                           f"({rc})")
    resample_u8.launches += 1
    return out


resample_u8.launches = 0
