"""Color-space conversions with OpenCV's u8 arithmetic.

Counterpart of chessboard_vision_tpu.ops.color. Images are (..., H, W, 3)
u8 in BGR order (HWC) or (..., 3, H, W) (planar), as in the JAX package.

- gray (Y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15) and BGR -> HSV are
  integer fixed point: bit-exact against cv2 and the JAX package.
- BGR -> Lab is fixed point with two tables (sRGB inverse gamma, cube
  root), looked up by index: a 256- or 2041-entry gather costs one kernel
  on a GPU, where the JAX package evaluates polynomials because TPU XLA
  serializes gathers. The gamma table is cv2's exact one, which the JAX
  polynomial reproduces on all 256 inputs; the cube-root table is the JAX
  package's division-free ``fast_cbrt``, evaluated once per input on the
  host with the jitted function's rounding, so Lab is bit-equal to it.
- HSV -> BGR and Lab -> BGR run in f32 as the JAX package writes them;
  XLA:CPU may contract their multiply-adds, so they agree with the jitted
  JAX functions within one level (the tests state where). convertScaleAbs
  rounds its multiply-add once, as cv2 does, and is bit-equal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from chessboard_vision_tpu_torch.ops.xla_rounding import fma

_R2Y, _G2Y, _B2Y, _GRAY_SHIFT = 9798, 19235, 3735, 15


def _f32(v: float) -> float:
    """``v`` rounded to f32: the constant an f32 JAX expression uses."""
    return float(np.float32(v))


def _gray(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    b, g, r = (c.to(torch.int32) for c in (b, g, r))
    y = (r * _R2Y + g * _G2Y + b * _B2Y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.to(torch.uint8)


def bgr2gray(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR u8 -> (..., H, W) gray u8."""
    return _gray(bgr[..., 0], bgr[..., 1], bgr[..., 2])


def planar_bgr2gray(planar: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) planar BGR u8 -> (..., H, W) gray u8."""
    return _gray(planar[..., 0, :, :], planar[..., 1, :, :], planar[..., 2, :, :])


# ---------------------------------------------------------------------------
# BGR <-> HSV (u8, H in [0, 180))
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12


def _round_div(num: int, den: torch.Tensor) -> torch.Tensor:
    """round(num / den) for den > 0, 0 where den == 0: the integer form of
    cv2's sdiv/hdiv tables (no .5 ties exist for these numerators)."""
    d = den.clamp(min=1)
    return torch.where(den > 0, torch.div(2 * num + d, 2 * d, rounding_mode="floor"), 0)


def bgr2hsv(bgr: torch.Tensor) -> torch.Tensor:
    """Exact cv2.COLOR_BGR2HSV for (..., 3) u8 images."""
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin
    s = (diff * _round_div(255 << _HSV_SHIFT, v) + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    vr = v == r
    vg = ~vr & (v == g)
    h0 = torch.where(vr, g - b, torch.where(vg, b - r + 2 * diff, r - g + 4 * diff))
    hdiv = _round_div((180 << _HSV_SHIFT) // 6, diff)
    h = (h0 * hdiv + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


# Sector -> (b, g, r) source index into the value table [v, p, q, t].
_HSV_SECTOR = np.array(
    [[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]], np.int64
)


@functools.lru_cache(maxsize=None)
def _on(name: str, device: torch.device) -> torch.Tensor:
    """A numpy table of this module as a tensor on ``device``, made once."""
    return torch.as_tensor(_TABLES[name], device=device)


def hsv2bgr(hsv: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_HSV2BGR for (..., 3) u8 (f32 path)."""
    f = hsv.float()
    h = f[..., 0] * _f32(6.0 / 180.0)
    s = f[..., 1] * _f32(1.0 / 255.0)
    v = f[..., 2] * _f32(1.0 / 255.0)
    sector = torch.floor(h)
    frac = h - sector
    sector = torch.remainder(sector.to(torch.int64), 6)
    tab = torch.stack((v, v * (1 - s), v * (1 - s * frac), v * (1 - s * (1 - frac))), dim=-1)
    src = _on("hsv_sector", hsv.device)[sector]  # (..., 3) index into tab
    bgr = torch.gather(tab, -1, src)
    return torch.round(bgr * 255.0).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# BGR -> Lab (u8): OpenCV's fixed point with the sRGB gamma
# ---------------------------------------------------------------------------

_GAMMA_SHIFT = 3
_LAB_SHIFT = 12
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT


def _srgb_inv_gamma(u):
    return np.where(u <= 0.04045, u / 12.92, ((u + 0.055) / 1.055) ** 2.4)


_i = np.arange(256) / 255.0
_GTAB = np.round(_srgb_inv_gamma(_i) * 255 * (1 << _GAMMA_SHIFT)).astype(np.int32)
del _i

_CBRT_N = 3 * 255 * (1 << _GAMMA_SHIFT) + 1

_XYZ_M = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
_WHITE = np.array([0.950456, 1.0, 1.088754])
_LAB_C = np.round((_XYZ_M / _WHITE[:, None]) * (1 << _LAB_SHIFT)).astype(np.int64)
for _r in range(3):
    _LAB_C[_r, 2] = (1 << _LAB_SHIFT) - _LAB_C[_r, 0] - _LAB_C[_r, 1]
del _r
_LSCALE = (116 * 255 + 50) // 100
_LSHIFT = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def fast_cbrt(t: torch.Tensor, contract: bool = False) -> torch.Tensor:
    """f32 cube root for non-negative inputs, division-free: a bit-trick
    seed and 4 Newton steps on the inverse cube root, then t*y^2 (the JAX
    package's ``fast_cbrt``, same operation order). ``contract`` rounds
    each step's ``4/3 - (t/3)*y^3`` once, as XLA:CPU's fused multiply-add
    does in the jitted JAX function."""
    t = t.float().clamp(min=1e-20)
    # The seed's constant as a Python int (int32 arithmetic): a tensor made
    # of it on a card would be a blocking copy, which waits for the card.
    y = (0x548C2B4B - torch.div(t.view(torch.int32), 3, rounding_mode="trunc")).view(
        torch.float32)
    third, four_thirds = _f32(1.0 / 3.0), _f32(4.0 / 3.0)
    tt = t * third
    for _ in range(4):
        y3 = y * y * y
        step = fma(-tt, y3, torch.full_like(t, four_thirds)) if contract else four_thirds - tt * y3
        y = y * step
    return t * (y * y)


def _cbrt_table() -> np.ndarray:
    """_cbrt_fixed's value for every index of the Lab cube-root domain,
    computed once on the host as the jitted JAX function computes it (equal
    on all 6121 indices; the JAX package's test exhausts them too)."""
    idx = torch.arange(_CBRT_N, dtype=torch.int32)
    t = idx.float() * _f32(1.0 / (255 * (1 << _GAMMA_SHIFT)))
    f = torch.where(
        t < 0.008856, t * _f32(7.787) + _f32(0.13793103448275862), fast_cbrt(t, contract=True)
    )
    return torch.round(f * (1 << _LAB_SHIFT2)).to(torch.int32).numpy()


_TABLES = {
    "hsv_sector": _HSV_SECTOR,
    "gamma": _GTAB,
    "cbrt": _cbrt_table(),
}


def _gamma_fixed(x_u8: torch.Tensor) -> torch.Tensor:
    """cv2's sRGB inverse-gamma fixed-point table, looked up: equal to the
    JAX package's polynomial on all 256 inputs."""
    return _on("gamma", x_u8.device)[x_u8.long()]


def _cbrt_fixed(idx: torch.Tensor) -> torch.Tensor:
    """The Lab cube-root fixed point of ``idx``, looked up in the table of
    ``fast_cbrt`` values (the JAX package computes it per pixel)."""
    return _on("cbrt", idx.device)[idx.long()]


def _bgr2lab_channels(b_u8, g_u8, r_u8):
    """Per-channel BGR u8 -> (L, a, b) i32 before the clip."""
    B, G, R = _gamma_fixed(b_u8), _gamma_fixed(g_u8), _gamma_fixed(r_u8)
    C = _LAB_C
    fX = _cbrt_fixed(_descale(R * int(C[0, 0]) + G * int(C[0, 1]) + B * int(C[0, 2]), _LAB_SHIFT))
    fY = _cbrt_fixed(_descale(R * int(C[1, 0]) + G * int(C[1, 1]) + B * int(C[1, 2]), _LAB_SHIFT))
    fZ = _cbrt_fixed(_descale(R * int(C[2, 0]) + G * int(C[2, 1]) + B * int(C[2, 2]), _LAB_SHIFT))
    L = _descale(_LSCALE * fY + _LSHIFT, _LAB_SHIFT2)
    a = _descale(500 * (fX - fY) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = _descale(200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return L, a, bb


def bgr2lab(bgr: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_BGR2LAB for (..., 3) u8 (fixed point)."""
    L, a, bb = _bgr2lab_channels(bgr[..., 0], bgr[..., 1], bgr[..., 2])
    return torch.stack([L, a, bb], dim=-1).clamp(0, 255).to(torch.uint8)


def planar_bgr2lab(planar: torch.Tensor) -> torch.Tensor:
    """bgr2lab on (..., 3, H, W) planar u8, bit-equal to the HWC form."""
    L, a, bb = _bgr2lab_channels(
        planar[..., 0, :, :], planar[..., 1, :, :], planar[..., 2, :, :]
    )
    return torch.stack([L, a, bb], dim=-3).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Lab -> BGR (u8), f32
# ---------------------------------------------------------------------------

_XYZ_INV = np.linalg.inv(_XYZ_M)


def _srgb_gamma(u: torch.Tensor) -> torch.Tensor:
    """u^(1/2.4) as sqrt(sqrt(cbrt(u^5))), linear below 0.0031308."""
    u5 = u * u
    u5 = u5 * u5 * u
    p = torch.sqrt(torch.sqrt(fast_cbrt(u5)))
    return torch.where(u <= 0.0031308, u * _f32(12.92), 1.055 * p - 0.055)


def _lab2bgr_channels(l_u8, a_u8, b_u8):
    """Per-channel Lab u8 -> (B, G, R) f32 in [0, 1] before quantization."""
    L = l_u8.float() * _f32(100.0 / 255.0)
    a = a_u8.float() - 128.0
    b = b_u8.float() - 128.0
    fY = (L + 16.0) / 116.0
    fX = fY + a / 500.0
    fZ = fY - b / 200.0

    def finv(f):
        return torch.where(f > 6.0 / 29.0, f * f * f, (f - 16.0 / 116.0) / 7.787)

    X = finv(fX) * _f32(_WHITE[0])
    Y = finv(fY) * _f32(_WHITE[1])
    Z = finv(fZ) * _f32(_WHITE[2])
    M = [[_f32(v) for v in row] for row in _XYZ_INV]
    R = M[0][0] * X + M[0][1] * Y + M[0][2] * Z
    G = M[1][0] * X + M[1][1] * Y + M[1][2] * Z
    B = M[2][0] * X + M[2][1] * Y + M[2][2] * Z
    return B, G, R


def _quantize(rgb: torch.Tensor) -> torch.Tensor:
    rgb = _srgb_gamma(rgb.clamp(0.0, 1.0))
    return torch.round(rgb * 255.0).clamp(0, 255).to(torch.uint8)


def lab2bgr(lab: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_LAB2BGR for (..., 3) u8 (f32 path)."""
    return _quantize(torch.stack(_lab2bgr_channels(lab[..., 0], lab[..., 1], lab[..., 2]), -1))


def planar_lab2bgr(planar: torch.Tensor) -> torch.Tensor:
    """lab2bgr on (..., 3, H, W) planar u8, bit-equal to the HWC form."""
    return _quantize(torch.stack(_lab2bgr_channels(
        planar[..., 0, :, :], planar[..., 1, :, :], planar[..., 2, :, :]
    ), -3))


def convert_scale_abs(x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """cv2.convertScaleAbs: saturate(round(|x*alpha + beta|)), half to even.
    ``x*alpha + beta`` is rounded to f32 once, as cv2's fused multiply-add
    (and XLA's) rounds it: a u8 times an f32 is exact in float64."""
    v = (x.double() * _f32(alpha) + _f32(beta)).float().abs()
    return torch.round(v).clamp(0, 255).to(torch.uint8)
