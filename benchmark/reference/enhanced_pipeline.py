"""The plain reference of the enhanced vision step, for N boards on one device.

``ReferencePipeline`` (pipeline.py) with the squares taken from enhanced
color boards, as chessboard_vision_tpu_torch/parallel/multistream.py
(``_squares``, per-rig plans, ``with_enhancer``) and models/pipeline.py
(``_enhanced_squares``, ``blur``) take them at commit b8e261e: each board
warped in color with its own rig's tile plan (the three planes resampled,
then the 64 overlapping tiles assembled), enhanced on its own (enhance.py:
the five stages of hericmr/chessboard-vision ``frame_enhancer.py:161-181``,
``process_pipeline``), grayscaled, its padded squares gathered at the square
maps' integer coordinates, then the 5x5 blur. The plain stages take the
tick's boards together, each board on its own: a board a call would launch
each of the plain bilateral's ~450 ops once a board, and the replay would
take longer than the run's timed window several times over.
The rest of the step is the frozen plain one. No kernel runs: the bilateral
and CLAHE are their plain versions, which the port's kernels match bit for
bit on the card.

Departures from ``frame_enhancer.py:161-181``, all the port's own:

- upstream enhances the whole camera frame; here, as in the port and the
  JAX package, the warped color board (980 px at 1080p) is enhanced, and
  the squares are cut from it;
- stage 0, the HSV color profile, is the identity: a checkout holds no
  ``color_profile.json`` (upstream without the file does the same);
- BGR -> Lab is OpenCV's u8 fixed point; Lab -> BGR is the JAX package's
  f32 formula (color.py), where cv2's u8 conversion has fixed-point
  tables of its own: the two can differ by a level;
- the bilateral sums its taps in another f32 order than OpenCV's, and
  CLAHE's apply mixes the LUTs with fused multiply-adds (the TPU kernels'
  rounding): each can differ from cv2 by a level on a few pixels;
- min-max normalize takes one minimum and maximum over a board's three
  planes, as cv2.normalize does on a 3-channel image.

``resample_dtype`` below float32 is the benchmark's lower-precision control:
the color warp's taps and lerps in that dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import matmul_resample as mr
from .color import planar_bgr2gray
from .enhance import enhance
from .filters import gaussian_blur_valid
from .geometry import BoardGeometry
from .pipeline import ReferencePipeline

IMPLEMENTS = {"hough_backend": "conv", "use_enhancer": True}


class EnhancedReferencePipeline(ReferencePipeline):
    """ReferencePipeline whose squares come from enhanced color boards."""

    def __init__(self, geometries: Sequence[BoardGeometry], device,
                 resample_dtype: torch.dtype = torch.float32):
        super().__init__(geometries, device, resample_dtype)
        base = geometries[0]
        B = base.board_size
        _, _, starts, tile = base.board_tile_query_coords()
        self.tile_index = torch.as_tensor(mr.board_tile_index(starts, tile, B),
                                          device=self.device)
        self.tile_plans = [mr.build_plan(*g.board_tile_query_coords()[:2], g.src_h, g.src_w,
                                         device=self.device) for g in geometries]
        s = base.squares
        self.ext_index = torch.as_tensor(s.iy.astype("int64") * B + s.ix, device=self.device)

    def board(self, planar: torch.Tensor, i: int) -> torch.Tensor:
        """Board ``i``'s (3, B, B) u8 color warp of its (3, Hf, Wf) frame."""
        plan, dims = self.tile_plans[i]
        tiles = mr.resample_gray_u8(planar, plan, dims, self.resample_dtype)  # (3, 64, T, T)
        return mr.assemble_board_from_tiles(tiles, self.tile_index)

    def squares(self, frames: torch.Tensor) -> torch.Tensor:
        """(n, Hf, Wf, 3) HWC u8 frames -> (n*64, H, W) blurred gray squares
        of the enhanced boards."""
        planar = frames.to(self.device).movedim(-1, -3)
        boards = torch.stack([self.board(planar[i], i) for i in range(self.n)])
        gray = planar_bgr2gray(enhance(boards))  # (n, B, B)
        padded = gray.reshape(self.n, -1)[:, self.ext_index]  # (n, 64, H+2p, W+2p)
        return gaussian_blur_valid(padded.reshape((-1,) + tuple(padded.shape[-2:])), 5,
                                   pad=self.pad)


def build(config: dict, geometries: Sequence[BoardGeometry], device,
          resample_dtype: torch.dtype) -> EnhancedReferencePipeline:
    return EnhancedReferencePipeline(geometries, device, resample_dtype=resample_dtype)
