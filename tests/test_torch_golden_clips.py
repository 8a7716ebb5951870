"""The port on the regression clips: every frame's occupancy FEN and colored
FEN equal tests/golden_clip*.json.

Each clip of tests/test_regression_clip.py (clean, hard, shadow, lens,
video, castle, enpassant, promotion) runs through the port's
VisionPipeline on the CPU with the exact Hough backend (``auto`` there) on
its HWC camera frames as host arrays, with the clip's reference capture
and forced rescans, and the FENs come from the port's own rules copy. The
goldens were written by the JAX package's exact pipeline on the same host
frames (test_regression_clip.run_pipeline), which its ``step`` takes
planar: the matmul resample, the route the port takes here too. The video clip's frames
come out of a JPEG decode: where the decoded pixels differ from the
golden's (another OpenCV/libjpeg build), it skips as the JAX test does.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.models.pipeline import (
    VisionPipeline,
    occupancy_to_set,
    outputs_to_numpy,
)
from chessboard_vision_tpu_torch.rules import (
    classify_piece_colors,
    occupancy_to_colored_fen,
    occupancy_to_fen,
)

from fixtures import DEFAULT_CORNERS
from test_regression_clip import CLIPS

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)


def run_port(corners, clip):
    """(occupancy FENs, colored FENs) of a built clip through the port."""
    pipe = VisionPipeline(tgeo.BoardGeometry.from_calibration(corners), device="cpu")
    assert pipe.hough_backend == "exact"
    ref_frame, frames, s2c = clip
    state = pipe.capture_reference(pipe.init_state(), ref_frame)
    fens, colored = [], []
    for i, fr in enumerate(frames):
        assert isinstance(fr, np.ndarray) and fr.shape[-1] == 3  # host HWC: taken planar
        state, out = pipe.step(state, fr, squares_to_check=s2c(i))
        out = outputs_to_numpy(out)
        mask = np.zeros((8, 8), bool)
        for f, r in occupancy_to_set(out.occupancy):
            mask[f, r] = True
        fens.append(occupancy_to_fen(mask).split()[0])
        colors = classify_piece_colors(out.center_mean, out.occupancy, out.corner_mean)
        colored.append(occupancy_to_colored_fen(mask, colors).split()[0])
    return fens, colored


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_port_clip_matches_golden(name):
    clip_fn, golden_path = CLIPS[name]
    with open(golden_path) as fh:
        golden = json.load(fh)
    clip = clip_fn()
    if "decoded_sha256" in golden:  # the hash of test_regression_clip._decoded_hash
        h = hashlib.sha256(clip[0].tobytes())
        for f in clip[1]:
            h.update(f.tobytes())
        if h.hexdigest() != golden["decoded_sha256"]:
            pytest.skip(f"{name}: JPEG codec decodes differently from the golden environment")
    fens, colored = run_port(getattr(clip_fn, "corners", DEFAULT_CORNERS), clip)
    assert len(fens) == len(golden["fens"]) == len(golden["colored_fens"])
    for i, (got, want) in enumerate(zip(fens, golden["fens"])):
        assert got == want, f"{name} frame {i}: {got} != golden {want}"
    for i, (got, want) in enumerate(zip(colored, golden["colored_fens"])):
        assert got == want, f"{name} frame {i} colored: {got} != golden {want}"
