"""The UI tools through the port vs the JAX package's, under one scripted HighGUI.

Each tool's ``main`` runs in both packages on the same seeded 1280x720
frames (tests/fixtures.py) with the same script: cv2's camera and HighGUI
(``VideoCapture``, ``namedWindow``, the trackbars, ``setMouseCallback``,
``imshow``, ``waitKey``, ``destroyAllWindows``) are replaced on the cv2
module by ``ScriptedHighGui``, which moves trackbars, presses keys and
clicks on given frames and records every shown image; drawing is cv2's
own. The port runs on the CPU (``--device cpu``), where both packages'
``auto`` Hough backend is the exact one. Every shown image and every saved
JSON must be bit-equal. The two tools that show the enhancer's color
stages (calibrate_colors, enhance_demo) hold the enhanced images to the
CPU parity limits of tests/test_torch_enhance.py (ROADMAP Queue C 7:
HSV -> BGR within one level on at most 1e-4 of the pixels, the full
enhancement within 9 levels on at most 1e-3); their other images are
bit-equal.

The calibrator (``CalibrationModule.run``): four clicks, ENTER, 'g' (the
smart grid), 's'; the saved calibration.json equals the JAX one, and a
port session calibrated from a camera with no saved calibration
(``on_calibration_requested(cap)``) reaches it and gets the JAX config.
"""

import functools
import json
import os

import cv2
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chessboard_vision_tpu.models.enhancer import ImageEnhancerTPU
from chessboard_vision_tpu.models.pipeline import VisionPipeline as JaxPipeline
from chessboard_vision_tpu.ops import enhance as jenh
from chessboard_vision_tpu.tools import calibrate_colors as jcc
from chessboard_vision_tpu.tools import calibrate_piece_detector as jcpd
from chessboard_vision_tpu.tools import calibrate_sensitivity as jcs
from chessboard_vision_tpu.tools import calibration_module as jcm
from chessboard_vision_tpu.tools import enhance_demo as jed
from chessboard_vision_tpu_torch.session.game_session import GameSession
from chessboard_vision_tpu_torch.tools import calibrate_colors as tcc
from chessboard_vision_tpu_torch.tools import calibrate_piece_detector as tcpd
from chessboard_vision_tpu_torch.tools import calibrate_sensitivity as tcs
from chessboard_vision_tpu_torch.tools import calibration_module as tcm
from chessboard_vision_tpu_torch.tools import enhance_demo as ted

from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

CONFIG = {
    "corners": DEFAULT_CORNERS.tolist(),
    "player_color": "white",
    "orientation_flipped": False,
    "grid_lines_x": None,
    "grid_lines_y": None,
}
ONE_LEVEL_FRACTION = 1e-4  # tests/test_torch_enhance.py
ENHANCE_MAX_DIFF, ENHANCE_FRACTION = 9, 1e-3  # tests/test_torch_enhance.py
DARK_PIECE = (40, 36, 30)


@pytest.fixture(autouse=True)
def writable_jax_images(monkeypatch):
    """The JAX tools draw on ``np.asarray`` of a jax Array, which this jax
    returns read-only, so cv2 refuses to draw (ROADMAP Queue C 18). Here
    the two JAX methods whose images the tools draw on return writable
    copies of the same pixels; the port returns writable arrays itself."""
    for cls, name in ((JaxPipeline, "warp_board"), (ImageEnhancerTPU, "apply_color_profile")):
        method = getattr(cls, name)
        monkeypatch.setattr(cls, name,
                            lambda self, frame, _m=method: np.array(_m(self, frame), copy=True))


class ScriptedHighGui:
    """cv2's camera and HighGUI, scripted by frame. Frame n (1-based) is
    the n-th frame read: trackbar moves and clicks of frame n land just
    before it is returned, and ``waitKey`` after it returns the key of
    frame n. Every ``imshow`` is recorded as (window, copy of the image)."""

    NAMES = ("VideoCapture", "namedWindow", "createTrackbar", "getTrackbarPos",
             "setMouseCallback", "imshow", "waitKey", "destroyAllWindows")

    def __init__(self, frames, keys=None, bars=None, clicks=None):
        self.frames = frames
        self.keys = keys or {}
        self.bars = bars or {}
        self.clicks = clicks or {}
        self.n = 0
        self.positions, self.callbacks, self.shown = {}, {}, []
        self.destroyed = 0

    def install(self, monkeypatch):
        for name in self.NAMES:
            monkeypatch.setattr(cv2, name, getattr(self, name))
        return self

    # the camera
    def VideoCapture(self, index):
        return self

    def isOpened(self):
        return True

    def set(self, prop, value):
        return True

    def release(self):
        pass

    def read(self):
        if self.n >= len(self.frames):
            return False, None
        self.n += 1
        self.positions.update(self.bars.get(self.n, {}))
        for x, y in self.clicks.get(self.n, ()):
            for callback in self.callbacks.values():
                callback(cv2.EVENT_LBUTTONDOWN, x, y, 0, None)
        return True, self.frames[self.n - 1].copy()

    # HighGUI
    def namedWindow(self, name, *args):
        pass

    def createTrackbar(self, name, window, value, vmax, callback):
        self.positions[name] = value

    def getTrackbarPos(self, name, window):
        return self.positions[name]

    def setMouseCallback(self, window, callback, *args):
        self.callbacks[window] = callback

    def imshow(self, window, img):
        self.shown.append((window, np.array(img, copy=True)))

    def waitKey(self, ms=0):
        return self.keys.get(self.n, -1)

    def destroyAllWindows(self):
        self.destroyed += 1


def _files(names):
    out = {}
    for name in names:
        if os.path.exists(name):
            with open(name) as fh:
                out[name] = fh.read()
    return out


def _drive(monkeypatch, tmp_path, pkg, script, call, files=(), saved=None):
    """Run ``call()`` in a working directory of its own holding
    calibration.json (and ``saved``'s files) under ``script``; returns
    (its result, the script, the files of ``files`` it left)."""
    where = tmp_path / pkg
    where.mkdir()
    monkeypatch.chdir(where)
    for name, data in {"calibration.json": CONFIG, **(saved or {})}.items():
        with open(name, "w") as fh:
            json.dump(data, fh)
    gui = script().install(monkeypatch)
    result = call()
    return result, gui, _files(files)


def _frames(n, seed, lifted_from=None, **kw):
    """n start-position frames; from frame ``lifted_from`` on, the e2 pawn
    is lifted."""
    rng = np.random.default_rng(seed)
    occ = initial_occupancy()
    lift = occ.copy()
    lift[4, 1] = False
    return [make_board_frame(lift if lifted_from and i + 1 >= lifted_from else occ, rng, **kw)
            for i in range(n)]


def _assert_same_shows(jgui, tgui, near=()):
    """The same windows in the same order; each image bit-equal, or for a
    window in ``near``, within its (max diff, fraction) limit."""
    assert [w for w, _ in tgui.shown] == [w for w, _ in jgui.shown]
    for i, ((window, want), (_, got)) in enumerate(zip(jgui.shown, tgui.shown)):
        assert got.shape == want.shape and got.dtype == want.dtype, (i, window)
        if window in near:
            max_diff, fraction = near[window]
            d = np.abs(got.astype(int) - want.astype(int))
            assert d.max() <= max_diff and (d > 0).mean() <= fraction, (
                i, window, int(d.max()), int((d > 0).sum()))
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"image {i} ({window})")


def _counting(monkeypatch, module):
    """Count the VisionPipeline builds of a port tool module."""
    built = []
    cls = module.VisionPipeline

    def build(*args, **kw):
        built.append(kw.get("piece_settings") or kw.get("change_settings"))
        return cls(*args, **kw)

    monkeypatch.setattr(module, "VisionPipeline", build)
    return built


# Frame 1 builds the pipeline at the saved (default) settings; every slider
# moves on frame 2 (the radius extremes and new thresholds); the rebuild
# waits until they have been still for 15 frames: frame 17.
PIECE_BARS = {2: {"Min radius %": 0, "Max radius %": 80, "Param1": 80, "Param2": 20,
                  "Center diff": 30}}
PIECE_KEYS = {17: ord("s"), 18: ord("e"), 19: ord("q")}


def test_piece_detector_tool_matches_jax(monkeypatch, tmp_path):
    """calibrate_piece_detector.main: the same 19 shown images (occupied
    squares circled in their method's color, with confidences and the
    settings line), a rebuild on frame 17 at the radius extremes, the same
    piece_detector_settings.json and piece_stats.txt (but its timestamp)."""
    frames = _frames(20, 3)
    files = ("piece_detector_settings.json", "piece_stats.txt")

    def script():
        return ScriptedHighGui(frames, keys=PIECE_KEYS, bars=PIECE_BARS)

    jrc, jgui, jfiles = _drive(monkeypatch, tmp_path, "jax", script, jcpd.main, files)
    built = _counting(monkeypatch, tcpd)
    trc, tgui, tfiles = _drive(monkeypatch, tmp_path, "port", script,
                               lambda: tcpd.main(["--device", "cpu"]), files)
    assert jrc == trc == 0 and tgui.destroyed == jgui.destroyed == 1
    assert len(tgui.shown) == 19 and tgui.n == 19
    _assert_same_shows(jgui, tgui)
    assert built == [
        {"min_radius": 20, "max_radius": 55, "param1": 100, "param2": 25, "center_diff": 40},
        {"min_radius": 5, "max_radius": 80, "param1": 80, "param2": 20, "center_diff": 30},
    ]
    assert json.loads(tfiles[files[0]]) == built[1]
    assert tfiles[files[0]] == jfiles[files[0]]
    t_stats, j_stats = (f[files[1]].splitlines() for f in (tfiles, jfiles))
    assert t_stats[1:] == j_stats[1:] and t_stats[2] == "occupied: 32/64"


def test_sensitivity_tool_matches_jax(monkeypatch, tmp_path):
    """calibrate_sensitivity.main: a blur change (5 -> 9) rebuilds the
    geometry with blur_pad 4 on frame 17; with the hand test on and the
    reference re-captured once, the e2 pawn lifted from frame 18 on shows
    the preview (the square and e3, e4); the same shown images and
    sensitivity_settings.json. The e2 pawn is dark: the change gate passes
    a light piece lifted off a light square unseen (ROADMAP Queue C 5)."""
    colors = np.empty((8, 8), object)
    colors[4, 1] = DARK_PIECE
    frames = _frames(20, 5, lifted_from=18, piece_colors=colors)
    bars = {2: {"Blur": 9, "Sensitivity": 20, "Alpha x100": 20}}
    keys = {3: ord("h"), 5: ord("r"), 19: ord("s"), 20: ord("q")}
    files = ("sensitivity_settings.json",)
    previews = []
    lifted = tcs.lifted_square_and_destinations
    monkeypatch.setattr(tcs, "lifted_square_and_destinations",
                        lambda game, occ: previews.append(lifted(game, occ)) or previews[-1])

    def script():
        return ScriptedHighGui(frames, keys=keys, bars=bars)

    jrc, jgui, jfiles = _drive(monkeypatch, tmp_path, "jax", script, jcs.main, files)
    built = _counting(monkeypatch, tcs)
    trc, tgui, tfiles = _drive(monkeypatch, tmp_path, "port", script,
                               lambda: tcs.main(["--device", "cpu"]), files)
    assert jrc == trc == 0 and len(tgui.shown) == 20
    _assert_same_shows(jgui, tgui)
    assert [b["blur_kernel"] for b in built] == [5, 9]
    assert previews[:17] == [(None, [])] * 17
    assert previews[-1][0] == (4, 1) and sorted(previews[-1][1]) == [(4, 2), (4, 3)]
    assert tfiles == jfiles
    assert json.loads(tfiles[files[0]]) == {"z_threshold": 2.0, "initial_variance": 100,
                                            "alpha": 0.2, "blur_kernel": 9}


def test_colors_tool_matches_jax(monkeypatch, tmp_path):
    """calibrate_colors.main: the identity profile, then a radical profile
    (hue shift, saturation, contrast, brightness, target hue); the triptych
    equals the JAX one but for the enhanced third's one-level HSV -> BGR
    rounding, and color_profile.json is the same."""
    frames = _frames(3, 7)
    bars = {2: {"Hue shift": 100, "Sat x10": 14, "Contrast x10": 12, "Brightness": 110,
                "Radical": 1, "Target hue": 15, "Hue window": 30}}
    keys = {2: ord("s"), 3: ord("q")}
    files = ("color_profile.json",)

    def script():
        return ScriptedHighGui(frames, keys=keys, bars=bars)

    jrc, jgui, jfiles = _drive(monkeypatch, tmp_path, "jax", script, jcc.main, files)
    trc, tgui, tfiles = _drive(monkeypatch, tmp_path, "port", script,
                               lambda: tcc.main(["--device", "cpu"]), files)
    assert jrc == trc == 0 and len(tgui.shown) == 3
    _assert_same_shows(jgui, tgui, near={"Color Calibration": (1, ONE_LEVEL_FRACTION)})
    np.testing.assert_array_equal(tgui.shown[0][1], jgui.shown[0][1])  # the identity profile
    assert tfiles == jfiles
    assert json.loads(tfiles[files[0]]) == tcc.profile_from_trackbars(
        [bars[2].get(name, default) for name, _m, _c, default in tcc.TRACKBARS])


class _FixedFps:
    def __init__(self):
        self.fps = 24.0

    def update(self):
        return self.fps


def test_enhance_demo_matches_jax(monkeypatch, tmp_path):
    """enhance_demo.main on whole camera frames (a 192x320 camera: the JAX
    side runs its TPU kernels in interpret mode, as
    tests/test_torch_enhance.py does) with a color profile from
    color_profile.json: Original (with the FPS HUD) bit-equal; Enhanced and
    its Otsu analysis within the enhancement's CPU limits."""
    frames = [np.ascontiguousarray(f[300:492, 480:800]) for f in _frames(2, 9)]
    profile = {"contrast": 1.1, "brightness": 4, "sat_scale": 1.2}
    monkeypatch.setattr(jed, "FpsCounter", _FixedFps)
    monkeypatch.setattr(ted, "FpsCounter", _FixedFps)
    monkeypatch.setattr(jenh, "clahe", functools.partial(jenh.clahe, backend="pallas"))
    monkeypatch.setattr(jed, "ImageEnhancerTPU",
                        functools.partial(ImageEnhancerTPU, bilateral_backend="pallas"))

    def script():
        return ScriptedHighGui(frames, keys={2: ord("q")})

    def jax_main():
        with pltpu.force_tpu_interpret_mode():
            return jed.main()

    saved = {"color_profile.json": profile}
    jrc, jgui, _ = _drive(monkeypatch, tmp_path, "jax", script, jax_main, saved=saved)
    trc, tgui, _ = _drive(monkeypatch, tmp_path, "port", script,
                          lambda: ted.main(["--device", "cpu"]), saved=saved)
    assert jrc == trc == 0
    assert [w for w, _ in tgui.shown] == ["Original", "Enhanced", "Analysis (Otsu)"] * 2
    near = (ENHANCE_MAX_DIFF, ENHANCE_FRACTION)
    _assert_same_shows(jgui, tgui, near={"Enhanced": near, "Analysis (Otsu)": near})


# The calibrator: four clicks at the fixture's corners on frame 2 (out of
# order: the tool reorders them), ENTER on frame 3, then the verification
# loop: 'g' on frame 5 refines the grid, 's' on frame 7 saves.
CLICKS = {2: [tuple(DEFAULT_CORNERS[i]) for i in (3, 0, 2, 1)]}
CALIB_KEYS = {3: 13, 5: ord("g"), 7: ord("s")}


def test_calibration_module_matches_jax(monkeypatch, tmp_path):
    """CalibrationModule.run with no saved calibration: the click display,
    the warped verification views (cv2.warpPerspective through the gui)
    with the refined grid, and the saved calibration.json equal the JAX
    ones."""
    frames = _frames(8, 11)

    def script():
        return ScriptedHighGui(frames, keys=CALIB_KEYS, clicks=CLICKS)

    def unsaved(call):
        def run():
            os.remove("calibration.json")
            return call()
        return run

    files = ("calibration.json",)
    jconfig, jgui, jfiles = _drive(monkeypatch, tmp_path, "jax", script,
                                   unsaved(lambda: jcm.CalibrationModule().run(cv2.VideoCapture(0))),
                                   files)
    tconfig, tgui, tfiles = _drive(
        monkeypatch, tmp_path, "port", script,
        unsaved(lambda: tcm.CalibrationModule(device="cpu").run(cv2.VideoCapture(0))), files)
    assert tconfig == jconfig and tfiles == jfiles
    assert [w for w, _ in tgui.shown] == ["Calibration"] * 3 + ["Verification"] * 4
    _assert_same_shows(jgui, tgui)
    assert tconfig["corners"] == [list(map(int, DEFAULT_CORNERS[i])) for i in (3, 0, 2, 1)]
    assert tconfig["grid_lines_x"] is not None and len(tconfig["grid_lines_y"]) == 9


def test_session_calibrates_from_the_camera_without_a_saved_calibration(monkeypatch, tmp_path):
    """GameSession.on_calibration_requested(cap) with no calibration.json
    runs the calibrator on cv2's HighGUI, gets the JAX config, builds the
    pipeline and captures the reference from the frames after it (10
    warm-up reads); answering 'y' to the saved calibration's prompt loads
    it without a window."""
    frames = _frames(20, 13)

    def script():
        return ScriptedHighGui(frames, keys=CALIB_KEYS, clicks=CLICKS)

    def calibrate():
        os.remove("calibration.json")
        session = GameSession(device="cpu")
        assert session.on_calibration_requested(cv2.VideoCapture(0))
        return session

    session, gui, files = _drive(monkeypatch, tmp_path, "port", script, calibrate,
                                 ("calibration.json",))
    jconfig, _, _ = _drive(monkeypatch, tmp_path, "jax", script,
                           lambda: (os.remove("calibration.json"),
                                    jcm.CalibrationModule().run(cv2.VideoCapture(0)))[1])
    assert session.config == jconfig and json.loads(files["calibration.json"]) == jconfig
    assert gui.n == 7 + 11 and session.pipe_state is not None
    assert session.pipeline.geometry.grid_x == jconfig["grid_lines_x"]
    monkeypatch.setattr("builtins.input", lambda prompt="": "y")
    again = GameSession(device="cpu")
    reader = ScriptedHighGui(frames)
    assert tcm.CalibrationModule(device="cpu").run(reader) == jconfig and reader.n == 0
    assert again.on_calibration_requested(None)
    assert again.config == jconfig
