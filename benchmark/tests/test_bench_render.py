"""The torch renderer against the numpy one it was copied from
(chessboard_vision_tpu_torch/tools/synth.py, copied here in numpy), noise off."""

import numpy as np
import pytest
import torch

from benchmark.reference import chesslib as chess
from benchmark.reference.geometry import get_perspective_transform
from benchmark.render import (BACKGROUND, DARK, LIGHT, OUTLINE, Camera, Scene, bench_corners,
                              board_render_maps, render_boards)


def render_board_np(occ, colors, radii, board_px):
    """synth.render_board with per-square colors and radii, float64."""
    sq = board_px // 8
    img = np.zeros((board_px, board_px, 3), np.float64)
    for row in range(8):
        for col in range(8):
            img[row * sq:(row + 1) * sq, col * sq:(col + 1) * sq] = (
                LIGHT if (row + col) % 2 == 0 else DARK)
    yy, xx = np.mgrid[:sq, :sq]
    d = np.sqrt((yy - sq // 2) ** 2 + (xx - sq // 2) ** 2)
    for f in range(8):
        for rank in range(8):
            if occ[f, rank]:
                r = int(sq * float(radii[f, rank]))
                cell = img[(7 - rank) * sq:(8 - rank) * sq, f * sq:(f + 1) * sq]
                cell[d <= r] = colors[f, rank]
                cell[np.abs(d - r) <= 1.0] = OUTLINE
    return img


def camera_np(board, corners, frame_size, board_px):
    """synth.SynthCamera.render without noise."""
    bp = float(board_px)
    src = np.array([[0, 0], [bp, 0], [0, bp], [bp, bp]])
    minv = np.linalg.inv(get_perspective_transform(src, corners))
    h, w = frame_size
    ys, xs = np.mgrid[:h, :w].astype(np.float64)
    den = minv[2, 0] * xs + minv[2, 1] * ys + minv[2, 2]
    bx = (minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]) / den
    by = (minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]) / den
    inside = (bx >= 0) & (bx < board_px - 1) & (by >= 0) & (by < board_px - 1)
    bx, by = bx[inside], by[inside]
    x0, y0 = np.floor(bx).astype(np.int64), np.floor(by).astype(np.int64)
    i = y0 * board_px + x0
    fx, fy = (bx - x0)[:, None], (by - y0)[:, None]
    b = board.reshape(-1, 3)
    top = b[i] * (1 - fx) + b[i + 1] * fx
    bot = b[i + board_px] * (1 - fx) + b[i + board_px + 1] * fx
    frame = np.full(frame_size + (3,), float(BACKGROUND))
    frame[inside] = top * (1 - fy) + bot * fy
    return np.clip(frame, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("board_px,frame_size,moves", [
    (140, (240, 320), []), (140, (240, 320), ["e2e4", "g8f6"]), (220, (320, 480), ["b1c3"]),
])
def test_render_matches_numpy(board_px, frame_size, moves):
    board = chess.Board()
    for m in moves:
        board.push(chess.Move.from_uci(m))
    occ, colors, radii = board_render_maps(board)
    want_board = render_board_np(occ, colors, radii, board_px)
    got_board = render_boards([Scene(board)], board_px, "cpu")[0].double().numpy()
    assert np.abs(got_board - want_board).max() < 1e-3
    corners = bench_corners(*frame_size) + np.array([[3, -2], [-4, 1], [2, 5], [-1, -3]])
    want = camera_np(want_board, corners, frame_size, board_px)
    got = Camera(corners, frame_size, board_px, "cpu").render([Scene(board)])[0].numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    # float32 sampling against float64: a level at most, on a few pixels
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_hand_covers_from_and_to_squares():
    board = chess.Board()
    plain = render_boards([Scene(board)], 160, "cpu")[0]
    hand = render_boards([Scene(board, ((4, 1), (4, 3)))], 160, "cpu")[0]
    sq = 20
    for f, r in ((4, 1), (4, 3)):
        y, x = (7 - r) * sq + sq // 2, f * sq + sq // 2
        assert not torch.equal(plain[y, x], hand[y, x])
    assert torch.equal(plain[sq // 2, sq // 2], hand[sq // 2, sq // 2])  # a8 untouched


def test_same_seed_same_frames():
    board = chess.Board()
    cam = Camera(bench_corners(240, 320), (240, 320), 140, "cpu")
    frames = []
    for _ in range(2):
        g = torch.Generator().manual_seed(2**33 + 1)
        frames.append(cam.render([Scene(board)] * 2, g))
    assert torch.equal(frames[0], frames[1]) and not torch.equal(frames[0][0], frames[0][1])
