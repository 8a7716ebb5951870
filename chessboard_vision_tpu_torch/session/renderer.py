"""Board overlay rendering (cv2, host-side UI path).

Counterpart of chessboard_vision_tpu.session.renderer, equal to it pixel
for pixel: grid lines (smart or linear), noise overlay, last-move
highlight, lifted-piece highlight, radar destination circles, piece
glyphs, turn and FPS HUD, clock line. The image is the warped board on the
host (``VisionPipeline.warp_board``); drawing is cv2's, which each function
imports itself, so the module imports where there is no cv2 (the card's
machine) and only drawing needs it.
"""

from __future__ import annotations

from chessboard_vision_tpu_torch.rules import chess


def _sq_to_cell(f, r):
    """Logical (file, rank) -> visual (col, row) with rank 8 on top."""
    return f, 7 - r


def draw_chess_grid_dynamic(img, board_size: int, orientation: str = "WHITE"):
    """Grid lines + file/rank labels (reference board_detection.py:112-146).

    orientation 'WHITE': a1 bottom-left; 'BLACK': rotated labels.
    """
    import cv2

    sq = board_size // 8
    for i in range(1, 8):
        cv2.line(img, (i * sq, 0), (i * sq, board_size), (255, 255, 255), 2)
        cv2.line(img, (0, i * sq), (board_size, i * sq), (255, 255, 255), 2)
    if orientation == "WHITE":
        files = list("abcdefgh")
        ranks = [8, 7, 6, 5, 4, 3, 2, 1]
    else:
        files = list("hgfedcba")
        ranks = [1, 2, 3, 4, 5, 6, 7, 8]
    for i, f in enumerate(files):
        cv2.putText(img, f, (i * sq + sq // 2 - 10, board_size - 10),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 255), 2)
    for i, rank in enumerate(ranks):
        cv2.putText(img, str(rank), (5, i * sq + sq // 2 + 10),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 255), 2)
    return img


def draw_board_overlay(
    vis,
    board_size: int,
    grid_x,
    grid_y,
    game,
    board_lock,
    noise_active: bool = False,
    lifted=None,
    radar=(),
    fps: float = 0.0,
    clock_text: str = "",
):
    """Draw the session's state over the warped board ``vis`` (B, B, 3) u8
    in place and return it; the board is read under ``board_lock``."""
    import cv2

    sq = board_size // 8

    # Grid
    if grid_x and grid_y and len(grid_x) == 9:
        for x in grid_x:
            cv2.line(vis, (int(x), 0), (int(x), board_size), (0, 200, 100), 1)
        for y in grid_y:
            cv2.line(vis, (0, int(y)), (board_size, int(y)), (0, 200, 100), 1)
    else:
        for i in range(9):
            cv2.line(vis, (i * sq, 0), (i * sq, board_size), (50, 50, 50), 1)
            cv2.line(vis, (0, i * sq), (board_size, i * sq), (50, 50, 50), 1)

    if noise_active:
        overlay = vis.copy()
        overlay[:] = (0, 0, 80)
        cv2.addWeighted(overlay, 0.3, vis, 0.7, 0, vis)
        cv2.putText(vis, "move in progress", (board_size // 2 - 120, board_size // 2),
                    cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 0, 255), 3)

    with board_lock:
        # Last-move highlight
        if game.board.move_stack:
            last = game.board.peek()
            overlay = vis.copy()
            for sq_idx in (last.from_square, last.to_square):
                col, row = _sq_to_cell(chess.square_file(sq_idx), chess.square_rank(sq_idx))
                x1, y1 = col * sq, row * sq
                cv2.rectangle(overlay, (x1, y1), (x1 + sq, y1 + sq), (100, 50, 0), -1)
            cv2.addWeighted(overlay, 0.5, vis, 0.5, 0, vis)

        if lifted is not None:
            col, row = _sq_to_cell(*lifted)
            x1, y1 = col * sq, row * sq
            overlay = vis.copy()
            cv2.rectangle(overlay, (x1, y1), (x1 + sq, y1 + sq), (0, 0, 200), -1)
            cv2.addWeighted(overlay, 0.4, vis, 0.6, 0, vis)

        if radar:
            # One overlay and one blend for all destinations.
            overlay = vis.copy()
            for dest in radar:
                col, row = _sq_to_cell(*dest)
                cx, cy = col * sq + sq // 2, row * sq + sq // 2
                cv2.circle(overlay, (cx, cy), int(sq * 0.2), (0, 100, 0), -1)
            cv2.addWeighted(overlay, 0.6, vis, 0.4, 0, vis)

        # Piece glyphs
        for f in range(8):
            for r in range(8):
                piece = game.board.piece_at(chess.square(f, r))
                if piece:
                    col, row = _sq_to_cell(f, r)
                    x = col * sq + sq // 2
                    y = row * sq + sq // 2
                    sym = piece.symbol()
                    color = (255, 255, 255) if piece.color == chess.WHITE else (0, 0, 0)
                    bg = (0, 0, 0) if piece.color == chess.WHITE else (255, 255, 255)
                    cv2.putText(vis, sym, (x - 15, y + 10), cv2.FONT_HERSHEY_SIMPLEX, 1.2, bg, 4)
                    cv2.putText(vis, sym, (x - 15, y + 10), cv2.FONT_HERSHEY_SIMPLEX, 1.2, color, 2)

        turn = "White" if game.board.turn else "Black"
        cv2.putText(vis, f"Turn: {turn}", (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 0), 2)

    cv2.putText(vis, f"FPS: {fps:.1f}", (board_size - 150, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                (0, 255, 255), 2)
    if clock_text:
        cv2.putText(vis, clock_text, (10, board_size - 12), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                    (255, 255, 255), 2)
    return vis
