"""NumPy/OpenCV oracle backend.

Counterpart of chessboard_vision_tpu.reference: the reference pipeline's
stages (frame_enhancer.py, change_detector.py, piece_detector.py) in cv2,
the parity oracle of ``process_video --compare-oracle``
(replay_session.py). cv2 is imported in the classes' ``__init__`` and in
the functions that draw on it, never when a module is imported: the
package imports where there is no cv2 (the card's machine), and using an
oracle there raises an ImportError that names cv2.
"""

from chessboard_vision_tpu_torch.reference.change_detector import ChangeDetectorCV
from chessboard_vision_tpu_torch.reference.enhancer import ImageEnhancerCV
from chessboard_vision_tpu_torch.reference.piece_detector import PieceDetectorCV

__all__ = ["ImageEnhancerCV", "ChangeDetectorCV", "PieceDetectorCV"]
