"""Contour stages of the automatic corner detector, in numpy on the host.

Each function reproduces one OpenCV call that the JAX package's
``geometry.find_chessboard_corners`` makes, on the same inputs:

- ``find_external_contours``: ``cv2.findContours(mask, RETR_EXTERNAL,
  CHAIN_APPROX_NONE)`` of a binary mask. As OpenCV 5 does, the image's
  one-pixel frame is kept (a blob at (0, 0) yields a contour that starts
  there), every border starts at its component's raster-first pixel and is
  followed by Suzuki-Abe's outer-border rule (OpenCV's direction order, so
  the walk goes down first), and a component that lies in a hole of
  another is dropped. Foreground is 8-connected, background 4-connected.
  ``min_box_area`` skips components whose pixel-centre bounding box is no
  larger: a border's area never exceeds it, so a caller that filters by
  area traces only the components that can pass.
- ``contour_area``: ``cv2.contourArea`` (shoelace, absolute value).
- ``arc_length``: ``cv2.arcLength(c, closed=True)`` (f32 segment lengths
  summed in float64, in order).
- ``approx_poly_dp``: ``cv2.approxPolyDP(c, eps, closed=True)``: OpenCV's
  Douglas-Peucker for a closed curve, which starts from a pair of
  approximately farthest points that it picks itself, splits each slice at
  the point farthest from its segment (OpenCV 5 measures the distance to
  the segment, not to its line), then removes points on almost straight
  runs.

Contours are (n, 1, 2) int32 (x, y) arrays, as OpenCV returns them.
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy import ndimage

# OpenCV's Freeman chain directions: 0 is +x, counting counterclockwise on
# the screen (+y points down): 1 up-right, 2 up, ..., 6 down, 7 down-right.
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_EIGHT = np.ones((3, 3), bool)


def trace_outer_border(mask: np.ndarray, y0: int, x0: int) -> np.ndarray:
    """The outer border of the component whose raster-first pixel is
    (y0, x0), as OpenCV follows it: (n, 1, 2) int32 (x, y) points, every
    step written (pixels on a one-pixel-wide part appear twice). ``mask``
    must hold a zero frame around the component (no index wraps)."""
    h, w = mask.shape
    buf = np.ascontiguousarray(mask, dtype=bool).tobytes()  # flat, fast to index
    step = [dx + dy * w for dx, dy in zip(_DX, _DY)]
    i0 = y0 * w + x0
    # The first neighbour met clockwise from the left (which is empty for a
    # raster-first pixel) is the border's last pixel.
    s = 4
    for _ in range(8):
        s = (s - 1) & 7
        if buf[i0 + step[s]]:
            break
    else:
        return np.array([[[x0, y0]]], np.int32)  # a single pixel
    i1 = i0 + step[s]
    i3 = i0
    pts = []
    while True:
        for _ in range(8):  # counterclockwise from the direction we came by
            s = (s + 1) & 7
            i4 = i3 + step[s]
            if buf[i4]:
                break
        pts.append(i3)
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    y, x = np.divmod(np.asarray(pts, np.int64), w)
    return np.stack([x, y], axis=-1).astype(np.int32).reshape(-1, 1, 2)


def find_external_contours(mask: np.ndarray, min_box_area: int = -1) -> List[np.ndarray]:
    """The outer borders of the components of ``mask`` (2-D, nonzero is
    foreground) that lie in no hole of another, as
    ``cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)[0]``
    lists them (last found first), skipping components whose pixel-centre
    bounding box area (w - 1) * (h - 1) is at most ``min_box_area``."""
    fg = np.pad(np.asarray(mask) != 0, 1)
    labels, _ = ndimage.label(fg, structure=_EIGHT)
    candidates = []
    for i, (ys, xs) in enumerate(ndimage.find_objects(labels)):
        if (ys.stop - ys.start - 1) * (xs.stop - xs.start - 1) > min_box_area:
            y0 = ys.start
            x0 = xs.start + int(np.argmax(labels[y0, xs] == i + 1))
            candidates.append((i + 1, ys, xs, y0, x0))
    if len(candidates) > 1:
        # A component in a hole of another lies in that one's bounding box,
        # so only a candidate can hold another. The background's 4-connected
        # components: the one holding the padding frame is the outside, the
        # others are holes. The pixel left of a raster-first pixel lies in
        # the background that surrounds the component.
        bg = ndimage.label(~fg)[0]
        candidates = [c for c in candidates if bg[c[3], c[4] - 1] == bg[0, 0]]
    found = []
    for label, ys, xs, y0, x0 in candidates:
        crop = labels[y0 - 1 : ys.stop + 1, xs.start - 1 : xs.stop + 1] == label
        c = trace_outer_border(crop, 1, x0 - xs.start + 1)
        c += np.array([xs.start - 2, y0 - 2], np.int32)  # crop and pad offsets
        found.append((y0, x0, c))
    found.sort(key=lambda t: (t[0], t[1]), reverse=True)
    return [c for _, _, c in found]


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea: the shoelace area of the closed polygon, unsigned."""
    p = np.asarray(contour, np.int64).reshape(-1, 2)
    q = np.roll(p, 1, axis=0)
    return abs(float(np.sum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]))) * 0.5


def arc_length(contour: np.ndarray) -> float:
    """cv2.arcLength(contour, closed=True): each segment's length in f32
    (the closing one first), summed in float64 in order."""
    p = np.asarray(contour).reshape(-1, 2).astype(np.float32)
    d = p - np.roll(p, 1, axis=0)
    seg = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    return float(np.cumsum(seg.astype(np.float64))[-1]) if len(seg) else 0.0


def approx_poly_dp(contour: np.ndarray, epsilon: float) -> np.ndarray:
    """cv2.approxPolyDP(contour, epsilon, closed=True) of an int contour:
    (m, 1, 2) int32. The scans over a curve are numpy reductions; a tie
    goes to the first point in OpenCV's scan order, as its strict ``>``
    gives it."""
    pts = np.asarray(contour).reshape(-1, 2).astype(np.int64)
    count = len(pts)
    if count == 0:
        return np.zeros((0, 1, 2), np.int32)
    xs, ys = pts[:, 0], pts[:, 1]
    eps = float(epsilon) ** 2
    # 1. A pair of approximately farthest points: three rounds, each from
    # the point the last one found farthest.
    pos, far, max_dist = 0, 0, 0.0
    for _ in range(3):
        pos = (pos + far) % count
        order = (pos + np.arange(1, count)) % count
        d = (xs[order] - xs[pos]) ** 2 + (ys[order] - ys[pos]) ** 2
        max_dist = float(d.max(initial=0))
        far = int(np.argmax(d)) + 1 if max_dist > 0 else 0
    src = list(zip(xs.tolist(), ys.tolist()))
    start = src[pos]
    dst = []
    stack = []
    if max_dist <= eps:
        dst.append(start)
    else:
        b = (far + pos) % count
        stack += [(b, pos), (pos, b)]
    # 2. Split each slice at the point farthest from its segment (OpenCV 5:
    # past an end, the distance to that end) until all lie within eps.
    while stack:
        s0, s1 = stack.pop()
        sx, sy = src[s0]
        n = (s1 - s0) % count - 1  # points strictly inside the slice
        if n <= 0:
            dst.append((sx, sy))
            continue
        ex, ey = src[s1]
        dx, dy = ex - sx, ey - sy
        dd = dx * dx + dy * dy
        idx = (s0 + np.arange(1, n + 1)) % count
        px, py = xs[idx] - sx, ys[idx] - sy
        dot = px * dx + py * dy
        cross = (py * dx - px * dy).astype(np.float64)
        dist = np.where(dot <= 0, (px * px + py * py).astype(np.float64),
                        np.where(dot >= dd, ((px - dx) ** 2 + (py - dy) ** 2).astype(np.float64),
                                 cross * cross / max(dd, 1)))
        k = int(np.argmax(dist))
        if dist[k] <= eps:
            dst.append((sx, sy))
        else:
            split = int(idx[k])
            stack += [(split, s1), (s0, split)]
    # 3. Drop points that lie on an almost straight run between their
    # neighbours, walking the closed result once.
    count = new_count = len(dst)
    pos = count - 1
    start = dst[pos]
    pos = (pos + 1) % count
    wpos = pos
    pt = dst[pos]
    pos = (pos + 1) % count
    i = 0
    while i < count and new_count > 2:
        end = dst[pos]
        pos = (pos + 1) % count
        dx, dy = end[0] - start[0], end[1] - start[1]
        dist = abs((pt[0] - start[0]) * dy - (pt[1] - start[1]) * dx)
        inner = (pt[0] - start[0]) * (end[0] - pt[0]) + (pt[1] - start[1]) * (end[1] - pt[1])
        if dist * dist <= 0.5 * eps * (dx * dx + dy * dy) and dx != 0 and dy != 0 and inner >= 0:
            new_count -= 1
            dst[wpos] = start = end
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start = pt
        wpos = (wpos + 1) % count
        pt = end
        i += 1
    return np.asarray(dst[:new_count], np.int32).reshape(-1, 1, 2)
