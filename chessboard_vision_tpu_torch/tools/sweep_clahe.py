"""Variant sweep of the CLAHE kernels (kernels/clahe.cu) on a CUDA card.

Each variant is a copy of ``clahe.cu`` with some of its constexpr tuning
constants changed by text substitution, built with the port's nvcc flags
into ``kernels/_build/sweep/`` (all builds started together) and loaded
with ctypes. On the 980 x 980 Lab-L of a rendered top-down board (the
1080p board size), on random u8 and on a constant plane, every variant is
first checked bit-equal to the plain versions, then timed: device time per
call under torch.profiler, the variants run in order and then in reverse
order and the two means averaged.

- B3 (histograms + LUTs): TILE_THREADS (the block of a tile) and
  TILE_ROW_BATCH (rows a warp loads before it counts).
- B4 (LUT apply): APPLY_WARPS (rows of a block at a time) and APPLY_ROWS
  (rows a thread).

The card's name and power limit (nvidia-smi) head the output.

Run: python -m chessboard_vision_tpu_torch.tools.sweep_clahe [--iters 200]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from chessboard_vision_tpu_torch.kernels import BUILD_DIR, KERNEL_DIR, build
from chessboard_vision_tpu_torch.kernels import clahe as kc
from chessboard_vision_tpu_torch.ops.color import planar_bgr2lab
from chessboard_vision_tpu_torch.tools.synth import initial_occupancy, render_board

TILES = 8
SIZE = 980  # the 1080p board, px
# name -> constants changed from clahe.cu's (the first is clahe.cu as it is)
VARIANTS = {
    "as_built": {},
    "hist_threads_512": {"TILE_THREADS": "512"},
    "hist_batch_2": {"TILE_ROW_BATCH": "2"},
    "hist_batch_8": {"TILE_ROW_BATCH": "8"},
    "apply_rows_1": {"APPLY_ROWS": "1"},
    "apply_rows_4": {"APPLY_ROWS": "4"},
    "apply_warps_4": {"APPLY_WARPS": "4"},
    "apply_warps_4_rows_4": {"APPLY_WARPS": "4", "APPLY_ROWS": "4"},
}


def variant_source(name: str, consts: dict) -> str:
    """Write clahe.cu with `consts` substituted; returns the file's path."""
    with open(os.path.join(KERNEL_DIR, "clahe.cu")) as f:
        src = f.read()
    for const, value in consts.items():
        src, n = re.subn(rf"(constexpr \w+ {const} = )[^;]+;", rf"\g<1>{value};", src)
        if n != 1:
            raise ValueError(f"clahe.cu has no constexpr {const}")
    out_dir = os.path.join(BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"clahe_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def device_us(fn, iters: int) -> float:
    """Mean device-busy us per call of fn() under torch.profiler (after a
    warmup)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters


class Variant:
    """One built variant's two launches, as the wrappers make them."""

    def __init__(self, lib_path: str):
        self.lib = kc.bind(ctypes.CDLL(lib_path))

    def hist_luts(self, img, th, tw, clip):
        hist = torch.empty((TILES * TILES, 256), dtype=torch.int32, device=img.device)
        luts = torch.empty((TILES * TILES, 256), dtype=torch.float32, device=img.device)
        rc = self.lib.cbv_clahe_hist(img.data_ptr(), 1, img.shape[0], img.shape[1], th, tw, TILES,
                                     hist.data_ptr(), luts.data_ptr(),
                                     clip, kc._lut_scale(th * tw),
                                     torch.cuda.current_stream().cuda_stream)
        kc._raise_if(rc, self.lib, "clahe_hist")
        return hist, luts

    def apply(self, img, luts, th, tw):
        out = torch.empty_like(img)
        rc = self.lib.cbv_clahe_apply(img.data_ptr(), luts.data_ptr(), out.data_ptr(), 1,
                                      img.shape[0], img.shape[1], kc._inv(th), kc._inv(tw),
                                      TILES, torch.cuda.current_stream().cuda_stream)
        kc._raise_if(rc, self.lib, "clahe_apply")
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200, help="calls per timing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_clahe needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: build(f"clahe_{kv[0]}", variant_source(*kv)), VARIANTS.items())))
    dev = torch.device("cuda")
    variants = {name: Variant(b.path) for name, b in built.items()}

    board = render_board(initial_occupancy(), SIZE, np.random.default_rng(0))
    board = np.clip(np.round(board), 0, 255).astype(np.uint8)
    lab_l = planar_bgr2lab(torch.from_numpy(np.moveaxis(board, -1, 0).copy()).to(dev))[0]
    planes = {
        "board": lab_l.contiguous(),
        "random": torch.randint(0, 256, (SIZE, SIZE), device=dev, dtype=torch.uint8,
                                generator=torch.Generator(device=dev).manual_seed(0)),
        "constant": torch.full((SIZE, SIZE), 77, device=dev, dtype=torch.uint8),
    }
    th = tw = -(-SIZE // TILES)
    clip = max(int(3.0 * th * tw / 256), 1)
    for name, v in variants.items():
        for label, img in planes.items():
            hist, luts = v.hist_luts(img, th, tw, clip)
            want = kc.clahe_hist_luts_reference(img, th, tw, TILES, clip)
            out = v.apply(img, luts, th, tw)
            torch.cuda.synchronize()
            if not (torch.equal(hist, want[0]) and torch.equal(luts, want[1]) and torch.equal(
                    out, kc.clahe_apply_reference(img, want[1], th, tw, TILES))):
                raise SystemExit(f"variant {name} differs from the plain version on {label}")
    print(f"all {len(variants)} variants bit-equal to the plain versions on "
          f"{', '.join(planes)} ({SIZE}x{SIZE}, {TILES}x{TILES} tiles)")

    for name, b in built.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}")

    timings = {}  # (variant, what) -> [us, ...]
    order = list(variants)
    for names in (order, order[::-1]):
        for name in names:
            v = variants[name]
            for label, img in planes.items():
                _, luts = v.hist_luts(img, th, tw, clip)
                for what, fn in (
                    (f"B3 {label}", lambda: v.hist_luts(img, th, tw, clip)),
                    (f"B4 {label}", lambda: v.apply(img, luts, th, tw)),
                ):
                    timings.setdefault((name, what), []).append(device_us(fn, args.iters))
    whats = [w for w in dict.fromkeys(w for _, w in timings)]
    print("device us per call (mean of the forward and the reverse pass; each pass in brackets)")
    print(f"{'variant':22s} " + " ".join(f"{w:>16s}" for w in whats))
    for name in order:
        cells = []
        for w in whats:
            a, b = timings[(name, w)]
            cells.append(f"{(a + b) / 2:6.2f} [{a:.1f},{b:.1f}]")
        print(f"{name:22s} " + " ".join(f"{c:>16s}" for c in cells))


if __name__ == "__main__":
    main()
