"""Ablations of the enhanced path's kernels (B2-B4) on a CUDA card.

Counterpart of chessboard_vision_tpu.tools.ablate_enhanced: how much of
each kernel's time is data movement, how much its arithmetic, and how
much the launch. Each variant is an extra template instantiation of the
production kernel in ``kernels/bilateral.cu`` or ``kernels/clahe.cu`` with
one part taken out (the files' headers list them), so a difference is
that part's; the production instantiation, its launch and its bits are
the wrappers' (``bilateral_planar``, ``clahe_hist_luts``, ``clahe_hist``,
``clahe_apply``).

- bilateral (B2, on (3, H, W) u8): full, notable (the color weight's table
  lookup out), sumsonly (products out too), stageonly (the tile staging
  and the store). The TPU tool's "noexp" has no counterpart (this kernel
  has no exp: a table replaced it), "cdonly" is sumsonly, "shifts" is
  stageonly.
- hist (B3, on the unpadded (H, W) L plane): full (histograms and LUTs,
  the path's launch), noluts (the histograms alone, the same
  instantiation), loadonly (the loads, no counting; the TPU tool's
  "matonly"), countonly (the shared atomics, no loads).
- apply (B4): full, lookuponly (the LUT lookups, no blend; "matonly"),
  blendonly (the blend, no lookups; "blendonly"), copy (load and store).
- mid: the LUT phase as torch ops on the card (clahe_luts_from_hist, each
  result folded into the next input as the TPU tool does), and, from the
  hist rows, full - noluts: the same phase inside B3's epilogue.
- copy: a device copy of each kernel's bytes (``Tensor.copy_``), the
  floor of its data movement; empty: one launch of an empty kernel, the
  launch floor.

Timing: chained calls, each input the previous output (a histogram
launch's input is the plane it counted: its outputs are not an image),
between CUDA events recorded while a sleep kernel holds the stream, so
every call is enqueued before the card starts and the events bracket the
card's work, not the host's launches; the least over ``--passes`` passes.
The bilateral is also timed with its input held fixed (a chain of it
smooths random input within a few calls) on random u8 and on a rendered
board, for full and notable: the question of whether its cost on random
input is the table lookups.

Prints the table to stderr and ONE JSON line to stdout, with the card's
name and power limit (nvidia-smi).

Usage:
    python -m chessboard_vision_tpu_torch.tools.ablate_enhanced
        [--size 980 | --size 1080x1920] [--iters 200] [--passes 3]
        [--only bilateral,hist,apply,mid,copy,empty]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

GROUPS = ("bilateral", "hist", "apply", "mid", "copy", "empty")
TILES = 8
CLIP_LIMIT = 3.0
BILATERAL_VARIANTS = {"full": 0, "notable": 1, "sumsonly": 2, "stageonly": 3}
HIST_VARIANTS = {"full": 0, "loadonly": 1, "countonly": 2}
APPLY_VARIANTS = {"full": 0, "lookuponly": 1, "blendonly": 2, "copy": 3}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_size(text: str) -> tuple:
    """"980" (a square board, the enhanced path's) or "HxW" (a camera
    frame, e.g. 1080x1920) -> (H, W)."""
    try:
        parts = [int(p) for p in text.lower().split("x")]
    except ValueError:
        raise argparse.ArgumentTypeError(f"--size {text!r}: give N or HxW") from None
    if len(parts) == 1:
        parts *= 2
    if len(parts) != 2 or min(parts) < 2 * TILES:
        raise argparse.ArgumentTypeError(f"--size {text!r}: give N or HxW, each >= {2 * TILES}")
    return tuple(parts)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=parse_size, default=(980, 980),
                    help="board edge N or camera frame HxW (default 980: the 1080p board)")
    ap.add_argument("--iters", type=int, default=200, help="chained calls a pass")
    ap.add_argument("--passes", type=int, default=3, help="timed passes (the least wins)")
    ap.add_argument("--only", default="", help=f"comma-separated groups of {','.join(GROUPS)}")
    args = ap.parse_args(argv)
    groups = [g for g in args.only.split(",") if g]
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        ap.error(f"--only: unknown groups {unknown}; choose from {','.join(GROUPS)}")
    if args.iters < 1 or args.passes < 1:
        ap.error("--iters and --passes must be at least 1")
    args.groups = groups or list(GROUPS)
    return args


def held_chain_us(fn, x0, iters: int, passes: int):
    """(least µs a call over ``passes`` chains of ``iters`` calls y =
    fn(y) from x0, whether the stream was held). Held: between CUDA
    events while a sleep kernel holds the stream, held longer and again
    when the host was not done in time. A chain the host cannot enqueue
    within a held stream of a few seconds is timed between events around
    it, unheld, which counts the host's gaps too."""
    y = x0
    for _ in range(3):
        y = fn(y)
    torch.cuda.synchronize()
    best, cycles, done = float("inf"), 20_000_000, 0  # ~10 ms at the H100's boost clock
    held_ok = True
    while done < passes:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        held = torch.cuda.Event()
        if held_ok:
            torch.cuda._sleep(cycles)
            held.record()
        start.record()
        y = x0
        for _ in range(iters):
            y = fn(y)
        end.record()
        still_held = held_ok and not held.query()
        torch.cuda.synchronize()
        if held_ok and not still_held:
            cycles *= 4
            held_ok = cycles <= 20_000_000 * 4 ** 3
            continue
        best = min(best, start.elapsed_time(end) * 1e3 / iters)
        done += 1
    return best, held_ok


class Variants:
    """ctypes launchers of the kernels' ablation instantiations."""

    def __init__(self):
        from chessboard_vision_tpu_torch.kernels import bilateral as kb
        from chessboard_vision_tpu_torch.kernels import clahe as kc

        self.kb, self.kc = kb, kc
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.blib, self.clib = kb._library(), kc._library()
        self.blib.cbv_bilateral_variant.argtypes = [I, P, P, I, I, ctypes.POINTER(F), P, P]
        for fn, args in ((self.clib.cbv_clahe_hist_variant, [I, P, I, I, I, I, I, P, P, I, F, P]),
                         (self.clib.cbv_clahe_apply_variant, [I, P, P, P, I, I, F, F, I, P]),
                         (self.clib.cbv_empty, [P])):
            fn.argtypes, fn.restype = args, I
        self.blib.cbv_bilateral_variant.restype = I

    @staticmethod
    def _stream():
        return torch.cuda.current_stream().cuda_stream

    def _check(self, rc, lib, what):
        if rc != 0:
            raise RuntimeError(f"{what}: {lib.cbv_cuda_error_string(rc).decode()} ({rc})")

    def bilateral(self, variant: int, img: torch.Tensor) -> torch.Tensor:
        kb = self.kb
        out = torch.empty_like(img)
        sw = kb.space_weights(kb.KERNEL_D, 75.0)
        rc = self.blib.cbv_bilateral_variant(
            variant, img.data_ptr(), out.data_ptr(), img.shape[1], img.shape[2],
            sw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            kb._table_buffer(img.device, 75.0).data_ptr(), self._stream())
        self._check(rc, self.blib, f"bilateral variant {variant}")
        return out

    def hist(self, variant: int, img, th, tw, clip, hist, luts):
        rc = self.clib.cbv_clahe_hist_variant(
            variant, img.data_ptr(), img.shape[0], img.shape[1], th, tw, TILES, hist.data_ptr(),
            luts.data_ptr(), clip, self.kc._lut_scale(th * tw), self._stream())
        self._check(rc, self.clib, f"clahe_hist variant {variant}")

    def apply(self, variant: int, img, luts, th, tw) -> torch.Tensor:
        out = torch.empty_like(img)
        rc = self.clib.cbv_clahe_apply_variant(
            variant, img.data_ptr(), luts.data_ptr(), out.data_ptr(), img.shape[0],
            img.shape[1], self.kc._inv(th), self.kc._inv(tw), TILES, self._stream())
        self._check(rc, self.clib, f"clahe_apply variant {variant}")
        return out

    def empty(self):
        self._check(self.clib.cbv_empty(self._stream()), self.clib, "empty kernel")


def rendered_board(h: int, w: int) -> np.ndarray:
    """(3, h, w) u8 planar: a rendered board at (h, w) (a square size), or a
    rendered camera frame of the benchmark's layout (any other)."""
    from chessboard_vision_tpu_torch.ops.layout import to_planar
    from chessboard_vision_tpu_torch.tools.synth import (
        SynthCamera,
        bench_corners,
        initial_occupancy,
        render_board,
    )

    rng = np.random.default_rng(1)
    if h == w:
        board = np.clip(np.rint(render_board(initial_occupancy(), h, rng)), 0, 255)
        return to_planar(board.astype(np.uint8))
    camera = SynthCamera(bench_corners(h, w), frame_size=(h, w), board_px=min(h, w) - 100)
    return to_planar(camera.render(initial_occupancy(), rng))


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def run(args) -> dict:
    """Every selected group's rows: {name: µs a call}."""
    from chessboard_vision_tpu_torch.kernels import bilateral as kb
    from chessboard_vision_tpu_torch.kernels import clahe as kc

    H, W = args.size
    dev = torch.device("cuda")
    th, tw = -(-H // TILES), -(-W // TILES)
    clip = max(int(CLIP_LIMIT * th * tw / 256), 1)
    g = torch.Generator(device=dev).manual_seed(0)
    img3 = torch.randint(0, 256, (3, H, W), dtype=torch.uint8, device=dev, generator=g)
    plane = torch.randint(0, 256, (H, W), dtype=torch.uint8, device=dev, generator=g)
    luts = torch.randint(0, 256, (TILES * TILES, 256), device=dev, generator=g).float()
    var = Variants()
    res, unheld = {}, []

    def measure(name, fn, x0):
        res[name], held = held_chain_us(fn, x0, args.iters, args.passes)
        if not held:
            unheld.append(name)
        log(f"  {name:<28} {res[name]:9.2f} us/call" + ("" if held else " (unheld)"))

    if "bilateral" in args.groups:
        log(f"bilateral d=9 on (3, {H}, {W}) u8, chained:")
        measure("bilateral/full", lambda y: kb.bilateral_planar(y), img3)
        for name, v in BILATERAL_VARIANTS.items():
            if v:
                measure(f"bilateral/{name}", lambda y, v=v: var.bilateral(v, y), img3)
        board = torch.as_tensor(rendered_board(H, W), device=dev)
        log("bilateral, input held fixed:")
        for label, x in (("random", img3), ("board", board)):
            measure(f"bilateral/full@{label}", lambda y, x=x: kb.bilateral_planar(x), x)
            measure(f"bilateral/notable@{label}", lambda y, x=x: var.bilateral(1, x), x)
    if "hist" in args.groups:
        log(f"clahe histograms of the unpadded ({H}, {W}) plane, {TILES}x{TILES} tiles of "
            f"{th}x{tw}:")
        hist = torch.empty((TILES * TILES, 256), dtype=torch.int32, device=dev)
        lut_out = torch.empty((TILES * TILES, 256), dtype=torch.float32, device=dev)
        measure("hist/full", lambda y: (kc.clahe_hist_luts(y, th, tw, TILES, clip), y)[1], plane)
        measure("hist/noluts", lambda y: (kc.clahe_hist(y, th, tw, TILES), y)[1], plane)
        for name, v in HIST_VARIANTS.items():
            if v:
                measure(f"hist/{name}",
                        lambda y, v=v: (var.hist(v, y, th, tw, clip, hist, lut_out), y)[1], plane)
    if "apply" in args.groups:
        log(f"clahe LUT apply on the unpadded ({H}, {W}) plane:")
        measure("apply/full", lambda y: kc.clahe_apply(y, luts, th, tw, TILES), plane)
        for name, v in APPLY_VARIANTS.items():
            if v:
                measure(f"apply/{name}", lambda y, v=v: var.apply(v, y, luts, th, tw), plane)
    if "mid" in args.groups:
        log(f"clahe LUT phase, ({TILES * TILES}, 256), torch ops on the card:")
        hist0 = torch.randint(0, clip + 40, (TILES * TILES, 256), dtype=torch.int32,
                              device=dev, generator=g)
        measure("mid/torch", lambda h: (h - kc.clahe_luts_from_hist(h, th * tw, clip)
                                        .to(torch.int32)).abs(), hist0)
        if "hist/full" in res:
            res["mid/epilogue"] = res["hist/full"] - res["hist/noluts"]
            log(f"  {'mid/epilogue (hist full - noluts)':<28} {res['mid/epilogue']:9.2f} us/call")
    if "copy" in args.groups:
        log("device copies of the kernels' bytes:")
        for label, x in (("u8_plane", plane), ("u8_3plane", img3)):
            # Two buffers in turns: each copy reads the one the last wrote.
            a, b = torch.empty_like(x), torch.empty_like(x)
            measure(f"copy/{label}", lambda y, a=a, b=b: (b if y is a else a).copy_(y), x)
    if "empty" in args.groups:
        log("launch floor:")
        measure("empty/launch", lambda y: (var.empty(), y)[1], None)
    return res, unheld


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_enhanced times the port's CUDA kernels and needs a CUDA card: "
                           "torch.cuda.is_available() is False on this machine")
    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    values, unheld = run(args)
    print(json.dumps({
        "metric": "enhanced_kernel_ablations",
        "unit": "us_per_call",
        "size": list(args.size),
        "card": smi,
        "timing": f"held-stream CUDA events, {args.iters} chained calls, least of "
                  f"{args.passes} passes",
        "values": values,
        "unheld": unheld,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
