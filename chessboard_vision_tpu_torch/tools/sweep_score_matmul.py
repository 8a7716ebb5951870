"""Launch-shape sweep of the Hough score matmul (kernels/score_matmul.cu).

The kernel takes its CTA tile as arguments: 64-row warpgroups and 64-column
sub-tiles. The wrapper picks them from the shape
(``score_matmul.tile_shape``); this tool launches every tile it could pick
at each shape through the library's C entry point, on random bf16 operands
at the plans' (M, K) and the stream widths N, and prints per (M, N, K) the
device time of each (torch.profiler, mean device-busy time of a call)
beside torch.mm's, the wrapper's own choice marked ``*``. Every launch is
first checked: within the matmul tolerance of the plain version, and each
64-column block bit-equal to its own N = 64 launch.

(M, K): 1080p's plan (7168, 3200) and the 720p plans (3840 and 2048 rows,
K 1250 padded to 1256).

The card's name and power limit (nvidia-smi) head the output.

Run: python -m chessboard_vision_tpu_torch.tools.sweep_score_matmul [--iters 100]
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from chessboard_vision_tpu_torch.kernels import score_matmul as sm
from chessboard_vision_tpu_torch.tools.sweep_clahe import device_us

PLANS = ((7168, 3200), (3840, 1256), (2048, 1256))
SCORE_RTOL, SCORE_ATOL = 2e-4, 2e-3  # tests/test_hough_conv.py's tolerance


def launch(lib, a, b, wg, nt):
    (M, K), N = a.shape, b.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    rc = lib.cbv_score_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, nt, wg,
                              torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch {(M, N, K)} tile {(wg, nt)}: "
                           f"{lib.cbv_cuda_error_string(rc).decode()}")
    return out


def timed(fn, iters):
    """device_us as text, taken again once where the profiler saw no record
    of the calls (it loses a window now and then); "not seen" if twice."""
    for _ in range(2):
        us = device_us(fn, iters)
        if us > 0:
            return f"{us:.2f}"
    return "not seen"


def shapes(n):
    """(warpgroups, sub-tiles) the wrapper could pick at N: one 64 x 64 tile
    at N <= 64, else each candidate of tile_shape with its sub-tiles spread
    evenly over the fewest column tiles."""
    subtiles = -(-n // 64)
    if subtiles == 1:
        return [(1, 1)]
    return sorted({(wg, -(-subtiles // -(-subtiles // nt))) for wg in (1, 2) for nt in (2, 4)})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100, help="calls per timing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_score_matmul needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    lib, dev = sm._library(), torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    print("device us per call; (64-row warpgroups, 64-column sub-tiles); * the wrapper's "
          "choice")
    for m, k in PLANS:
        a = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        widths = (64, 256, 512, 1024) if m == 7168 else (64, 256)
        pf = torch.randn(max(widths), k, device=dev, generator=g).to(torch.bfloat16)
        for n in widths:
            b = pf[:n]
            want = sm.score_matmul_reference(a, b)
            chosen = sm.tile_shape(m, n, sms)
            mm = timed(lambda: torch.mm(a, b.T, out_dtype=torch.float32), args.iters)
            cells = []
            for wg, nt in shapes(n):
                got = launch(lib, a, b, wg, nt)
                torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
                for i in range(n // 64):
                    own = launch(lib, a, b[i * 64:(i + 1) * 64], 1, 1)
                    if not torch.equal(got[:, i * 64:(i + 1) * 64], own):
                        raise SystemExit(f"({m}, {n}, {k}) {(wg, nt)}: columns {i * 64}.. "
                                         "differ from their N = 64 launch")
                us = timed(lambda: launch(lib, a, b, wg, nt), args.iters)
                mark = "*" if (wg, nt) == chosen else ""
                cells.append(f"{(wg, nt)}{mark} {us}")
            print(f"({m}, {n}, {k}) torch.mm {mm}: " + ", ".join(cells), flush=True)


if __name__ == "__main__":
    main()
