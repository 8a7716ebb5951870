"""The benchmark of chessboard_vision_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell of ``BENCHMARK.json`` names a
configuration (``benchmark/configs/<config>.json``: the deployment, its rigs,
the session it drives and the limits of its comparison) and a traffic mix
(``benchmark/traffic/<mix>.json``, read by schedule.py). The configuration's
``session`` names its driver (``benchmark/drivers/<session>.py``), its
``reference`` the plain reference of its vision step
(``benchmark/reference/<reference>.py``, compare.py), and every metric is
read by its own file (``benchmark/metrics/<metric>.py``), so a
configuration, its reference, a mix or a metric is added by adding files.
A configuration whose ``pipeline`` settings its reference does not
implement is refused before anything is set up: exit 1, no result.

A run: the rigs' corners and every board's game from the seed; the frame
bank rendered on the card (render.py) and copied to host memory once, as
camera frames; the session built, its reference captured and the traffic's
warm-up calls made (all of that is ``setup_s``); the timed window of
``--seconds``; with ``--trace 1`` two traced stretches after it (plain, then
with Python stacks for the attribution); the peak device memory read; the
program freed; then the plain reference (reference/) replays every call the
program took, on the same frames with the same host clock, and the two are
compared. The last line of stdout is one JSON object; the comparison's
numbers, each beside its limit, end stderr and the JSON line.

Exits 3 without a result when no CUDA card (or fewer than the cell asks for)
is present, and 4 when a module named jax, jaxlib, flax or
chessboard_vision_tpu is loaded once the run is done, checked just before the
result is printed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # the run's set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Callable, NamedTuple, Optional  # noqa: E402

import numpy as np  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "chessboard_vision_tpu"})
NO_CARD_RC, FORBIDDEN_RC = 3, 4
RENDER_CHUNK = 8  # scenes rendered a pass


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# -- the cell, found by name --------------------------------------------------


class Cell(NamedTuple):
    root: str  # the checkout whose benchmark/ holds the cell's files
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # the manifest's metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``, with its
    configuration and traffic mix read from their files; SystemExit where
    the configuration's reference does not implement its pipeline."""
    from benchmark import compare

    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as fh:
        config = json.load(fh)
    refused = compare.unimplemented(config, root)
    if refused:
        raise SystemExit(f"{workload}: " + "; ".join(refused))
    with open(os.path.join(root, "benchmark", "traffic", w["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return Cell(root, workload, config, traffic, int(w["chips"]),
                [m for m in manifest["end_to_end"] if _reports(m, workload)],
                [m for m in manifest["per_layer"] if _reports(m, workload)])


def load_file(root: str, kind: str, name: str):
    """The module ``<root>/benchmark/<kind>/<name>.py``, loaded by its path
    (a metric's name holds dots)."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT) -> Callable:
    """``read(run)`` of ``benchmark/metrics/<name>.py``: the metric's value,
    or None where the run holds nothing for it to read."""
    return load_file(root, "metrics", name).read


# -- the traffic: rigs, games, frames -----------------------------------------


def rig_corners(config: dict, seed: int) -> list:
    """Each rig's calibration corners (TL, TR, BL, BR), whole pixels: the
    centred board of render.bench_corners, each corner moved by up to
    ``board_jitter_px`` in x and y, drawn from the seed."""
    from benchmark.render import bench_corners

    h, w = config["frame_size"]
    rng = np.random.default_rng([seed, 7])
    j = config["board_jitter_px"]
    base = bench_corners(h, w)
    return [np.rint(base + rng.uniform(-j, j, base.shape)).astype(np.int64)
            for _ in range(config["boards"])]


class Frames:
    """The frame bank on the host, ``bank[b]`` (scenes, renders, H, W, 3) u8,
    and each call's frames (boards, H, W, 3). For one board a call's frames
    are a view of the bank. For several, one (boards, H, W, 3) buffer a
    render is kept and a board's row is copied into it only when that board's
    scene changes."""

    def __init__(self, bank: list, scripts: list, renders: int):
        self.bank, self.scripts, self.renders = bank, scripts, renders
        if len(bank) > 1:
            shape = (len(bank),) + bank[0].shape[2:]
            self._bufs = [np.empty(shape, np.uint8) for _ in range(renders)]
            self._held = [[-1] * len(bank) for _ in range(renders)]

    def index(self, call: int) -> list:
        """(scene, render) of every board at ``call``."""
        return [(s.state(call), call % self.renders) for s in self.scripts]

    def __call__(self, call: int) -> np.ndarray:
        idx = self.index(call)
        if len(self.bank) == 1:
            s, r = idx[0]
            return self.bank[0][s, r][None]
        r = idx[0][1]
        buf, held = self._bufs[r], self._held[r]
        for b, (s, _) in enumerate(idx):
            if held[b] != s:
                buf[b] = self.bank[b][s, r]
                held[b] = s
        return buf


def render_bank(config: dict, scripts: list, corners: list, renders: int, seed: int,
                device) -> list:
    """Every board's scenes x renders, rendered on ``device`` from the seed
    and copied to host memory: one (scenes, renders, H, W, 3) u8 array a board."""
    import torch

    from benchmark.render import Camera, Scene

    h, w = config["frame_size"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    bank = []
    for script, c in zip(scripts, corners):
        cam = Camera(c, (h, w), min(h, w) - 100, device)
        scenes = [Scene(*script.scene(i)) for i in range(script.n_scenes) for _ in range(renders)]
        out = np.empty((len(scenes), h, w, 3), np.uint8)
        for i in range(0, len(scenes), RENDER_CHUNK):
            part = scenes[i:i + RENDER_CHUNK]
            out[i:i + len(part)] = cam.render(part, gen).cpu().numpy()
        bank.append(out.reshape(script.n_scenes, renders, h, w, 3))
    return bank


# -- the run --------------------------------------------------------------------


class Record(NamedTuple):
    """What a run's metric readers read."""

    window_s: float
    setup_s: float
    latency_s: np.ndarray  # every offered frame's latency (a tick's, for each of its frames)
    frames_done: int  # frames returned inside the window
    wait_s: np.ndarray  # each timed call's start less its due time (open loop)
    call_s: np.ndarray  # each timed call's wall time
    step_s: np.ndarray  # the host time of each timed call inside the pipeline's step
    stretches: list  # trace.Stretch of the traced run: [plain, with stacks]
    b1_shape: tuple  # (M, N, K) of the configuration's Hough score matmul
    config: dict  # the cell's configuration


class Call(NamedTuple):
    frames_at: int  # the schedule's call index
    now: float  # host clock (time.time) when the call returned: the sessions' clock
    moves: list  # each board's committed uci or None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, control: bool = False):
    """One run of ``cell``: (the result line's object, with ``control`` the
    lower-precision control's comparison beside it; the Record its metrics
    were read from)."""
    import torch

    from benchmark import compare, schedule
    from benchmark import trace as tr
    from benchmark.roofline import b1_shape

    t_start = T_PROCESS if t_start is None else t_start
    config, on_card = cell.config, torch.device(device).type == "cuda"
    traffic = schedule.Traffic.from_json(cell.traffic, seconds)
    corners = rig_corners(config, seed)
    scripts = [schedule.BoardScript(traffic, seed, b) for b in range(config["boards"])]
    bank = render_bank(config, scripts, corners, traffic.renders, seed, device)
    frames = Frames(bank, scripts, traffic.renders)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    driver_mod = load_file(cell.root, "drivers", config["session"])
    drv = driver_mod.Driver(config, corners, device)
    calls: list = []

    def call(c: int):
        moves = drv.call(frames(c))
        calls.append(Call(c, time.time(), moves))

    drv.capture(frames(0))
    for c in range(traffic.warmup_calls):
        call(c)
    if on_card:
        torch.cuda.synchronize()
    # What set-up made lives through the window: keep the collector's full
    # passes off it, so that they do not land in the window at random.
    gc.collect()
    gc.freeze()

    # -- the timed window
    c = traffic.warmup_calls
    waits, walls, steps, lat = [], [], [], []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    close = t0 + seconds
    if traffic.loop == "open":
        n_due = int(round(traffic.rate_hz * seconds))
        done = 0
        for i in range(n_due):
            due = t0 + i / traffic.rate_hz
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
            start = time.perf_counter()
            if start >= close:
                break
            call(c)
            c += 1
            end = time.perf_counter()
            waits.append(start - due)
            walls.append(end - start)
            steps.append(drv.step_s)
            lat.append(end - due)
            done += end <= close
        lat += [close - (t0 + i / traffic.rate_hz) for i in range(len(lat), n_due)]
        window_s, attempted, frames_done = float(seconds), n_due, done
    else:
        end = t0
        while True:
            start = time.perf_counter()
            if start >= close:
                break
            call(c)
            c += 1
            end = time.perf_counter()
            walls.append(end - start)
            steps.append(drv.step_s)
        window_s = end - t0
        lat = np.repeat(walls, drv.boards)
        attempted = frames_done = len(walls) * drv.boards
    timed_calls = len(walls)

    # -- the traced stretches
    stretches = []
    if trace:
        from torch.profiler import record_function

        for with_stack in (False, True):
            torch.cuda.synchronize()
            fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
            os.close(fd)
            try:
                with tr.device_trace(path, with_stack):
                    tr.sleep_pads()
                    s0 = time.perf_counter()
                    for j in range(traffic.trace_calls):
                        if traffic.loop == "open":
                            wait = s0 + j / traffic.rate_hz - time.perf_counter()
                            if wait > 0:
                                time.sleep(wait)
                        with record_function(tr.CALL_RANGE):
                            call(c)
                        c += 1
                    torch.cuda.synchronize()
                stretches.append(tr.read(path))
            finally:
                os.remove(path)

    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(device))
        kind = torch.cuda.get_device_name(torch.device(device))
    else:
        peak, kind = 0, "cpu"

    # -- the program's answers, then the plain reference's
    program = compare.Answers(
        outputs=list(drv.outputs),
        blocked=drv.blocked(),
        commits=compare.commits_of([x.moves for x in calls], drv.boards),
        fens=drv.final_fens(),
    )
    boards, rules = drv.boards, driver_mod.REFERENCE
    drv.close()
    del drv, driver_mod
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = compare.replay(config, cell.root, rules, corners, bank, frames, calls, device)
    checks = compare.compare(program, ref, config["limits"])
    ref_s = time.perf_counter() - t_ref
    control_checks = None
    if control:
        low = compare.replay(config, cell.root, rules, corners, bank, frames, calls, device,
                             control=True)
        control_checks = compare.compare(low, ref, config["limits"])

    record = Record(
        window_s=window_s, setup_s=setup_s,
        latency_s=np.asarray(lat, np.float64), frames_done=frames_done,
        wait_s=np.asarray(waits), call_s=np.asarray(walls), step_s=np.asarray(steps),
        stretches=stretches, b1_shape=b1_shape(config["frame_size"], boards), config=config,
    )
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"], cell.root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": int(attempted),
              "failed": int(attempted - frames_done), "metrics": metrics, "device": dev}
    if stretches:
        plain, stacked = stretches
        dev["busy_s"], dev["window_s"] = plain.busy_s, plain.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in plain.device_ops[:10]],
                               "idle_gaps": [list(x) for x in stacked.idle_gaps[:10]]}
    log(f"{cell.name} seed {seed}: {timed_calls} timed calls, {len(calls)} in all, "
        f"commits {[len(x) for x in program.commits]} (reference "
        f"{[len(x) for x in ref.commits]}), reference replay {ref_s:.1f} s")
    if control_checks is not None:
        result["control"] = control_checks
        for k, v in control_checks.items():
            log(f"control {k}: {v['value']!r} (limit {v['limit']!r})")
    for k, v in checks.items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    result["checks"] = checks
    gc.unfreeze()
    return result, record


def forbidden_loaded() -> list:
    """The top-level names in ``sys.modules`` (compared whole) that no run
    may load: jax, jaxlib, flax, chessboard_vision_tpu."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def card_missing(cell: Cell) -> Optional[str]:
    """Why the cell cannot run here, or None when its CUDA cards are present."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n >= cell.chips:
        return None
    return (f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, {n} found")


def main(argv=None, device: str = "cuda") -> int:
    """One run; ``device`` other than "cuda" skips the look for a card (the
    CPU tests drive a whole run so)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(ROOT, args.workload)
    missing = card_missing(cell) if device == "cuda" else None
    if missing:
        log(f"FAIL: {missing}")
        return NO_CARD_RC
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), device=device)
    # Last, after the traced stretches, the reference's replay and every
    # metric reader: nothing may have loaded JAX or the JAX package.
    found = forbidden_loaded()
    if found:
        log(f"FAIL: modules loaded in this process: {', '.join(found)}")
        return FORBIDDEN_RC
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
