"""utils/profiling of the port vs the JAX package's, on the CPU.

FpsCounter must count as the JAX class counts. device_trace is a
torch.profiler scope: on the CPU it records the ops of its block and
writes a Chrome trace. (The port's spans and call table:
tests/test_torch_tracing.py.)

aggregate_device_op_ms reads torch's Chrome trace: device records
("kernel", "gpu_memcpy", "gpu_memset" events) joined by "correlation" to
the runtime call that launched them on a host thread, whose enclosing
"python_function" spans give the port's frames. The card's traces cannot
be made here, so synthetic traces in that layout hold it to the JAX
function's cases (tests/test_profiling.py), and the same logical trace in
both layouts must give both functions the same dict. A real CPU trace of a
port step holds the stack reader to torch's own format.
"""

import gzip
import json
import time

import numpy as np
import pytest
import torch

from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame

from chessboard_vision_tpu.utils import profiling as jprof
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline
from chessboard_vision_tpu_torch.utils import profiling as tprof

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)


@pytest.mark.parametrize("mod", [jprof, tprof], ids=["jax", "port"])
def test_fps_counter_window(mod):
    c = mod.FpsCounter(window=0.0)  # every update refreshes
    c.update()
    time.sleep(0.01)
    assert c.update() > 0 and c.fps > 0
    slow = mod.FpsCounter(window=3600.0)
    assert slow.update() == 0.0 and slow.fps == 0.0  # inside the window: no reading yet


def test_device_trace_records_the_block_and_writes_a_chrome_trace(tmp_path):
    x = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        y = (x @ x).sum()
    assert float(y) > 0
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# -- aggregate_device_op_ms on torch's trace layout ---------------------------

HOST_PID, HOST_TID = 4242, 4242
DEVICE_PID, DEVICE_TID = 0, 7
PORT = "chessboard_vision_tpu_torch/"
STAGES = {"ops/canny.py": "hough", "ops/color.py": "color"}


class TorchTrace:
    """A Chrome trace laid out as torch.profiler writes one on the card.
    Each ``launch`` nests its Python frames (outermost first, torch's
    "path(line): name" spans) around a cudaLaunchKernel on the host thread
    and puts the kernel on the device lane with the call's correlation."""

    def __init__(self):
        self.events = [
            {"ph": "M", "name": "process_name", "pid": HOST_PID, "tid": 0,
             "args": {"name": "python"}},
            {"ph": "M", "name": "process_name", "pid": DEVICE_PID, "tid": 0,
             "args": {"name": "python"}},
        ]
        self.t = 1000.0
        self.corr = 100

    def _span(self, cat, name, ts, dur, pid=HOST_PID, tid=HOST_TID, **args):
        self.events.append({"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
                            "ts": ts, "dur": dur, "args": args})

    def launch(self, stack, dur_us, kernel="void k<1>(float*)", resolved=True, cat="kernel",
               returned=None):
        """``returned``: a frame called by the innermost one that returned
        before the launch."""
        t0, depth = self.t, len(stack)
        for i, frame in enumerate(stack):
            self._span("python_function", frame, t0 + i, 100.0 - 2 * i)
        if returned:
            self._span("python_function", returned, t0 + depth, 0.5)
        self.corr += 1
        if resolved:
            self._span("cuda_runtime", "cudaLaunchKernel", t0 + depth + 1, 2.0,
                       cbid=211, correlation=self.corr)
        self._span(cat, kernel, t0 + 50, dur_us, pid=DEVICE_PID, tid=DEVICE_TID,
                   correlation=self.corr, device=0, stream=7)
        self.t += 200.0 + dur_us

    def host_op(self, name, dur_us):
        self._span("cpu_op", name, self.t, dur_us)
        self.t += dur_us + 10

    def write(self, path):
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "trace.json", "w") as fh:
            json.dump({"schemaVersion": 1, "traceEvents": self.events}, fh)
        return str(path)


def _frames(module, caller="models/pipeline.py"):
    """A launch's stack: the test, the pipeline's step, the module."""
    return ["test_torch_profiling.py(1): test", f"{PORT}{caller}(300): step",
            f"{PORT}{module}(42): op"]


def _jax_trace(tmp_path, ops):
    """The JAX layout of tests/test_profiling.py: (source, us) device ops."""
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    events = [{"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/device:TPU:0"}},
              {"ph": "M", "pid": 2, "name": "process_name", "args": {"name": "/host:CPU"}}]
    for pid, source, us in ops:
        events.append({"ph": "X", "pid": pid, "tid": 1, "ts": 0, "dur": us, "name": "op",
                       "args": {"long_name": "fusion.1", "source": f"{source}:42"}})
    with gzip.open(d / "host.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    return str(tmp_path)


def test_aggregate_groups_by_stage_and_divides(tmp_path):
    tr = TorchTrace()
    tr.launch(_frames("ops/canny.py"), 4000)
    tr.launch(_frames("ops/canny.py"), 1000)
    tr.launch(_frames("ops/color.py"), 2000, cat="gpu_memcpy")
    tr.launch(_frames("ops/warp.py"), 500, cat="gpu_memset")  # -> other
    tr.host_op("aten::conv2d", 9000)  # host lane: not a device record
    got = tprof.aggregate_device_op_ms(tr.write(tmp_path / "t"), stage_of=STAGES, per=2)
    assert got == {"hough": 2.5, "color": 1.0, "other": 0.25}
    assert list(got) == ["hough", "color", "other"]  # largest stage first


def test_aggregate_excludes_sources_and_device_spans(tmp_path):
    tr = TorchTrace()
    tr.launch(_frames("ops/canny.py"), 1000)
    tr.launch(_frames("models/pipeline.py", caller="parallel/multistream.py"), 8000)
    # a span on the device lane that is not a record (an annotation)
    tr._span("gpu_user_annotation", "step", 0, 7000, pid=DEVICE_PID, tid=DEVICE_TID)
    got = tprof.aggregate_device_op_ms(tr.write(tmp_path / "t"), stage_of=STAGES,
                                       exclude_sources=("models/pipeline.py",))
    assert got == {"hough": 1.0}


def test_aggregate_empty_and_host_only_traces(tmp_path):
    assert tprof.aggregate_device_op_ms(str(tmp_path)) == {}  # no trace
    tr = TorchTrace()
    tr.host_op("aten::conv2d", 9000)
    tr._span("python_function", f"{PORT}ops/canny.py(42): canny", 0, 50000)
    assert tprof.aggregate_device_op_ms(tr.write(tmp_path / "t"), stage_of=STAGES) == {}


def test_same_logical_trace_same_dict_as_jax(tmp_path):
    """One logical trace, (source module, device us) ops, in the TPU layout
    for the JAX function and in torch's for the port's: the same dict."""
    ops = [("ops/canny.py", 4000), ("ops/canny.py", 1250), ("ops/color.py", 2000),
           ("ops/warp.py", 500), ("ops/fsm.py", 125), ("models/pipeline.py", 3000)]
    stages = dict(STAGES, **{"ops/fsm.py": "fsm"})
    jax_ops = [(1, f"chessboard_vision_tpu/{m}", us) for m, us in ops]
    jax_ops.append((2, "chessboard_vision_tpu/ops/canny.py", 9000))  # host pid
    tr = TorchTrace()
    for m, us in ops:
        tr.launch(_frames(m), us)
    tr.host_op("aten::add", 9000)
    for kw in (dict(per=1), dict(per=4), dict(per=3, exclude_sources=("models/pipeline.py",))):
        want = jprof.aggregate_device_op_ms(_jax_trace(tmp_path / "jax" / str(kw["per"]), jax_ops),
                                            stage_of=stages, **kw)
        got = tprof.aggregate_device_op_ms(tr.write(tmp_path / "port"), stage_of=stages, **kw)
        assert got == want and list(got) == list(want)
        assert want  # the JAX side read its trace


def test_walks_outward_to_the_innermost_mapped_frame(tmp_path):
    """A record goes to the innermost port frame with a key: B1's wrapper
    under the conv Hough takes its own stage when the map names it, else
    the caller's; a helper with no key (xla_rounding) and frames outside
    the port (torch's) pass it to the caller."""
    tr = TorchTrace()
    b1 = _frames("kernels/score_matmul.py", caller="ops/hough_conv.py")
    tr.launch(b1, 300, kernel="score_matmul_kernel<1, 1>")
    tr.launch([f"{PORT}models/pipeline.py(300): step", f"{PORT}ops/change.py(80): update",
               f"{PORT}ops/xla_rounding.py(20): fma", "torch/functional.py(9): einsum"], 200)
    tr.launch([f"{PORT}ops/layout.py(5): to_planar"], 100,
              returned=f"{PORT}ops/change.py(9): helper")
    td = tr.write(tmp_path / "t")
    hough = {"ops/hough_conv.py": "hough", "ops/change.py": "change_model"}
    assert tprof.aggregate_device_op_ms(td, stage_of=hough) == {
        "hough": 0.3, "change_model": 0.2, "other": 0.1}
    with_b1 = {"kernels/score_matmul.py": "b1", **hough}
    assert tprof.aggregate_device_op_ms(td, stage_of=with_b1) == {
        "b1": 0.3, "change_model": 0.2, "other": 0.1}
    rows = tprof.device_op_rows(td)
    assert rows[0][0] == "score_matmul_kernel<1, 1>"
    assert rows[0][1] == ("kernels/score_matmul.py(42): op", "ops/hough_conv.py(300): step")
    assert [f.split("(")[0] for f in rows[1][1]] == [
        "ops/xla_rounding.py", "ops/change.py", "models/pipeline.py"]
    assert rows[2][1] == ("ops/layout.py(5): to_planar",)  # not the call that returned
    # excluded by the innermost PORT frame (torch's einsum frame is not one)
    assert tprof.aggregate_device_op_ms(td, stage_of=hough,
                                        exclude_sources=("ops/xla_rounding.py",)) == {
        "hough": 0.3, "other": 0.1}


def test_unresolved_correlation_lands_in_other(tmp_path):
    """A record whose launch is not in the trace, and one launched from no
    port frame, go to "other": the stages sum to the device total."""
    tr = TorchTrace()
    tr.launch(_frames("ops/canny.py"), 700)
    tr.launch(_frames("ops/canny.py"), 450, resolved=False)
    tr.launch(["chip_smoke.py(10): _pad"], 50, kernel="spin_kernel(long)")
    td = tr.write(tmp_path / "t")
    got = tprof.aggregate_device_op_ms(td, stage_of=STAGES)
    assert got == {"hough": 0.7, "other": 0.5}
    total = sum(e["dur"] for e in tr.events if e.get("cat") == "kernel") / 1e3
    assert sum(got.values()) == pytest.approx(total)
    assert [r[1] for r in tprof.device_op_rows(td)][1:] == [(), ()]


def test_real_cpu_trace_of_a_port_step(tmp_path):
    """A port step on the CPU through device_trace: no device records, so
    {} (as the JAX function on a CPU trace), while the trace's own host ops
    resolve through the stack reader to the port's modules."""
    g = tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe = VisionPipeline(g, device="cpu", hough_backend="conv")
    frame = make_board_frame(initial_occupancy(), np.random.default_rng(0))
    state = pipe.capture_reference(pipe.init_state(), frame)
    td = str(tmp_path / "trace")
    with tprof.device_trace(td):
        pipe.step(state, frame)
    assert tprof.aggregate_device_op_ms(td, stage_of=STAGES) == {}
    assert tprof.device_op_rows(td) == []
    events = tprof.load_trace(td)
    stacks = tprof.PythonStacks(events)
    modules = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            frames = stacks.port_frames(e["pid"], e["tid"], e["ts"])
            if frames:
                modules.setdefault(tprof.frame_path(frames[0]), set()).add(e["name"])
    assert {"ops/filters.py", "ops/hough_conv.py", "ops/canny.py"} <= set(modules)
    assert "aten::mul" in modules["ops/filters.py"]  # the Gaussian blur's taps
    assert all(f.startswith(("ops/", "models/", "kernels/")) for f in modules)
