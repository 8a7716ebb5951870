"""The single-board step as one CUDA graph (utils/graphs.py, ``VisionPipeline.step``).

On the card a conv pipeline without the enhancer captures a kind of call
(frame shape, dtype, host or tensor, the ``use_`` flags) on its third call
and replays it from then on. Held here:

- the rule: graphs engage on the card, conv backend, no enhancer, and
  nowhere else; CPU pipelines (conv and exact) never capture;
- the upload into a given buffer, and the packed buffers' layout;
- the mechanism on the CPU, with the capture stood in for by running the
  captured body at capture and at each replay (what a graph replays): the
  step's results against the eager step's, the state passed in left as it
  was, returned tensors never written by later calls, the counters;
- the module caches a step reads never evict (a graph reads their tensors
  at the addresses it captured);
- on the card (marked ``cuda``, skipped without one): the same clip, the
  graphed step bit-equal to the eager one on every output and state leaf,
  the counters, B1's launch count, threads sharing one pipeline, replays
  after the module caches churned, and a pipeline on a card that is not
  the current one (skipped with fewer than two cards).

The module imports neither jax nor cv2; on a machine with only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_graph_step.py
"""

import functools
import sys
import threading
import types
from collections import Counter

import numpy as np
import pytest
import torch

from chessboard_vision_tpu_torch.geometry import BoardGeometry
from chessboard_vision_tpu_torch.kernels import score_matmul as sm
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy
from chessboard_vision_tpu_torch.ops import hough_conv
from chessboard_vision_tpu_torch.utils import graphs as ug
from chessboard_vision_tpu_torch.utils.checkpoint import tree_fill, tree_leaves, tree_map
from chessboard_vision_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

CPU_SIZE = (240, 320)  # (H, W) of the CPU tests' frames
CARD_SIZE = (720, 1280)  # the player's camera
S2C = {(0, 0), (3, 4), (4, 6), (7, 7)}

# The clip: (frame index, step keywords, state swapped in before the call).
# Every kind of call the session makes (full and smart scans, a refresh), a
# state from capture_reference and one through numpy, and both use_ flags
# off, each kind past its capture.
CLIP = [
    (0, {}, None),
    (1, {"squares_to_check": S2C}, None),
    (2, {"squares_to_check": S2C}, None),
    (0, {"refresh_refs": True}, None),
    (1, {"squares_to_check": S2C}, "capture_reference"),
    (2, {"squares_to_check": S2C}, None),
    (0, {}, "state_from_numpy"),
    (1, {"squares_to_check": S2C, "use_smoothing": False}, None),
    (2, {"squares_to_check": S2C, "use_delta": False}, None),
    (0, {"use_smoothing": False}, None),
    (1, {"squares_to_check": S2C, "use_smoothing": False, "refresh_refs": True}, None),
    (2, {"use_delta": False}, None),
    (0, {"squares_to_check": S2C, "use_delta": False}, None),
    (1, {"squares_to_check": S2C}, None),
    (2, {"squares_to_check": S2C}, "capture_reference"),
]


@pytest.fixture(autouse=True)
def empty_table():
    tprof.clear()
    yield
    tprof.clear()


def _scene(size):
    h, w = size
    corners = bench_corners(h, w)
    g = BoardGeometry.from_calibration(corners, display_size=(w, h))
    cam = SynthCamera(corners, frame_size=(h, w), board_px=g.board_size)
    rng = np.random.default_rng(21)
    occ = initial_occupancy()
    moved = occ.copy()
    moved[4, 1], moved[4, 3] = False, True  # e2e4, [file, rank]
    frames = [cam.render(occ, rng), cam.render(occ, rng), cam.render(moved, rng)]
    return g, frames


def _counts() -> Counter:
    total = Counter()
    for call in tprof.recorded_calls():
        total.update(call.counts)
    return total


def _graph_counts() -> tuple:
    c = _counts()
    return c["pipeline.graph_captures"], c["pipeline.graph_replays"]


def _assert_same(got, want, where):
    got_leaves, want_leaves = tree_leaves(got), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for i, (x, y) in enumerate(zip(got_leaves, want_leaves)):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{where}: leaf {i}"
        assert torch.equal(x, y), f"{where}: leaf {i} differs"


def _snapshot(tree) -> tuple:
    return tuple(x.clone() for x in tree_leaves(tree))


def _kinds(clip) -> Counter:
    """Calls of each kind the graphs key on (host frames throughout)."""
    return Counter((kw.get("use_smoothing", True), kw.get("use_delta", True)) for _, kw, _ in clip)


def run_clip(pipe, eager, frames, clip=CLIP):
    """Step ``pipe`` and the eager ``eager(state, frame, kw)`` through the
    clip on one chain of states: every call bit-equal, the state passed in
    unchanged by the call, each returned tree unchanged two calls later."""
    state = pipe.capture_reference(pipe.init_state(), frames[0])
    kept = []  # (returned tree, its snapshot)
    for i, (k, kw, swap) in enumerate(clip):
        if swap == "capture_reference":
            state = pipe.capture_reference(state, frames[k])
        elif swap == "state_from_numpy":
            state = tp.state_from_numpy(tp.state_to_numpy(state), device=pipe.device)
        passed = _snapshot(state)
        got = pipe.step(state, frames[k], **kw)
        _assert_same(got, eager(state, frames[k], kw), f"call {i}")
        _assert_same(state, passed, f"call {i}: the state passed in")
        kept.append((got, _snapshot(got)))
        if i >= 2:
            old, snap = kept[i - 2]
            assert all(torch.equal(x, y) for x, y in zip(tree_leaves(old), snap)), \
                f"call {i} wrote what call {i - 2} returned"
        state = got[0]


# -- the rule, on the CPU ------------------------------------------------------


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("backend", ["conv", "exact"])
@pytest.mark.parametrize("enhancer", [False, True])
def test_graphs_engage_on_the_card_with_conv_and_no_enhancer(device, backend, enhancer):
    want = device == "cuda" and backend == "conv" and not enhancer
    assert tp.graphs_engage(torch.device(device), backend, enhancer) is want


@pytest.mark.parametrize("backend", ["conv", "exact"])
def test_cpu_pipelines_never_capture(backend):
    """A CPU pipeline has no graphs and counts no capture or replay over
    repeated calls of one kind; each step equals a one-frame step_many."""
    g, frames = _scene(CPU_SIZE)
    pipe = tp.VisionPipeline(g, hough_backend=backend, device="cpu")
    assert pipe._graphs is None
    state = pipe.capture_reference(pipe.init_state(), frames[0])
    for i in range(4):
        s2c = S2C if i % 2 else None
        got = pipe.step(state, frames[i % 3], squares_to_check=s2c)
        st, out = pipe.step_many(state, frames[i % 3][None], squares_to_check=s2c)
        _assert_same(got, (st, tp.StepOutputs(*(x[0] for x in out))), f"call {i}")
        state = got[0]
    assert _graph_counts() == (0, 0)


# -- the parts, on the CPU -----------------------------------------------------


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "tensor"])
def test_upload_into_a_given_buffer(on_device):
    """``_upload`` with ``out`` lands the frame and the flags in it and
    returns views of it, equal to what a fresh upload returns."""
    g, frames = _scene(CPU_SIZE)
    pipe = tp.VisionPipeline(g, hough_backend="conv", device="cpu")
    frame = torch.as_tensor(frames[1]) if on_device else frames[1]
    mask = tp.positions_to_mask(S2C)
    buf = torch.zeros(frames[1].size + 66, dtype=torch.uint8)
    got = pipe._upload(frame, mask, (True, False), out=buf)
    want = pipe._upload(frame, mask, (True, False))
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
        assert x.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
    assert got[1].dtype == torch.bool and bool(got[2][0]) and not bool(got[2][1])


def test_packed_layout_round_trips_a_state():
    """A state and outputs packed into one buffer: each leaf on a 16-byte
    boundary, views of that buffer, the tree rebuilt leaf for leaf."""
    g, frames = _scene(CPU_SIZE)
    pipe = tp.VisionPipeline(g, hough_backend="conv", device="cpu")
    tree = pipe.step(pipe.capture_reference(pipe.init_state(), frames[0]), frames[1])
    spec, n = ug.layout(tree_leaves(tree))
    assert n % 16 == 0 and all(at % 16 == 0 for at, *_ in spec)
    buf = torch.empty(n, dtype=torch.uint8)
    vs = ug.views(buf, spec)
    for v, x in zip(vs, tree_leaves(tree)):
        v.copy_(x)
    back = tree_fill(tree_map(lambda _: 0, tree), iter(vs))
    assert type(back) is tuple and type(back[0]) is tp.PipelineState
    assert type(back[1]) is tp.StepOutputs
    _assert_same(back, tree, "round trip")
    assert {x.untyped_storage().data_ptr() for x in tree_leaves(back)} == {buf.data_ptr()}


def test_a_key_warms_up_eagerly_then_keeps_its_graph():
    graphs = ug.StepGraphs(torch.device("cpu"))
    assert [graphs.get("a", 8) for _ in range(ug.WARMUP)] == [None] * ug.WARMUP
    assert graphs.get("b", 8) is None
    first = graphs.get("a", 8)
    assert first is not None and first.inputs.shape == (8,)
    assert graphs.get("a", 8) is first and graphs.get("b", 8) is None


def _port_lru_caches() -> dict:
    """Every ``functools.lru_cache`` of the port's modules, by its name."""
    found = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("chessboard_vision_tpu_torch.") and mod is not None:
            for attr, obj in list(vars(mod).items()):
                if hasattr(obj, "cache_info") and getattr(obj, "__module__", None) == name:
                    found[f"{name}.{attr}"] = obj
    return found


def test_module_caches_a_step_reads_never_evict(monkeypatch):
    """A graph reads a module cache's tensor at the address it captured and
    never calls the cache again, so every cache a conv step calls keeps its
    entries. B1's K aligned to 8, as on the card, puts the planes' zero
    tail on the path."""
    monkeypatch.setattr(hough_conv, "k_align_for", lambda device: 8)
    g, frames = _scene(CPU_SIZE)
    pipe = tp.VisionPipeline(g, hough_backend="conv", device="cpu")
    state = pipe.capture_reference(pipe.init_state(), frames[0])
    caches = _port_lru_caches()

    def calls(f):
        info = f.cache_info()
        return info.hits + info.misses

    before = {name: calls(f) for name, f in caches.items()}
    for i in range(2):
        state, _ = pipe.step(state, frames[i + 1], squares_to_check=S2C if i else None)
    called = {name for name, f in caches.items() if calls(f) > before[name]}
    assert "chessboard_vision_tpu_torch.ops.hough_conv._zero_tail" in called
    assert [name for name in called if caches[name].cache_info().maxsize is not None] == []


# -- the mechanism on the CPU, the capture stood in for ---------------------------


@pytest.fixture
def stand_in_capture(monkeypatch):
    """Capture by running the body once and replay by running it again:
    what a graph does, on the CPU."""

    def captured(body, graphs):
        body()
        return types.SimpleNamespace(replay=body)

    monkeypatch.setattr(ug, "_captured", captured)


def _graphed_cpu_pipeline(g):
    pipe = tp.VisionPipeline(g, hough_backend="conv", device="cpu")
    pipe._graphs = ug.StepGraphs(pipe.device)
    return pipe


def _eager_by(pipe):
    def eager(state, frame, kw):
        return pipe.step(state, frame, **kw)
    return eager


def test_graphed_clip_matches_the_eager_step(stand_in_capture):
    g, frames = _scene(CPU_SIZE)
    run_clip(_graphed_cpu_pipeline(g), _eager_by(tp.VisionPipeline(g, hough_backend="conv",
                                                                   device="cpu")), frames)
    kinds = _kinds(CLIP)
    assert _graph_counts() == (sum(n > ug.WARMUP for n in kinds.values()),
                               sum(max(n - ug.WARMUP, 0) for n in kinds.values()))


def test_one_kind_captures_once_and_replays_every_later_call(stand_in_capture):
    g, frames = _scene(CPU_SIZE)
    pipe = _graphed_cpu_pipeline(g)
    state = pipe.capture_reference(pipe.init_state(), frames[0])
    calls = 6
    for i in range(calls):
        state, _ = pipe.step(state, frames[i % 3], squares_to_check=S2C if i % 2 else None)
    assert _graph_counts() == (1, calls - ug.WARMUP)


def test_a_state_the_graph_cannot_take_runs_eagerly(stand_in_capture):
    """A state with another leaf dtype runs the step eagerly (no replay),
    with the eager step's results; the graph then takes its own states."""
    g, frames = _scene(CPU_SIZE)
    pipe = _graphed_cpu_pipeline(g)
    eager = tp.VisionPipeline(g, hough_backend="conv", device="cpu")
    state = pipe.capture_reference(pipe.init_state(), frames[0])
    for i in range(3):
        state, _ = pipe.step(state, frames[i])
    odd = state._replace(piece=state.piece._replace(hist_len=state.piece.hist_len.long()))
    _assert_same(pipe.step(odd, frames[1]), eager.step(odd, frames[1]), "odd state")
    assert _graph_counts() == (1, 1)
    pipe.step(state, frames[2])
    assert _graph_counts() == (1, 2)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _eager_step_many(pipe):
    """The eager step on the card: a one-frame ``step_many`` (never graphed)."""

    def eager(state, frame, kw):
        kw = dict(kw)
        refresh = kw.pop("refresh_refs", False)
        st, out = pipe.step_many(state, frame[None], refresh_first=refresh, **kw)
        return st, tp.StepOutputs(*(x[0] for x in out))

    return eager


@pytest.mark.cuda
def test_card_graphed_clip_is_bit_equal_to_eager(cuda):
    g, frames = _scene(CARD_SIZE)
    pipe = tp.VisionPipeline(g, device=cuda)
    assert pipe._graphs is not None
    run_clip(pipe, _eager_step_many(tp.VisionPipeline(g, device=cuda)), frames)
    kinds = _kinds(CLIP)
    assert _graph_counts() == (sum(n > ug.WARMUP for n in kinds.values()),
                               sum(max(n - ug.WARMUP, 0) for n in kinds.values()))


@pytest.mark.cuda
def test_card_tensor_frames_replay_their_own_graph(cuda):
    """HWC frames already on the card (the gather route) and planar ones:
    a graph each, bit-equal to eager."""
    g, frames = _scene(CARD_SIZE)
    pipe = tp.VisionPipeline(g, device=cuda)
    eager = _eager_step_many(tp.VisionPipeline(g, device=cuda))
    hwc = [torch.as_tensor(f, device=cuda) for f in frames]
    planar = [f.permute(2, 0, 1).contiguous() for f in hwc]
    clip = [(k % 3, {"squares_to_check": S2C} if k % 2 else {}, None) for k in range(5)]
    run_clip(pipe, eager, hwc, clip)
    run_clip(pipe, eager, planar, clip)
    assert _graph_counts() == (2, 2 * (5 - ug.WARMUP))


@pytest.mark.cuda
def test_card_one_kind_captures_once_and_launches_b1_each_call(cuda):
    g, frames = _scene(CARD_SIZE)
    pipe = tp.VisionPipeline(g, device=cuda)
    state = pipe.capture_reference(pipe.init_state(), frames[0])
    calls = 8
    for i in range(calls):
        before = sm.score_matmul.launches
        state, _ = pipe.step(state, frames[i % 3], squares_to_check=S2C if i % 2 else None)
        assert sm.score_matmul.launches == before + 1, f"call {i}"
    torch.cuda.synchronize()
    assert _graph_counts() == (1, calls - ug.WARMUP)


@pytest.mark.cuda
def test_card_replays_survive_the_module_caches_churning(cuda, monkeypatch):
    """After the capture, 40 other zero tails cached, then every free byte
    of the allocator's small pool taken by NaN blocks: the zero tail the
    graph captured is still owned by its cache, and each replay equals
    the eager step."""
    g, frames = _scene(CARD_SIZE)
    pipe = tp.VisionPipeline(g, device=cuda)
    eager = _eager_step_many(tp.VisionPipeline(g, device=cuda))
    state = pipe.capture_reference(pipe.init_state(), frames[0])
    for i in range(ug.WARMUP):
        state, _ = pipe.step(state, frames[i % 3])
    cached, tails = hough_conv._zero_tail, []

    def spy(n, width, device):  # keeps the address, not the tensor
        tail = cached(n, width, device)
        tails.append((tail.data_ptr(), tail.numel() * tail.element_size()))
        return tail

    monkeypatch.setattr(hough_conv, "_zero_tail", spy)
    state, _ = pipe.step(state, frames[ug.WARMUP % 3])  # the capture
    monkeypatch.setattr(hough_conv, "_zero_tail", cached)
    assert _graph_counts() == (1, 1) and len(tails) == 1  # B1's K = 1256 at 720p: a tail of 6
    for width in range(100, 140):
        hough_conv._zero_tail(64, width, cuda)
    stats = torch.cuda.memory_stats(cuda)
    free = stats["reserved_bytes.small_pool.current"] - stats["allocated_bytes.small_pool.current"]
    nan = [torch.full((512,), float("nan"), dtype=torch.bfloat16, device=cuda)
           for _ in range(free // 1024 + 1)]
    (at, nbytes), = tails
    assert not [x for x in nan if x.data_ptr() < at + nbytes and at < x.data_ptr() + 1024], \
        "the captured zero tail was freed and its bytes reused"
    for i in range(3):
        got = pipe.step(state, frames[i % 3])
        _assert_same(got, eager(state, frames[i % 3], {}), f"replay {i}")
        state = got[0]
    assert _graph_counts() == (1, 4)


@pytest.mark.cuda
def test_card_a_pipeline_on_a_card_not_current(cuda):
    """A pipeline on the second card while the first is current captures
    and replays on its own card, and leaves the first current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    g, frames = _scene(CARD_SIZE)
    pipe = tp.VisionPipeline(g, device=other)
    clip = [(k % 3, {"squares_to_check": S2C} if k % 2 else {}, None) for k in range(6)]
    run_clip(pipe, _eager_step_many(tp.VisionPipeline(g, device=other)), frames, clip)
    assert torch.cuda.current_device() == 0
    assert _graph_counts() == (1, len(clip) - ug.WARMUP)


@pytest.mark.cuda
def test_card_threads_share_one_graphed_pipeline(cuda):
    """16 threads, each its own chain of states through one pipeline, a
    short switch interval: every chain equals the eager chain."""
    g, frames = _scene(CARD_SIZE)
    pipe = tp.VisionPipeline(g, device=cuda)
    ref = pipe.capture_reference(pipe.init_state(), frames[0])
    seq = [(i % 3, S2C if i % 2 else None) for i in range(6)]
    eager = tp.VisionPipeline(g, device=cuda)
    want, state = [], ref
    for k, s2c in seq:
        state, out = eager.step_many(state, frames[k][None], squares_to_check=s2c)
        want.append((state, tp.StepOutputs(*(x[0] for x in out))))
    results, errors = {}, []

    def chain(t):
        try:
            st, got = ref, []
            for k, s2c in seq:
                st, out = pipe.step(st, frames[k], squares_to_check=s2c)
                got.append((st, out))
            results[t] = got
        except Exception as e:  # reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=chain, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(results) == 16
    for t, got in results.items():
        for i, (x, y) in enumerate(zip(got, want)):
            _assert_same(x, y, f"thread {t} call {i}")
