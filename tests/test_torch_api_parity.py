"""The port does all the JAX package does: its public surface, by name.

Both packages are read with ``ast`` (nothing is imported, so neither jax
nor torch is needed): every public function, class, method and parameter
of ``chessboard_vision_tpu/`` must have a counterpart of the same name in
the port's module of the same path (a name the port's module imports from
another module of the port counts, with that definition's parameters).
The only exceptions are ``NOT_CARRIED`` (the TPU's form, not its function,
or a class the port replaced: its methods go with it) and ``RENAMED`` (the port's idiom for the same thing: its counterpart, a
name or an argparse option, and a reason).
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "chessboard_vision_tpu")
PORT_ROOT = os.path.join(REPO, "chessboard_vision_tpu_torch")
PORT_PACKAGE = "chessboard_vision_tpu_torch"

# Keys: "module" (a whole module), "module::name" (a function, class or
# Class.method) or "module::name(param)".
NOT_CARRIED = {
    "ops/pallas/__init__.py": "the Pallas kernels' package; the kernels are twinned in kernels/",
    "ops/pallas/bilateral.py": "the TPU kernel B2 and its TPU-shape check; twinned by "
                               "kernels/bilateral.cu behind ops/enhance.bilateral_planar",
    "ops/pallas/clahe_apply.py": "the TPU kernels B3/B4 in their one-hot layouts; twinned by "
                                 "kernels/clahe.cu behind ops/enhance.clahe",
    "ops/static_resample.py": "a TPU gather workaround; its host helper to_planar is "
                              "ops/layout.py, its resample the warp and matmul resample",
    "models/pipeline.py::nested_scan": "a remote-compiler hang workaround of the TPU's scan",
    "models/pipeline.py::VisionPipeline.step_many(inner_chunk)": "nested_scan's chunking",
    "models/pipeline.py::VisionPipeline.__init__(donate_state)": "XLA buffer donation",
    "parallel/mesh.py::replicated": "a GSPMD sharding: torch has no global sharded array",
    "parallel/mesh.py::stream_sharding(axis)": "GSPMD axis names: the port's mesh axes are fixed",
    "parallel/mesh.py::stream_square_sharding(data_axis)": "GSPMD axis names",
    "parallel/mesh.py::stream_square_sharding(space_axis)": "GSPMD axis names",
    "parallel/mesh.py::shard_pytree_leading_axis(axis)": "GSPMD axis names",
    "parallel/mesh.py::shard_pytree_stream_square(data_axis)": "GSPMD axis names",
    "parallel/mesh.py::shard_pytree_stream_square(space_axis)": "GSPMD axis names",
    "utils/profiling.py::StageTimer": "read by nothing, and its synchronising form slowed what "
                                      "it timed; the port times its layers with spans "
                                      "(utils/profiling.span, recorded_calls)",
}
ARGPARSE = "an option of the tool's argparse main(argv)"
RENAMED = {
    "models/enhancer.py::ImageEnhancerTPU": ("ImageEnhancer", "the port's class runs on any "
                                             "device, named by device="),
    "tools/calibrate_colors.py::main(camera_id)": ("--camera", ARGPARSE),
    "tools/calibrate_piece_detector.py::main(camera_id)": ("--camera", ARGPARSE),
    "tools/calibrate_sensitivity.py::main(camera_id)": ("--camera", ARGPARSE),
    "tools/enhance_demo.py::main(camera_id)": ("--camera", ARGPARSE),
    "ops/matmul_resample.py::assemble_board_from_tiles(starts)": (
        "index", "the index form: one gather by a tile index built once"),
    "ops/matmul_resample.py::assemble_board_from_tiles(board_size)": (
        "index", "the index form"),
    "ops/matmul_resample.py::warp_board_color(starts)": ("index", "the index form"),
    "ops/matmul_resample.py::warp_board_color(board_size)": ("index", "the index form"),
}


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _surface(path: str) -> dict:
    """A module's public names: {"f": params, "C": None, "C.m": params},
    and the names it imports from the port: {name: (module path, name)}."""
    tree = ast.parse(open(path).read())
    defs, imports = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                defs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            defs[node.name] = None
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (not sub.name.startswith("_")
                                                         or sub.name == "__init__"):
                    defs[f"{node.name}.{sub.name}"] = _params(sub)
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(PORT_PACKAGE):
            module = node.module[len(PORT_PACKAGE) + 1:].replace(".", "/")
            for alias in node.names:
                imports[alias.asname or alias.name] = (module, alias.name)
    return {"defs": defs, "imports": imports}


def _modules(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py") and "__pycache__" not in dirpath:
                path = os.path.join(dirpath, f)
                out[os.path.relpath(path, root)] = _surface(path)
    return out


JAX, PORT = _modules(JAX_ROOT), _modules(PORT_ROOT)


def _port_lookup(module: str, name: str):
    """(found, params) of ``name`` in the port's ``module``, following an
    import to the port module that defines it."""
    surface = PORT.get(module)
    if surface is None:
        return False, None
    if name in surface["defs"]:
        return True, surface["defs"][name]
    head = name.split(".")[0]
    if head in surface["imports"]:
        src_module, src_name = surface["imports"][head]
        for candidate in (src_module + ".py", src_module + "/__init__.py"):
            if candidate in PORT:
                return _port_lookup(candidate, src_name + name[len(head):])
    return False, None


def _gaps() -> list:
    """Every JAX name or parameter without a counterpart, as allowlist keys."""
    gaps = []
    for module, surface in sorted(JAX.items()):
        if module in NOT_CARRIED:
            continue
        if module not in PORT:
            gaps.append(module)
            continue
        for name, params in sorted(surface["defs"].items()):
            key = f"{module}::{name}"
            head = name.split(".")[0]
            if key in NOT_CARRIED or f"{module}::{head}" in NOT_CARRIED:
                continue  # a class not carried takes its methods with it
            renamed = RENAMED.get(f"{module}::{head}")
            port_name = renamed[0] + name[len(head):] if renamed else name
            found, port_params = _port_lookup(module, port_name)
            if not found:
                gaps.append(key)
                continue
            for p in params or []:
                pkey = f"{key}({p})"
                if p not in port_params and pkey not in NOT_CARRIED and pkey not in RENAMED:
                    gaps.append(pkey)
    return gaps


def test_every_public_name_and_parameter_has_a_counterpart():
    assert _gaps() == []


@pytest.mark.parametrize("key", sorted(NOT_CARRIED) + sorted(RENAMED))
def test_allowlist_entries_name_real_jax_surface(key):
    """Each allowlist entry names something the JAX package has (a stale
    entry would hide a future gap), and each renamed counterpart exists."""
    module, _, rest = key.partition("::")
    assert module in JAX, key
    if not rest:
        return
    name, _, param = rest.partition("(")
    assert name in JAX[module]["defs"], key
    if param:
        assert param.rstrip(")") in (JAX[module]["defs"][name] or []), key
    if key not in RENAMED:
        return
    counterpart = RENAMED[key][0]
    if not param:
        assert _port_lookup(module, counterpart)[0], key
    elif counterpart.startswith("--"):  # an option of the port's argparse main
        assert f'"{counterpart}"' in open(os.path.join(PORT_ROOT, module)).read(), key
    else:
        assert counterpart in (_port_lookup(module, name)[1] or []), key


def _cpu_device_defaults(path: str) -> list:
    """Public functions and methods of a module whose ``device`` parameter
    defaults to "cpu", as "path:line name"."""
    out = []
    for node in ast.walk(ast.parse(open(path).read())):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name.startswith("_") and node.name != "__init__":
            continue
        a = node.args
        positional = a.posonlyargs + a.args
        defaults = [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
        for arg, default in zip(positional + a.kwonlyargs, defaults + list(a.kw_defaults)):
            if (arg.arg == "device" and isinstance(default, ast.Constant)
                    and default.value == "cpu"):
                out.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {node.name}")
    return out


def test_no_public_builder_defaults_device_to_the_cpu():
    """The port's entry points and builders run on the card unless the
    caller names the CPU (device.resolve_device): a ``device="cpu"``
    default would hand a caller on the card CPU tensors in silence, where
    the JAX counterpart places its arrays on the accelerator."""
    found = [hit for root, _, files in os.walk(PORT_ROOT) for f in sorted(files)
             if f.endswith(".py") for hit in _cpu_device_defaults(os.path.join(root, f))]
    assert found == []
