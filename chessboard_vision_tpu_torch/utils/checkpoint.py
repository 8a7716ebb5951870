"""Session checkpoints: device-state trees + host metadata in one npz.

Counterpart of chessboard_vision_tpu.utils.checkpoint, in the same format:
``np.savez_compressed`` with the tree's leaves as ``leaf_<i>`` in
NamedTuple field order (depth first, the order ``jax.tree.leaves`` gives
the JAX package's states, None dropped as there) plus a JSON metadata blob
(``__meta__``). So a checkpoint written by either package resumes in the
other. Loading fills a template tree (e.g. ``pipeline.init_state()``), so
the format needs no pickled structure.
"""

from __future__ import annotations

import json
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

from chessboard_vision_tpu_torch.device import resolve_device


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of nested (Named)tuples in field order, None dropped."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def _fill(template: Any, leaves: Iterator[Any]) -> Any:
    if template is None:
        return None
    if isinstance(template, tuple):
        children = [_fill(node, leaves) for node in template]
        return type(template)(*children) if hasattr(template, "_fields") else tuple(children)
    return next(leaves)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of trees of one structure, taken in turn; the
    result has ``tree``'s structure."""
    leaves = [fn(*xs) for xs in zip(tree_leaves(tree), *map(tree_leaves, rest))]
    return _fill(tree, iter(leaves))


def _host_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def read_meta(path: str) -> dict:
    """The JSON metadata of a checkpoint, without its leaves."""
    with np.load(path) as data:
        return json.loads(bytes(data["__meta__"].tobytes()).decode("utf-8"))


def save_tree(path: str, tree: Any, meta: dict) -> None:
    """Save a tree's leaves (tensors on any device, or arrays) and a
    JSON-serializable metadata dict."""
    arrays = {
        f"leaf_{i}": leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
        else np.asarray(leaf)
        for i, leaf in enumerate(tree_leaves(tree))
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_tree(path: str, template: Any, device="cuda") -> Tuple[Any, dict]:
    """Load (tree, meta): structure, shapes and dtypes from ``template``,
    leaves as tensors on ``device`` (the card unless the caller asks for
    the CPU)."""
    device = resolve_device(device, "load_tree")
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode("utf-8"))
        leaves = []
        for i, tmpl in enumerate(tree_leaves(template)):
            arr = data[f"leaf_{i}"]
            want_shape, want = tuple(np.shape(tmpl)), _host_dtype(tmpl)
            if arr.shape != want_shape:
                if arr.ndim == 0 and arr.dtype == np.bool_ == want:
                    # Legacy leaf: a bool flag later widened from a scalar
                    # to a vector (ChangeModelState.calibrated, () -> (64,))
                    # broadcasts losslessly. Bool only: broadcasting any
                    # scalar would hide a checkpoint whose leaf order moved.
                    arr = np.broadcast_to(arr, want_shape).copy()
                elif (
                    arr.ndim == 3
                    and len(want_shape) == 2
                    and arr.shape[0] == want_shape[0]
                    and arr.shape[1] * arr.shape[2] == want_shape[1]
                ):
                    # Legacy leaf: the change model's means/variances moved
                    # from (64, H, W) to flat (64, H*W); the row-major
                    # flatten is value-identical.
                    arr = arr.reshape(want_shape)
                else:
                    raise ValueError(
                        f"checkpoint leaf {i} shape {arr.shape} != template "
                        f"{want_shape}: was the pipeline built with a different geometry?"
                    )
            leaves.append(torch.as_tensor(np.ascontiguousarray(arr, dtype=want), device=device))
    return _fill(template, iter(leaves)), meta
