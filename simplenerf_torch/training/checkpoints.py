"""Checkpoint save/restore in the JAX package's msgpack format.

The bytes are those of `flax.serialization.to_bytes` on
{"iteration", "params", "opt_state"} (lists stored as {"0": ..., "1": ...}
maps, arrays as ext-type ndarrays), written with the port's own codec, so a
checkpoint written by either package loads into the other. Files follow the
reference naming (`Model_IterNNNNNN` + a `Model_Latest` pointer).

Loading checks the saved tree against a target tree (structure and shapes):
the same architecture-drift guard as the JAX package's target pytree.

The optimizer state has the JAX package's flat-Adam layout,
{"0": {"count", "mu", "nu"}, "1": {"count"}} (optax's adam state and its
schedule count): mu and nu are flat float32 vectors in
`jax.flatten_util.ravel_pytree` order of the params (dict keys sorted,
lists in order; `flat_leaves`), so Adam moments cross between the packages.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from simplenerf_torch.training import msgpack_codec


def _to_state(tree: Any) -> Any:
    """Tensor tree -> flax state dict (lists as {"0": ...} maps, tensors as float arrays)."""
    if isinstance(tree, dict):
        return {str(k): _to_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_state(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu").numpy()
    return tree


def _from_state(target: Any, state: Any, device, path: str = "params") -> Any:
    """Restore `state` into the structure of `target`, checking keys and shapes."""
    if isinstance(target, dict):
        if not isinstance(state, dict) or set(map(str, target)) != set(state):
            raise ValueError(f"checkpoint structure differs from the model at {path}")
        return {k: _from_state(v, state[str(k)], device, f"{path}.{k}") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(state, dict) or set(state) != {str(i) for i in range(len(target))}:
            raise ValueError(f"checkpoint list length differs from the model at {path}")
        return [_from_state(v, state[str(i)], device, f"{path}.{i}") for i, v in enumerate(target)]
    arr = np.asarray(state)
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"checkpoint shape {arr.shape} != model shape {tuple(target.shape)} at {path}")
    return torch.as_tensor(arr, dtype=target.dtype, device=device)


def save_checkpoint(output_dir: Path, iteration: int, params: Any, opt_state: Any = None) -> Path:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    opt = opt_state_to_state(opt_state) if opt_state is not None else None
    state = {"iteration": int(iteration), "params": _to_state(params), "opt_state": opt}
    path = output_dir / f"Model_Iter{iteration:06}.msgpack"
    path.write_bytes(msgpack_codec.packb(state))
    latest = output_dir / "Model_Latest.msgpack"
    if latest.exists() or latest.is_symlink():
        latest.unlink()
    latest.symlink_to(path.name)
    return path


def latest_checkpoint(output_dir: Path) -> Optional[Path]:
    latest = Path(output_dir) / "Model_Latest.msgpack"
    return latest if latest.exists() else None


def flat_leaves(tree: Any) -> list:
    """The leaves of a params tree in ravel_pytree order: dict keys sorted,
    lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flat_leaves(v)]
    return [tree]


def opt_state_to_state(opt_state: dict) -> dict:
    """{"count": int, "mu", "nu": flat tensors} -> the JAX checkpoint layout."""
    count = np.asarray(int(opt_state["count"]), np.int32)
    return {
        "0": {"count": count, "mu": _to_state(opt_state["mu"]), "nu": _to_state(opt_state["nu"])},
        "1": {"count": count.copy()},
    }


def opt_state_from_state(state: Any, params: Any, device) -> Optional[dict]:
    """The JAX checkpoint layout -> {"count", "mu", "nu"} on `device`, checked
    against the params tree.

    As the JAX package's `load_checkpoint` does: moments saved as per-leaf
    trees (checkpoints from before the flat-vector Adam) are restored through
    the params tree and ravelled in `flat_leaves` order, with a warning (Adam
    is elementwise, so the flat state is the same state); a layout that
    cannot be read gives None, with a warning, and the caller keeps fresh
    optimizer state.
    """
    size = sum(p.numel() for p in flat_leaves(params))
    try:
        adam = state["0"]
        count = int(np.asarray(adam["count"]))
        if isinstance(adam["mu"], dict) and isinstance(adam["nu"], dict):
            mu, nu = (torch.cat([leaf.reshape(-1) for leaf in flat_leaves(
                _from_state(params, adam[k], torch.device(device), f"opt_state.{k}"))]).float()
                for k in ("mu", "nu"))
            warnings.warn("migrated per-leaf Adam checkpoint state to the flat-vector layout")
        else:
            mu, nu = (torch.as_tensor(np.asarray(adam[k], np.float32), device=device)
                      for k in ("mu", "nu"))
        if mu.shape != (size,) or nu.shape != (size,):
            raise ValueError(f"checkpoint Adam moments {tuple(mu.shape)} != flat params ({size},)")
    except (ValueError, KeyError, TypeError, IndexError):
        warnings.warn("checkpoint optimizer state layout is unrecognizable; "
                      "resuming with FRESH optimizer state (Adam moments reset)")
        return None
    return {"count": count, "mu": mu, "nu": nu}


def load_checkpoint(path: Path, params_target: Any, device="cpu"):
    """(iteration, params on `device`, raw opt_state) from a checkpoint.

    params_target fixes the expected tree; the optimizer state is returned
    as the decoded raw tree and not interpreted.
    """
    raw = msgpack_codec.restore(Path(path).read_bytes())
    params = _from_state(params_target, raw["params"], torch.device(device))
    return int(raw["iteration"]), params, raw.get("opt_state")
