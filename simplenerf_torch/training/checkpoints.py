"""Checkpoint save/restore in the JAX package's msgpack format.

The bytes are those of `flax.serialization.to_bytes` on
{"iteration", "params", "opt_state"} (lists stored as {"0": ..., "1": ...}
maps, arrays as ext-type ndarrays), written with the port's own codec, so a
checkpoint written by either package loads into the other. Files follow the
reference naming (`Model_IterNNNNNN` + a `Model_Latest` pointer).

Loading checks the saved tree against a target tree (structure and shapes):
the same architecture-drift guard as the JAX package's target pytree.
"""

from __future__ import annotations

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
    state = {"iteration": int(iteration), "params": _to_state(params), "opt_state": _to_state(opt_state)}
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


def load_checkpoint(path: Path, params_target: Any, device="cpu"):
    """(iteration, params on `device`, raw opt_state) from a checkpoint.

    params_target fixes the expected tree; the optimizer state is returned
    as the decoded raw tree and not interpreted.
    """
    raw = msgpack_codec.restore(Path(path).read_bytes())
    params = _from_state(params_target, raw["params"], torch.device(device))
    return int(raw["iteration"]), params, raw.get("opt_state")
