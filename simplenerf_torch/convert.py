"""Parameter trees between numpy (the JAX package's layout) and tensors.

Both directions keep the canonical layout of `fields/mlp.py`: per MLP name
(`coarse`, `fine`, ...) a dict with `pts` (list of {"w": (fan_in, fan_out),
"b": (fan_out,)}), `pts_out`, and when the views branch exists `feature`,
`views` (list) and `views_out`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device="cpu", dtype: torch.dtype = torch.float32) -> Any:
    """Nested dict/list of arrays (numpy or anything `np.asarray` takes) -> tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return torch.as_tensor(np.array(tree), dtype=dtype, device=device)


def params_to_numpy(tree: Any) -> Any:
    """Nested dict/list of tensors -> the same tree of float numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().to("cpu").numpy()
