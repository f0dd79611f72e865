"""Sinusoidal positional encoding.

Channel layout of the reference PositionalEncoder: identity first, then per
frequency [sin(x*2^0), cos(x*2^0), sin(x*2^1), ...], each over all input
dims. Frequencies ascend, so the first (2*d+1)*3 channels are exactly a
degree-d encoding, which the points-augmentation model relies on.

`encode_parts` gives the same channels in the "blocked" order
[x | sin f0..f_{D-1} | cos f0..f_{D-1}] that the MLP and the kernel read;
`blocked_to_reference_perm` maps between the two; `take_rows` applies
such a map to a weight's rows.
"""

from __future__ import annotations

import functools

import torch


def out_dim(degree: int, input_dims: int = 3) -> int:
    """Channels produced for `degree` frequency octaves (incl. identity)."""
    return (2 * degree + 1) * input_dims


def encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Positional-encode (..., d) -> (..., (2*degree+1)*d), reference order."""
    if degree == 0:
        return x
    feats = [x]
    for i in range(degree):
        scaled = x * (2.0**i)
        feats.append(torch.sin(scaled))
        feats.append(torch.cos(scaled))
    return torch.cat(feats, dim=-1)


def frequency_matrix(degree: int, input_dims: int = 3, device=None) -> torch.Tensor:
    """B (d, d*degree) with B[j, d*i + j] = 2^i."""
    b = torch.zeros((input_dims, input_dims * degree), dtype=torch.float32, device=device)
    for i in range(degree):
        for j in range(input_dims):
            b[j, input_dims * i + j] = 2.0**i
    return b


def encode_parts(x: torch.Tensor, degree: int):
    """(x, sin, cos) blocks, sin/cos shaped (..., 3*degree), frequency-major.

    The scaled coordinates z[..., 3i+j] = x[..., j] * 2^i are formed by a
    broadcast product rather than `x @ frequency_matrix`: both are exact
    (one power-of-two factor per channel), and the product cannot be routed
    through reduced-precision matmul units.
    """
    if degree == 0:
        return x, None, None
    freqs = 2.0 ** torch.arange(degree, dtype=x.dtype, device=x.device)
    z = (freqs[:, None] * x[..., None, :]).reshape(*x.shape[:-1], x.shape[-1] * degree)
    return x, torch.sin(z), torch.cos(z)


def blocked_to_reference_perm(degree: int, input_dims: int = 3) -> list[int]:
    """perm such that encode(x)[..., perm[k]] == blocked channel k."""
    d = input_dims
    perm = list(range(d))
    for i in range(degree):  # sin block
        perm.extend(d + 2 * d * i + j for j in range(d))
    for i in range(degree):  # cos block
        perm.extend(d + 2 * d * i + d + j for j in range(d))
    return perm


@functools.lru_cache(maxsize=None)
def _rows_on(rows: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.long, device=device)


def take_rows(w: torch.Tensor, rows) -> torch.Tensor:
    """w[rows] for host row indices (a `blocked_to_reference_perm`), with
    the indices made once per device and kept there: a CUDA graph of the
    train step cannot copy them from the host at each step."""
    return w.index_select(0, _rows_on(tuple(rows), w.device))
