"""Image, array and CSV IO helpers (stdlib PNG codec and csv; no imageio or pandas)."""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from simplenerf_torch.data import png


def read_csv(path: Path) -> dict[str, list[str]]:
    """A headed CSV file as {column: [cell strings]}."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: [r[i] for r in body] for i, name in enumerate(header)}


def write_csv(path: Path, columns: dict[str, list]) -> None:
    """{column: values} -> a headed CSV file; floats keep full precision."""

    def cell(v):
        return repr(float(v)) if isinstance(v, (float, np.floating)) else str(v)

    names = list(columns)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(names)
        for row in zip(*(columns[n] for n in names)):
            writer.writerow([cell(v) for v in row])


def read_image(path: Path) -> np.ndarray:
    path = Path(path)
    if path.suffix == ".png":
        return png.decode(path.read_bytes())
    if path.suffix == ".npy":
        return np.load(path.as_posix())
    raise RuntimeError(f"Unknown image format: {path}")


def read_mask(path: Path) -> np.ndarray:
    path = Path(path)
    if path.suffix == ".png":
        return png.decode(path.read_bytes()) == 255
    if path.suffix == ".npy":
        return np.load(path.as_posix())
    raise RuntimeError(f"Unknown mask format: {path}")


def write_image(path: Path, image: np.ndarray) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(png.encode(image))


def write_depth(path: Path, depth: np.ndarray, as_png: bool = True) -> None:
    """Save raw depth as .npy and optionally an 8-bit visualization png."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path.with_suffix(".npy").as_posix(), depth)
    if as_png:
        lo, hi = float(np.min(depth)), float(np.max(depth))
        vis = (depth - lo) / (hi - lo) if hi > lo else np.zeros_like(depth)
        write_image(path.with_suffix(".png"), np.round(vis * 255).astype(np.uint8))
