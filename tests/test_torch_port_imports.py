"""simplenerf_torch stands alone: no JAX package, no host libraries the card
machine lacks; its PNG and msgpack codecs agree with imageio and flax."""

import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_torch.data import png
from simplenerf_torch.device import resolve_device
from simplenerf_torch.training import msgpack_codec

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ["jax", "flax", "optax", "simplenerf_tpu", "pandas", "imageio", "msgpack", "cv2",
             "matplotlib", "tensorboard", "lpips"]


def test_port_imports_without_jax_or_host_libraries():
    # A subprocess: this test process has JAX loaded already (tests/conftest.py).
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "simplenerf_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    assert len(modules) >= 20


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)


@pytest.mark.parametrize("channels", [0, 3, 4])
def test_png_matches_imageio(tmp_path, channels):
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.default_rng(channels)
    shape = (13, 17) if channels == 0 else (13, 17, channels)
    # Smooth ramps plus noise, so the foreign encoder picks every filter type.
    ramp = np.add.outer(np.arange(13), np.arange(17)) * 7
    img = ((ramp.reshape(13, 17, *([1] if channels else [])) + rng.integers(0, 9, shape)) % 256).astype(np.uint8)
    # Ours -> imageio.
    path = tmp_path / "ours.png"
    path.write_bytes(png.encode(img))
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
    # imageio -> ours.
    path2 = tmp_path / "theirs.png"
    imageio.imwrite(path2, img)
    np.testing.assert_array_equal(png.decode(path2.read_bytes()), img)


def test_png_all_filter_types():
    """Rows filtered with each of the five PNG filters decode exactly."""
    import struct
    import zlib

    rng = np.random.default_rng(7)
    h, w, c = 5, 6, 3
    img = rng.integers(0, 256, (h, w, c)).astype(np.int64)
    stride = w * c
    flat = img.reshape(h, stride)
    rows = []
    for y in range(h):
        prior = flat[y - 1] if y else np.zeros(stride, np.int64)
        line = flat[y]
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        p = left + prior - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        filt = [line, line - left, line - prior, line - (left + prior) // 2, line - paeth][y]
        rows.append(bytes([y]) + bytes((filt & 0xFF).astype(np.uint8)))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)

    def chunk(k, d):
        return struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF)

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")
    np.testing.assert_array_equal(png.decode(data), img.astype(np.uint8))


def _tree(rng):
    return {
        "iteration": 12345,
        "params": {"coarse": {"pts": {"0": {"w": rng.standard_normal((63, 4)).astype(np.float32),
                                             "b": np.zeros(4, np.float32)}},
                              "pts_out": {"w": rng.standard_normal((4, 1)).astype(np.float32)}}},
        "opt_state": {"0": {"count": np.asarray(3, np.int32), "lr": 0.5, "name": "x" * 40,
                             "neg": -70000, "flag": True, "none": None}, "1": {}},
    }


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), (a, b)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _flax_bytes(fser, tree):
    # in_place: as `to_bytes` (what checkpoints use) calls it, keeping key
    # order; the copying path re-sorts dict keys through a tree_map.
    return fser.msgpack_serialize(copy.deepcopy(tree), in_place=True)


def test_msgpack_matches_flax():
    fser = pytest.importorskip("flax.serialization")
    tree = _tree(np.random.default_rng(0))
    theirs = _flax_bytes(fser, tree)
    ours = msgpack_codec.packb(tree)
    assert ours == theirs
    _assert_tree_equal(msgpack_codec.restore(theirs), fser.msgpack_restore(theirs))
    _assert_tree_equal(fser.msgpack_restore(ours), tree)
    # Sizes that need the 16- and 32-bit headers.
    big = {"a" * 300: np.arange(70000, dtype=np.float32), "m": {str(i): i for i in range(20)},
           "s": "y" * 70000, "u": 2**40, "n": -(2**40)}
    assert msgpack_codec.packb(big) == _flax_bytes(fser, big)
    _assert_tree_equal(msgpack_codec.restore(_flax_bytes(fser, big)), big)


NEW_MODULES = ["simplenerf_torch.losses.visibility", "simplenerf_torch.data.realestate",
               "simplenerf_torch.drivers.realestate", "simplenerf_torch.dataset_tools.splits",
               "simplenerf_torch.dataset_tools.extractors", "simplenerf_torch.priors.colmap"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_prior_and_realestate_modules_stand_alone(module):
    """Each module of the dense-depth, visibility, RealEstate10K and prior
    tools slice imports alone without the JAX package, pandas or OpenCV,
    and its source imports none of them."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    source = (REPO / (module.replace(".", "/") + ".py")).read_text()
    for name in ("jax", "simplenerf_tpu", "pandas", "cv2", "imageio"):
        assert f"import {name}" not in source and f"from {name}" not in source, name
