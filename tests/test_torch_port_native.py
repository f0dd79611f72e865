"""The port's native splat (simplenerf_torch.native, warp.cpp built with g++)
against its numpy plain version and the JAX package's splat.

- the splat on seeded inputs (tests/test_native.py's case), with and
  without a mask: the native op, the port's numpy plain version and the
  JAX package's `masks.bilinear_splat` agree at 1e-10, the validity masks
  exactly;
- the reference's integral-position quirk (four coincident corners);
- MaskComputer and `generate_visibility_masks` through the native splat
  equal to the JAX package's and to the plain version's;
- the build: the library lands under build/native/ with a hash of the
  source, the compiler and its flags in its name; a missing compiler, and
  a source that does not compile, raise (with the compiler's stderr); bad
  shapes raise before any pointer is passed.
"""

import numpy as np
import pytest

from simplenerf_tpu.qa import masks as jmasks
from simplenerf_torch import native
from simplenerf_torch.qa import masks


def _splat_inputs(seed=7, h=37, w=53, c=3):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0, 1, (h, w, c))
    # positions scattered inside and slightly outside the canvas
    trans = np.stack([rng.uniform(-3, w + 2, (h, w)), rng.uniform(-3, h + 2, (h, w))], axis=-1)
    depth = rng.uniform(0.1, 10.0, (h, w))
    mask = rng.uniform(0, 1, (h, w)) > 0.2
    return values, trans, depth, mask


def _assert_three_agree(values, trans, depth, mask):
    got = masks.bilinear_splat(values, trans.copy(), depth, mask)
    plain = masks.bilinear_splat(values, trans.copy(), depth, mask, plain=True)
    jax_side = jmasks.bilinear_splat(values, trans.copy(), depth, mask)
    for want in (plain, jax_side):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-10)
    return got


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
def test_native_splat_matches_plain_version_and_jax(masked):
    values, trans, depth, mask = _splat_inputs()
    out, valid = _assert_three_agree(values, trans, depth, mask if masked else None)
    assert valid.any() and not valid.all()


def test_integral_positions_quirk():
    """Integral positions hit four coincident corners (reference quirk)."""
    h, w = 8, 8
    values = np.ones((h, w, 1))
    trans = np.stack(np.meshgrid(np.arange(w), np.arange(h)), axis=-1).astype(float)
    out, valid = _assert_three_agree(values, trans, np.ones((h, w)), None)
    assert valid.all()
    acc, acc_w = native.bilinear_splat_accumulate(values, trans, np.ones((h, w)), None)
    # Each pixel's weight lands 4x on its own (shifted) canvas cell: 4 / e^50.
    np.testing.assert_allclose(acc_w[1:-1, 1:-1], 4 / np.exp(50.0), rtol=1e-12)


def _mask_scene(seed=3, h=24, w=32):
    rng = np.random.default_rng(seed)
    depth1 = rng.uniform(2.0, 6.0, (h, w))
    depth2 = depth1 * rng.uniform(0.97, 1.03, (h, w))
    t2 = np.eye(4)
    t2[0, 3] = 0.2
    k = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    frame = rng.uniform(0, 255, (h, w, 3))
    return frame, depth1, depth2, np.eye(4), t2, k


def test_mask_computer_native_equals_plain_and_jax():
    frame, d1, d2, t1, t2, k = _mask_scene()
    got = masks.MaskComputer().compute_mask(frame, d1, d2, t1, t2, k, k)
    np.testing.assert_array_equal(got, masks.MaskComputer(plain=True).compute_mask(frame, d1, d2, t1, t2, k, k))
    np.testing.assert_array_equal(got, jmasks.MaskComputer().compute_mask(frame, d1, d2, t1, t2, k, k))
    assert 0.05 < got.mean() < 0.95


def test_generate_visibility_masks_equal_jax(tmp_path):
    frame, d1, d2, t1, t2, k = _mask_scene(4)
    train = {0: {"frame": frame, "depth": d1, "extrinsic": t1, "intrinsic": k},
             2: {"depth": d2, "extrinsic": t2, "intrinsic": k}}
    test = {5: {"depth": d2, "extrinsic": t2, "intrinsic": k},
            6: {"depth": d1, "extrinsic": t1, "intrinsic": k}}
    masks.generate_visibility_masks(tmp_path / "port", "s", train, test)
    jmasks.generate_visibility_masks(tmp_path / "jax", "s", train, test)
    names = sorted(p.name for p in (tmp_path / "port/s/visibility_masks").iterdir())
    assert names == ["0005_0000.npy", "0005_0002.npy", "0006_0000.npy", "0006_0002.npy"]
    for name in names:
        np.testing.assert_array_equal(np.load(tmp_path / "port/s/visibility_masks" / name),
                                      np.load(tmp_path / "jax/s/visibility_masks" / name))


def test_build_lands_under_build_native_keyed_on_a_hash(monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert native.BUILD_DIR.parent.parent == native.SOURCE.parents[2]  # the repository root
    native.load()
    assert path.exists() and path.name.startswith("libwarp_") and len(path.stem) == len("libwarp_") + 16
    monkeypatch.setattr(native, "CXX_FLAGS", (*native.CXX_FLAGS, "-DSNERF_OTHER_FLAGS"))
    assert native.library_path() != path


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-dir/g++"))
    with pytest.raises(RuntimeError, match="not found"):
        masks.bilinear_splat(*_splat_inputs(h=4, w=5))
    assert list(tmp_path.iterdir()) == []  # no partial library left behind


def test_failed_compile_raises_with_the_compilers_stderr(monkeypatch, tmp_path):
    bad = tmp_path / "warp.cpp"
    bad.write_text("extern \"C\" void bilinear_splat( { this is not C++ }\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.load()
    assert list((tmp_path / "build").iterdir()) == []


def test_bad_shapes_raise_before_the_call():
    values, trans, depth, mask = _splat_inputs(h=4, w=5)
    with pytest.raises(ValueError):
        native.bilinear_splat_accumulate(values, trans[:, :4], depth, mask)
    with pytest.raises(ValueError):
        native.bilinear_splat_accumulate(values, trans, depth, mask[:3])
