"""The float32 kernels' 3xTF32 product core, emulated on the CPU, against
the JAX package.

The float32 forward and row-pass kernels (csrc/fused_mlp_tf32_sm90.cuh)
form each float32 product on the tensor cores as three TF32 products:
x = big + small with big = tf32(x) and small = tf32(x - big) (cvt.rna:
round to nearest, ties away from zero), D = A_small B_big + A_big B_small
+ A_big B_big in float32. Here: the split, emulated by bit arithmetic on
the int32 view (`fused_mlp.tf32_halves`), against its definition and
against JAX's `lax.reduce_precision` to TF32; the three-term product
against JAX's float32 `jnp.dot`, and the one-term product (big B_big only)
shown at least ten times worse; the kernel's register fragments and the
packer's permuted K order (`_slab_index`) put together as the hardware
pairs them, against the plain product; the header's constants against the
packer's. The kernels themselves run only on the card
(tests/test_torch_port_cuda.py).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simplenerf_torch.ops import fused_mlp


def _values(seed, n=4096):
    """Float32 values over many binades, signs, exact ties of the 13 low
    bits, and the largest mantissas (which round up into the next binade)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))).astype(np.float32)
    bits = x.view(np.uint32)
    bits[: n // 8] = (bits[: n // 8] & np.uint32(0xFFFFE000)) | np.uint32(0x1000)  # ties
    bits[n // 8 : n // 4] |= np.uint32(0x007FFFFF)  # all mantissa bits set
    return bits.view(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_emulation(seed):
    """big has its 13 low mantissa bits zero and is x rounded to the nearest
    TF32 value, ties away from zero (JAX's reduce_precision rounds ties to
    even: the two agree off the ties); small is TF32 too; big + small gives
    back x to 2^-22 relative."""
    x = _values(seed)
    big, small = (t.numpy() for t in fused_mlp.tf32_halves(torch.from_numpy(x)))
    for h in (big, small):
        assert not np.any(h.view(np.uint32) & np.uint32(0x1FFF))
    want = np.asarray(jax.lax.reduce_precision(jnp.asarray(x), exponent_bits=8, mantissa_bits=10))
    tie = (x.view(np.uint32) & np.uint32(0x1FFF)) == 0x1000
    assert tie.sum() >= len(x) // 8
    np.testing.assert_array_equal(big[~tie], want[~tie])
    assert np.all(np.abs(big[tie]) > np.abs(x[tie]))  # away from zero
    x64 = x.astype(np.float64)
    assert np.all(np.abs(big.astype(np.float64) - x64) <= 2.0**-11 * np.abs(x64))
    assert np.all(np.abs(big.astype(np.float64) + small - x64) <= 2.0**-22 * np.abs(x64))


def _products(a, b):
    """(three-term, one-term) 3xTF32 emulations of a @ b in float32."""
    ab, as_ = fused_mlp.tf32_halves(torch.from_numpy(a))
    bb, bs = fused_mlp.tf32_halves(torch.from_numpy(b))
    return ((as_ @ bb + ab @ bs + ab @ bb).numpy(), (ab @ bb).numpy())


@pytest.mark.parametrize("shape", [(64, 63, 256), (64, 256, 256), (37, 256, 128)])
def test_three_term_product_matches_jax_dot(shape):
    """The three-term product is as close to the exact product as JAX's
    float32 jnp.dot is (within a few times, both at float32 rounding); the
    one-term product, TF32 alone, is at least ten times further."""
    m, k, n = shape
    rng = np.random.default_rng(k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    jdot = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b), precision=jax.lax.Precision.HIGHEST))
    three, one = _products(a, b)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    err_j = np.abs(jdot - exact).max()
    err_3 = np.abs(three - exact).max()
    err_1 = np.abs(one - exact).max()
    assert np.abs(three - jdot).max() <= 8 * 2.0**-24 * k * scale.max() / np.sqrt(k)
    assert err_3 <= 4 * err_j, (err_3, err_j)
    assert err_1 >= 10 * err_3, (err_1, err_3)


@pytest.mark.parametrize("n", [64, 128])
def test_fragments_and_permuted_chunks_form_the_product(n):
    """The kernel's A fragments (thread quad position t of rows g, g + 8
    loads the float2 at columns 2t, 2t + 1 of each k8 step) and the
    packer's chunk image (slot p of each 8-deep group holds K row
    _TF32_PERM[p]), paired as wgmma pairs them (fragment element a0 with
    slot t, a2 with slot t + 4), form X @ W exactly as JAX's dot does."""
    k = 64
    rng = np.random.default_rng(n)
    x = rng.standard_normal((64, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)  # (K, N)
    idx = fused_mlp._slab_index(k, n, n, 0, f32=True)
    image = np.where(idx >= 0, w.reshape(-1)[np.maximum(idx, 0)], 0.0).astype(np.float32)
    chunks = image.astype(np.float64).reshape(k // 32, n // 64, 64, 8, 4)  # slab, chunk, row, group, float
    x64 = x.astype(np.float64)
    got = np.zeros((64, n))
    for row in range(64):
        for col in range(n):
            ch, r = divmod(col, 64)
            for kb in range(k // 32):
                # the chunk's row r, its 16-byte groups read through the 128-byte swizzle
                b = chunks[kb, ch, r][np.arange(8) ^ (r % 8)].reshape(32)
                for s in range(4):
                    for t in range(4):
                        c = kb * 32 + 8 * s + 2 * t  # the float2 the thread loads
                        a_lo, a_hi = x64[row, c], x64[row, c + 1]  # fragment a0 / a2 (a1 / a3 at g + 8)
                        got[row, col] += a_lo * b[8 * s + t] + a_hi * b[8 * s + t + 4]
    want = np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(w), precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, x64 @ w.astype(np.float64), rtol=1e-12, atol=1e-12)


def test_split_image_halves_reassemble_the_image():
    """tf32_split's plain version: each 8 KB chunk becomes its big image,
    then its small image, and the two add back to the chunk to 2^-22."""
    rng = np.random.default_rng(5)
    image = torch.from_numpy(rng.standard_normal(3 * fused_mlp._TF32_CHUNK_FLOATS).astype(np.float32))
    out = fused_mlp.tf32_split(image).view(3, 2, fused_mlp._TF32_CHUNK_FLOATS)
    big, small = fused_mlp.tf32_halves(image.view(3, -1))
    assert torch.equal(out[:, 0], big) and torch.equal(out[:, 1], small)
    x = image.double().view(3, -1)
    assert torch.all((out[:, 0].double() + out[:, 1].double() - x).abs() <= 2.0**-22 * x.abs())
    with pytest.raises(ValueError):
        fused_mlp.tf32_split(image[:-1])


def test_tf32_header_constants_match_the_packer():
    """The chunk geometry of csrc/fused_mlp_tf32_sm90.cuh is the packer's,
    and its comment states the packer's K permutation."""
    text = (Path(fused_mlp.__file__).resolve().parent / "csrc" / "fused_mlp_tf32_sm90.cuh").read_text()
    vals = {"kRows": 64, "kBlockBytes": fused_mlp._SM90_KBLOCK}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", text):
        vals[name] = eval(expr, {}, vals)
    assert vals["kChunkRows"] == fused_mlp._TF32_CHUNK_ROWS
    assert vals["kSlabK"] == fused_mlp._TF32_DEPTH
    assert vals["kChunkFloats"] == fused_mlp._TF32_CHUNK_FLOATS
    assert vals["kSlotBytes"] == fused_mlp._TF32_SLOT
    assert " ".join(map(str, fused_mlp._TF32_PERM)) in " ".join(text.split())
