"""The port's int8, bitmap, chain and fused wire codecs against the JAX
package's, on the same numpy-made inputs.

Tolerance: none.  Wire bytes, every wire array (indices, int8 codes,
scales, bitmaps, values, shape vectors) and the decoded uploads must be
equal, floats bitwise.  The masked trees come from the reference's own
selective mask, as ``tests/test_wirepath.py`` makes them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as jc
from repro.core import compression as jcomp
from repro.core.masking import MaskingConfig, mask_pytree
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.core import codecs as tc
from repro_torch.core import compression as tcomp
from repro_torch.core import strategy as tst


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a) -> np.ndarray:
    a = _np(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _rand(shape, seed):
    return jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)


@functools.lru_cache()
def _masked(gamma):
    tree = {"w": _rand((300, 77), 0), "b": _rand((7,), 1),
            "e": _rand((7000,), 2)}
    jtree = mask_pytree(jax.random.PRNGKey(3), tree,
                        MaskingConfig(gamma=gamma, mode="selective"))
    return jtree, {k: _t(v) for k, v in jtree.items()}


def _pairings(mod, gamma):
    return {
        "coo": (mod.SparseCodec(gamma=gamma),
                mod.FusedSparseCodec(gamma=gamma)),
        "coo+int8": (mod.ChainCodec((mod.SparseCodec(gamma=gamma),
                                     mod.Int8Codec())),
                     mod.FusedSparseCodec(gamma=gamma, quantized=True)),
        "bitmap": (mod.BitmapCodec(gamma=gamma),
                   mod.FusedSparseCodec(gamma=gamma, wire="bitmap")),
        "bitmap+int8": (mod.ChainCodec((mod.BitmapCodec(gamma=gamma),
                                        mod.Int8Codec())),
                        mod.FusedSparseCodec(gamma=gamma, wire="bitmap",
                                             quantized=True)),
    }


def _assert_wire_equal(got, want, path=()):
    """Same nested structure, dtypes and values (floats bitwise)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _assert_wire_equal(got[key], want[key], path + (key,))
        return
    g, w = _np(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
    np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))


@pytest.mark.parametrize("gamma", [0.1, 0.5])
@pytest.mark.parametrize("pairing", ["coo", "coo+int8", "bitmap",
                                     "bitmap+int8"])
def test_codec_pairing_matches_reference(gamma, pairing):
    """wire_bytes, every wire array and every roundtrip equal the JAX
    package's; the fused roundtrip equals the oracle's bitwise; the
    batched roundtrip_stacked equals the per-client roundtrip."""
    jmasked, masked = _masked(gamma)
    j_oracle, j_fused = _pairings(jc, gamma)[pairing]
    t_oracle, t_fused = _pairings(tc, gamma)[pairing]
    want_bytes = j_fused.wire_bytes(jmasked)
    assert want_bytes == j_oracle.wire_bytes(jmasked)
    assert t_fused.wire_bytes(masked) == t_oracle.wire_bytes(masked) \
        == want_bytes
    assert tc.tree_wire_nbytes(t_fused.encode(masked)) == want_bytes
    assert t_fused.name == j_fused.name and t_oracle.name == j_oracle.name
    _assert_wire_equal(t_fused.encode(masked), j_fused.encode(jmasked))
    _assert_wire_equal(t_oracle.encode(masked), j_oracle.encode(jmasked))

    want = j_fused.roundtrip(jmasked)
    fused = t_fused.roundtrip(masked)
    _assert_wire_equal(fused, want)
    _assert_wire_equal(t_oracle.roundtrip(masked), want)
    stacked = {k: torch.stack([v, 0.5 * v, torch.zeros_like(v)])
               for k, v in masked.items()}
    for codec in (t_fused, t_oracle):
        rows = codec.roundtrip_stacked(stacked)
        for i in range(3):
            one = codec.roundtrip({k: v[i] for k, v in stacked.items()})
            for k in one:
                assert torch.equal(rows[k][i].view(torch.int32),
                                   one[k].view(torch.int32)), (k, i)


@pytest.mark.parametrize("preset,want", [("fig5", 431_184),
                                         ("fig5-fused", 431_184),
                                         ("fig5-int8", 268_966),
                                         ("fig5-fused-int8", 268_966),
                                         ("fig5-bitmap", 229_809)])
def test_lenet28_wire_bytes_match_reference(preset, want):
    """The fused codec counts bytes through its oracle, on a shape-only
    template the kernel wrappers would reject."""
    from repro.core import strategy as jst
    p = jpm.init_lenet(jax.random.PRNGKey(0), image_size=28)
    params = bridge.params_from_numpy(jax.device_get(p), device="cpu")
    assert jst.get(preset).codec.wire_bytes(p) == want
    assert tst.get(preset).codec.wire_bytes(params) == want
    assert tst.get(preset).codec.name == jst.get(preset).codec.name


def test_fused_unquantized_roundtrip_is_lossless():
    """The unquantised fused wire gives back the masked delta exactly (up
    to the sign of zero: the eager reference mask writes -0.0)."""
    masked = _masked(0.5)[1]
    for wire in ("coo", "bitmap"):
        out = tc.FusedSparseCodec(gamma=0.5, wire=wire).roundtrip(masked)
        for k, v in masked.items():
            assert torch.equal(out[k], v)


@pytest.mark.parametrize("poison", [np.inf, np.nan])
@pytest.mark.parametrize("pairing", ["coo+int8", "bitmap+int8"])
def test_nonfinite_upload_decodes_as_in_the_reference(pairing, poison):
    """One client's non-finite entry in a maskable leaf: the reference's
    jitted, vmapped roundtrip and the port's stacked one decode the same
    values (NaN where the reference has NaN: the fused threshold drops a
    NaN, the sort keeps it), and the other clients are untouched."""
    jmasked, masked = _masked(0.5)
    rows = [{k: v.clone() for k, v in masked.items()} for _ in range(3)]
    rows[1]["e"][5] = float(poison)
    stacked = {k: torch.stack([r[k] for r in rows]) for k in masked}
    jstacked = {k: jnp.asarray(v.numpy()) for k, v in stacked.items()}
    for j_codec, t_codec in zip(_pairings(jc, 0.5)[pairing],
                                _pairings(tc, 0.5)[pairing]):
        want = jax.jit(lambda s, c=j_codec: jc.roundtrip_stacked(c, s))(
            jstacked)
        got = tc.roundtrip_stacked(t_codec, stacked)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{t_codec.name} {k}")
        assert torch.equal(got["e"][0], got["e"][2])
        if poison == np.inf:     # a NaN may fail the threshold and vanish
            assert not bool(torch.isfinite(got["e"][1]).all())


# ------------------------------------------------------------------- int8
def test_quantize_int8_matches_reference_with_ties():
    """Round half to even on exact ties, the reciprocal-multiply scale,
    zeros kept, and the row form equal to per-row calls."""
    x = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0, -127.0,
                    3.49, -3.51], np.float32)
    want = jcomp.quantize_int8(jnp.asarray(x))
    got = tcomp.quantize_int8(_t(x))
    _assert_wire_equal(got, want)
    assert got["q"].tolist()[:7] == [127, 0, 2, 2, 0, -2, -2]
    rng = np.random.default_rng(1)
    rows = (rng.standard_normal((4, 300)) * 10.0 ** rng.uniform(
        -6, 3, (4, 1))).astype(np.float32)
    rows[1] = 0.0
    q, scale = tcomp.quantize_int8_rows(_t(rows))
    for i in range(4):
        want = jcomp.quantize_int8(jnp.asarray(rows[i]))
        _assert_wire_equal({"q": q[i], "scale": scale[i]}, want)
        np.testing.assert_array_equal(
            _bits(tcomp.dequantize_int8({"q": q[i], "scale": scale[i]})),
            _bits(jcomp.dequantize_int8(want)))


def test_int8_codes_of_nonfinite_quotients_match_xla():
    """NaN codes as 0 and infinities saturate, as XLA converts them."""
    v = np.asarray([np.nan, np.inf, -np.inf, 300.0, -1e9, 126.5],
                   np.float32)
    want = jax.jit(lambda a: jnp.clip(jnp.round(a), -127, 127).astype(
        jnp.int8))(jnp.asarray(v))
    np.testing.assert_array_equal(tcomp.int8_codes(_t(v)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("bad", ["missing", "dtype", "shape", "nonfinite"])
def test_dequantize_int8_rejects_malformed_payloads(bad):
    good = tcomp.quantize_int8(_t(np.linspace(-1, 1, 50, dtype=np.float32)))
    payload = dict(good)
    if bad == "missing":
        del payload["scale"]
    elif bad == "dtype":
        payload["q"] = payload["q"].to(torch.int16)
    elif bad == "shape":
        payload["scale"] = payload["scale"].reshape(1)
    else:
        payload["scale"] = torch.tensor(float("inf"))
    with pytest.raises(ValueError):
        tcomp.dequantize_int8(payload)
    with pytest.raises(ValueError):
        jcomp.dequantize_int8({k: np.asarray(v) for k, v in payload.items()})


# ----------------------------------------------------------------- bitmap
@pytest.mark.parametrize("k", [3, 4, 20])
def test_bitmap_encode_matches_reference(k):
    masked = np.zeros((20,), np.float32)
    masked[[2, 7, 13, 19]] = [1.0, -2.0, 3.0, 0.5]
    want = jcomp.encode_bitmap(jnp.asarray(masked), k)
    got = tcomp.encode_bitmap(_t(masked), k)
    _assert_wire_equal(got, want)
    _assert_wire_equal(tcomp.decode_bitmap(got), jcomp.decode_bitmap(want))


def _bad_bitmap(bad):
    masked = torch.zeros((20,))
    masked[[2, 7, 13]] = torch.tensor([1.0, -2.0, 3.0])
    p = dict(tcomp.encode_bitmap(masked, 4))
    if bad == "missing":
        del p["bitmap"]
    elif bad == "dtype":
        p["bitmap"] = p["bitmap"].to(torch.int32)
    elif bad == "ndim":
        p["values"] = p["values"][None]
    elif bad == "negative_shape":
        p["shape"] = torch.tensor([-20], dtype=torch.int32)
    elif bad == "bytes":
        p["bitmap"] = p["bitmap"][:-1]
    elif bad == "no_slots":
        p["values"] = torch.zeros((0,))
    elif bad == "too_many_slots":
        p["values"] = torch.zeros((21,))
    elif bad == "padding":
        p["bitmap"] = p["bitmap"].clone()
        p["bitmap"][2] |= 1 << 7
    elif bad == "popcount":
        p["bitmap"] = torch.tensor([0xFF, 0xFF, 0x0F], dtype=torch.uint8)
    elif bad == "nonfinite":
        p["values"] = p["values"].clone()
        p["values"][0] = float("nan")
    return p


@pytest.mark.parametrize("bad,match", [
    ("missing", "missing keys"), ("dtype", "must be uint8"),
    ("ndim", "must be 1-D"), ("negative_shape", "negative shape"),
    ("bytes", "expected"), ("no_slots", "value slots"),
    ("too_many_slots", "value slots"), ("padding", "trailing"),
    ("popcount", "popcount"), ("nonfinite", "non-finite")])
def test_decode_bitmap_fails_loudly_like_the_reference(bad, match):
    payload = _bad_bitmap(bad)
    with pytest.raises(ValueError, match=match):
        tcomp.decode_bitmap(payload)
    with pytest.raises(ValueError, match=match):
        jcomp.decode_bitmap({k: np.asarray(v) for k, v in payload.items()})


def test_bitmap_encode_rejects_bad_budget():
    with pytest.raises(ValueError, match="needs k >= 1"):
        tcomp.encode_bitmap(torch.ones(8), 0)
    with pytest.raises(ValueError, match="exceeds tensor size"):
        tcomp.encode_bitmap(torch.ones(8), 9)


# --------------------------------------------------------- byte accounting
@pytest.mark.parametrize("encoding", ["auto", "bitmap", "coordinate"])
@pytest.mark.parametrize("gamma", [0.01, 0.2, 1.0])
def test_payload_bytes_match_reference(encoding, gamma):
    assert tcomp.payload_bytes(70000, gamma, 1, encoding) == \
        jcomp.payload_bytes(70000, gamma, 1, encoding)
    p = jpm.init_lenet(jax.random.PRNGKey(0), image_size=28)
    params = bridge.params_from_numpy(jax.device_get(p), device="cpu")
    want = jcomp.pytree_payload_bytes(p, gamma, encoding=encoding)
    got = tcomp.pytree_payload_bytes(params, gamma, encoding=encoding)
    assert (got.dense_bytes, got.sparse_bytes, got.encoding,
            dict(got.encoding_bytes)) == (want.dense_bytes, want.sparse_bytes,
                                          want.encoding,
                                          dict(want.encoding_bytes))
