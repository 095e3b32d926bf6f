"""The port's per-array masking kernels (plain PyTorch versions on the CPU)
and ``ops.topk_mask`` / ``ops.masked_count`` against the JAX package's
Pallas kernels in interpret mode, on the same numpy-made inputs.

Tolerances: histograms and counts exact; masks bitwise (int32 bit patterns,
so the sign of zero counts).  The reference pads the flat input to 256 x
1024 blocks; the port's kernels take the flat vector, so the reference's
outputs are cut back to the input's n entries.

Two reference faults are pinned side by side with the port's values:
``floor(log2|x|)`` is not the exponent on XLA:CPU, and ``masked_count``
counts the block padding when tau <= 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import topk_mask as jtk
from repro_torch.kernels import ops
from repro_torch.kernels import topk_mask as tk

N = 3001                      # not a multiple of 1024: the kernels' tail


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The per-array kernels' plain versions on the CPU: with several test
    workers on one machine, torch's intra-op threads only contend.
    Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _padded(x: np.ndarray):
    """The reference kernels' (R, 1024) block layout of a flat vector."""
    return jops._pad_to_blocks(jnp.asarray(x))


def _inputs(kind: str, seed: int = 0) -> np.ndarray:
    """Flat fp32 inputs of N entries."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(N).astype(np.float32)
    if kind == "normal":
        x *= (10.0 ** rng.uniform(-6, 1, N)).astype(np.float32)
    elif kind == "zeros_negatives":
        x = -np.abs(x) * 1e-2
        x[::3] = 0.0
        x[1::7] = -0.0
    elif kind == "extremes":
        x[::5] = 3e8 * np.sign(x[::5])           # above 2^28
        x[1::11] = 2.0 ** 40
        x[2::13] = 1e-31                         # below 2^-96, normal
        x[3::17] = -2.0 ** -100
    elif kind == "nan":
        x[::9] = np.nan
        x[1::19] = -np.nan
    return x


KINDS = ["normal", "zeros_negatives", "extremes", "nan"]


# -------------------------------------------------------------- kernels 6–8
@pytest.mark.parametrize("kind", KINDS)
def test_exponent_histogram_matches_pallas(kind):
    x = _inputs(kind, seed=1)
    want = np.asarray(jtk.exponent_histogram(_padded(x), interpret=True))
    got = tk.exponent_histogram(_t(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == (128,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tau", [2.0 ** -100, 1e-4, 0.3, 2.5, 3e8])
def test_count_ge_matches_pallas(kind, tau):
    x = _inputs(kind, seed=2)
    want = int(jtk.count_ge(_padded(x), jnp.float32(tau), interpret=True))
    got = tk.count_ge(_t(x), torch.tensor(tau, dtype=torch.float32))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tau", [1e-4, 0.3, 3e8])
def test_apply_threshold_matches_pallas_bitwise(kind, tau):
    x = _inputs(kind, seed=3)
    want = np.asarray(jtk.apply_threshold(_padded(x), jnp.float32(tau),
                                          interpret=True)).reshape(-1)[:N]
    got = tk.apply_threshold(_t(x), torch.tensor(tau, dtype=torch.float32))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 3, 5, 1023, 2997])
def test_exponent_histogram_on_offset_views_matches_pallas(kind, offset, n):
    """Views that start 1-3 elements into a larger tensor (off the 16-byte
    boundary) at odd lengths: the CUDA kernel's head and tail."""
    base = _inputs(kind, seed=offset)
    view = _t(base)[offset:offset + n]
    assert view.is_contiguous() and view.storage_offset() == offset
    want = np.asarray(jtk.exponent_histogram(
        _padded(base[offset:offset + n]), interpret=True))
    np.testing.assert_array_equal(tk.exponent_histogram(view).numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 3, 5, 1023, 2997])
def test_apply_threshold_on_offset_views_matches_pallas(kind, offset, n):
    """Views that start 1-3 elements into a larger tensor (off the 16-byte
    boundary) at odd lengths: the CUDA kernel's head, tail and output
    offset; bitwise, the sign of zero included."""
    base = _inputs(kind, seed=10 + offset)
    view = _t(base)[offset:offset + n]
    assert view.is_contiguous() and view.storage_offset() == offset
    for tau in (2.0 ** -100, 0.3):
        want = np.asarray(jtk.apply_threshold(
            _padded(base[offset:offset + n]), jnp.float32(tau),
            interpret=True)).reshape(-1)[:n]
        got = tk.apply_threshold(view, torch.tensor(tau, dtype=torch.float32))
        assert tuple(got.shape) == (n,)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


_SUBNORMAL_TAUS = [1e-45, 2.0 ** -127]


@pytest.mark.parametrize("tau", [0.0, *_SUBNORMAL_TAUS, 2.0 ** -126,
                                 2.0 ** -100, 0.3, 1.0, 3e38,
                                 float("inf")])
def test_apply_threshold_at_tau_and_one_ulp_either_side(tau):
    """Magnitudes at tau and one ulp below and above it, of both signs,
    beside +-0, subnormals, +-inf and NaN: the port keeps exactly |x| >=
    tau (IEEE compares, no flush) and writes +0.0 for the rest.  The
    reference agrees bit for bit except under a subnormal tau, which
    XLA:CPU flushes to 0 with every subnormal |x|: there it keeps each
    zero or subnormal x below tau (0 >= 0), where the port writes +0.0."""
    t = np.float32(tau)
    near = [np.nextafter(t, np.float32(0)), t,
            np.nextafter(t, np.float32(np.inf))]
    x = np.array(near + [-v for v in near]
                 + [0.0, -0.0, 1e-45, -1e-45, 2.0 ** -127, -(2.0 ** -127),
                    2.0 ** -126, np.inf, -np.inf, np.nan, -np.nan],
                 np.float32)
    got = tk.apply_threshold(_t(x), torch.tensor(t))
    want = np.where(np.abs(x) >= t, x, np.float32(0.0))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    ref = np.asarray(jtk.apply_threshold(_padded(x), jnp.float32(t),
                                         interpret=True)).reshape(-1)[:x.size]
    differ = _bits(ref) != _bits(want)
    if tau in _SUBNORMAL_TAUS:
        flushed = ((np.abs(x) < t) & (np.abs(x) < np.float32(2.0 ** -126))
                   & (_bits(x) != 0))
        assert flushed.any()
        np.testing.assert_array_equal(differ, flushed)
        np.testing.assert_array_equal(_bits(ref[flushed]), _bits(x[flushed]))
    else:
        assert not differ.any()


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 5, 1023])
def test_apply_output_lies_at_its_inputs_offset_from_16_bytes(offset, n):
    """The CUDA wrapper's output buffer: as far past a 16-byte boundary as
    x, so the kernel's float4 stores line up with its float4 loads."""
    x = torch.zeros(n + 8)[offset:offset + n]
    out = tk._empty_congruent(x)
    assert tuple(out.shape) == (n,) and out.is_contiguous()
    assert out.dtype == x.dtype and out.device == x.device
    assert (out.data_ptr() - x.data_ptr()) % 16 == 0
    assert out.untyped_storage().nbytes() <= 4 * (n + 3)


@pytest.mark.parametrize("offset", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [1, 3, 5, 1023, 2997])
def test_count_ge_on_offset_views_matches_pallas(offset, n):
    """Views that start at any 4-byte offset of a larger tensor and lengths
    that are not multiples of 4 (the CUDA kernel's head and tail)."""
    base = _inputs("extremes", seed=offset)
    base[offset::29] = np.nan
    view = _t(base)[offset:offset + n]
    assert view.is_contiguous() and view.storage_offset() == offset
    for tau in (2.0 ** -100, 1e-4, 0.3, 3e8):
        want = int(jtk.count_ge(_padded(base[offset:offset + n]),
                                jnp.float32(tau), interpret=True))
        got = tk.count_ge(view, torch.tensor(tau, dtype=torch.float32))
        assert int(got) == want, tau


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("tau", [1e-9, 0.5, 4.0])
def test_masked_count_of_offset_views_matches_reference(offset, tau):
    x = np.random.default_rng(7).standard_normal(4103).astype(np.float32)
    view = x[offset:offset + 4097]
    want = int(jops.masked_count(jnp.asarray(view), tau, interpret=True))
    got = ops.masked_count(_t(x)[offset:offset + 4097], tau)
    assert int(got) == want


def test_select_threshold_counts_matches_reference():
    """Exact where XLA's exp2 is exact (bracket ends >= 2^-13), and the
    bracket counts at both ends equal for every k."""
    x = _inputs("normal", seed=4)
    hist = tk.exponent_histogram(_t(x))
    jhist = jnp.asarray(hist.numpy())
    for k in (1, 7, 300, 1500, N, N + 5):
        got = [t.item() for t in tk.select_threshold_counts(hist, k)]
        want = [float(v) for v in jtk.select_threshold_counts(
            jhist, jnp.int32(k))]
        assert got[2:] == want[2:], k
        if got[0] >= 2.0 ** -13:
            assert got[:2] == want[:2], k
        assert got[1] == 2 * got[0] or got[0] == 2.0 ** -97
        lo, hi = tk.select_threshold(hist, k)
        assert (lo.item(), hi.item()) == tuple(got[:2])


# --------------------------------------------------------- ops.topk_mask
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma", [0.1, 0.25, 0.5])
@pytest.mark.parametrize("shape", [(512,), (2048,), (300, 77),
                                   (3, 3, 128, 128)])
def test_topk_mask_matches_reference_bitwise(shape, gamma, dtype):
    """Magnitudes here put every bracket end above 2^-13, where XLA's exp2
    is exact, so the two pipelines take the same steps."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = _t(x).to(getattr(torch, dtype))
    want = jops.topk_mask(jx, gamma, interpret=True)
    got = ops.topk_mask(tx, gamma)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(_bits(got.float().numpy()),
                                  _bits(np.asarray(want, np.float32)))


@pytest.mark.parametrize("shape", [(512,), (2048,), (300, 77),
                                   (3, 3, 128, 128)])
def test_topk_mask_below_exact_exp2_differs_only_between_taus(shape):
    """At magnitudes near 1e-6 the reference's bracket ends come from an
    inexact exp2, so its final tau may differ from the port's.  Both masks
    are threshold masks (every kept magnitude above every dropped one), so
    they can differ only on the entries whose magnitude lies between the
    two final taus; there are at most a few of them, and every other entry
    is bitwise equal."""
    rng = np.random.default_rng(8)
    x = (1e-6 * rng.standard_normal(shape)).astype(np.float32)
    want = np.asarray(jops.topk_mask(jnp.asarray(x), 0.25,
                                     interpret=True)).reshape(-1)
    got = ops.topk_mask(_t(x), 0.25).numpy().reshape(-1)
    mag = np.abs(x.reshape(-1))
    for keep in (want != 0, got != 0):
        assert mag[keep].min() > mag[~keep].max()
    differ = (want != 0) != (got != 0)
    assert differ.sum() <= max(2, 0.002 * mag.size)
    np.testing.assert_array_equal(_bits(got[~differ]), _bits(want[~differ]))


def _topk_kept(out, x, gamma):
    n = x.numel()
    k = max(1, round(gamma * n))
    kept = (out != 0).reshape(-1).numpy()
    mags = x.float().abs().reshape(-1).numpy()
    return kept, mags, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma", [0.05, 0.2, 0.5, 0.9])
@pytest.mark.parametrize("shape", [(256,), (1000,), (128, 128), (300, 77),
                                   (8, 8, 65)])
def test_topk_mask_properties(shape, gamma, dtype):
    """The reference's property test, repeated on the port: kept <= k,
    kept >= about 0.9 k, and every kept magnitude at least every dropped
    one."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=gen).to(dtype)
    out = ops.topk_mask(x, gamma)
    assert out.shape == x.shape and out.dtype == x.dtype
    kept, mags, k = _topk_kept(out, x, gamma)
    assert kept.sum() <= k
    assert kept.sum() >= max(1, int(0.9 * k) - 2)
    if kept.any() and (~kept).any():
        assert mags[kept].min() >= mags[~kept].max() - 1e-6


def test_topk_mask_exact_against_sort_oracle():
    """Distinct magnitudes: the pipeline equals the sort oracle."""
    from repro_torch.kernels import ref as tref
    gen = torch.Generator().manual_seed(0)
    base = torch.arange(1, 513, dtype=torch.float32)
    sign = torch.where(torch.arange(512) % 2 == 0, 1.0, -1.0)
    x = (base * sign)[torch.randperm(512, generator=gen)]
    torch.testing.assert_close(ops.topk_mask(x, 0.25),
                               tref.topk_mask_ref(x, 0.25), rtol=0, atol=0)


def test_topk_mask_preserves_values():
    x = torch.randn(2048, generator=torch.Generator().manual_seed(5))
    out = ops.topk_mask(x, 0.3)
    nz = out != 0
    assert torch.equal(out[nz], x[nz])


def test_topk_mask_runs_one_histogram_iters_counts_and_one_apply(
        monkeypatch):
    calls = []
    for name in ("exponent_histogram", "count_ge", "apply_threshold"):
        fn = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _fn=fn, _n=name:
                            calls.append(_n) or _fn(*a))
    ops.topk_mask(torch.randn(700), 0.5, iters=5)
    assert calls == ["exponent_histogram"] + ["count_ge"] * 5 + [
        "apply_threshold"]
    assert ops.pytree_sweep_count(11, segmented=False) == 11 * (8 + 2)


# ------------------------------------------------------- ops.masked_count
@pytest.mark.parametrize("tau", [1e-9, 0.5, 1.5, 4.0])
def test_masked_count_matches_reference(tau):
    x = np.random.default_rng(6).standard_normal(4096).astype(np.float32)
    want = int(jops.masked_count(jnp.asarray(x), tau, interpret=True))
    got = ops.masked_count(_t(x).reshape(64, 64), tau)
    assert got.dtype == torch.int32 and int(got) == want


def test_masked_count_of_bf16_counts_in_fp32():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(2))
    got = ops.masked_count(x.bfloat16(), 0.5)
    assert int(got) == int((x.bfloat16().float().abs() >= 0.5).sum())


# ----------------------------------------------------- wrapper contracts
def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.randn(10)
    tau = torch.tensor(0.5)
    with pytest.raises(ValueError):
        tk.exponent_histogram(x.reshape(2, 5))
    with pytest.raises(ValueError):
        tk.count_ge(x.double(), tau)
    with pytest.raises(ValueError):
        tk.apply_threshold(x, torch.tensor([0.5, 0.6]))
    with pytest.raises(ValueError):
        tk.count_ge(torch.randn(10, device="meta"), tau)
    tk.reset_launch_counts()
    tk.count_ge(x, tau)
    assert tk.launch_counts() == {"exponent_histogram": 0, "count_ge": 0,
                                  "apply_threshold": 0}


# ----------------------------------------------- reference faults, pinned
def test_reference_bins_by_inexact_log2_the_port_by_exponent():
    """The reference bins by ``floor(log2|x|)`` (``topk_mask.py:73``,
    ``ref.py:44``), which on XLA:CPU misses the bin definition of
    ``ref.py:17``: it puts some ``nextafter(2^j, 0)`` in bin j instead of
    j - 1, the exact powers 2^13, 2^15, 2^26, 2^27, 2^30 and 2^31 one bin
    low, infinities in bin 0 (the int conversion of log2(inf)), and counts
    subnormals nowhere (flushed to zero).  The port bins by the exponent
    field: every value in its own bin, inf in bin 127, subnormals in 0."""
    def bins(values, fn):
        out = []
        for v in values:
            h = fn(np.array([v], np.float32))
            out.append(int(np.nonzero(h)[0][0]) - 96 if h.any() else None)
        return out

    def ref_hist(v):
        return np.asarray(jtk.exponent_histogram(_padded(v), interpret=True))

    def port_hist(v):
        return tk.exponent_histogram(_t(v)).numpy()

    powers = [13, 15, 26, 27, 30, 31]
    exact = np.array([2.0 ** e for e in powers], np.float32)
    assert bins(exact, ref_hist) == [e - 1 for e in powers]
    assert bins(exact, port_hist) == powers

    js = np.arange(-60, 32)
    below = np.nextafter(np.float32(2.0) ** js.astype(np.float32),
                         np.float32(0))
    port = np.array(bins(below, port_hist))
    np.testing.assert_array_equal(port, js - 1)
    ref = np.array(bins(below, ref_hist))
    assert (ref == js).sum() > 0 and ((ref == js) | (ref == js - 1)).all()

    special = np.array([np.inf, -np.inf, 1e-40, -1e-45], np.float32)
    assert bins(special, ref_hist) == [-96, -96, None, None]
    assert bins(special, port_hist) == [31, 31, -96, -96]


def test_reference_masked_count_counts_its_padding():
    """``ops.masked_count`` (``ops.py:430``) pads to 256 x 1024 blocks
    (``ops.py:48``) and counts the padding once tau <= 0: 262,144 for 1000
    entries.  The port counts x's own entries only."""
    x = np.zeros(1000, np.float32)
    assert int(jops.masked_count(jnp.asarray(x), 0.0, interpret=True)) \
        == 262_144
    assert int(ops.masked_count(_t(x), 0.0)) == 1000
    assert int(ops.masked_count(_t(x), -1.0)) == 1000
    y = np.full(1000, np.nan, np.float32)
    assert int(ops.masked_count(_t(y), 0.0)) == 0
