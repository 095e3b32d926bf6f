"""The port's wkv6 (kernels/wkv6.py, behind ops.wkv6 and
models/rwkv.wkv6_chunked) against the reference on the CPU.

On the CPU the wrapper runs ``wkv6_plain``, one exponent per pair
(tests/test_torch_cuda.py holds the CUDA kernel against it on the card).
``_wkv6_subchunk_plain`` mirrors the kernel's own formulation (sub-chunks
of 16, the pair decay split at each boundary and again inside the
diagonal blocks, exp2 of log2e-scaled sums) and is held here against
``wkv6_plain``, the step recurrence and the Pallas kernel, at sub-chunk
and chunk edges.  The inputs are made once with numpy and handed to both
packages.  Tolerances: 2e-3 (abs and rel) against the reference's chunked
forms, as tests/test_kernels.py holds them against each other; 1e-4 abs
and 1e-5 rel against the step-by-step recurrence (outputs up to about 45
in size), which both chunked forms must reproduce.

The backward (``wkv6_backward_plain``, behind ``Wkv6Function``) is held
against autograd of ``wkv6_plain`` (rtol 1e-4, atol 1e-5 of each
gradient's largest magnitude: the same products in other orders), also at
the model's strongest decay and at exactly one chunk, and
against ``jax.vjp`` of the reference's ``wkv6_chunked`` with per-step
decays logw >= -1, where the reference's factored form stays finite
(its factors e^{-cum} reach e^64 at T = 64): rtol 1e-4, atol 1e-5 of the
gradient's scale (the largest difference seen is 1.1e-6 of it).
T = 100 leaves a partial chunk; s0 and the adjoint of sT are nonzero.
"""

import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.models import rwkv as jrwkv
from repro_torch.kernels import build, ops, profile_wkv6
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import rwkv


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend.  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(B, T, H, D, seed=11):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-4.0, 1.0, (B, T, H, D))).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    s0 = rng.standard_normal((B, H, D, D)).astype(np.float32)
    return [r, k, v, logw, u, s0]


def _port(x):
    y, s = ops.wkv6(*(torch.from_numpy(a) for a in x))
    return y.numpy(), s.numpy()


def _reference_steps(r, k, v, logw, u, s0):
    """The reference's single-token recurrence, T times."""
    S = jnp.asarray(s0)
    ys = []
    for t in range(r.shape[1]):
        sl = slice(t, t + 1)
        y, S = jrwkv.wkv6_step(r[:, sl], k[:, sl], v[:, sl], logw[:, sl],
                               u, S)
        ys.append(np.asarray(y))
    return np.concatenate(ys, 1), np.asarray(S)


def _port_steps(r, k, v, logw, u, s0):
    """The port's own single-token recurrence, T times."""
    S = torch.from_numpy(s0)
    ys = []
    for t in range(r.shape[1]):
        y, S = rwkv.wkv6_step(*(torch.from_numpy(a[:, t:t + 1])
                                for a in (r, k, v, logw)),
                              torch.from_numpy(u), S)
        ys.append(y.numpy())
    return np.concatenate(ys, 1), S.numpy()


SHAPES = [(2, 8, 3, 8), (2, 64, 3, 8), (2, 100, 3, 8), (1, 100, 2, 32)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wkv6_plain_matches_pallas_kernel_and_chunked_form(shape):
    x = _inputs(*shape)
    y, s = _port(x)
    for yr, sr in (jops.wkv6(*x, interpret=True),
                   jrwkv.wkv6_chunked(*x)):
        np.testing.assert_allclose(y, np.asarray(yr), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(s, np.asarray(sr), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wkv6_plain_matches_step_recurrence(shape):
    x = _inputs(*shape)
    y, s = _port(x)
    for yr, sr in (_reference_steps(*x), _port_steps(*x)):
        np.testing.assert_allclose(y, yr, atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(s, sr, atol=1e-4, rtol=1e-5)


def test_wkv6_chunked_routes_through_the_wrapper():
    x = _inputs(2, 70, 2, 8)
    y, s = rwkv.wkv6_chunked(*(torch.from_numpy(a) for a in x))
    y2, s2 = _port(x)
    assert np.array_equal(y.numpy(), y2) and np.array_equal(s.numpy(), s2)
    assert wk.launch_counts() == {"wkv6": 0,      # CPU: plain version
                                  "wkv6_backward": 0}


def test_reference_chunked_wkv6_overflows_where_the_port_does_not():
    """ROADMAP Queue 3: with logw = -1.5 at every step, e^{-cum} passes the
    fp32 range inside one 64-step chunk.  The reference's chunked form and
    its Pallas kernel give NaN; the port's exponents are differences of
    prefix sums and stay finite, matching the step recurrence."""
    B, T, H, D = 1, 64, 1, 4
    x = _inputs(B, T, H, D)
    x[3] = np.full((B, T, H, D), -1.5, np.float32)
    x[4] = np.zeros((H, D), np.float32)
    x[5] = np.zeros((B, H, D, D), np.float32)
    y_chunked, _ = jrwkv.wkv6_chunked(*x)
    y_pallas, _ = jops.wkv6(*x, interpret=True)
    assert np.isnan(np.asarray(y_chunked)).any()
    assert np.isnan(np.asarray(y_pallas)).any()
    y_steps, s_steps = _reference_steps(*x)
    assert np.isfinite(y_steps).all()
    y, s = _port(x)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    np.testing.assert_allclose(y, y_steps, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(s, s_steps, atol=1e-4, rtol=1e-5)
    # where the decay is mild, the reference's chunked form agrees
    x[3] = np.full((B, T, H, D), -0.5, np.float32)
    y_chunked, _ = jrwkv.wkv6_chunked(*x)
    np.testing.assert_allclose(_port(x)[0], np.asarray(y_chunked),
                               atol=2e-3, rtol=2e-3)


def test_wkv6_finite_at_the_models_strongest_decay():
    """logw = -e^4, the model's clip, on half the channels."""
    x = _inputs(2, 100, 2, 32)
    x[3][..., :16] = -np.exp(4.0)
    y, s = _port(x)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    yr, sr = _reference_steps(*x)
    np.testing.assert_allclose(y, yr, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(s, sr, atol=1e-4, rtol=1e-5)


def test_wkv6_single_step_and_zero_state():
    x = _inputs(3, 1, 2, 8)
    y, s = _port(x)
    yr, sr = _reference_steps(*x)
    np.testing.assert_allclose(y, yr, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s, sr, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad", ["rank", "u", "s0", "dtype", "layout"])
def test_wkv6_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = [torch.from_numpy(a) for a in _inputs(1, 8, 2, 8)]
    if bad == "rank":
        x[0] = x[0][0]
    elif bad == "u":
        x[4] = x[4][:1]
    elif bad == "s0":
        x[5] = x[5][..., :4]
    elif bad == "dtype":
        x[1] = x[1].double()
    else:
        x[2] = x[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        wk.wkv6(*x)


SUB_T = [1, 15, 16, 17, 63, 64, 65, 100]
SUB_D = [32, 64]


def _subchunk(x):
    y, s = wk._wkv6_subchunk_plain(*(torch.from_numpy(a) for a in x))
    return y.numpy(), s.numpy()


@pytest.mark.parametrize("D", SUB_D)
@pytest.mark.parametrize("T", SUB_T)
def test_wkv6_subchunk_form_matches_plain_version(T, D):
    x = _inputs(2, T, 2, D)
    y, s = _subchunk(x)
    yp, sp = _port(x)
    np.testing.assert_allclose(y, yp, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(s, sp, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("D", SUB_D)
@pytest.mark.parametrize("T", SUB_T)
def test_wkv6_subchunk_form_matches_step_recurrence(T, D):
    x = _inputs(2, T, 2, D)
    y, s = _subchunk(x)
    ys, ss = _port_steps(*x)
    np.testing.assert_allclose(y, ys, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(s, ss, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("D", SUB_D)
@pytest.mark.parametrize("T", SUB_T)
def test_wkv6_subchunk_form_matches_pallas_kernel(T, D):
    x = _inputs(2, T, 2, D)
    y, s = _subchunk(x)
    yr, sr = jops.wkv6(*x, interpret=True)
    np.testing.assert_allclose(y, np.asarray(yr), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(s, np.asarray(sr), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("D", SUB_D)
def test_wkv6_subchunk_form_finite_at_the_models_strongest_decay(D):
    """logw = -e^4 on half the channels: every split factor stays <= 1."""
    x = _inputs(2, 100, 2, D)
    x[3][..., : D // 2] = -np.exp(4.0)
    y, s = _subchunk(x)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    ys, ss = _port_steps(*x)
    np.testing.assert_allclose(y, ys, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(s, ss, atol=1e-4, rtol=1e-5)


def test_profile_marks_cover_every_phase_and_stay_out_of_the_build():
    """kernels/profile_wkv6.py reads one clock count per WKV6_MARK; the
    production build compiles the marks to nothing."""
    src = (build.SOURCES[0].parent / "wkv6.cu").read_text()
    assert len(profile_wkv6.PHASES) == profile_wkv6.MARKS
    for m in range(profile_wkv6.MARKS):
        assert f"WKV6_MARK({m});" in src
    assert not any("WKV6_PROFILE" in flag for flag in build.NVCC_FLAGS)


def _adjoints(B, T, H, D, seed=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, H, D, D)).astype(np.float32))


GRAD_NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


def _close(got, want, rtol, atol_frac, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_frac * float(np.abs(want).max()),
        err_msg=name)


def _autograd_of_plain(x, dy, dsT):
    leaves = [torch.from_numpy(a).requires_grad_() for a in x]
    y, s = wk.wkv6_plain(*leaves)
    loss = (y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(dsT)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("case", ["T100_D32", "T100_D64", "strong_decay",
                                  "T64_one_chunk"])
def test_wkv6_backward_plain_matches_autograd(case):
    shape = {"T100_D32": (2, 100, 2, 32), "T100_D64": (1, 100, 2, 64),
             "strong_decay": (1, 100, 2, 32), "T64_one_chunk": (2, 64, 2, 8)}
    x = _inputs(*shape[case])
    if case == "strong_decay":
        x[3][..., :16] = -np.exp(4.0)
    dy, dsT = _adjoints(*shape[case])
    grads = wk.wkv6_backward_plain(*(torch.from_numpy(a) for a in x),
                                   torch.from_numpy(dy),
                                   torch.from_numpy(dsT))
    assert all(bool(g.isfinite().all()) for g in grads)
    for name, g, want in zip(GRAD_NAMES, grads, _autograd_of_plain(x, dy,
                                                                    dsT)):
        _close(g.numpy(), want, 1e-4, 1e-5, name)


@pytest.mark.parametrize("shape", [(2, 100, 2, 32), (1, 64, 2, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wkv6_backward_plain_matches_jax_vjp(shape):
    x = _inputs(*shape)
    rng = np.random.default_rng(13)
    x[3] = -np.exp(rng.uniform(-4.0, 0.0, shape)).astype(np.float32)
    dy, dsT = _adjoints(*shape)
    grads = wk.wkv6_backward_plain(*(torch.from_numpy(a) for a in x),
                                   torch.from_numpy(dy),
                                   torch.from_numpy(dsT))
    _, vjp = jax.vjp(jax.jit(jrwkv.wkv6_chunked),
                     *(jnp.asarray(a) for a in x))
    ref = vjp((jnp.asarray(dy), jnp.asarray(dsT)))
    for name, g, want in zip(GRAD_NAMES, grads, ref):
        assert np.isfinite(np.asarray(want)).all(), name
        _close(g.numpy(), want, 1e-4, 1e-5, name)


def test_wkv6_function_carries_the_plain_backward():
    """Under grad mode the wrapper (and ops.wkv6, rwkv.wkv6_chunked) runs
    Wkv6Function: on the CPU its gradients are the plain backward's, bit
    for bit; only the gradients asked for, sT's adjoint absent taken as
    zeros."""
    x = _inputs(2, 100, 2, 32)
    dy, _ = _adjoints(2, 100, 2, 32)
    leaves = [torch.from_numpy(a).requires_grad_(i != 5)
              for i, a in enumerate(x)]
    y, _ = rwkv.wkv6_chunked(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), leaves[:5])
    want = wk.wkv6_backward_plain(*(torch.from_numpy(a) for a in x),
                                  torch.from_numpy(dy),
                                  torch.zeros((2, 2, 32, 32)))
    for g, w in zip(got, want[:5]):
        assert torch.equal(g, w)
    assert wk.launch_counts() == {"wkv6": 0, "wkv6_backward": 0}


# The CUDA backward's own three-pass formulation (wkv6._wkv6_backward_
# chunked_plain: chunks of 64 padded with zero rows, the chunk terms, the
# two serial scans, the split pair decays and the diagonal blocks' shared
# exponents) at T = 1, past a chunk and over three chunks.
CHUNKED_T = [1, 100, 200]


def _step_recurrence_grads(x, dy, dsT):
    """Autograd of the port's single-token recurrence, T times."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in x]
    r, k, v, logw, u, S = leaves
    ys = []
    for t in range(r.shape[1]):
        sl = slice(t, t + 1)
        y, S = rwkv.wkv6_step(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u, S)
        ys.append(y)
    loss = (torch.cat(ys, 1) * torch.from_numpy(dy)).sum() + \
        (S * torch.from_numpy(dsT)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _chunked(x, dy, dsT):
    grads = wk._wkv6_backward_chunked_plain(
        *(torch.from_numpy(a) for a in x), torch.from_numpy(dy),
        torch.from_numpy(dsT))
    assert all(bool(g.isfinite().all()) for g in grads)
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("D", SUB_D)
@pytest.mark.parametrize("T", CHUNKED_T)
def test_wkv6_backward_chunked_form_matches_plain_and_jax_vjp(T, D):
    shape = (2, T, 2, D)
    x = _inputs(*shape)
    rng = np.random.default_rng(14)
    x[3] = -np.exp(rng.uniform(-4.0, 0.0, shape)).astype(np.float32)
    dy, dsT = _adjoints(*shape)
    got = _chunked(x, dy, dsT)
    plain = wk.wkv6_backward_plain(*(torch.from_numpy(a) for a in x),
                                   torch.from_numpy(dy),
                                   torch.from_numpy(dsT))
    _, vjp = jax.vjp(jax.jit(jrwkv.wkv6_chunked),
                     *(jnp.asarray(a) for a in x))
    ref = vjp((jnp.asarray(dy), jnp.asarray(dsT)))
    for name, g, want, jwant in zip(GRAD_NAMES, got, plain, ref):
        _close(g, want.numpy(), 1e-4, 1e-5, name)
        _close(g, jwant, 1e-4, 1e-5, name)


@pytest.mark.parametrize("shape", [(2, 200, 2, 32), (2, 100, 1, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wkv6_backward_chunked_form_at_the_models_strongest_decay(shape):
    """logw = -e^4 on half the channels, where the reference's factored
    form overflows: against the plain backward and autograd of the step
    recurrence."""
    x = _inputs(*shape)
    x[3][..., : shape[3] // 2] = -np.exp(4.0)
    dy, dsT = _adjoints(*shape)
    got = _chunked(x, dy, dsT)
    plain = wk.wkv6_backward_plain(*(torch.from_numpy(a) for a in x),
                                   torch.from_numpy(dy),
                                   torch.from_numpy(dsT))
    steps = _step_recurrence_grads(x, dy, dsT)
    for name, g, want, swant in zip(GRAD_NAMES, got, plain, steps):
        _close(g, want.numpy(), 1e-4, 1e-5, name)
        _close(g, swant, 1e-4, 1e-5, name)
