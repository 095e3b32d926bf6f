"""The port's selective-SSM scan (kernels/ssm_scan.py behind ops.ssm_scan)
and SSM branch (models/ssm.py) against the reference on the CPU.

On the CPU the wrapper runs ``ssm_scan_plain`` (tests/test_torch_cuda.py
holds the CUDA kernel against it on the card).  Inputs are made once with
numpy and handed to both packages.  Tolerances: atol 1e-5 for the scan,
as tests/test_kernels.py holds the Pallas kernel to its oracle; 1e-4 for
the whole branch (a softplus, exponentials and two projections before the
scan, summed in other orders).

The backward (``ssm_scan_backward_plain``, behind ``SsmScanFunction``) is
held against autograd of the plain forward and ``jax.vjp`` of the
reference's oracle ``ssm_scan_ref`` in its (B, T, N, D) layout, with a
nonzero h0 and an adjoint for hT: rtol 1e-4 and atol 1e-5 of the
gradient's largest magnitude against autograd (the same products summed
in other orders), rtol 1e-4 and atol 1e-5 of it against ``jax.vjp``
(XLA's reverse scan, the same recurrence; the largest difference seen is
about 1e-7 of the scale).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as ssk
from repro_torch.models import ssm


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend.  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(B, T, d, N, seed=0):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, d, N))))
         ).astype(np.float32)
    bx = rng.standard_normal((B, T, d, N)).astype(np.float32)
    c = rng.standard_normal((B, T, N)).astype(np.float32)
    h0 = rng.standard_normal((B, d, N)).astype(np.float32)
    return a, bx, c, h0


SHAPES = [(1, 8, 4, 2), (2, 37, 19, 4), (2, 300, 33, 16), (1, 256, 256, 8)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssm_scan_matches_pallas_kernel_and_oracles(shape):
    a, bx, c, h0 = _inputs(*shape)
    y, hT = ops.ssm_scan(*(torch.from_numpy(x) for x in (a, bx, c, h0)))
    y_pallas, h_pallas = jops.ssm_scan(a, bx, c, h0, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_pallas), atol=1e-5)
    # both oracles take the (B, T, N, D) layout of the TPU kernel
    tr = (a.transpose(0, 1, 3, 2), bx.transpose(0, 1, 3, 2), c,
          h0.transpose(0, 2, 1))
    y_ref, h_ref = jref.ssm_scan_ref(*tr)
    y_port_ref, h_port_ref = ref.ssm_scan_ref(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in tr))
    for yr, hr in ((np.asarray(y_ref), np.asarray(h_ref)),
                   (y_port_ref.numpy(), h_port_ref.numpy())):
        np.testing.assert_allclose(y.numpy(), yr, atol=1e-5)
        np.testing.assert_allclose(hT.numpy(), hr.transpose(0, 2, 1),
                                   atol=1e-5)
    assert ssk.launch_counts() == {"ssm_scan": 0,      # CPU: plain version
                                   "ssm_scan_backward": 0}


@pytest.mark.parametrize("bad", ["rank", "c", "h0", "dtype"])
def test_ssm_scan_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = [torch.from_numpy(v) for v in _inputs(1, 8, 4, 2)]
    if bad == "rank":
        x[0] = x[0][0]
    elif bad == "c":
        x[2] = x[2][:, :4]
    elif bad == "h0":
        x[3] = x[3][:, :3]
    else:
        x[1] = x[1].double()
    with pytest.raises(ValueError):
        ssk.ssm_scan(*x)


@pytest.fixture(scope="module")
def branch():
    """One SSM branch (d_model = d_inner = 16, N = 4), the reference's
    params carried across the bridge, and a (2, 64, 32) input."""
    key = jax.random.PRNGKey(5)
    params = jssm.init_ssm_params(key, 16, 16, 4, jnp.float32)
    xz = np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                    (2, 64, 32)))
    port = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return params, port, xz


@pytest.mark.parametrize("T", [64, 37])
def test_ssm_forward_matches_reference(branch, T):
    params, port, xz = branch
    xz = xz[:, :T]
    h0 = np.random.default_rng(1).standard_normal((2, 16, 4)
                                                  ).astype(np.float32)
    y_ref, h_ref = jssm.ssm_forward(params, xz, h0)
    y, hT = ssm.ssm_forward(port, torch.from_numpy(xz), torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_ref), atol=1e-4,
                               rtol=1e-4)


def test_ssm_step_matches_reference_and_forward(branch):
    params, port, xz = branch
    h_ref = jnp.zeros((2, 16, 4))
    h = torch.zeros((2, 16, 4))
    ys = []
    for t in range(xz.shape[1]):
        y_ref, h_ref = jssm.ssm_step(params, xz[:, t:t + 1], h_ref)
        y, h = ssm.ssm_step(port, torch.from_numpy(xz[:, t:t + 1]), h)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4,
                                   rtol=1e-4)
        ys.append(y)
    y_fwd, h_fwd = ssm.ssm_forward(port, torch.from_numpy(xz),
                                   torch.zeros((2, 16, 4)))
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_fwd.numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_fwd.numpy(), atol=1e-4,
                               rtol=1e-4)


BWD_SHAPES = [(2, 100, 5, 16), (1, 37, 3, 4)]


def _adjoints(B, T, d, N, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, d)).astype(np.float32),
            rng.standard_normal((B, d, N)).astype(np.float32))


def _close(got, want, rtol, atol_frac, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_frac * float(np.abs(want).max()),
        err_msg=name)


@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssm_scan_backward_matches_autograd_and_jax_vjp(shape):
    x = _inputs(*shape)
    dy, dhT = _adjoints(*shape)
    tx = [torch.from_numpy(v) for v in x]
    grads = ssk.ssm_scan_backward_plain(*tx, torch.from_numpy(dy),
                                        torch.from_numpy(dhT))
    leaves = [v.clone().requires_grad_() for v in tx]
    y, hT = ssk.ssm_scan_plain(*leaves)
    auto = torch.autograd.grad(
        (y * torch.from_numpy(dy)).sum() + (hT * torch.from_numpy(dhT)).sum(),
        leaves)
    a, bx, c, h0 = x
    tr = (a.transpose(0, 1, 3, 2), bx.transpose(0, 1, 3, 2), c,
          h0.transpose(0, 2, 1))
    _, vjp = jax.vjp(jref.ssm_scan_ref, *(jnp.asarray(v) for v in tr))
    ja, jbx, jc, jh0 = vjp((jnp.asarray(dy), jnp.asarray(dhT.transpose(0, 2,
                                                                        1))))
    ref = (np.asarray(ja).transpose(0, 1, 3, 2),
           np.asarray(jbx).transpose(0, 1, 3, 2), np.asarray(jc),
           np.asarray(jh0).transpose(0, 2, 1))
    for name, g, ga, gr in zip(("da", "dbx", "dc", "dh0"), grads, auto, ref):
        _close(g.numpy(), ga.numpy(), 1e-4, 1e-5, name)
        _close(g.numpy(), gr, 1e-4, 1e-5, name)


def test_ssm_scan_function_carries_the_plain_backward():
    """Under grad mode the wrapper (and ops.ssm_scan) runs SsmScanFunction:
    on the CPU its gradients are the plain backward's, bit for bit; the
    gradients asked for only, hT's adjoint absent taken as zeros."""
    x = [torch.from_numpy(v) for v in _inputs(2, 100, 5, 16)]
    dy, _ = _adjoints(2, 100, 5, 16)
    leaves = [v.clone().requires_grad_(i != 2) for i, v in enumerate(x)]
    y, _ = ops.ssm_scan(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                              [leaves[0], leaves[1], leaves[3]])
    want = ssk.ssm_scan_backward_plain(*x, torch.from_numpy(dy),
                                       torch.zeros_like(x[3]))
    for g, w in zip(got, (want[0], want[1], want[3])):
        assert torch.equal(g, w)
    assert ssk.launch_counts() == {"ssm_scan": 0, "ssm_scan_backward": 0}


# The CUDA path's split: the forward's checkpoints h_{16 k} and a backward
# that recomputes each 16-step chunk from them (ssm_scan._ssm_scan_
# checkpoint_plain, _ssm_scan_backward_from_checkpoints_plain).
@pytest.mark.parametrize("shape", [(2, 1, 3, 4), (2, 37, 5, 16),
                                   (1, 64, 4, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssm_scan_checkpoints_are_the_states_every_16_steps(shape):
    B, T, d, N = shape
    tx = [torch.from_numpy(v) for v in _inputs(*shape)]
    y, hT, hk = ssk._ssm_scan_checkpoint_plain(*tx)
    yp, hTp = ssk.ssm_scan_plain(*tx)
    assert torch.equal(y, yp) and torch.equal(hT, hTp)
    a, bx, _, h = tx
    states = [h]
    for t in range(T):
        h = a[:, t] * h + bx[:, t]
        states.append(h)
    assert tuple(hk.shape) == (B, -(-T // ssk.CHECKPOINT), d, N)
    for k in range(hk.shape[1]):
        assert torch.equal(hk[:, k], states[ssk.CHECKPOINT * k])


@pytest.mark.parametrize("T", [37, 64])
def test_ssm_scan_backward_from_checkpoints_matches_plain_and_jax_vjp(T):
    shape = (2, T, 5, 16)
    x = _inputs(*shape)
    dy, dhT = _adjoints(*shape)
    tx = [torch.from_numpy(v) for v in x]
    hk = ssk._ssm_scan_checkpoint_plain(*tx)[2]
    grads = ssk._ssm_scan_backward_from_checkpoints_plain(
        *tx[:3], hk, torch.from_numpy(dy), torch.from_numpy(dhT))
    want = ssk.ssm_scan_backward_plain(*tx, torch.from_numpy(dy),
                                       torch.from_numpy(dhT))
    a, bx, c, h0 = x
    tr = (a.transpose(0, 1, 3, 2), bx.transpose(0, 1, 3, 2), c,
          h0.transpose(0, 2, 1))
    _, vjp = jax.vjp(jref.ssm_scan_ref, *(jnp.asarray(v) for v in tr))
    ja, jbx, jc, jh0 = vjp((jnp.asarray(dy),
                            jnp.asarray(dhT.transpose(0, 2, 1))))
    ref = (np.asarray(ja).transpose(0, 1, 3, 2),
           np.asarray(jbx).transpose(0, 1, 3, 2), np.asarray(jc),
           np.asarray(jh0).transpose(0, 2, 1))
    for name, g, w, gr in zip(("da", "dbx", "dc", "dh0"), grads, want, ref):
        _close(g.numpy(), w.numpy(), 1e-4, 1e-5, name)
        _close(g.numpy(), gr, 1e-4, 1e-5, name)


@pytest.mark.parametrize("T", [17, 100])
def test_ssm_scan_function_matches_autograd_of_the_plain_forward(T):
    """SsmScanFunction (the wrapper under grad mode) against autograd
    through ssm_scan_plain's steps, every input's gradient."""
    shape = (2, T, 5, 16)
    x = [torch.from_numpy(v) for v in _inputs(*shape)]
    dy, dhT = (torch.from_numpy(v) for v in _adjoints(*shape))
    grads = []
    for fn in (ssk.ssm_scan, ssk.ssm_scan_plain):
        leaves = [v.clone().requires_grad_() for v in x]
        y, hT = fn(*leaves)
        grads.append(torch.autograd.grad((y * dy).sum() + (hT * dhT).sum(),
                                         leaves))
    for name, g, w in zip(("da", "dbx", "dc", "dh0"), *grads):
        _close(g.numpy(), w.numpy(), 1e-4, 1e-5, name)
