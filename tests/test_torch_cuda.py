"""Tests of the port that need an NVIDIA card: each CUDA kernel against its
plain PyTorch version, ``ops.topk_mask`` on the card against the same
pipeline on the CPU, the fig5 and fig5-fused-int8 rounds (LeNet) and
the random-mask round (GRU-LM) on the card against the same rounds on the
CPU, the reduced rwkv6 and hymba serving paths on the card (wkv6 and
ssm_scan kernels) against the same paths on the CPU (plain versions), the
wkv6 and ssm_scan backward kernels against their plain backwards, and
the sharded client-state store's gather and scatter on the card against
the CPU's, the MoE's routing on the card against the CPU's, reduced
gemma2's decode against its forward on the card, the zoo archs'
parameter trees initialised on the card, and the scan form's graph
replays against the eager round loop, bit for bit.  They skip without a
card.  This file imports no JAX, so on a machine without it run it
alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core import strategy
from repro_torch.core.server import FederatedServer
from repro_torch.data.partition import iid_partition_images, partition_text
from repro_torch.data.synthetic import class_gaussian_images, markov_text
from repro_torch.kernels import measure, ops
from repro_torch.kernels import packing as pk
from repro_torch.configs import get_arch
from repro_torch.kernels import segmented as seg
from repro_torch.kernels import ssm_scan as ssk
from repro_torch.kernels import topk_mask as tk
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import serve, steps
from repro_torch.models import paper_models as pm
from repro_torch.models import transformer as tr

pytestmark = pytest.mark.cuda


@pytest.fixture
def one_torch_thread():
    """For the tests that run a CPU half beside the card's: one intra-op
    thread, as the CPU-only port files pin it, so several test workers on
    one machine do not contend.  Restored after the test."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _buffer(seed: int, clients: int = 4):
    gen = torch.Generator().manual_seed(seed)
    shapes = [(5, 5, 6, 16), (784, 120), (120, 84), (84, 10)]
    leaves = []
    for shape in shapes:
        x = 1e-3 * torch.randn((clients,) + shape, generator=gen)
        flat = x.view(clients, -1)
        flat[:, ::97] = 0.0
        flat[:, 1::211] = -1e-31
        flat[:, 2::1009] = 3e8
        flat[0, 5] = float("nan")
        flat[-1, 6] = float("-inf")
        leaves.append(x)
    spec = pk.build_pack_spec([leaf[0] for leaf in leaves])
    return pk.pack_stacked(leaves, spec), spec.seg_ids(clients), \
        clients * spec.num_segments


@pytest.mark.parametrize("seed", [0, 1])
def test_kernels_match_plain_versions(cuda, seed):
    x2d, seg_ids, S = _buffer(seed)
    x2d, seg_ids = x2d.to(cuda), seg_ids.to(cuda)
    hist = seg.segmented_histogram(x2d, seg_ids, S)
    assert torch.equal(hist, seg.segmented_histogram_plain(x2d, seg_ids, S))
    k = torch.full((S,), 200, dtype=torch.int32, device=cuda)
    lo, hi, _, _ = seg.select_thresholds(hist, k)
    cand = seg.candidate_taus(lo, hi, 16, geometric=True).contiguous()
    assert torch.equal(seg.segmented_count(x2d, seg_ids, cand),
                       seg.segmented_count_plain(x2d, seg_ids, cand))
    out, kept = seg.segmented_apply(x2d, seg_ids, hi.contiguous())
    want, want_kept = seg.segmented_apply_plain(x2d, seg_ids, hi)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert torch.equal(kept, want_kept)


@pytest.mark.parametrize("seed", [0, 1])
def test_wire_kernels_match_plain_versions(cuda, seed):
    """Stats exact (maxima bitwise, NaN and inf included); encode fp32
    bitwise and int8 codes exact, with bitmaps and kept counts."""
    from repro_torch.core.compression import int8_scales
    x2d, seg_ids, S = _buffer(seed)
    x2d, seg_ids = x2d.to(cuda), seg_ids.to(cuda)
    hist, amax = seg.segmented_stats(x2d, seg_ids, S)
    want_hist, want_amax = seg.segmented_stats_plain(x2d, seg_ids, S)
    assert torch.equal(hist, want_hist)
    assert torch.equal(amax.view(torch.int32), want_amax.view(torch.int32))
    tau = torch.full((S,), 1e-3, device=cuda)
    scales = int8_scales(amax[:, 0]).contiguous()
    for sc in (None, scales):
        got = seg.segmented_encode(x2d, seg_ids, tau, sc)
        want = seg.segmented_encode_plain(x2d, seg_ids, tau, sc)
        out, want_out = got[0], want[0]
        if sc is None:
            out, want_out = out.view(torch.int32), want_out.view(torch.int32)
        assert torch.equal(out, want_out)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def _wire_calls(x2d, seg_ids, taus, scales, plain: bool) -> dict:
    """The histogram, stats and encode (int8, fp32) through the wrappers
    or, with ``plain``, through their plain versions; each returns a
    tuple."""
    S = taus.numel()
    hist = (seg.segmented_histogram_plain if plain
            else seg.segmented_histogram)
    stats = seg.segmented_stats_plain if plain else seg.segmented_stats
    encode = seg.segmented_encode_plain if plain else seg.segmented_encode
    return {"hist": lambda x: (hist(x, seg_ids, S),),
            "stats": lambda x: stats(x, seg_ids, S),
            "int8": lambda x: encode(x, seg_ids, taus, scales),
            "fp32": lambda x: encode(x, seg_ids, taus)}


def _bitwise_all(got, want) -> bool:
    return all(measure.bitwise(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("rows", [1, 3, 5, 4095, 33 * 1024 + 5])
def test_wire_kernels_bitwise_on_edge_inputs(cuda, rows):
    """The histogram, stats and encode (int8 and fp32) bitwise against their
    plain versions on R rows holding NaN, +-inf, -0.0, subnormals and
    magnitudes at and beside 2^-96; segments of 1-7 rows (single-row ones,
    and changes in the middle of a block's rows; 32-row blocks at the
    largest R); ids S + 1 and -2; scales of 1e-12, inf and NaN."""
    inputs = [t.to(cuda) for t in measure.wire_edge_inputs(rows, seed=rows)]
    got = _wire_calls(*inputs, plain=False)
    want = _wire_calls(*inputs, plain=True)
    for kind in got:
        assert _bitwise_all(got[kind](inputs[0]), want[kind](inputs[0])), kind


@pytest.mark.parametrize("kind", ["hist", "stats", "int8", "fp32"])
def test_wire_kernels_refuse_a_buffer_off_the_16_byte_boundary(cuda, kind):
    """The histogram, stats and encode read rows as float4: a view 4 bytes
    into its storage is refused before any launch, and the next call is
    right."""
    inputs = [t.to(cuda) for t in measure.wire_edge_inputs(1030, seed=3)]
    x2d = inputs[0]
    storage = torch.empty(x2d.numel() + 4, device=cuda)
    view = storage[1:1 + x2d.numel()].view(x2d.shape)
    view.copy_(x2d)
    name = {"hist": "segmented_histogram",
            "stats": "segmented_stats"}.get(kind, "segmented_encode")
    seg.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        _wire_calls(*inputs, plain=False)[kind](view)
    assert seg.launch_counts()[name] == 0
    assert _bitwise_all(_wire_calls(*inputs, plain=False)[kind](x2d),
                        _wire_calls(*inputs, plain=True)[kind](view))
    assert seg.launch_counts()[name] == 1


@pytest.mark.parametrize("candidates", [1, 8, 16, 17, 32, 4096])
def test_count_kernel_takes_any_candidate_count(cuda, candidates):
    x2d, seg_ids, S = _buffer(3)
    x2d, seg_ids = x2d.to(cuda), seg_ids.to(cuda)
    gen = torch.Generator().manual_seed(candidates)
    taus = torch.sort(10.0 ** (-5 + 4 * torch.rand(
        (S, candidates), generator=gen)), 1).values.to(cuda).contiguous()
    assert torch.equal(seg.segmented_count(x2d, seg_ids, taus),
                       seg.segmented_count_plain(x2d, seg_ids, taus))


def _odd_taus(S: int, C: int, seed: int, order: str) -> torch.Tensor:
    """(S, C) taus from 1e-5 to 10 in ``order`` ("sorted", "reversed" or
    "shuffled"), with duplicated neighbours and, unless sorted, NaN, inf,
    -0.0, 0.0, negative and subnormal taus mixed in."""
    gen = torch.Generator().manual_seed(seed)
    taus = 10.0 ** (-5 + 6 * torch.rand((S, C), generator=gen))
    if C > 3:
        taus[:, 1::3] = taus[:, 0::3][:, :taus[:, 1::3].shape[1]]
    taus = torch.sort(taus, 1).values
    if order == "reversed":
        taus = taus.flip(1)
    elif order == "shuffled":
        taus = taus[:, torch.randperm(C, generator=gen)]
        special = torch.tensor([float("nan"), float("inf"), -0.0, 0.0,
                                -1.0, 1e-45, 3e8])
        flat = taus.reshape(-1)
        flat[::5] = special.repeat(flat[::5].numel() // 7 + 1)[
            :flat[::5].numel()]
    return taus.contiguous()


@pytest.mark.parametrize("order", ["sorted", "reversed", "shuffled"])
@pytest.mark.parametrize("candidates", [1, 8, 16, 17, 32, 4096])
def test_count_kernel_takes_any_order_of_taus(cuda, candidates, order):
    """Bitwise against the plain version: unsorted and duplicated taus, NaN,
    inf, -0.0, <= 0 and subnormal taus, NaN and inf entries, rows outside
    [0, S) and segment changes in the middle of a block."""
    x2d, seg_ids, S = _buffer(4)
    seg_ids = seg_ids.clone()
    seg_ids[3] = S + 1
    seg_ids[7] = -2
    taus = _odd_taus(S, candidates, candidates, order).to(cuda)
    x2d, seg_ids = x2d.to(cuda), seg_ids.to(cuda)
    assert torch.equal(seg.segmented_count(x2d, seg_ids, taus),
                       seg.segmented_count_plain(x2d, seg_ids, taus))


@pytest.mark.parametrize("candidates", [16, 4096])
def test_count_kernel_on_a_2_20_buffer_of_7_segments(cuda, candidates):
    gen = torch.Generator().manual_seed(9)
    rows = (1 << 20) // 1024
    x2d = torch.randn((rows, 1024), generator=gen)
    x2d *= 10.0 ** (-4 + 4 * torch.rand((rows, 1), generator=gen))
    seg_ids = torch.sort(torch.randint(0, 7, (rows,), generator=gen,
                                       dtype=torch.int32)).values
    taus = _odd_taus(7, candidates, 5, "shuffled")
    x2d, seg_ids, taus = x2d.to(cuda), seg_ids.to(cuda), taus.to(cuda)
    assert torch.equal(seg.segmented_count(x2d, seg_ids, taus),
                       seg.segmented_count_plain(x2d, seg_ids, taus))


def test_count_kernel_refuses_a_buffer_off_the_16_byte_boundary(cuda):
    """The count kernel reads rows as float4: an (R, 1024) view that starts
    4 bytes into its storage is refused before any launch, and the context
    stays sound for the next call."""
    x2d, seg_ids, S = _buffer(3)
    x2d, seg_ids = x2d.to(cuda), seg_ids.to(cuda)
    storage = torch.empty(x2d.numel() + 4, device=cuda)
    view = storage[1:1 + x2d.numel()].view(x2d.shape)
    view.copy_(x2d)
    taus = _odd_taus(S, 16, 16, "sorted").to(cuda)
    seg.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        seg.segmented_count(view, seg_ids, taus)
    assert seg.launch_counts()["segmented_count"] == 0
    assert torch.equal(seg.segmented_count(x2d, seg_ids, taus),
                       seg.segmented_count_plain(view, seg_ids, taus))


def test_wrappers_count_their_launches(cuda):
    x2d, seg_ids, S = _buffer(2)
    tree = {"w": x2d[:8].to(cuda)}
    seg.reset_launch_counts()
    ops.topk_mask_pytree(tree, 0.5, min_leaf_size=0)
    assert seg.launch_counts() == {"segmented_histogram": 1,
                                   "segmented_count": 2,
                                   "segmented_apply": 1,
                                   "segmented_stats": 0,
                                   "segmented_encode": 0}


def test_wire_wrappers_count_their_launches(cuda):
    x2d, seg_ids, S = _buffer(2)
    tree = {"w": x2d[:8].to(cuda)}
    seg.reset_launch_counts()
    ops.topk_encode_pytree(tree, 0.5, min_leaf_size=0, quantize=True,
                           assume_masked=True)
    ops.topk_encode_pytree(tree, 0.5, min_leaf_size=0)
    assert seg.launch_counts() == {"segmented_histogram": 0,
                                   "segmented_count": 2,
                                   "segmented_apply": 0,
                                   "segmented_stats": 2,
                                   "segmented_encode": 2}


def test_stacked_masking_on_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    tree = {"a": 1e-2 * torch.randn((6, 300, 40), generator=gen),
            "b": torch.randn((6, 10), generator=gen)}
    got = ops.topk_mask_stacked({k: v.to(cuda) for k, v in tree.items()}, 0.5)
    want = ops.topk_mask_stacked(tree, 0.5)
    for k in tree:
        assert torch.equal(got[k].cpu().view(torch.int32),
                           want[k].view(torch.int32)), k


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("preset,error_feedback",
                         [("fig5", False), ("fig5-fused-int8", True)])
def test_fig5_round_on_card_matches_cpu(cuda, preset, error_feedback):
    """Participants and bytes exact; losses, parameters and residuals
    within 1e-4 (cuDNN and the CPU reduce in different orders)."""
    ds = class_gaussian_images(num_train=256, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, 8, 16, seed=0)
    st = strategy.get(preset, error_feedback=error_feedback,
                      masking=strategy.MaskPolicy.selective(
                          0.5, backend="kernel"))
    runs = {}
    for device in ("cuda", "cpu"):
        params = pm.init_lenet(torch.Generator().manual_seed(0),
                               image_size=12, device=device)
        server = FederatedServer.from_strategy(
            st, pm.classifier_loss(pm.lenet_forward), params, 8, seed=0,
            device=device)
        server.run((xs, ys), ns, 3)
        runs[device] = server
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert [r.num_sampled for r in gpu.history] == \
        [r.num_sampled for r in cpu.history]
    assert gpu.summary()["transport_bytes"] == cpu.summary()["transport_bytes"]
    for a, b in zip(gpu.history, cpu.history):
        assert a.mean_loss == pytest.approx(b.mean_loss, rel=1e-4)
    for k, v in cpu.params.items():
        torch.testing.assert_close(gpu.params[k].cpu(), v, rtol=1e-4,
                                   atol=1e-4)
    res = cpu.store.residuals_dense()
    for k, v in gpu.store.residuals_dense().items():
        torch.testing.assert_close(v.cpu(), res[k], rtol=1e-4, atol=1e-4)


SCAN_CASES = [("fig5", {}), ("fig5-fused-int8", {"error_feedback": True}),
              ("fig3-importance", {}), ("hetero-dropout", {}),
              ("noniid-dyn", {}), ("byzantine-signflip", {})]


@pytest.fixture
def deterministic_cudnn():
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved


def _scan_run(st, scan: bool, rounds: int = 6):
    ds = class_gaussian_images(num_train=256, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, 8, 16, seed=0)
    params = pm.init_lenet(torch.Generator().manual_seed(0), image_size=12,
                           device="cuda")
    server = FederatedServer.from_strategy(
        st, pm.classifier_loss(pm.lenet_forward), params, 8, seed=0,
        device="cuda", scan_rounds=scan,
        eval_fn=pm.classifier_accuracy(pm.lenet_forward))
    seg.reset_launch_counts()
    server.run((xs, ys), ns, rounds, eval_every=3,
               eval_data=(torch.as_tensor(ds.test_x).cuda(),
                          torch.as_tensor(ds.test_y).cuda()))
    return server, seg.launch_counts()


@pytest.mark.parametrize("preset,over", SCAN_CASES)
def test_scan_rounds_replay_equals_the_eager_loop_bit_for_bit(
        cuda, deterministic_cudnn, preset, over):
    """The scan form's graph replays against the per-round loop on the
    card (LeNet-12, M = 8, 6 rounds, eval every 3): parameters, every
    store tree, norms, each round's loss bits and record, and the launch
    counts equal; one graph per bucket, one replay a round."""
    st = strategy.get(preset, **over)
    if st.masking.mode == "selective":
        st = st.with_masking(strategy.MaskPolicy.selective(
            st.masking.gamma, backend="kernel"))
    (scan, scan_counts), (loop, loop_counts) = (_scan_run(st, True),
                                                _scan_run(st, False))
    assert scan_counts == loop_counts
    if st.masking.mode == "selective":
        assert scan_counts["segmented_histogram"] == 6
    for k, v in scan.params.items():
        assert torch.equal(v, loop.params[k]), k
    for tree in scan.store.trees:
        want = loop.store.dense_view(tree)
        for k, v in scan.store.dense_view(tree).items():
            assert torch.equal(v, want[k]), (tree, k)
    if scan.store.norms is not None:
        assert torch.equal(scan.store.norms, loop.store.norms)
    for a, b in zip(scan.history, loop.history):
        assert (a.num_sampled, a.cohort_size, a.transport_bytes,
                a.quarantined, a.dropped, a.adversarial, a.sim_round_s) == \
            (b.num_sampled, b.cohort_size, b.transport_bytes, b.quarantined,
             b.dropped, b.adversarial, b.sim_round_s)
        assert a.mean_loss == b.mean_loss or (a.mean_loss != a.mean_loss
                                              and b.mean_loss != b.mean_loss)
        assert a.eval_metric == b.eval_metric
    stats = scan.graph_stats()
    assert stats["graphs"] == len({r.cohort_size for r in scan.history})
    assert stats["replays"] == 6
    assert loop.graph_stats()["graphs"] == 0


def test_scan_captures_again_for_batches_of_another_shape(
        cuda, deterministic_cudnn):
    """A later run with another batch size captures a graph of its own for
    the same bucket (the reference compiles again for new input shapes),
    and still equals the eager loop bit for bit."""
    st = strategy.get("fig5", masking=strategy.MaskPolicy.selective(
        0.5, backend="kernel"))
    runs = []
    for scan in (True, False):
        server, _ = _scan_run(st, scan, rounds=2)
        ds = class_gaussian_images(num_train=256, image_size=12, seed=1)
        xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, 8, 8,
                                          seed=1)
        server.run((xs, ys), ns, 2)
        runs.append(server)
    scan, loop = runs
    assert scan.graph_stats()["graphs"] == 2
    assert scan.graph_stats()["replays"] == 4
    for k, v in scan.params.items():
        assert torch.equal(v, loop.params[k]), k


def test_a_sync_inside_the_captured_round_raises(cuda):
    """A host sync in the part a graph captures fails the capture; nothing
    falls back to the eager round."""
    from repro_torch.core.graphs import CapturedRound

    def compute(params, carried, batches, n, inputs, mask, noise):
        x = params["w"] * 2.0
        if float(x.sum()) > 0:         # a device-to-host read
            x = x + 1.0
        return {}, {"x": x}

    args = ({"w": torch.ones(4, device=cuda)}, {}, [], torch.ones(
        2, device=cuda), {}, None, None)
    with pytest.raises(RuntimeError):
        CapturedRound(compute, args)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.parametrize("n", [1, 3001, 147_456, 1 << 20])
def test_topk_kernels_match_plain_versions(cuda, n):
    """Histograms and counts exact, apply bitwise, tails included."""
    x = measure.edge_vector(n, seed=n).to(cuda)
    assert torch.equal(tk.exponent_histogram(x),
                       tk.exponent_histogram_plain(x))
    for tau in (-1.0, 0.0, 1e-40, 2.0 ** -100, 1e-4, 0.3, 3e8,
                float("inf"), float("nan")):
        t = torch.tensor(tau, device=cuda)
        assert int(tk.count_ge(x, t)) == int(tk.count_ge_plain(x, t)), tau
        assert torch.equal(tk.apply_threshold(x, t).view(torch.int32),
                           tk.apply_threshold_plain(x, t).view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(512,), (300, 77), (3, 3, 128, 128)])
def test_topk_mask_on_card_matches_cpu(cuda, shape, dtype):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    got = ops.topk_mask(x.to(cuda), 0.25).cpu()
    want = ops.topk_mask(x, 0.25)
    assert torch.equal(got.float().view(torch.int32),
                       want.float().view(torch.int32))
    assert int(ops.masked_count(x.to(cuda), 0.5)) == int(
        ops.masked_count(x, 0.5))


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4095, 147_456])
def test_count_ge_on_views_at_any_offset(cuda, offset, n):
    """Views such as ``x[1:]`` and ``x[3:]`` start off the 16-byte
    boundary: the kernel's head and tail."""
    x = measure.edge_vector(n + 8, seed=n).to(cuda)
    view = x[offset:offset + n]
    for tau in (-1.0, 0.0, 1e-40, 1e-4, 0.3, float("inf"), float("nan")):
        t = torch.tensor(tau, device=cuda)
        assert int(tk.count_ge(view, t)) == int(tk.count_ge_plain(view, t))


def test_count_ge_ticket_resets_between_calls(cuda):
    """The last block sets the ticket back to 0: calls back to back, a call
    after an n = 0 call, and calls on a second stream agree."""
    x = measure.edge_vector(1 << 20, seed=3).to(cuda)
    t = torch.tensor(1e-3, device=cuda)
    want = int(tk.count_ge_plain(x, t))
    outs = [tk.count_ge(x, t), tk.count_ge(x[1:], t), tk.count_ge(x, t)]
    assert int(outs[0]) == int(outs[2]) == want
    assert int(outs[1]) == int(tk.count_ge_plain(x[1:], t))
    assert int(tk.count_ge(x[:0], t)) == 0
    assert int(tk.count_ge(x, t)) == want
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = [tk.count_ge(x, t) for _ in range(3)]
    side.synchronize()
    assert [int(g) for g in got] == [want] * 3


MARKER = "FillFunctor"     # the marker fills' kernel


def _device_records(prof) -> list:
    """Every device record of a trace as (name, start µs, duration µs),
    in start order."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted((e.name, e.time_range.start, e.time_range.elapsed_us())
                  for e in events)


def _profiled_calls(call, cuda, calls: int = 10):
    """Trace ``calls`` calls of ``call`` between two marker fills.  A first
    short session starts the tracer; the markers come first and last in
    the counted one, so a record the tracer drops as it starts or stops is
    a marker's, not the kernel's."""
    from torch.profiler import ProfilerActivity, profile
    marker = torch.empty(1, device=cuda)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        call()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.fill_(0.0)
        torch.cuda.synchronize()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        marker.fill_(1.0)
        torch.cuda.synchronize()
    return prof


def _assert_one_kernel_record_a_call(prof, kernel: str, calls: int):
    """``calls`` records of ``kernel`` and no record but the markers'
    beside them; a failure lists every record counted, by name with
    counts, and each record's start and duration."""
    import collections
    records = _device_records(prof)
    counts = collections.Counter(name for name, _, _ in records)
    ours = sum(n for name, n in counts.items() if kernel in name)
    others = [name for name in counts
              if kernel not in name and MARKER not in name]
    assert ours == calls and not others, (
        f"{ours} records of {kernel} for {calls} calls, others {others}: "
        f"counts {dict(counts)}; records {records}")


def test_count_ge_call_is_one_device_operation(cuda):
    """No memset before the kernel: ten count_ge calls put ten operations on
    the stream, every one the count kernel."""
    x = torch.randn(147_456, device=cuda)
    t = torch.tensor(0.5, device=cuda)
    prof = _profiled_calls(lambda: tk.count_ge(x, t), cuda)
    _assert_one_kernel_record_a_call(prof, "count_ge_kernel", 10)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 7, 4095, 147_457])
def test_exponent_histogram_on_views_at_any_offset(cuda, offset, n):
    """Views that start 1-3 elements in (off the 16-byte boundary) at odd
    lengths: the kernel's head and tail; n = 0 writes 128 zeros."""
    x = measure.edge_vector(n + 8, seed=n).to(cuda)
    view = x[offset:offset + n]
    got = tk.exponent_histogram(view)
    assert torch.equal(got, tk.exponent_histogram_plain(view))
    assert int(got.sum()) == int(((view != 0) & ~view.isnan()).sum())


def test_exponent_histogram_scratch_resets_between_calls(cuda):
    """The last block zeroes the scratch histogram and sets the ticket back
    to 0: calls back to back, a call after an n = 0 call, and calls on a
    second stream agree."""
    x = measure.edge_vector(1 << 20, seed=5).to(cuda)
    want = tk.exponent_histogram_plain(x)
    outs = [tk.exponent_histogram(x), tk.exponent_histogram(x[1:]),
            tk.exponent_histogram(x)]
    assert torch.equal(outs[0], want) and torch.equal(outs[2], want)
    assert torch.equal(outs[1], tk.exponent_histogram_plain(x[1:]))
    assert not tk.exponent_histogram(x[:0]).any()
    assert torch.equal(tk.exponent_histogram(x), want)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = [tk.exponent_histogram(x) for _ in range(3)]
    side.synchronize()
    assert all(torch.equal(g, want) for g in got)


def test_exponent_histogram_call_is_one_device_operation(cuda):
    """No memset before the kernel: ten calls put ten operations on the
    stream, every one the histogram kernel."""
    x = torch.randn(147_456, device=cuda)
    prof = _profiled_calls(lambda: tk.exponent_histogram(x), cuda)
    _assert_one_kernel_record_a_call(prof, "exponent_hist_kernel", 10)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 7, 4095, 147_457])
def test_apply_threshold_on_views_at_any_offset(cuda, offset, n):
    """Views that start 1-3 elements in (off the 16-byte boundary) at odd
    lengths: the kernel's head and tail, and an output at the view's
    offset from the boundary; bitwise.  n = 0 launches nothing."""
    x = measure.edge_vector(n + 8, seed=n).to(cuda)
    view = x[offset:offset + n]
    taus = (-1.0, 0.0, 1e-40, 2.0 ** -100, 1e-4, 0.3, float("inf"),
            float("nan"))
    tk.reset_launch_counts()
    for tau in taus:
        t = torch.tensor(tau, device=cuda)
        got = tk.apply_threshold(view, t)
        assert got.shape == view.shape
        assert (got.data_ptr() - view.data_ptr()) % 16 == 0
        assert measure.bitwise(got, tk.apply_threshold_plain(view, t)), tau
    assert tk.launch_counts()["apply_threshold"] == (len(taus) if n else 0)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_apply_launcher_refuses_an_output_off_the_inputs_alignment(
        cuda, offset):
    """The float4 stores need the output as far past a 16-byte boundary as
    x: for an x off the boundary and an output on it the C launcher
    returns an error and writes nothing."""
    from repro_torch.kernels import build
    x = measure.edge_vector(4096, seed=offset).to(cuda)
    view = x[offset:offset + 4000]
    out = torch.full((4000,), 7.0, device=cuda)
    assert out.data_ptr() % 16 == 0
    t = torch.tensor(1e-4, device=cuda)
    rc = build.library().topk_apply_launch(
        view.data_ptr(), 4000, t.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())


def test_apply_threshold_call_is_one_device_operation(cuda):
    """No scratch and no memset: ten calls put ten operations on the
    stream, every one the apply kernel."""
    x = torch.randn(147_456, device=cuda)
    t = torch.tensor(0.5, device=cuda)
    prof = _profiled_calls(lambda: tk.apply_threshold(x, t), cuda)
    _assert_one_kernel_record_a_call(prof, "apply_threshold_kernel", 10)


@pytest.mark.parametrize("offset", [0, 1])
def test_apply_threshold_equals_hardshrink_for_positive_tau(cuda, offset):
    """For tau > 0 and NaN-free x, ``hardshrink(x, nextafter(tau, 0))``
    (keeps |x| > lambda, writes +0.0) is the same function, bit for bit."""
    x = measure.edge_vector(147_456 + 8, seed=9)
    x[x.isnan()] = 1.0
    view = x.to(cuda)[offset:offset + 147_456]
    finite = view[view.isfinite()].abs()
    for tau in (2.0 ** -100, 1e-4, float(finite.median()),
                float(finite.max()), 3e8):
        lam = float(torch.nextafter(torch.tensor(tau),
                                    torch.tensor(0.0)))
        got = tk.apply_threshold(view, torch.tensor(tau, device=cuda))
        want = torch.nn.functional.hardshrink(view, lam)
        assert measure.bitwise(got, want), tau


def test_topk_wrappers_count_their_launches(cuda):
    x = torch.randn(5000, device=cuda)
    tk.reset_launch_counts()
    ops.topk_mask(x, 0.5)
    ops.masked_count(x, 0.1)
    assert tk.launch_counts() == {"exponent_histogram": 1, "count_ge": 9,
                                  "apply_threshold": 1}


@pytest.mark.usefixtures("one_torch_thread")
def test_gru_random_round_on_card_matches_cpu(cuda):
    """The same injected mask scores on both devices: participants, kept
    counts and bytes exact; losses and parameters within 1e-4 (the
    embedding backward accumulates with atomics on the card)."""
    ds = markov_text(num_train=8 * 400, vocab_size=256, seed=0)
    xs, ys, ns = partition_text(ds.train_tokens, 8, 8, 24, seed=0)
    params = pm.init_gru_lm(torch.Generator().manual_seed(0), 256, 64, 64,
                            device="cpu")
    maskable = {k: v.shape for k, v in params.items() if v.numel() >= 256}

    def mask_scores(t, m):
        gen = torch.Generator().manual_seed(100 + t)
        return {k: torch.rand((m,) + tuple(s), generator=gen)
                for k, s in maskable.items()}

    st = strategy.get("fig5", masking=strategy.MaskPolicy.random(0.5))
    runs = {}
    for device in ("cuda", "cpu"):
        server = FederatedServer.from_strategy(
            st, pm.gru_lm_loss, params, 8, seed=0, device=device,
            mask_scores=mask_scores)
        server.run((xs, ys), ns, 3)
        runs[device] = server
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert [r.num_sampled for r in gpu.history] == \
        [r.num_sampled for r in cpu.history]
    assert gpu.summary()["transport_bytes"] == cpu.summary()["transport_bytes"]
    for a, b in zip(gpu.history, cpu.history):
        assert a.mean_loss == pytest.approx(b.mean_loss, rel=1e-4)
    for k, v in cpu.params.items():
        torch.testing.assert_close(gpu.params[k].cpu(), v, rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------- model zoo
def _wkv6_inputs(B, T, H, D, seed, strong=False):
    gen = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, D), generator=gen) for _ in range(3))
    logw = -torch.exp(torch.empty((B, T, H, D)).uniform_(-4.0, 1.0,
                                                         generator=gen))
    if strong:                      # the model's clip, e^4, on half the lanes
        logw[..., : D // 2] = -float(torch.tensor(4.0).exp())
    u = 0.1 * torch.randn((H, D), generator=gen)
    s0 = torch.randn((B, H, D, D), generator=gen)
    return [r, k, v, logw, u, s0]


@pytest.mark.parametrize("shape", [(2, 100, 3, 64), (1, 1, 2, 32),
                                   (2, 64, 4, 32), (1, 257, 2, 64),
                                   (2, 17, 3, 64), (2, 31, 2, 32),
                                   (2, 65, 2, 64), (1, 300, 1, 64),
                                   (1, 100, 1, 32)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("strong", [False, True])
def test_wkv6_kernel_matches_plain_version(cuda, shape, strong):
    """Both fp32, summed in other orders: atol 1e-3 on outputs up to about
    100, rtol 1e-4."""
    x = [t.to(cuda) for t in _wkv6_inputs(*shape, seed=0, strong=strong)]
    y, s = wk.wkv6(*x)
    torch.cuda.synchronize()
    y_plain, s_plain = wk.wkv6_plain(*x)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, y_plain, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(s, s_plain, atol=1e-3, rtol=1e-4)


def test_wkv6_call_is_one_launch(cuda):
    x = [t.to(cuda) for t in _wkv6_inputs(2, 130, 2, 64, seed=0)]
    wk.reset_launch_counts()
    wk.wkv6(*x)
    torch.cuda.synchronize()
    assert wk.launch_counts() == {"wkv6": 1, "wkv6_backward": 0}


def test_wkv6_kernel_refuses_unaligned_inputs(cuda):
    x = [t.to(cuda) for t in _wkv6_inputs(1, 8, 2, 32, seed=0)]
    flat = torch.zeros(x[0].numel() + 1, device=cuda)
    x[0] = flat[1:].view(x[0].shape)
    with pytest.raises(ValueError, match="16-byte"):
        wk.wkv6(*x)


def test_wkv6_kernel_refuses_other_head_dims(cuda):
    x = [t.to(cuda) for t in _wkv6_inputs(1, 8, 2, 16, seed=0)]
    with pytest.raises(ValueError, match="head dims"):
        wk.wkv6(*x)


@pytest.mark.parametrize("shape", [(1, 8, 4, 2), (2, 37, 19, 4),
                                   (2, 300, 33, 16), (1, 256, 256, 8),
                                   (1, 5, 3, 1), (1, 9, 2, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssm_scan_kernel_matches_plain_version(cuda, shape):
    """Both fp32; the kernel fuses the update into an FMA and sums the
    state lanes as a butterfly: atol 1e-4, rtol 1e-5."""
    B, T, d, N = shape
    gen = torch.Generator().manual_seed(1)
    a = torch.sigmoid(torch.randn((B, T, d, N), generator=gen)).to(cuda)
    bx = torch.randn((B, T, d, N), generator=gen).to(cuda)
    c = torch.randn((B, T, N), generator=gen).to(cuda)
    h0 = torch.randn((B, d, N), generator=gen).to(cuda)
    y, hT = ssk.ssm_scan(a, bx, c, h0)
    torch.cuda.synchronize()
    y_plain, h_plain = ssk.ssm_scan_plain(a, bx, c, h0)
    torch.testing.assert_close(y, y_plain, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(hT, h_plain, atol=1e-4, rtol=1e-5)


def test_ssm_scan_kernel_refuses_other_state_dims(cuda):
    x = torch.zeros((1, 4, 3, 3), device=cuda)
    with pytest.raises(ValueError, match="divide 32"):
        ssk.ssm_scan(x, x, torch.zeros((1, 4, 3), device=cuda),
                     torch.zeros((1, 3, 3), device=cuda))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_reduced_serving_on_card_matches_cpu(cuda, arch):
    """fp32 prefill and greedy generate of the reduced config on the card
    (kernels) and on the CPU (plain versions): logits within 1e-4, tokens
    equal; the prefill launches its kernel once per recurrent layer and
    generate never."""
    import dataclasses
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              compute_dtype="float32")
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            "float32", device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(1))
    prefill = steps.make_prefill_step(cfg)
    counts = wk if arch.startswith("rwkv") else ssk
    counts.reset_launch_counts()
    got = prefill({k: v.to(cuda) for k, v in params.items()},
                  {"tokens": toks.to(cuda)})
    assert sum(counts.launch_counts().values()) == cfg.num_layers
    want = prefill(params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    counts.reset_launch_counts()
    gen_card = serve.generate(cfg, {k: v.to(cuda) for k, v in
                                    params.items()}, toks[:, :40].to(cuda),
                              8, 49)
    assert sum(counts.launch_counts().values()) == 0
    gen_cpu = serve.generate(cfg, params, toks[:, :40], 8, 49)
    assert torch.equal(gen_card.cpu(), gen_cpu)


def _store_script(store, device):
    """One sequence of commit-masked scatters over two trees that fills a
    4-slot window and evicts, then every client's rows gathered."""
    gen = torch.Generator().manual_seed(7)
    script = [(1, [1, 4, 6], [1.0, 0.0, 1.0]), (2, [2, 3, 6], [1.0] * 3),
              (3, [5, 7], [1.0, 1.0]), (4, [0, 1, 8, 9], [1.0, 1.0, 1.0, 0.0])]
    for rnd, ids, commit in script:
        for tree in ("residuals", "drift"):
            rows = {"w": torch.randn((len(ids), 300), generator=gen),
                    "b": torch.randn((len(ids),), generator=gen)}
            store.scatter(ids, {k: v.to(device) for k, v in rows.items()},
                          torch.tensor(commit, device=device), rnd, tree=tree)
    return {tree: store.gather(list(range(10)), tree)
            for tree in ("residuals", "drift")}


@pytest.mark.usefixtures("one_torch_thread")
def test_sharded_store_on_card_matches_cpu(cuda):
    """Gather, commit-masked scatter, eviction and the fresh slots' zeroing
    on the card against the same sequence on the CPU: pools, gathered rows
    and the slot directory exact."""
    from repro_torch.core.client_store import ShardedStore
    stores, rows = {}, {}
    for device in ("cuda", "cpu"):
        template = {"w": torch.zeros(300, device=device),
                    "b": torch.zeros((), device=device)}
        stores[device] = ShardedStore(10, template, 4,
                                      extra_trees={"drift": template})
        rows[device] = _store_script(stores[device], device)
    gpu, cpu = stores["cuda"], stores["cpu"]
    assert gpu.slots["w"].device.type == "cuda"
    assert gpu.evictions == cpu.evictions > 0
    assert (gpu._slot_ids == cpu._slot_ids).all()
    assert (gpu._slot_round == cpu._slot_round).all()
    for tree in ("residuals", "drift"):
        for k, v in rows["cpu"][tree].items():
            assert torch.equal(rows["cuda"][tree][k].cpu(), v), (tree, k)
        for k, v in cpu._pools[tree].items():
            assert torch.equal(gpu._pools[tree][k].cpu(), v), (tree, k)


# ------------------------------------------------ attacks and robust rules
def test_row_l2_on_card_has_the_cpu_bits(cuda):
    """The repaired norm: the same bits on the card as on the CPU, over
    leaves of 1 to 147,456 entries, 256 rows, and magnitudes 1e-3 to 1e3."""
    from repro_torch.core.federated import _row_l2
    gen = torch.Generator().manual_seed(7)
    tree = {f"l{i}": torch.randn((256, n), generator=gen) * scale
            for i, (n, scale) in enumerate([(1, 1.0), (3, 1e3), (1000, 1e-3),
                                            (147_456, 0.1), (4097, 1.0)])}
    tree["l3"][:, ::3] = 0.0
    got = _row_l2({k: v.to(cuda) for k, v in tree.items()}).cpu()
    assert torch.equal(got, _row_l2(tree))


@pytest.mark.usefixtures("one_torch_thread")
def test_attack_noise_on_card_is_within_an_ulp_of_the_cpu(cuda):
    from repro_torch.core.attacks import client_attack_noise
    leaves = {"w": (300, 7), "b": (5,)}
    ids = [0, 3, 99, 123_456]
    got = client_attack_noise(3, 2, ids, leaves)
    want = client_attack_noise(3, 2, ids, leaves, "cpu")
    for k, v in want.items():
        g = got[k].cpu()
        ulp = torch.nextafter(v.abs(), torch.tensor(float("inf"))) - v.abs()
        assert bool(((g - v).abs() <= ulp).all()), k


@pytest.mark.parametrize("rule", ["coordinate_median", "trimmed_mean",
                                  "krum", "multi_krum", "norm_filter"])
def test_robust_rules_on_card_match_cpu(cuda, rule):
    """Sparse uploads with zero-weight rows: the median and Krum's choice
    exact, multi-Krum's ranks and the filter's kept rows exact; the
    weighted sums they end in (the trimmed mean's, FedAvg's over the kept
    rows) within 1e-6: the card's reductions run in another order."""
    args = {"trimmed_mean": (0.2,), "krum": (1,), "multi_krum": (1, 3),
            "norm_filter": (6.0,)}.get(rule, ())
    agg = strategy.get_aggregator(rule, *args)
    gen = torch.Generator().manual_seed(1)
    up = {"w": torch.randn((9, 6, 5), generator=gen),
          "b": torch.randn((9, 3), generator=gen)}
    up["w"][torch.rand((9, 6, 5), generator=gen) < 0.6] = 0.0
    w = torch.randint(1, 50, (9,), generator=gen).float()
    w[[0, 4]] = 0.0
    g = {k: torch.randn(v.shape[1:], generator=gen) for k, v in up.items()}
    want = agg.fn(g, up, w, "delta")
    got = agg.fn({k: v.to(cuda) for k, v in g.items()},
                 {k: v.to(cuda) for k, v in up.items()}, w.to(cuda), "delta")
    for k, v in want.items():
        if rule in ("trimmed_mean", "multi_krum", "norm_filter"):
            torch.testing.assert_close(got[k].cpu(), v, rtol=1e-6,
                                       atol=1e-6)
        else:
            assert torch.equal(got[k].cpu(), v), k
    from repro_torch.core import robust
    from repro_torch.core.federated import _row_l2
    if rule == "multi_krum":
        ranks = [torch.argsort(torch.argsort(
            robust._krum_scores(u, ww, 1)[0].cpu(), stable=True),
            stable=True) for u, ww in
            ((up, w), ({k: v.to(cuda) for k, v in up.items()}, w.to(cuda)))]
        assert torch.equal(ranks[0], ranks[1])
    if rule == "norm_filter":
        assert torch.equal(_row_l2({k: v.to(cuda) for k, v in up.items()})
                           .cpu() <= 6.0, _row_l2(up) <= 6.0)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("kind", ["sign_flip", "scale", "gauss", "zero",
                                  "nan"])
def test_attacked_forms_on_card_are_bit_identical(cuda, kind):
    """LeNet-12, M = 10, 5 rounds, fig5 with error feedback under each
    attack kind: on the card the cohort, full and store forms give the same
    parameters and residuals bit for bit, and the card's ledger is the
    CPU's."""
    from repro_torch.core.attacks import AttackModel
    from repro_torch.core.client_store import ShardedStore
    ds = class_gaussian_images(num_train=320, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, 10, 16, seed=0)
    st = strategy.get("fig5", error_feedback=True).replace(
        attack=AttackModel(kind=kind, fraction=0.3, strength=2.0, sigma=0.05))
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for device in ("cuda", "cpu"):
            for form in ("full", "cohort", "store"):
                params = pm.init_lenet(torch.Generator().manual_seed(0),
                                       image_size=12, device=device)
                store = (ShardedStore(10, params, 10) if form == "store"
                         else None)
                server = FederatedServer.from_strategy(
                    st, pm.classifier_loss(pm.lenet_forward), params, 10,
                    seed=0, device=device, store=store,
                    engine="full" if form == "full" else "cohort")
                if form == "store":
                    xd, yd = (torch.as_tensor(a).to(device) for a in (xs, ys))
                    server.run(lambda ids, xd=xd, yd=yd: (
                        xd[torch.as_tensor(ids).to(device)],
                        yd[torch.as_tensor(ids).to(device)]), ns, 5)
                else:
                    server.run((xs, ys), ns, 5)
                runs[device, form] = server
    finally:
        torch.backends.cudnn.deterministic = False

    def ledger(s):
        return [(r.num_sampled, r.cohort_size, r.adversarial, r.quarantined,
                 r.transport_bytes) for r in s.history]

    full = runs["cuda", "full"]
    assert min(r.cohort_size for r in runs["cuda", "cohort"].history) < 10
    for form in ("cohort", "store"):
        other = runs["cuda", form]
        for k, v in full.params.items():
            assert torch.equal(v, other.params[k]), (form, k)
        ra, rb = full.store.residuals_dense(), other.store.residuals_dense()
        for k in ra:
            assert torch.equal(ra[k], rb[k]), (form, k)
    for form in ("full", "cohort", "store"):
        assert ledger(runs["cuda", form]) == ledger(runs["cpu", form])
    assert sum(r.adversarial for r in full.history) > 0


# ------------------------------------------------------- the training path
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrence_backward_kernels_on_card(cuda, arch):
    """wkv6 and ssm_scan differentiate on the card through their
    autograd.Functions: the gradients (one launch of the backward kernel)
    against the plain backward on the same card tensors, each within 1e-4
    (wkv6) or 1e-5 (ssm_scan) of its largest magnitude; two runs of the
    backward bit for bit; and ``lm_loss`` of the reduced model
    backpropagates through both kernels to finite gradients."""
    gen = torch.Generator().manual_seed(1)
    if arch == "rwkv6-1.6b":
        fwd, bwd, tol = wk.wkv6, wk.wkv6_backward_plain, 1e-4
        counts = wk
        x = _wkv6_inputs(2, 100, 2, 64, 0)
        adj = [torch.randn((2, 100, 2, 64), generator=gen),
               torch.randn((2, 2, 64, 64), generator=gen)]
    else:
        fwd, bwd, tol = ssk.ssm_scan, ssk.ssm_scan_backward_plain, 1e-5
        counts = ssk
        x = [torch.sigmoid(torch.randn((2, 100, 40, 16), generator=gen)),
             torch.randn((2, 100, 40, 16), generator=gen),
             torch.randn((2, 100, 16), generator=gen),
             torch.randn((2, 40, 16), generator=gen)]
        adj = [torch.randn((2, 100, 40), generator=gen),
               torch.randn((2, 40, 16), generator=gen)]
    x = [t.to(cuda) for t in x]
    adj = [t.to(cuda) for t in adj]
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in x]
        outs = fwd(*leaves)
        counts.reset_launch_counts()
        runs.append(torch.autograd.grad(
            sum((o * a).sum() for o, a in zip(outs, adj)), leaves))
        torch.cuda.synchronize()
        assert sum(counts.launch_counts().values()) == 1
    want = bwd(*x, *adj)
    for g, again, w in zip(runs[0], runs[1], want):
        assert torch.equal(g, again)
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())
    import dataclasses
    cfg = get_arch(arch).reduced()
    if arch == "hymba-1.5b":
        cfg = dataclasses.replace(cfg, layer_pattern=cfg.layer_pattern[:2],
                                  num_layers=2)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device=cuda)
    params = {k: v.requires_grad_() for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab_size, (1, 70), device=cuda)
    counts.reset_launch_counts()
    loss = tr.lm_loss(params, cfg, {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert min(counts.launch_counts().values()) > 0


@pytest.mark.parametrize("kernel,shape,strong", [
    ("wkv6", (2, 1, 2, 32), False), ("wkv6", (2, 1, 2, 64), False),
    ("wkv6", (2, 65, 2, 32), False), ("wkv6", (2, 65, 2, 64), False),
    ("wkv6", (2, 130, 2, 64), True), ("ssm_scan", (2, 1, 40, 16), False),
    ("ssm_scan", (2, 17, 40, 16), False), ("ssm_scan", (2, 65, 40, 16),
                                             False)],
    ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_recurrence_backward_kernels_at_grid_edges(cuda, kernel, shape,
                                                   strong):
    """The backward kernels at the edges of their grids (T = 1, a step past
    a chunk, B = 2, D = 32 and 64, the strongest decay): finite, two runs
    bit for bit, each gradient within 1e-4 (wkv6) or 1e-5 (ssm_scan) of its
    largest magnitude of the plain backward's."""
    gen = torch.Generator().manual_seed(3)
    if kernel == "wkv6":
        B, T, H, D = shape
        x = _wkv6_inputs(B, T, H, D, 4, strong=strong)
        adj = [torch.randn((B, T, H, D), generator=gen),
               torch.randn((B, H, D, D), generator=gen)]
        kern, plain, tol = wk.wkv6_backward, wk.wkv6_backward_plain, 1e-4
    else:
        B, T, d, N = shape
        x = [torch.sigmoid(torch.randn(shape, generator=gen)),
             torch.randn(shape, generator=gen),
             torch.randn((B, T, N), generator=gen),
             torch.randn((B, d, N), generator=gen)]
        adj = [torch.randn((B, T, d), generator=gen),
               torch.randn((B, d, N), generator=gen)]
        kern, plain, tol = (ssk.ssm_scan_backward,
                            ssk.ssm_scan_backward_plain, 1e-5)
    x = [t.to(cuda) for t in x]
    adj = [t.to(cuda) for t in adj]
    first, again = kern(*x, *adj), kern(*x, *adj)
    torch.cuda.synchronize()
    want = plain(*x, *adj)
    for g, g2, w in zip(first, again, want):
        assert torch.equal(g, g2)
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= tol * float(
            w.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("T", [1, 17, 25, 65])
def test_ssm_scan_checkpointing_forward_matches_plain(cuda, T):
    """The forward that training runs (it also writes h every 16 steps):
    y and hT against the plain scan, the checkpoints against the plain
    checkpointing forward, atol 1e-4 / rtol 1e-5, at T = 1, one pass of 16
    and a step, the eight-step remainder and a step past four passes."""
    gen = torch.Generator().manual_seed(5)
    shape = (2, T, 40, 16)
    x = [torch.sigmoid(torch.randn(shape, generator=gen)),
         torch.randn(shape, generator=gen),
         torch.randn((2, T, 16), generator=gen),
         torch.randn((2, 40, 16), generator=gen)]
    x = [t.to(cuda) for t in x]
    y, hT, hk = ssk._forward(*x, checkpoints=True)
    torch.cuda.synchronize()
    assert tuple(hk.shape) == (2, -(-T // ssk.CHECKPOINT), 40, 16)
    for got, want in zip((y, hT, hk), ssk._ssm_scan_checkpoint_plain(*x)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("kind", ["full", "sliding", "chunked"])
def test_flash_attention_backward_on_card_matches_cpu(cuda, kind):
    """fp32, GQA 4/2, softcap, q_offset: output and (dq, dk, dv) on the
    card against the CPU, rtol 1e-4 / atol 1e-5."""
    from repro_torch.models import attention as attn
    gen = torch.Generator().manual_seed(2)
    q = torch.randn((2, 40, 4, 16), generator=gen)
    k, v = (torch.randn((2, 48, 2, 16), generator=gen) for _ in range(2))
    g = torch.randn((2, 40, 4, 16), generator=gen)
    outs = []
    for dev in ("cpu", cuda):
        ins = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = attn.flash_attention(*ins, attn=kind, window=16,
                                   softcap_val=30.0, q_offset=8, block_q=16)
        grads = torch.autograd.grad(out, ins, g.to(dev))
        outs.append([t.detach().cpu() for t in (out, *grads)])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.usefixtures("one_torch_thread")
def test_pod_round_on_card_matches_cpu(cuda):
    """The reduced pod round (fig5 on the kernels, axis-0 wire) on the
    card; the CPU masks each card delta on the plain versions (masks bit
    for bit) and aggregates its own masks (parameters bit for bit: the
    same masks, wire and fp32 sum order)."""
    from repro_torch.core.strategy import MaskPolicy
    from repro_torch.launch import fedtrain as ft
    cfg = get_arch("qwen2-1.5b").reduced()
    st = strategy.get("fig5").with_masking(
        MaskPolicy.selective(0.5, backend="kernel"))
    fed_cfg = ft.FedPodConfig.from_strategy(st, 4, local_steps=2)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 2, 2, 32),
                         generator=torch.Generator().manual_seed(1))
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
    part = torch.tensor([1.0, 1.0, 0.0, 1.0])
    seen = {}
    seg.reset_launch_counts()
    new, m = ft.make_fed_round(cfg, fed_cfg, observe=lambda c, d, k: seen.
                               __setitem__(c, ({n: v.cpu() for n, v in
                                                d.items()},
                                               {n: v.cpu() for n, v in
                                                k.items()})))(
        {k: v.to(cuda) for k, v in params.items()}, batches, torch.ones(4),
        part)
    torch.cuda.synchronize()
    assert seg.launch_counts()["segmented_count"] == 8
    assert float(m["num_sampled"]) == 3.0
    upload = ft._Upload(params, fed_cfg.codec)
    w = ft._weights(part, torch.ones(4), True)
    for c in range(4):
        delta, masked = seen[c]
        cpu_masked = ft.mask_deltas(delta, fed_cfg)
        for n in masked:
            assert torch.equal(cpu_masked[n], masked[n]), (c, n)
        upload.add(cpu_masked, float(w[c]))
    for k, v in upload.apply(params).items():
        assert torch.equal(new[k].cpu(), v), k


def _moe_cfg(real: int):
    """Reduced qwen2-moe-a2.7b: 2 layers, top 4 over ``real`` experts
    padded to a multiple of 16, fp32."""
    import dataclasses
    return dataclasses.replace(
        get_arch("qwen2-moe-a2.7b").reduced(), num_layers=2,
        moe_experts=real, moe_pad_experts=True, moe_topk=4,
        compute_dtype="float32", param_dtype_serve="float32")


def _routed_run(cfg, params, toks, device, steps_: int, monkeypatch):
    """forward over ``toks`` in groups of 32 and ``steps_`` decode steps
    on ``device``: (logits, decode logits, every call's (ids, positions,
    keep))."""
    from repro_torch.models import moe
    log = []
    original = moe.route

    def record(*args, **kw):
        r = original(*args, **{**kw, "group_size": 32})
        log.append(r)
        return r
    monkeypatch.setattr(moe, "route", record)
    on = {k: v.to(device) for k, v in params.items()}
    with torch.no_grad():
        logits = tr.forward(on, cfg, toks.to(device))[0]
        state = tr.init_decode_state(cfg, toks.shape[0], steps_ + 1,
                                     "float32", device=device)
        dec = []
        for t in range(steps_):
            lg, state = tr.decode_step(on, cfg, state,
                                       toks[:, t:t + 1].to(device))
            dec.append(lg)
    monkeypatch.undo()
    return (logits.cpu(), torch.cat(dec, 1).cpu(),
            [(r.expert_ids.cpu(), r.positions.cpu(), r.keep.cpu())
             for r in log])


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("real", [13, 60])
def test_moe_routing_on_card_matches_cpu(cuda, real, monkeypatch):
    """The MoE through forward (2 x 64 tokens in groups of 32: capacity
    binds) and 8 decode steps on the card and the CPU from the same
    weights: ids, capacity positions and keep masks equal call by call,
    no padded expert picked, logits within 1e-3 of their largest
    magnitude, no kernel of the port launched."""
    cfg = _moe_cfg(real)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            "float32", device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    for module in (seg, tk, wk, ssk):
        module.reset_launch_counts()
    card = _routed_run(cfg, params, toks, cuda, 8, monkeypatch)
    assert all(sum(m.launch_counts().values()) == 0
               for m in (seg, tk, wk, ssk))
    cpu = _routed_run(cfg, params, toks, "cpu", 8, monkeypatch)
    assert len(card[2]) == len(cpu[2]) == cfg.num_layers * 9
    for a, b in zip(card[2], cpu[2]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert int(a[0].max()) < real
    assert sum(int((~keep).sum()) for _, _, keep in card[2][:2]) > 0
    for got, want in zip(card[:2], cpu[:2]):
        assert float((got - want).abs().max()) <= \
            1e-3 * float(want.abs().max())


def test_gemma2_decode_agrees_with_forward_on_card(cuda):
    """Reduced gemma2-2b in fp32 on the card: the forward over 40 tokens
    (past the 32-token window) and 40 decode steps agree within the
    reference's serve == prefill tolerance (atol 2e-3, rtol 1e-3)."""
    import dataclasses
    cfg = dataclasses.replace(get_arch("gemma2-2b").reduced(),
                              compute_dtype="float32")
    params = tr.init_params(torch.Generator(device=cuda).manual_seed(0),
                            cfg, "float32", device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    with torch.no_grad():
        fwd = tr.forward(params, cfg, toks)[0][..., :cfg.vocab_size]
        state = tr.init_decode_state(cfg, 2, 41, "float32", device=cuda)
        dec = []
        for t in range(40):
            lg, state = tr.decode_step(params, cfg, state, toks[:, t:t + 1])
            dec.append(lg)
    torch.testing.assert_close(torch.cat(dec, 1), fwd.float(), atol=2e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-14b",
                                  "qwen2-moe-a2.7b", "musicgen-medium",
                                  "internvl2-26b", "qwen2-72b",
                                  "llama4-maverick-400b-a17b"])
def test_new_arch_init_on_card_matches_the_specs(cuda, arch):
    """``init_params`` on the card (bf16) has the names, shapes and dtypes
    of ``steps.params_specs`` (which the CPU tests hold to the reference's
    tree): bf16 leaves, the MoE router in fp32."""
    cfg = get_arch(arch).reduced()
    got = tr.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                         "bfloat16", device=cuda)
    want = steps.params_specs(cfg, "bfloat16")
    assert list(got) == list(want)
    for name, t in got.items():
        assert t.is_cuda and t.shape == want[name].shape, name
        assert t.dtype == want[name].dtype, name
        assert t.dtype == (torch.float32 if name.endswith(".router")
                           else torch.bfloat16), name
        assert bool(t.isfinite().all()), name


def test_stacked_init_on_card_draws_one_slice_at_a_time(cuda):
    """``dense_init`` from a card generator draws a stack one leading slice
    at a time into its dtype: each slice at the fan-in scale, and the peak
    beside the bf16 leaf is one slice's fp32 buffer, not the leaf's."""
    from repro_torch.models.common import dense_init
    shape = (8, 512, 2048)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = dense_init(gen, shape, torch.bfloat16)
    peak = torch.cuda.max_memory_allocated() - base
    leaf = w.numel() * 2
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == shape
    assert peak <= leaf + 2 * 4 * w[0].numel()
    stds = w.float().std(dim=(1, 2))
    assert torch.allclose(stds, torch.full_like(stds, 0.88 * 512 ** -0.5),
                          rtol=0.05)
    assert not torch.equal(w[0], w[1])
