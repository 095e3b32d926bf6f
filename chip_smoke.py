#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py           # every phase, one card
    python3 chip_smoke.py --profile # also trace two more rounds of the
                                    # fused LeNet path, vgg-fig5,
                                    # noniid-dyn and the store path, and
                                    # one prefill and 11
                                    # decode steps of each served arch

Phases, each printing its result on its own line; any failure ends the run
with a nonzero exit:

1. environment — card name and power limit, torch/CUDA versions, TF32
   settings (both off), and the kernel build time (one ``nvcc`` per source
   for sm_90a, all started together: segmented, topk_mask, wkv6,
   ssm_scan); then ``wkv6_build``: each wkv6 kernel's registers, stack
   and spills from the ``-Xptxas -v`` log, its threads, blocks a head and
   dynamic shared memory, and its TF32 HMMA and MUFU.EX2 counts in the
   SASS (``cuobjdump``; a kernel without HMMA fails the run); and
   ``wire_build``: the registers, stack and spills of the histogram and
   stats kernels, of both encode kernels (int8, fp32) and of the per-array
   histogram kernel; then ``seed_hashes``: sha256 of the LeNet main
   path's seed-0 data (images, IID and Dirichlet partitions), which must
   equal the values pinned on the CPU against the reference's arrays, and
   of the seed-0 ``init_lenet()`` leaves, reported beside the CPU's;
2. kernel parity — each of the five segmented CUDA kernels against its
   plain PyTorch version at the main path's shape (the cohort-packed
   LeNet-28 delta, 32 x 106 rows x 1024, S = 128) and on one 2^26-element
   buffer with 64 segments: histograms, counts, bitmaps and int8 codes
   exact, masked values and maxima bitwise; the count kernel also at
   C in {1, 8, 16, 17, 32, 4096} candidates, sorted, and shuffled with
   duplicates, NaN, inf, -0.0 and negative taus; then ``wire_edge_parity``:
   the histogram, stats and encode (int8 and fp32) bitwise against their
   plain versions
   on the edge inputs of ``kernels/measure.py`` at R in {1, 3, 5,
   4095, 33797} rows (NaN, +-inf, -0.0, subnormals, magnitudes at and
   beside 2^-96; segments of 1-7 rows, ids S + 1 and -2; scales of 1e-12,
   inf and NaN);
3. main paths, each through ``FederatedServer.from_strategy(...).run(...)``
   with M = 32 clients for 8 rounds, with the launch counts set to 0 just
   before and read just after:
   - LeNet-28 ``fig5`` (kernel masking, COO wire, FedAvg): m_t, buckets,
     exact wire bytes, a finite falling loss, launches 8/16/8;
   - LeNet-28 ``fig5-fused-int8`` (the fused int8 COO wire from one stats
     and one encode launch per round): the same checks, 268,966 bytes per
     upload, launches 8/16/8/8/8;
   - ``vgg-fig5`` (VGG, 617,770 parameters, 32 px CIFAR-shaped images),
     ``gru-fig5`` and ``gru-random`` (GRU-LM, 180,608 parameters, Markov
     text, random masking): m_t, buckets, exact bytes, a finite falling
     loss, the eval metric on held-out data, segmented launches 8/16/8 on
     the fig5 paths and 0 on gru-random, per-array launches 0 everywhere;
     for gru-random the exact kept count of every client's upload;
   then, on one round's stacked masked delta from the card, the fused
   codec's roundtrip against the plain codec chain's for all four wire
   pairings (bitwise, equal wire bytes); and small runs on the card
   against the same runs on the CPU (LeNet fig5; fig5-fused-int8 with
   error feedback; VGG-16 px and GRU-small on fig5; GRU-small on random
   with the same injected mask scores); then ``adaptive_path``, the
   generalized round bodies on LeNet-28 (M = 32, 8 rounds, counts set to 0
   just before each and read just after): ``fig3-importance`` (importance
   sampler, dense, oracle and cohort bodies), ``hetero-dropout`` (the
   flaky-mobile fleet's upload dropout, full participation, oracle body),
   ``noniid-dyn`` (FedDyn drift, importance sampler, kernel masking on a
   Dirichlet(0.5) partition: 8/16/8 launches) and ``fig5-fused-int8``
   under the threshold sampler on the flaky-mobile fleet (8/16/8/8/8):
   bytes equal to the participants' uploads, buckets as the sampler plans
   them, finite parameters, norms and drift, and a falling loss for
   fig3-importance and noniid-dyn; and each of the four at the small size
   on the card against the CPU (participants, arrived masks, bytes,
   ``sim_round_s`` and ``dropped`` exact);
3b. the client-state store: kernels 1-5 against their plain versions on
   the store path's own full-width VGG cohort buffer (its bucket of 256
   clients from the strategy's plan: 158,334,976 elements, 2,816
   segments) and on a 512-client one (316,669,952 elements, 5,632
   segments); ``store_path``: the store form of the round at fleet scale,
   full-width VGG on the reference's store operating point (M = 100,000
   on ``ShardedStore(retention=1024)``, importance sampler, error
   feedback, kernel masking, COO wire, a batch provider over 512 shards
   on the card), 8 rounds under deterministic cuDNN with the counts set
   to 0 just before and read just after (8/16/8), each round's m_t,
   bucket, participants, bytes, evictions, ``wall_s``, ``compile_s`` and
   smallest importance-draw margin in ulps, then ``memory_bytes()``
   against the residual bound ``(retention + 1) / M`` of the dense
   footprint, ``max_memory_allocated`` and the dense bytes avoided;
   ``store_resume``: a fresh server restores the round-4 checkpoint (save
   and restore seconds) and runs rounds 5-8 bit-identically to the
   uninterrupted run (parameters, pools, slot directory, evictions,
   versions, norms, m_t and bytes), then three more rounds on each server
   with and without deterministic cuDNN (its cost), and the same resume
   on the LeNet ``fig5`` main path's dense store;
   ``small_store_agreement``: the store path at the small VGG (M = 64,
   window 16, 6 rounds) on the card against the CPU (participants, slot
   directory, evictions, versions and bytes exact), and the store path's
   ``round_time``.  In ``store_path`` each round's payload norms
   (``federated._row_l2``) are also computed on the CPU from the card's
   payload: the bits, the norm vectors they give and the participants the
   CPU selection draws from each for the next round must be equal in
   every round (``norm_bits_equal_rounds``), and the norm's cost at the
   round-1 bucket is timed beside the ``torch.sum`` form it replaced;
3c. the async engine: ``async_path``, ``async_keystone``,
   ``small_async_agreement``, ``async_store``, ``async_resume`` and
   ``random_mask_store``;
3d. Byzantine attacks and robust aggregation: ``robust_path``, full-width
   VGG, M = 32, 8 rounds on the cohort engine for ``byzantine-signflip``,
   ``robust-median`` and ``robust-krum`` with fig5's masking on the
   kernels (counts set to 0 just before each run and read just after:
   8/16/8), one ``robust_round`` line a round (m_t, participants,
   adversarial, quarantined, bytes, ``wall_s``, the aggregation call's
   device time by CUDA events), the run's median, peak memory and final
   loss beside the honest ``vgg-fig5`` run's (no bar on it);
   ``attack_agreement``: every attack kind at LeNet-28, M = 12, 5 rounds
   on the full, cohort and store forms, card against CPU, the CPU
   replaying the card's client sweeps (participants, adversarial,
   quarantined and bytes exact, parameters within ATTACK_TOL) and on the
   card cohort == full == store bit for bit; ``attack_noise``: the gauss
   draws of 32 clients over full-width VGG, card against CPU, within one
   fp32 ulp; ``async_attack``: the async keystone on the three presets
   and a nan attack on ``async-flaky`` quarantined event by event;
4. the per-array path — ``ops.topk_mask(leaf, 0.5)`` on every maskable leaf
   of one client's VGG and GRU delta from the main paths, launch counts set
   to 0 just before and read just after (1/8/1 per leaf): kept <= k per
   leaf, and the entries where it and the round's segmented mask differ;
   then the three per-array kernels against their plain versions on those
   leaves, on the whole VGG delta as one vector, on a 2^26-element vector
   and on edge inputs (subnormals, +-inf, NaN), all three also on views of
   each that start 1-3 elements in, at odd lengths (0 and 1 included),
   and ``ops.topk_mask``
   on the kernels against the same pipeline on the plain versions
   (bitwise);
5. timing — each kernel's median time (CUDA events) on inputs that are not
   in the L2 cache, and on one buffer that stays there (``warm_ms``), its
   traced time per launch (``device_ms``: no launch gaps) with the trace's
   device records, the kernel's own records and the calls made (a
   per-array kernel that puts more than one record a call on the stream
   fails the run), beside
   its bound (bytes moved over 3.35 TB/s, or operations over 67 TFLOP/s
   fp32), the launches of its path's run, the wrapper's time per call, its
   plain version's time (the count kernel at 2^26 also with C = 32 and
   4096); the library yardsticks ``hardshrink(x, nextafter(tau, 0))`` for
   ``apply_threshold`` (back to back and device time, also into the
   kernel's rotating outputs beside the kernel's device time into one
   output, and whether it keeps the same entries bit for bit) and
   ``torch.topk(|x|, k)`` plus a scatter
   for ``ops.topk_mask``; the steady per-round wall time
   and ``compile_s`` of every main path and adaptive path; and ``fresh_process_round_time``:
   the fig5 path in a fresh process with an empty build directory, whose
   round 1 ``compile_s`` takes the kernel library's nvcc build;
6. the model zoo's serving slice, rwkv6-1.6b and hymba-1.5b, and
   gemma2-2b, qwen2.5-14b, qwen2-moe-a2.7b, musicgen-medium,
   internvl2-26b, qwen2-72b and llama4-maverick-400b-a17b (no kernel of
   the port: their prefill and generate must launch none):
   - ``zoo_kernel_parity``: the wkv6 and ssm_scan CUDA kernels against
     their plain versions at the full-width serving shapes ((8, 2048, 32,
     64) and (8, 2048, 1600, 16)), at head dim 32, at T = 100 and T = 1,
     and (wkv6) at the model's strongest decay, which must stay finite and
     match the step recurrence;
   - ``serve_path`` per arch at full width, bf16 params and compute,
     initialised on the card, at full depth but qwen2-72b (SERVE_DEPTH's
     33 of 80 layers) and llama4 (pattern positions 1 and 4: a chunked
     MoE layer and a full dense one): the exact parameter count (at full
     depth from ``meta`` tensors), ``make_prefill_step`` on 8 x 2048
     tokens (musicgen-medium: 4 codebooks of them; internvl2-26b: after
     256 prefix embeddings; llama4: 1 x 16,384, across the 8192-token
     chunk boundary) with finite logits (padded vocab; audio (B, 4,
     2048)); with the counts set to 0 just before and read just after,
     wkv6 24 or ssm_scan 32 launches and nothing else; llama4's MoE
     routing in that prefill against the CPU's on the same router inputs
     (``card_routing``); then ``generate`` on 8 prompts of 64 tokens plus
     32 greedy tokens, twice (identical tokens in range, no kernel
     launch); prefill wall time (median of 3) and decode time per step;
   - ``serve_consistency`` per arch at full width in fp32: ``forward`` over
     160 tokens against 160 ``decode_step``s at every position, atol 2e-3 /
     rtol 1e-3 (the reference's own check); not for the MoEs, whose decode
     routes each step's tokens as one group of capacity 1 (qwen2.5-14b's
     fp32 weights take 59.1 GB); internvl2-26b at 32 layers with a
     zero-length prefix, qwen2-72b at 16 (CONSISTENCY_DEPTH);
   - ``moe_card_agreement``: reduced qwen2-moe-a2.7b (2 layers, top 4 of
     60 experts padded to 64, then of 37 padded to 48; fp32): ``forward``
     over 2 x 128 tokens in groups of 64 (capacity binds) and 16
     ``decode_step``s on the card and the CPU from the same weights:
     expert ids, capacity positions, keep masks and dropped counts equal
     call by call, no padded expert picked, logits within 1e-3 of their
     largest magnitude; the same for reduced llama4 (its 4-layer
     pattern, top 1 of 4 experts and a shared expert on alternate layers,
     groups of 16); then ``moe_full_width_layer``: one full-width MoE
     layer (d 2048, 60 experts padded to 64, the 5632-wide shared FFN;
     fp32) over 1 x 4096 tokens in groups of 512 (capacity 42) on the
     card and the CPU: ids, positions and keep mask equal, y and the aux
     loss within 1e-3 of their scale;
   - ``kernel_time`` of both kernels at the serving shapes, as in phase 5;
7. the pod round and the training path on full-width qwen2-1.5b
   (1,543,910,912 parameters; fp32 master weights, bf16 compute):
   - ``zoo_grad_parity``: the wkv6 and ssm_scan backward kernels against
     their plain backwards on the card (T = 100 at D = 32 and 64 and N =
     16, the strongest decay, and the training shapes (1, 4096, 32, 64)
     and (1, 4096, 1600, 16); nonzero s0 / h0 and dsT / dhT): each
     gradient's largest difference over its largest magnitude within 1e-4
     (wkv6) or 1e-5 (ssm_scan), finite, two runs bit for bit; the
     checkpointing ssm_scan forward's y, hT and checkpoints against the
     plain versions (``ssm_checkpoint_parity``, atol 1e-4 / rtol 1e-5, T
     = 1, 17, 25, 65 and the training shape); and each autograd.Function
     through ``torch.autograd.grad`` against autograd of the plain forward;
   - ``fed_pod_path``: ``launch.fedtrain.make_fed_round`` with
     ``FedPodConfig.from_strategy`` of fig5 on the kernels (C = 4, E = 2,
     1 x 4096 markov_text tokens a step, the COO wire budgeted per
     first-axis slice), 3 rounds of ``DynamicSampling`` participation from
     a CPU generator, the counts set to 0 just before each round and read
     just after (kernels 1-3: 4 / 8 / 4 a round, each call on one client's
     152,401-segment, 1,621,854,208-element packed delta); per round the
     wall time, ``mean_loss``, ``num_sampled``, launches and peak memory;
     round 1's first client's masks on the kernels against the plain
     versions on the card, bit for bit, with every slice's kept count
     within its wire slots; then one traced round (device idle share);
   - ``fed_pod_cohort``: ``make_cohort_fed_round`` on NCCL, world size 1,
     against ``make_fed_round`` from the same state (``num_sampled``
     exact, loss rtol 1e-6, parameters rtol 1e-3 / atol 1e-4);
   - ``fed_pod_agreement``: reduced width, the card's round against the
     CPU masking the card's deltas (masks exact, parameters within 1e-6 of
     the aggregate's scale);
   - ``train_standard``: three ``make_train_step`` AdamW steps at 1 x 4096
     tokens (loss, grad norm, wall time, peak memory) and one ``lm_loss``
     forward and backward's time;
   - ``flash_vjp``: attention's backward at 12/2 heads, D 128, T 4096,
     bf16, against autograd of the plain attention (relative errors, the
     bytes each keeps for its backward, fwd+bwd times beside
     ``scaled_dot_product_attention`` as a yardstick) and attention's
     share of a local step (28 layers);
7b. the zoo's training path, rwkv6-1.6b and hymba-1.5b at full width and
   depth (fp32 master weights, bf16 compute), through the backward
   kernels:
   - ``train_zoo`` per arch: three ``make_train_step`` AdamW steps of 1 x
     4096 tokens (loss, grad norm, wall time, the forward and backward
     kernels' launches a step with the counts set to 0 just before and read
     just after: 48 / 24 and 64 / 32 predicted, peak memory), one
     ``lm_loss`` fwd+bwd's time and, traced, the backward kernels' share;
   - ``fed_pod_path`` on rwkv6-1.6b: the reference's own federated command
     (``src/repro/launch/train.py:13``) at the pod setup above (68,090
     segments; launches 4 / 8 / 4 and wkv6 384 / wkv6_backward 192 a
     round), 3 rounds, round 1's first client's masks bit for bit against
     the plain versions, no trace;
   - ``zoo_train_agreement``: reduced rwkv6 and hymba (head dim 32, N 16,
     fp32), one ``lm_loss``'s gradients on the card against the CPU, rtol
     1e-3 and atol 1e-4 of each leaf's largest magnitude;
   - ``kernel_time`` of both backward kernels at the training shapes;
7c. gemma2-2b, qwen2.5-14b and qwen2-moe-a2.7b at full width (fp32
   master weights, bf16 compute):
   - ``train_lm`` per arch: three ``make_train_step`` AdamW steps of 1 x
     4096 tokens at TRAIN_DEPTH's layers (gemma2-2b whole; the other two
     cut to the most layers whose step fits): loss, grad norm, wall time,
     no launch of a kernel of the port, peak memory, the MoE's aux loss,
     one ``lm_loss`` fwd+bwd's time;
   - ``fed_pod_path`` on gemma2-2b at POD_DEPTH's layers (the pod setup of
     section 7, 3 rounds): kernels 1-3 at 4 / 8 / 4 a round, round 1's
     first client's masks bit for bit against the plain versions, no
     trace;
7d. musicgen-medium and internvl2-26b at full width:
   - ``train_lm`` on musicgen-medium whole, on (1, 4, 4096) codebook
     grids;
   - ``fed_pod_path`` on musicgen-medium whole (the pod setup of section
     7 on (C, E, 1, 4, T) batches, 10,210 segments, 3 rounds): kernels
     1-3 at 4 / 8 / 4 a round, round 1's first client's masks bit for bit
     against the plain versions, no trace;
   - ``train_lm`` on internvl2-26b at TRAIN_DEPTH's layers, with 256
     prefix embeddings before 4096 tokens;
8. (``--profile`` only) ``torch.profiler`` over two more rounds of the
   fused LeNet path, of ``vgg-fig5``, of ``noniid-dyn`` and of the store
   path, and over one prefill and 11
   decode steps of each served arch: device busy time by kernel and the
   device's idle share of the wall time.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
SEG_LANE = 1024

MAIN_M, MAIN_ROUNDS, MAIN_BATCH = 32, 8, 32
MAIN_SAMPLED = [29, 26, 24, 21, 19, 18, 16, 14]
MAIN_BUCKETS = [32] * 6 + [16] * 2
MASK_LAUNCHES = {"segmented_histogram": 8, "segmented_count": 16,
                 "segmented_apply": 8}
# Per main path: upload bytes and launches of every kernel over 8 rounds.
MAIN_PATHS = {
    "fig5": (431_184, {**MASK_LAUNCHES, "segmented_stats": 0,
                       "segmented_encode": 0}),
    "fig5-fused-int8": (268_966, {**MASK_LAUNCHES, "segmented_stats": 8,
                                  "segmented_encode": 8}),
}
# The paper's other two models through the round (M = 32, 8 rounds): model,
# mask policy, bytes per upload and segmented launches over the run.
LM_PATHS = {
    "vgg-fig5": ("vgg", "selective", 2_471_228, MASK_LAUNCHES),
    "gru-fig5": ("gru", "selective", 722_472, MASK_LAUNCHES),
    "gru-random": ("gru", "random", 722_472, {}),
}
LM_PARAMS = {"vgg": 617_770, "gru": 180_608}
# The generalized round bodies on LeNet-28 (M = 32, 8 rounds): path ->
# (partition, segmented launches a round, whether the loss must fall).
# Kernel masking launches 1 histogram, 2 counts and 1 apply a round; the
# fused int8 wire 1 stats and 1 encode more.
THRESHOLD_PATH = "fig5-fused-int8+threshold+flaky-mobile"
MASK_PER_ROUND = {"segmented_histogram": 1, "segmented_count": 2,
                  "segmented_apply": 1}
ADAPTIVE_PATHS = {
    "fig3-importance": ("iid", {}, True),
    "hetero-dropout": ("iid", {}, False),
    "noniid-dyn": ("dirichlet", MASK_PER_ROUND, True),
    THRESHOLD_PATH: ("iid", {**MASK_PER_ROUND, "segmented_stats": 1,
                             "segmented_encode": 1}, False),
}
# The client-state store at fleet scale: benchmarks/client_store.py's
# operating point on full-width VGG, (M, retention, shard pool, round-1
# cohort, min_clients), and the small size held card against CPU.
STORE_FULL = (100_000, 1024, 512, 256, 32)
STORE_SMALL = (64, 16, 16, 8, 4)
STORE_BATCHES = 2                 # local batches a client
STORE_ROUNDS, STORE_SAVE_AFTER, STORE_SMALL_ROUNDS = 8, 4, 6
STORE_COST_ROUNDS = 3             # timed with and without deterministic cuDNN
STORE_STRESS_CLIENTS = 512        # kernels 1-5 on a 512-client VGG cohort
# The async engine: full-width VGG at M = 32 for 8 rounds, LeNet-28 for
# the keystone, resume (4 + 4 rounds) and card-vs-CPU runs, and the
# cross-round store at M = 1,024 (6 rounds; the evicting window holds
# more than a round's commits, which the store requires).
ASYNC_ROUNDS, ASYNC_KEYSTONE_ROUNDS, ASYNC_SMALL_ROUNDS = 8, 4, 6
ASYNC_STORE_M, ASYNC_STORE_ROUNDS, ASYNC_EVICT_RETENTION = 1024, 6, 768
RANDOM_STORE_ROUNDS = 3           # random masking on the store path
# Byzantine attacks: the three presets on full-width VGG (M = 32, 8
# rounds), every kind at LeNet-28 (M = 12, 5 rounds) on every form.
ROBUST_PRESETS = ("byzantine-signflip", "robust-median", "robust-krum")
ATTACK_KINDS = ("sign_flip", "scale", "gauss", "zero", "nan")
ATTACK_M, ATTACK_ROUNDS = 12, 5
ATTACK_KNOBS = {"fraction": 0.25, "strength": 2.0, "sigma": 0.05}
# Card against CPU under attack: the largest parameter difference over the
# leaf's largest magnitude (at least 1), as SMALL_RTOL elsewhere; the gauss
# noise itself may differ by one fp32 ulp (attacks.client_attack_noise).
ATTACK_TOL = 1e-3
# The LeNet main path's seed-0 data, pinned on the CPU against the
# reference's arrays (tests/test_torch_checkpoint.py), and the seed-0
# init_lenet() leaves as torch's CPU generator gives them there.
SEED_DATA_HASHES = {
    "images.train_x":
        "345379db7168c3c3a2212781693c8358930472c213c3573e68529b7ab6b00cfd",
    "images.train_y":
        "ccb571117f4528570ef565bb4e1fda6aebc6d5b8d7252da50889d3a7c6bc47cd",
    "images.test_x":
        "cdd7cbdce1fdb9d0baadcb8284df3e73e80d0693016c293f85a3f1ea4e66d09b",
    "images.test_y":
        "afc09549ae151a59c190649eb59b953ab1521b8c7fbde959d2e7a7baa253f68c",
    "iid.xs":
        "1cfae966923ce240833f3e3d92aa030086caec5a90b531bc1444e2977230957c",
    "iid.ys":
        "c22777cbc533e718e3a4be70439195254b99605fcec8417837f8e91cf3415c24",
    "iid.n":
        "ddbb87b200e172978838e8c9c60ffe206f7c03e50abbbbe81d5e504aff3e6e5a",
    "dirichlet.xs":
        "e548dc3e0480a61a6d5cc0405ffdb42b497aa1a60b46ffd77fc1204f79bd9490",
    "dirichlet.ys":
        "1abeee7a3f539dbe894d0dcd275ecb308d2056f6a00c2e722ddd6c6b5e198b44",
    "dirichlet.n":
        "ddbb87b200e172978838e8c9c60ffe206f7c03e50abbbbe81d5e504aff3e6e5a",
}
SEGMENTED = ("segmented_histogram", "segmented_count", "segmented_apply",
             "segmented_stats", "segmented_encode")
PER_ARRAY = ("exponent_histogram", "count_ge", "apply_threshold")
# Each timed kernel's name in a trace (``segmented_count_c32`` and
# ``segmented_encode_fp32`` time the same kernels at other arguments).
KERNEL_SYMBOLS = {"segmented_histogram": "seg_hist_kernel",
                  "segmented_count": "seg_count_kernel",
                  "segmented_apply": "seg_apply_kernel",
                  "segmented_stats": "seg_stats_kernel",
                  "segmented_encode": "seg_encode_kernel",
                  "exponent_histogram": "exponent_hist_kernel",
                  "count_ge": "count_ge_kernel",
                  "apply_threshold": "apply_threshold_kernel"}
PER_ARRAY_ITERS = 8
LARGEST_VGG_LEAF = 147_456       # conv2b.w, conv3a.w, conv3b.w: 3x3x128x128
COUNT_CANDIDATES = (1, 8, 16, 17, 32, 4096)
WIRE_EDGE_ROWS = (1, 3, 5, 4095, 33 * 1024 + 5)   # 33797: 32-row blocks
LARGE_COUNT_CANDIDATES = (32, 4096)   # timed at 2^26 beside the path's 16
SMALL_RTOL = 1e-3                # card vs CPU: reduction order differs
# The model zoo's serving slice: arch -> (its kernel, launches per prefill,
# parameters at full width and depth).  Every arch but rwkv6 and hymba runs
# no kernel of the port: attention, the MLPs and the MoE are torch ops.
ZOO_ARCHS = {"rwkv6-1.6b": ("wkv6", 24, 1_483_280_384),
             "hymba-1.5b": ("ssm_scan", 32, 1_403_905_600),
             "gemma2-2b": (None, 0, 2_614_222_080),
             "qwen2.5-14b": (None, 0, 14_770_033_664),
             "qwen2-moe-a2.7b": (None, 0, 15_146_928_128),
             "musicgen-medium": (None, 0, 1_384_418_304),
             "internvl2-26b": (None, 0, 19_862_722_560),
             "qwen2-72b": (None, 0, 72_706_203_648),
             "llama4-maverick-400b-a17b": (None, 0, 400_713_815_040)}
# Served at full width but cut where the bf16 weights do not fit the card
# beside the prefill: qwen2-72b at SERVE_DEPTH's whole layers (1.76 GB a
# layer, 4.98 GB of embedding and head), the most that fit after the
# script's earlier phases (34 ran out of memory there); llama4 at
# SERVE_PATTERN's pattern positions 1 and 4 (a chunked-attention MoE layer
# of 128 experts and a full-attention dense layer, 18,681,062,400
# parameters; one period of 4 layers is 70.6 GB).  llama4's prefill is
# SERVE_SHAPE's 1 x 16,384 tokens, so it crosses the 8192-token chunk
# boundary, and serve_path holds its MoE layer's routing on the card to
# the CPU's (SERVE_ROUTING).
SERVE_DEPTH = {"qwen2-72b": 33}
SERVE_PATTERN = {"llama4-maverick-400b-a17b": (0, 3)}
SERVE_SHAPE = {"llama4-maverick-400b-a17b": (1, 16_384)}
SERVE_ROUTING = ("llama4-maverick-400b-a17b",)
# serve == prefill in fp32: not the MoEs, whose decode routes each step's B
# tokens as one group of capacity max(1, int(B * topk / E * 1.25)) = 1 and
# so drops picks the forward keeps (the reference's tests/test_models.py
# leaves them out too; moe_card_agreement holds their decode to the CPU's
# instead).  Full depth but where CONSISTENCY_DEPTH cuts it: fp32 weights
# of qwen2-72b take 3.51 GB a layer, of internvl2-26b 1.56 GB (79.5 GB
# whole).  internvl2-26b runs with a zero-length prefix, which the
# reference's forward accepts.
CONSISTENCY_ARCHS = ("rwkv6-1.6b", "hymba-1.5b", "gemma2-2b", "qwen2.5-14b",
                     "musicgen-medium", "internvl2-26b", "qwen2-72b")
CONSISTENCY_DEPTH = {"internvl2-26b": 32, "qwen2-72b": 16}
SERVE_B, SERVE_T = 8, 2048       # prefill: 8 prompts of 2048 tokens
GEN_PROMPT, GEN_TOKENS = 64, 32  # generate: 64-token prompts, 32 greedy
PREFILL_REPS = 3
CONSISTENCY_T = 160              # 2.5 wkv6 chunks
WKV6_SHAPE = (SERVE_B, SERVE_T, 32, 64)      # rwkv6-1.6b: 32 heads of 64
SSM_SHAPE = (SERVE_B, SERVE_T, 1600, 16)     # hymba-1.5b: d 1600, N 16
# Kernel against plain version: both fp32, other summation orders and FMA
# contraction (wkv6 outputs reach about 100 at the serving shape).
WKV6_TOL = {"atol": 1e-3, "rtol": 1e-4}
SSM_TOL = {"atol": 1e-4, "rtol": 1e-5}
CONSISTENCY_TOL = {"atol": 2e-3, "rtol": 1e-3}   # tests/test_models.py
# The pod round on full-width qwen2-1.5b: C clients, E local steps of B
# sequences of T tokens (train_4k's length), 3 rounds; kernels 1-3 launch
# 1 histogram, 2 counts and 1 apply per client and round.
POD_C, POD_E, POD_B, POD_T, POD_ROUNDS = 4, 2, 1, 4096, 3
POD_PARAMS, POD_SEGMENTS, POD_LAYERS = 1_543_910_912, 152_401, 28
POD_LAUNCHES = {"segmented_histogram": POD_C, "segmented_count": 2 * POD_C,
                "segmented_apply": POD_C}
# The pod round per arch: parameters, segments of one client's delta on
# the kernel route, and the zoo kernels' launches a round beside kernels
# 1-3 (C clients x E steps x, a layer, two forwards under remat and one
# backward).
POD_ARCHS = {"qwen2-1.5b": (POD_PARAMS, POD_SEGMENTS, {}),
             "rwkv6-1.6b": (1_483_280_384, 68_090,
                            {"wkv6": POD_C * POD_E * 48,
                             "wkv6_backward": POD_C * POD_E * 24}),
             "gemma2-2b": (1_835_608_320, 256_145, {}),
             "musicgen-medium": (1_384_418_304, 10_210, {})}
# Depth of a pod round where the whole model does not fit the card (whole
# periods of the pattern), the most that fit after the script's earlier
# phases, as TRAIN_DEPTH's.  gemma2-2b: 256,000 embedding rows make
# 256,000 of the delta's segments.
POD_DEPTH = {"gemma2-2b": 16}
# The zoo's training path: arch -> (its kernel, forward and backward
# launches a train step: remat runs a layer's forward again in the
# backward; hymba's remat span is its 16-layer group).
ZOO_TRAIN = {"rwkv6-1.6b": ("wkv6", 48, 24),
             "hymba-1.5b": ("ssm_scan", 64, 32)}
TRAIN_WKV6_SHAPE = (POD_B, POD_T, 32, 64)     # rwkv6-1.6b, 1 x 4096 tokens
TRAIN_SSM_SHAPE = (POD_B, POD_T, 1600, 16)    # hymba-1.5b
# Backward kernel against plain backward: the largest difference of each
# gradient over its largest magnitude (fp32 both; other chunkings and
# summation orders).
GRAD_REL_TOL = {"wkv6": 1e-4, "ssm_scan": 1e-5}
# Kernels a backward call launches (csrc/wkv6_backward.cu: terms, scan,
# gradients, du; csrc/ssm_scan.cu: the sweep and the dC sum).
BWD_KERNELS = {"wkv6": 4, "ssm_scan": 2}
# Reduced rwkv6 and hymba: lm_loss gradients on the card against the CPU,
# fp32 with TF32 off.  An entry near 0 agrees only to the leaf's scale:
# hymba's 16 layers of sums in other orders (attention, the SSM branch,
# the kernels' chunkings) reach 2.5e-5 of a leaf's largest magnitude.
ZOO_AGREE_RTOL = 1e-3
ZOO_AGREE_ATOL = 1e-4            # of each leaf's largest magnitude
# The MoE on the card against the CPU (reduced qwen2-moe-a2.7b): real
# experts of each run (padded to 64 and to 48), 2 x 128 tokens in groups
# of 64, 16 decode steps; then one full-width layer (d 2048, 60 experts
# padded to 64, the 5632-wide shared FFN) over 1 x 4096 tokens in the
# default groups of 512.
MOE_AGREE_EXPERTS = (60, 37)
MOE_AGREE_B, MOE_AGREE_T, MOE_AGREE_GROUP, MOE_AGREE_STEPS = 2, 128, 64, 16
# and reduced llama4 (its whole 4-layer pattern: top 1 of 4 experts and a
# shared expert on the first and third layers) in groups of 16, capacity 5
MOE_AGREE_LLAMA4_GROUP = 16
# Training at full width: layers of each run (gemma2-2b and musicgen-medium
# whole), the most whose AdamW step (fp32 masters, 1 x 4096 tokens; 256
# prefix embeddings more for internvl2-26b) fits after the script's
# earlier phases: one layer more runs out of memory there.
TRAIN_DEPTH = {"gemma2-2b": 26, "qwen2.5-14b": 6, "qwen2-moe-a2.7b": 4,
               "musicgen-medium": 48, "internvl2-26b": 6}
ZOO_LIBRARY_NOTE = ("no single PyTorch call computes the RWKV6 wkv "
                    "recurrence or a selective-SSM scan")
ZOO_BWD_LIBRARY_NOTE = ("no single PyTorch call computes the gradient of "
                        "the RWKV6 wkv recurrence or of a selective-SSM scan")
ZOO_BWD_REPLACES_NOTE = {
    "wkv6_backward": "replaces no TPU kernel: the reference takes this "
                     "gradient by XLA autodiff of src/repro/models/"
                     "rwkv.py:76 (wkv6_chunked)",
    "ssm_scan_backward": "replaces no TPU kernel: the reference takes this "
                         "gradient by XLA autodiff of src/repro/models/"
                         "ssm.py:58 (ssm_forward's scan)"}
LIBRARY_NOTE = ("no single PyTorch call computes a segmented suffix "
                "histogram, a per-segment multi-threshold count, a per-row-"
                "tau select with counts, a segmented histogram with a "
                "segment max, or a select with a packed bitmap and counts")
PER_ARRAY_LIBRARY_NOTE = (
    "no single PyTorch call computes an exponent histogram or a count of "
    "|x| >= tau; apply_threshold's yardstick keeps what it keeps for "
    "tau > 0 and non-NaN x, but keeps NaN and takes its lambda on the "
    "host; the whole topk_mask pipeline's yardstick is torch.topk(|x|, k) "
    "plus a scatter (phase topk_mask_time)")
LIBRARY_APPLY = "torch.nn.functional.hardshrink(x, nextafter(tau, 0))"


def fail(msg: str) -> None:
    """End the run with a nonzero exit and ``msg``."""
    raise SystemExit(f"FAIL: {msg}")


STARTED = time.perf_counter()


def phase(name: str, **fields) -> None:
    """Print one phase's result as a JSON line, with the seconds since the
    script started (``at_s``)."""
    print(json.dumps({"phase": name, **fields,
                      "at_s": time.perf_counter() - STARTED}), flush=True)


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fns, reps: int = 20) -> float:
    """Median milliseconds of one call over ``reps`` CUDA-event-timed calls,
    after two warm-up calls; call i runs ``fns[i % len(fns)]``."""
    import torch
    for fn in fns[:2]:
        fn()
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fns[i % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Inputs for the kernels
# ---------------------------------------------------------------------------
def unsorted_taus(taus, seed: int):
    """``taus`` ((S, C) candidates) shuffled along C, with duplicated
    neighbours, and NaN, inf, -0.0 and negative taus in every seventh
    place: the count kernel's sort path."""
    import torch
    S, C = taus.shape
    gen = torch.Generator().manual_seed(seed)
    out = taus.cpu()[:, torch.randperm(C, generator=gen)].clone()
    if C > 2:
        out[:, 1::2] = out[:, 0::2][:, :out[:, 1::2].shape[1]]
    special = torch.tensor([float("nan"), float("inf"), -0.0, -1.0])
    flat = out.reshape(-1)
    flat[3::7] = special.repeat(flat[3::7].numel() // 4 + 1)[
        :flat[3::7].numel()]
    return out.to(taus.device)


def check_kernels(label: str, x2d, seg_ids, k,
                  candidates=COUNT_CANDIDATES) -> dict:
    """Each kernel against its plain version on the card; returns the
    largest absolute differences (int8 encode under ``segmented_encode``,
    fp32 encode under ``segmented_encode_fp32``).  The count kernel is also
    held at each number of ``candidates``, sorted and shuffled."""
    import torch
    from repro_torch.kernels import measure
    from repro_torch.kernels import segmented as seg
    S = k.numel()
    cand, tau, scales = measure.taus_for(x2d, seg_ids, k, S)
    got = {
        "segmented_histogram": (seg.segmented_histogram(x2d, seg_ids, S),),
        "segmented_count": (seg.segmented_count(x2d, seg_ids, cand),),
        "segmented_apply": seg.segmented_apply(x2d, seg_ids, tau),
        "segmented_stats": seg.segmented_stats(x2d, seg_ids, S),
        "segmented_encode": seg.segmented_encode(x2d, seg_ids, tau, scales),
        "segmented_encode_fp32": seg.segmented_encode(x2d, seg_ids, tau),
    }
    want = {
        "segmented_histogram": (
            seg.segmented_histogram_plain(x2d, seg_ids, S),),
        "segmented_count": (seg.segmented_count_plain(x2d, seg_ids, cand),),
        "segmented_apply": seg.segmented_apply_plain(x2d, seg_ids, tau),
        "segmented_stats": seg.segmented_stats_plain(x2d, seg_ids, S),
        "segmented_encode": seg.segmented_encode_plain(x2d, seg_ids, tau,
                                                       scales),
        "segmented_encode_fp32": seg.segmented_encode_plain(x2d, seg_ids,
                                                            tau),
    }
    if x2d.is_cuda:
        torch.cuda.synchronize()
    errs, exact = {}, {}
    for name in got:
        errs[name] = max(float((g.double() - w.double()).abs().nan_to_num()
                               .max()) for g, w in zip(got[name], want[name]))
        exact[name] = all(measure.bitwise(g, w)
                          for g, w in zip(got[name], want[name]))
    lo, hi, _, _ = seg.select_thresholds(
        got["segmented_histogram"][0], k)
    counts = {}
    for c in candidates:
        sorted_taus = seg.candidate_taus(lo, hi, c, geometric=True)
        for order, taus in (("sorted", sorted_taus),
                            ("unsorted", unsorted_taus(sorted_taus, c))):
            taus = taus.contiguous()
            counts[f"{c}-{order}"] = bool(torch.equal(
                seg.segmented_count(x2d, seg_ids, taus),
                seg.segmented_count_plain(x2d, seg_ids, taus)))
    phase("kernel_parity", shape=label, rows=x2d.shape[0], segments=S,
          max_abs_err=errs, exact=exact, count_by_candidates=counts,
          hist_total=int(got["segmented_histogram"][0][:, 0].sum()),
          kept_total=int(got["segmented_encode"][2].sum()))
    bad = [name for name, ok in exact.items() if not ok]
    bad += [f"segmented_count(C={c})" for c, ok in counts.items() if not ok]
    if bad:
        fail(f"kernels disagree with their plain versions ({label}): {bad}")
    return errs


def wire_edge_parity() -> dict:
    """The histogram, stats and encode (int8, fp32) against their plain
    versions on the edge inputs at each of ``WIRE_EDGE_ROWS`` rows, bitwise;
    any difference fails the run."""
    import torch
    from repro_torch.kernels import measure
    from repro_torch.kernels import segmented as seg
    exact = {}
    for rows in WIRE_EDGE_ROWS:
        x2d, ids, taus, scales = (t.cuda() for t in
                                  measure.wire_edge_inputs(rows, seed=rows))
        S = taus.numel()
        pairs = {
            "hist": ((seg.segmented_histogram(x2d, ids, S),),
                     (seg.segmented_histogram_plain(x2d, ids, S),)),
            "stats": (seg.segmented_stats(x2d, ids, S),
                      seg.segmented_stats_plain(x2d, ids, S)),
            "int8": (seg.segmented_encode(x2d, ids, taus, scales),
                     seg.segmented_encode_plain(x2d, ids, taus, scales)),
            "fp32": (seg.segmented_encode(x2d, ids, taus),
                     seg.segmented_encode_plain(x2d, ids, taus))}
        torch.cuda.synchronize()
        exact[str(rows)] = {
            kind: all(measure.bitwise(g, w) for g, w in zip(*pair))
            for kind, pair in pairs.items()}
    phase("wire_edge_parity", exact=exact)
    bad = [f"{kind} at R = {rows}" for rows, rec in exact.items()
           for kind, ok in rec.items() if not ok]
    if bad:
        fail(f"sweep kernels disagree with their plain versions: {bad}")
    return exact


def wire_build_record() -> dict:
    """The histogram, stats and both encode kernels' registers, stack and
    spills from the build's ``-Xptxas -v`` log, and the per-array
    histogram and apply kernels'."""
    from repro_torch.kernels import build, measure
    found = measure.wire_resources(build.build_log().read_text())
    if sorted(found) != ["apply", "exponent_hist", "fp32", "hist", "int8",
                         "stats"]:
        fail(f"sweep kernels in the build log: {sorted(found)}")
    return found


def kernel_symbol(name: str) -> str:
    """The CUDA kernel that the timing entry ``name`` launches."""
    return next(sym for key, sym in KERNEL_SYMBOLS.items()
                if name.startswith(key))


def time_kernels(label: str, x2d, seg_ids, k, count_candidates=()) -> dict:
    """Per kernel: its device time (C launcher called back to back on
    preallocated outputs), the wrapper's time per call (argument checks,
    output allocation and zeroing, launch), the plain version's time and
    the bound.  The count kernel also with each C of ``count_candidates``
    (``segmented_count_c<C>``: C geometric candidates a segment, ascending,
    as the masking path makes them).

    The bound counts device-memory bytes, so every timed call reads an input
    the L2 cache does not hold: the calls rotate over copies of ``x2d``
    (and of the outputs) that together exceed four times the L2 size.
    ``warm_ms`` is the same kernel called on one buffer, which after the
    first call sits in L2 when it fits there."""
    import torch
    from repro_torch.kernels import build, measure
    from repro_torch.kernels import segmented as seg
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    S = k.numel()
    n = x2d.numel()
    rows = x2d.shape[0]
    cand, tau, scales = measure.taus_for(x2d, seg_ids, k, S)
    lo, hi, _, _ = seg.select_thresholds(
        seg.segmented_histogram(x2d, seg_ids, S), k)
    cands = {"segmented_count": cand, **{
        f"segmented_count_c{c}":
        seg.candidate_taus(lo, hi, c, geometric=True).contiguous()
        for c in count_candidates}}
    l2 = torch.cuda.get_device_properties(x2d.device).L2_cache_size
    copies = max(2, -(-4 * l2 // x2d.nbytes))
    xs = [x2d] + [x2d.clone() for _ in range(copies - 1)]
    outs = [torch.empty_like(x2d) for _ in range(copies)]
    codes = [torch.empty(x2d.shape, dtype=torch.int8, device=x2d.device)
             for _ in range(copies)]
    bitmaps = [torch.empty((rows, SEG_LANE // 8), dtype=torch.uint8,
                           device=x2d.device) for _ in range(copies)]
    hist = torch.zeros((S, 32), dtype=torch.int32, device=x2d.device)
    amax = torch.zeros((S, 1), dtype=torch.float32, device=x2d.device)
    cnts = {name: torch.zeros(c.shape, dtype=torch.int32, device=x2d.device)
            for name, c in cands.items()}
    kept = torch.zeros((S, 1), dtype=torch.int32, device=x2d.device)
    sp = seg_ids.data_ptr()

    def launcher(name, i):
        x = xs[i].data_ptr()
        if name == "segmented_histogram":
            return lambda: lib.seg_histogram_launch(
                x, sp, rows, S, hist.data_ptr(), stream)
        if name in cands:
            return lambda: lib.seg_count_launch(
                x, sp, cands[name].data_ptr(), rows, S, cands[name].shape[1],
                cnts[name].data_ptr(), stream)
        if name == "segmented_apply":
            return lambda: lib.seg_apply_launch(
                x, sp, tau.data_ptr(), rows, S, outs[i].data_ptr(),
                kept.data_ptr(), stream)
        if name == "segmented_stats":
            return lambda: lib.seg_stats_launch(
                x, sp, rows, S, hist.data_ptr(), amax.data_ptr(), stream)
        if name == "segmented_encode":
            return lambda: lib.seg_encode_launch(
                x, sp, tau.data_ptr(), scales.data_ptr(), rows, S,
                codes[i].data_ptr(), bitmaps[i].data_ptr(), kept.data_ptr(),
                stream)
        return lambda: lib.seg_encode_launch(
            x, sp, tau.data_ptr(), None, rows, S, outs[i].data_ptr(),
            bitmaps[i].data_ptr(), kept.data_ptr(), stream)

    ids = 4 * rows
    work = {  # wrapper, plain, bytes, operations
        "segmented_histogram": (
            lambda x: seg.segmented_histogram(x, seg_ids, S),
            lambda x: seg.segmented_histogram_plain(x, seg_ids, S),
            4 * n + ids + 4 * S * 32, 32 * n),
        # An element's C counts follow from its rank among the candidates:
        # ceil(log2(C + 1)) compares.
        **{name: (
            lambda x, c=c: seg.segmented_count(x, seg_ids, c),
            lambda x, c=c: seg.segmented_count_plain(x, seg_ids, c),
            4 * n + ids + 8 * c.numel(),
            n * math.ceil(math.log2(c.shape[1] + 1)))
           for name, c in cands.items()},
        "segmented_apply": (
            lambda x: seg.segmented_apply(x, seg_ids, tau),
            lambda x: seg.segmented_apply_plain(x, seg_ids, tau),
            8 * n + ids + 8 * S, n),
        "segmented_stats": (
            lambda x: seg.segmented_stats(x, seg_ids, S),
            lambda x: seg.segmented_stats_plain(x, seg_ids, S),
            4 * n + ids + 4 * S * 32 + 4 * S, 33 * n),
        "segmented_encode": (
            lambda x: seg.segmented_encode(x, seg_ids, tau, scales),
            lambda x: seg.segmented_encode_plain(x, seg_ids, tau, scales),
            4 * n + n + n // 8 + ids + 12 * S, 3 * n),
        "segmented_encode_fp32": (
            lambda x: seg.segmented_encode(x, seg_ids, tau),
            lambda x: seg.segmented_encode_plain(x, seg_ids, tau),
            8 * n + n // 8 + ids + 8 * S, n),
    }
    results = {}
    for name, (wrapper, plain, nbytes, ops) in work.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        kernels = [launcher(name, i) for i in range(copies)]
        rec = {"ms": measure.cuda_loop_ms(kernels),
               "warm_ms": measure.cuda_loop_ms(kernels[:1]),
               **measure.device_ms(kernels, kernel_symbol(name),
                                   events_fallback=True),
               "wrapper_ms": cuda_ms([lambda x=x: wrapper(x) for x in xs]),
               "plain_ms": cuda_ms([lambda x=x: plain(x) for x in xs],
                                   reps=5),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": None, "bytes": nbytes, "operations": ops,
               "buffers": copies, "l2_bytes": l2}
        results[name] = rec
        phase("kernel_time", shape=label, kernel=name, **rec)
    del xs, outs, codes, bitmaps
    return results


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------
def fig5_server(M: int, image_size: int, num_train: int, batch: int,
                device: str, preset: str = "fig5",
                error_feedback: bool = False):
    """A server for ``preset`` (kernel masking, LeNet at ``image_size``)
    over M clients' synthetic shards, with its batches, sizes and test
    set."""
    from repro_torch.core import strategy
    st = strategy.get(preset, error_feedback=error_feedback,
                      masking=strategy.MaskPolicy.selective(
                          0.5, backend="kernel"))
    return lenet_server(st, M, image_size, num_train, batch, device)


def adaptive_strategy(name: str):
    """An ``ADAPTIVE_PATHS`` strategy: the preset, or fig5-fused-int8 under
    the threshold sampler on the flaky-mobile fleet (composed with
    ``FedStrategy.replace``), selective masking on the kernel backend."""
    import dataclasses
    from repro_torch.core import strategy
    from repro_torch.core.hetero import HeteroModel
    from repro_torch.core.sampling import ThresholdSampler
    if name == THRESHOLD_PATH:
        st = strategy.get("fig5-fused-int8").replace(
            sampler=ThresholdSampler(), hetero=HeteroModel("flaky-mobile"))
    else:
        st = strategy.get(name)
    if st.masking.mode == "selective":
        st = st.with_masking(dataclasses.replace(st.masking,
                                                 backend="kernel"))
    return st


def lenet_server(st, M: int, image_size: int, num_train: int, batch: int,
                 device: str, partition: str = "iid", make_store=None,
                 **server_kw):
    """A server for strategy ``st`` (LeNet at ``image_size``) over M
    clients' synthetic shards (IID, or Dirichlet(0.5) label skew), with its
    batches, sizes and test set; ``make_store(params)`` builds its store,
    and ``server_kw`` (engine, seed, draws) go to ``from_strategy``."""
    from repro_torch.core.server import FederatedServer
    from repro_torch.data.partition import (dirichlet_partition_images,
                                            iid_partition_images)
    from repro_torch.data.synthetic import class_gaussian_images
    from repro_torch.models import paper_models as pm
    import torch
    ds = class_gaussian_images(num_train=num_train, image_size=image_size,
                               seed=0)
    if partition == "dirichlet":
        xs, ys, ns = dirichlet_partition_images(ds.train_x, ds.train_y, M,
                                                batch, alpha=0.5, seed=0)
    else:
        xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, batch,
                                          seed=0)
    params = pm.init_lenet(torch.Generator().manual_seed(0),
                           image_size=image_size, device=device)
    eval_data = (torch.as_tensor(ds.test_x).to(device),
                 torch.as_tensor(ds.test_y).to(device))
    server_kw.setdefault("seed", 0)
    server = FederatedServer.from_strategy(
        st, pm.classifier_loss(pm.lenet_forward), params, M,
        eval_fn=pm.classifier_accuracy(pm.lenet_forward), device=device,
        store=make_store(params) if make_store is not None else None,
        **server_kw)
    return server, (xs, ys), ns, eval_data


def run_main_path(preset: str, device: str = "cuda") -> dict:
    """Phase 3: one main path, with every assertion on its result.  The
    launch counts are set to 0 just before the run and read just after."""
    from repro_torch.kernels import segmented as seg
    upload_bytes, want_launches = MAIN_PATHS[preset]
    server, batches, ns, eval_data = fig5_server(
        MAIN_M, 28, MAIN_M * 8 * MAIN_BATCH, MAIN_BATCH, device, preset)
    if server._num_params != 107_786:
        fail(f"LeNet-28 has {server._num_params} parameters, not 107786")
    seg.reset_launch_counts()
    t0 = time.perf_counter()
    server.run(batches, ns, MAIN_ROUNDS, eval_every=MAIN_ROUNDS,
               eval_data=eval_data)
    wall = time.perf_counter() - t0
    launches = seg.launch_counts()
    summ = server.summary()
    hist = server.history
    sampled = [r.num_sampled for r in hist]
    buckets = [r.cohort_size for r in hist]
    losses = [r.mean_loss for r in hist]
    phase("main_path", preset=preset, codec=summ["codec"], rounds=len(hist),
          num_sampled=sampled, buckets=buckets, losses=losses,
          transport_bytes=summ["transport_bytes"],
          client_upload_bytes=summ["client_upload_bytes"],
          final_eval=summ["final_eval"], launches=launches,
          quarantined=summ["quarantined"],
          round_wall_s=[r.wall_s for r in hist], run_wall_s=wall)
    if sampled != MAIN_SAMPLED:
        fail(f"{preset}: num_sampled {sampled} != {MAIN_SAMPLED}")
    if buckets != MAIN_BUCKETS:
        fail(f"{preset}: buckets {buckets} != {MAIN_BUCKETS}")
    if summ["client_upload_bytes"] != upload_bytes:
        fail(f"{preset}: upload bytes {summ['client_upload_bytes']}")
    if summ["transport_bytes"] != sum(MAIN_SAMPLED) * upload_bytes:
        fail(f"{preset}: transport_bytes {summ['transport_bytes']}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        fail(f"{preset}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{preset}: loss did not fall: {losses}")
    if launches != want_launches:
        fail(f"{preset}: launches {launches}, expected {want_launches}")
    for name, leaf in server.params.items():
        if not bool(leaf.isfinite().all()):
            fail(f"{preset}: non-finite parameter {name}")
    return {"launches": launches, "history": hist, "server": server,
            "batches": batches, "n_samples": ns}


def wire_identity(main: dict) -> None:
    """One round's stacked masked delta from the fused main path, on the
    card: for every wire pairing the fused codec's roundtrip_stacked is
    bitwise the plain codec chain's, and the wire bytes agree.  Both run on
    the same input, so nothing drifts between them."""
    import torch
    from repro_torch.core import codecs
    from repro_torch.core.client import stacked_client_update
    from repro_torch.kernels import measure
    server = main["server"]
    batches = [torch.as_tensor(x).to(server.device)
               for x in main["batches"]]
    uploads, _, _, _ = stacked_client_update(
        server._loss_fn, server.params, batches, server.cfg.client, None,
        False)
    results = {}
    for wire in ("coo", "bitmap"):
        for quantized in (False, True):
            base = (codecs.BitmapCodec if wire == "bitmap"
                    else codecs.SparseCodec)(gamma=0.5)
            plain = (codecs.ChainCodec((base, codecs.Int8Codec()))
                     if quantized else base)
            fused = codecs.FusedSparseCodec(gamma=0.5, quantized=quantized,
                                            wire=wire)
            got = codecs.roundtrip_stacked(fused, uploads)
            want = codecs.roundtrip_stacked(plain, uploads)
            if server.device.type == "cuda":
                torch.cuda.synchronize()
            label = plain.name
            results[label] = {
                "bitwise": all(measure.bitwise(got[k], want[k]) for k in want),
                "wire_bytes": [fused.wire_bytes(server.params),
                               plain.wire_bytes(server.params)]}
    phase("wire_identity", clients=int(batches[0].shape[0]), **results)
    for label, rec in results.items():
        if not rec["bitwise"] or len(set(rec["wire_bytes"])) != 1:
            fail(f"fused wire differs from {label}: {rec}")


def profile_device(label: str, fn, count: int, unit: str) -> None:
    """Trace one call of ``fn``, which runs ``count`` units of work (rounds,
    prefills): device time by kernel per unit and the device's idle share
    of the wall time.  The device's activity only: its kernel and memcpy
    records are all the result reads, and the host's operator records
    (hundreds of thousands in a pod round) cost minutes to aggregate."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(event):
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0.0))

    # Kernel and memcpy rows only: the aten rows repeat their kernels' time.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_s = sum(device_us(e) for e in events) / 1e6
    top = sorted(events, key=device_us, reverse=True)[:12]
    phase("profile", path=label, **{f"{unit}s": count}, wall_s=wall,
          device_busy_s=busy_s,
          device_idle_share=1.0 - busy_s / wall,
          **{f"top_ms_per_{unit}": [[e.key[:60], device_us(e) / 1e3 / count,
                                     e.count // count] for e in top]})


def profile_rounds(main: dict, label: str, rounds: int = 2) -> None:
    """Trace ``rounds`` more main-path rounds (see :func:`profile_device`)."""
    server = main["server"]
    profile_device(label, lambda: server.run(main["batches"],
                                             main["n_samples"], rounds),
                   rounds, "round")


def small_agreement(preset: str = "fig5", error_feedback: bool = False,
                    devices=("cuda", "cpu")) -> None:
    """A kernel path on the card against the same run on the CPU (plain
    versions) at a small size: participants and bytes exact, losses,
    parameters and residuals within SMALL_RTOL."""
    import torch
    runs = {}
    for device in devices:
        server, batches, ns, _ = fig5_server(8, 12, 512, 16, device, preset,
                                             error_feedback)
        server.run(batches, ns, 4)
        runs[device] = server
    gpu, cpu = (runs[d] for d in devices)
    sampled = [[r.num_sampled for r in s.history] for s in (gpu, cpu)]
    loss = [[r.mean_loss for r in s.history] for s in (gpu, cpu)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(*loss))
    param_err = max(float((gpu.params[k].cpu() - v).abs().max())
                    for k, v in cpu.params.items())
    res_gpu, res_cpu = (s.store.residuals_dense() for s in (gpu, cpu))
    res_err = max(float((res_gpu[k].cpu() - v).abs().max())
                  for k, v in res_cpu.items())
    res_norm = float(sum(v.abs().sum() for v in res_cpu.values()))
    phase("small_agreement", preset=preset, error_feedback=error_feedback,
          num_sampled=sampled[0], loss_rel_err=rel,
          max_param_abs_err=param_err, max_residual_abs_err=res_err,
          residual_l1=res_norm,
          transport_bytes=[gpu.summary()["transport_bytes"],
                           cpu.summary()["transport_bytes"]])
    if sampled[0] != sampled[1]:
        fail(f"participants differ card vs CPU: {sampled}")
    if gpu.summary()["transport_bytes"] != cpu.summary()["transport_bytes"]:
        fail("transport bytes differ card vs CPU")
    if rel > SMALL_RTOL or param_err > SMALL_RTOL or res_err > SMALL_RTOL:
        fail(f"card and CPU runs disagree: loss rel {rel}, "
             f"param {param_err}, residual {res_err}")
    if error_feedback and not res_norm > 0:
        fail("error feedback left every residual zero")
    if not all(bool(torch.isfinite(v).all()) for v in gpu.params.values()):
        fail("non-finite parameters on the card")


# ---------------------------------------------------------------------------
# The generalized round: adaptive samplers, the hetero fleet, FedDyn
# ---------------------------------------------------------------------------
def run_adaptive_path(name: str, device: str = "cuda") -> dict:
    """One generalized-body path at full width with every assertion on its
    result; the launch counts are set to 0 just before the run and read
    just after."""
    import torch
    from repro_torch.kernels import segmented as seg
    partition, per_round, must_learn = ADAPTIVE_PATHS[name]
    st = adaptive_strategy(name)
    server, batches, ns, eval_data = lenet_server(
        st, MAIN_M, 28, MAIN_M * 8 * MAIN_BATCH, MAIN_BATCH, device,
        partition)
    reset_all_counts()
    t0 = time.perf_counter()
    server.run(batches, ns, MAIN_ROUNDS, eval_every=MAIN_ROUNDS,
               eval_data=eval_data)
    wall = time.perf_counter() - t0
    launches = seg.launch_counts()
    summ = server.summary()
    hist = server.history
    sampled = [r.num_sampled for r in hist]
    buckets = [r.cohort_size for r in hist]
    losses = [r.mean_loss for r in hist]
    plan = [st.sampler.cohort_bucket(st.sampling,
                                     st.sampling.num_clients_host(t, MAIN_M),
                                     MAIN_M) for t in range(1, len(hist) + 1)]
    phase("adaptive_path", preset=name, sampler=summ["sampler"],
          hetero=summ.get("hetero"), objective=st.objective.kind,
          partition=partition, codec=summ["codec"], num_sampled=sampled,
          num_arrived=[r.num_sampled - r.dropped for r in hist],
          buckets=buckets, transport_bytes=summ["transport_bytes"],
          client_upload_bytes=summ["client_upload_bytes"],
          sim_total_s=summ.get("sim_total_s"),
          dropped_uploads=summ.get("dropped_uploads"),
          sim_round_s=[r.sim_round_s for r in hist], losses=losses,
          final_eval=summ["final_eval"], launches=launches,
          quarantined=summ["quarantined"],
          round_wall_s=[r.wall_s for r in hist], run_wall_s=wall)
    want = {k: MAIN_ROUNDS * per_round.get(k, 0) for k in SEGMENTED}
    if launches != want:
        fail(f"{name}: launches {launches}, expected {want}")
    if summ["transport_bytes"] != sum(sampled) * summ["client_upload_bytes"]:
        fail(f"{name}: transport_bytes {summ['transport_bytes']}")
    if buckets != plan:
        fail(f"{name}: buckets {buckets} != the sampler's {plan}")
    if any(n > b for n, b in zip(sampled, buckets)):
        fail(f"{name}: more participants than the bucket: {sampled}")
    if must_learn and not losses[-1] < losses[0]:
        fail(f"{name}: loss did not fall: {losses}")
    if st.hetero is not None and not summ["sim_total_s"] > 0:
        fail(f"{name}: no simulated round time")
    state = dict(server.params)
    if st.sampler.adaptive:
        state["norms"] = server.store.norms
    if st.objective.uses_drift:
        state.update({f"drift/{k}": v for k, v in
                      server.store.dense_view("drift").items()})
    for key, leaf in state.items():
        if not bool(torch.isfinite(leaf).all()):
            fail(f"{name}: non-finite {key}")
    return {"launches": launches, "history": hist, "server": server,
            "batches": batches, "n_samples": ns}


class recorded_selection:
    """Within the block, every generalized round's CPU selection (the
    participant and arrived masks, as the round folds its upload losses
    in) is appended to ``log``."""

    def __init__(self, log: list):
        self.log = log

    def __enter__(self):
        from repro_torch.core import federated
        self.real = real = federated._apply_dropout

        def record(part, *args):
            arrived, weights = real(part, *args)
            self.log.append((part.tolist(), arrived.tolist()))
            return arrived, weights

        federated._apply_dropout = record
        return self

    def __exit__(self, *exc):
        from repro_torch.core import federated
        federated._apply_dropout = self.real


def small_adaptive_agreement(name: str, devices=("cuda", "cpu")) -> None:
    """A generalized-body path on the card against the same run on the CPU
    at the small size (LeNet-12, M = 8, 4 rounds): participants, arrived
    masks, bytes, ``sim_round_s`` and ``dropped`` exact; losses,
    parameters, residuals, norms and drift within SMALL_RTOL."""
    import math
    import torch
    partition = ADAPTIVE_PATHS[name][0]
    runs, masks = [], []
    for device in devices:
        server, batches, ns, _ = lenet_server(adaptive_strategy(name), 8, 12,
                                              512, 16, device, partition)
        masks.append([])
        with recorded_selection(masks[-1]):
            server.run(batches, ns, 4)
        runs.append(server)
    gpu, cpu = runs

    def same(field):
        return [getattr(r, field) for r in gpu.history] == \
            [getattr(r, field) for r in cpu.history]

    loss = [[r.mean_loss for r in s.history] for s in (gpu, cpu)]
    rel = max((0.0 if math.isnan(a) and math.isnan(b)
               else abs(a - b) / abs(b)) for a, b in zip(*loss))

    def err(a: dict, b: dict) -> float:
        return max((float((a[k].cpu() - v).abs().max()) for k, v in b.items()),
                   default=0.0)

    errs = {"max_param_abs_err": err(gpu.params, cpu.params)}
    for tree in cpu.store.trees:
        errs[f"max_{tree}_abs_err"] = err(gpu.store.dense_view(tree),
                                          cpu.store.dense_view(tree))
    if cpu.store.norms is not None:
        errs["max_norm_abs_err"] = float(
            (gpu.store.norms.cpu() - cpu.store.norms).abs().max())
    exact = {"participants": [p for p, _ in masks[0]]
             == [p for p, _ in masks[1]],
             "arrived": [a for _, a in masks[0]] == [a for _, a in masks[1]],
             "num_sampled": same("num_sampled"), "dropped": same("dropped"),
             "sim_round_s": same("sim_round_s"),
             "transport_bytes": same("transport_bytes")}
    phase("small_agreement", preset=name,
          num_sampled=[r.num_sampled for r in gpu.history],
          dropped=[r.dropped for r in gpu.history], loss_rel_err=rel,
          exact=exact, **errs)
    if len(masks[0]) != 4 or not all(exact.values()):
        fail(f"{name}: card and CPU differ in {exact}")
    if rel > SMALL_RTOL or max(errs.values()) > SMALL_RTOL:
        fail(f"{name}: card and CPU runs disagree: loss rel {rel}, {errs}")
    if not all(bool(torch.isfinite(v).all()) for v in gpu.params.values()):
        fail(f"{name}: non-finite parameters on the card")


def round_time_line(preset: str, hist) -> None:
    """A path's steady round time: the median of rounds 2-8's ``wall_s``,
    beside round 1 and every round's ``compile_s``."""
    walls = [r.wall_s for r in hist]
    phase("round_time", preset=preset,
          steady_round_s_median=statistics.median(walls[1:]),
          rounds_s=walls[1:], first_round_s=walls[0],
          buckets=[r.cohort_size for r in hist],
          compile_s=[r.compile_s for r in hist])


# ---------------------------------------------------------------------------
# The paper's VGG and GRU-LM through the round
# ---------------------------------------------------------------------------
def model_setup(model: str, full: bool = True):
    """One model's data and functions: at full width (M = 32) or at the
    small size of the CPU parity tests (M = 8).  Returns ``(batches,
    n_samples, eval_data, init(device), loss_fn, eval_fn, M)`` with numpy
    batches and eval data."""
    import numpy as np
    import torch
    from repro_torch.data.partition import (iid_partition_images,
                                            partition_text)
    from repro_torch.data.synthetic import class_gaussian_images, markov_text
    from repro_torch.models import paper_models as pm
    if model == "vgg":
        size, widths, M, batch, num_train = (
            (32, (32, 64, 128, 128), MAIN_M, MAIN_BATCH, 8192) if full
            else (16, (16, 32, 64), 8, 16, 512))
        ds = class_gaussian_images(num_train=num_train, image_size=size,
                                   channels=3, noise=0.6, seed=0)
        xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, batch,
                                          seed=0)

        def init(device):
            return pm.init_vgg(torch.Generator().manual_seed(0), size, 3,
                               widths=widths, device=device)
        return ((xs, ys), ns, (ds.test_x, ds.test_y), init,
                pm.classifier_loss(pm.vgg_forward),
                pm.classifier_accuracy(pm.vgg_forward), M)
    vocab, width, M = (512, 128, MAIN_M) if full else (256, 64, 8)
    ds = markov_text(num_train=M * (3200 if full else 400), vocab_size=vocab,
                     seed=0)
    xs, ys, ns = partition_text(ds.train_tokens, M, 8, 24, seed=0)
    test = ds.test_tokens
    wins = np.stack([test[i * 24:(i + 1) * 24 + 1]
                     for i in range((test.shape[0] - 1) // 24)])

    def init(device):
        return pm.init_gru_lm(torch.Generator().manual_seed(0), vocab, width,
                              width, device=device)
    return ((xs, ys), ns, (wins[:, :-1], wins[:, 1:]), init, pm.gru_lm_loss,
            pm.perplexity, M)


def lm_server(model: str, policy: str, device: str, full: bool = True,
              mask_scores=None):
    """A ``fig5`` server for ``model`` with kernel selective masking or
    random masking (``policy``), with its batches, sizes and eval data."""
    import torch
    from repro_torch.core import strategy
    from repro_torch.core.server import FederatedServer
    batches, ns, evald, init, loss_fn, eval_fn, M = model_setup(model, full)
    masking = (strategy.MaskPolicy.random(0.5) if policy == "random" else
               strategy.MaskPolicy.selective(0.5, backend="kernel"))
    server = FederatedServer.from_strategy(
        strategy.get("fig5", masking=masking), loss_fn, init(device), M,
        eval_fn=eval_fn, seed=0, device=device, mask_scores=mask_scores)
    eval_data = tuple(torch.as_tensor(a).to(device) for a in evald)
    return server, batches, ns, eval_data


def kernel_modules() -> tuple:
    """Every module of the port that holds a kernel with a launch count."""
    from repro_torch.kernels import segmented, ssm_scan, topk_mask, wkv6
    return segmented, topk_mask, wkv6, ssm_scan


def reset_all_counts() -> None:
    """Set the launch count of every kernel to 0."""
    for module in kernel_modules():
        module.reset_launch_counts()


def run_lm_path(name: str) -> dict:
    """One of the VGG/GRU main paths, with every assertion on its result.
    The launch counts of all eight kernels are set to 0 just before the run
    and read just after."""
    from repro_torch.core.masking import random_keep
    from repro_torch.kernels import segmented as seg
    from repro_torch.kernels import topk_mask as tk
    model, policy, upload_bytes, seg_launches = LM_PATHS[name]
    server, batches, ns, eval_data = lm_server(model, policy, "cuda")
    if server._num_params != LM_PARAMS[model]:
        fail(f"{name}: {server._num_params} parameters, not "
             f"{LM_PARAMS[model]}")
    reset_all_counts()
    t0 = time.perf_counter()
    server.run(batches, ns, MAIN_ROUNDS, eval_every=MAIN_ROUNDS,
               eval_data=eval_data)
    wall = time.perf_counter() - t0
    launches = {**seg.launch_counts(), **tk.launch_counts()}
    want_launches = {k: seg_launches.get(k, 0) for k in launches}
    summ = server.summary()
    hist = server.history
    sampled = [r.num_sampled for r in hist]
    buckets = [r.cohort_size for r in hist]
    losses = [r.mean_loss for r in hist]
    kept = {}
    if policy == "random":
        # Every client's upload keeps exactly k entries of every maskable
        # leaf: the kept sets of one more round's draws, on the card.
        scores = server.round_mask_scores(MAIN_ROUNDS + 1)
        for leaf, sc in scores.items():
            n = sc[0].numel()
            counts = random_keep(sc.reshape(MAIN_M, n), 0.5).sum(1)
            kept[leaf] = [int(counts.min()), int(counts.max()),
                          max(1, round(0.5 * n))]
    phase("main_path", preset=name, codec=summ["codec"], rounds=len(hist),
          params=server._num_params, num_sampled=sampled, buckets=buckets,
          losses=losses, transport_bytes=summ["transport_bytes"],
          client_upload_bytes=summ["client_upload_bytes"],
          final_eval=summ["final_eval"],
          eval_metric="accuracy" if model == "vgg" else "perplexity",
          launches=launches, quarantined=summ["quarantined"],
          kept_per_upload_min_max_k=kept,
          round_wall_s=[r.wall_s for r in hist], run_wall_s=wall)
    if sampled != MAIN_SAMPLED:
        fail(f"{name}: num_sampled {sampled} != {MAIN_SAMPLED}")
    if buckets != MAIN_BUCKETS:
        fail(f"{name}: buckets {buckets} != {MAIN_BUCKETS}")
    if summ["client_upload_bytes"] != upload_bytes:
        fail(f"{name}: upload bytes {summ['client_upload_bytes']}")
    if summ["transport_bytes"] != sum(MAIN_SAMPLED) * upload_bytes:
        fail(f"{name}: transport_bytes {summ['transport_bytes']}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        fail(f"{name}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name}: loss did not fall: {losses}")
    ev = summ["final_eval"]
    if not (ev == ev and (0.0 <= ev <= 1.0 if model == "vgg"
                          else 1.0 <= ev < float("inf"))):
        fail(f"{name}: eval metric {ev}")
    if launches != want_launches:
        fail(f"{name}: launches {launches}, expected {want_launches}")
    if any(lo != k or hi != k for lo, hi, k in kept.values()):
        fail(f"{name}: kept counts per upload {kept}")
    for leaf_name, leaf in server.params.items():
        if not bool(leaf.isfinite().all()):
            fail(f"{name}: non-finite parameter {leaf_name}")
    return {"launches": launches, "history": hist, "server": server,
            "batches": batches, "n_samples": ns}


def client_delta(main: dict, client: int = 0) -> dict:
    """One client's unmasked delta tree from the server's current model, on
    the card."""
    import dataclasses
    import torch
    from repro_torch.core.client import stacked_client_update
    from repro_torch.core.masking import MaskingConfig
    server = main["server"]
    cfg = dataclasses.replace(server.cfg.client, masking=MaskingConfig())
    batches = [torch.as_tensor(x[client:client + 1]).to(server.device)
               for x in main["batches"]]
    uploads, _, _, _ = stacked_client_update(server._loss_fn, server.params,
                                          batches, cfg, None, False)
    return {k: v[0] for k, v in uploads.items()}


class plain_kernels:
    """Within the block ``ops.topk_mask`` runs on the three kernels' plain
    versions (on whatever device its input lies)."""

    def __enter__(self):
        from repro_torch.kernels import topk_mask as tk
        self.saved = {name: getattr(tk, name) for name in PER_ARRAY}
        for name in PER_ARRAY:
            setattr(tk, name, getattr(tk, name + "_plain"))

    def __exit__(self, *exc):
        from repro_torch.kernels import topk_mask as tk
        for name, fn in self.saved.items():
            setattr(tk, name, fn)


def per_array_path(deltas: dict) -> dict:
    """Phase 4a: ``ops.topk_mask(leaf, 0.5)`` on every maskable leaf of one
    client's VGG and GRU delta, with the per-array launch counts set to 0
    just before and read just after; kept <= k per leaf, and where it and
    the round's segmented mask (``ops.topk_mask_pytree``) differ."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_mask as tk
    leaves = {(model, name): leaf for model, tree in deltas.items()
              for name, leaf in tree.items() if leaf.numel() >= 256}
    reset_all_counts()
    masked = {key: ops.topk_mask(leaf, 0.5, PER_ARRAY_ITERS)
              for key, leaf in leaves.items()}
    torch.cuda.synchronize()
    launches = tk.launch_counts()
    segmented = {model: ops.topk_mask_pytree(tree, 0.5)
                 for model, tree in deltas.items()}
    report = {}
    for (model, name), out in masked.items():
        k = max(1, round(0.5 * out.numel()))
        kept = int((out != 0).sum())
        seg_keep = segmented[model][name] != 0
        report[f"{model}:{name}"] = {
            "n": out.numel(), "k": k, "kept": kept,
            "nonzero": int((leaves[(model, name)] != 0).sum()),
            "differ_from_segmented": int(((out != 0) != seg_keep).sum())}
    L = len(leaves)
    want = {"exponent_histogram": L, "count_ge": PER_ARRAY_ITERS * L,
            "apply_threshold": L}
    phase("per_array_path", leaves=L, launches=launches, per_leaf=report)
    if launches != want:
        fail(f"per-array path launches {launches}, expected {want}")
    over = [key for key, rec in report.items() if rec["kept"] > rec["k"]]
    if over:
        fail(f"per-array topk_mask kept more than k: {over}")
    return {"launches": launches, "leaves": leaves}


def views_agree(x, taus) -> dict:
    """The three per-array kernels against their plain versions on views of
    ``x`` that start 1, 2 or 3 elements in (off the 16-byte boundary) and
    on lengths 0, 1, 3, 5, 4095 and the rest of ``x`` (histogram and
    counts exact, apply bitwise): per kernel, "offset:length" -> exact."""
    import torch
    from repro_torch.kernels import measure
    from repro_torch.kernels import topk_mask as tk
    out = {name: {} for name in PER_ARRAY}
    for offset in (1, 2, 3):
        rest = max(0, x.numel() - offset)
        for n in sorted({min(m, rest) for m in (0, 1, 3, 5, 4095, rest)}):
            view = x[offset:offset + n]
            key = f"{offset}:{n}"
            out["exponent_histogram"][key] = bool(torch.equal(
                tk.exponent_histogram(view),
                tk.exponent_histogram_plain(view)))
            ts = [torch.tensor(tau, device=x.device) for tau in taus]
            out["count_ge"][key] = all(
                int(tk.count_ge(view, t)) == int(tk.count_ge_plain(view, t))
                for t in ts)
            out["apply_threshold"][key] = all(
                measure.bitwise(tk.apply_threshold(view, t),
                                tk.apply_threshold_plain(view, t))
                for t in ts)
    return out


def check_topk_kernels(label: str, x, errs: dict) -> dict:
    """Kernels 6–8 against their plain versions on the card at one input
    (histogram and counts exact, apply bitwise) and ``ops.topk_mask`` on
    the kernels against the same pipeline on the plain versions (bitwise).
    Folds the largest absolute differences into ``errs``."""
    import torch
    from repro_torch.kernels import measure, ops
    from repro_torch.kernels import topk_mask as tk
    with plain_kernels():
        want_mask = ops.topk_mask(x, 0.5, PER_ARRAY_ITERS)
    got_mask = ops.topk_mask(x, 0.5, PER_ARRAY_ITERS)
    finite = x[torch.isfinite(x)].abs()
    taus = [0.0, 2.0 ** -100, float(finite.median()) if finite.numel()
            else 1.0, float(finite.max()) if finite.numel() else 2.0]
    exact = {"exponent_histogram": bool(torch.equal(
        tk.exponent_histogram(x), tk.exponent_histogram_plain(x)))}
    count_ok, apply_ok, apply_err = True, True, 0.0
    for tau in taus:
        t = torch.tensor(tau, device=x.device)
        count_ok &= int(tk.count_ge(x, t)) == int(tk.count_ge_plain(x, t))
        got, want = tk.apply_threshold(x, t), tk.apply_threshold_plain(x, t)
        apply_ok &= measure.bitwise(got, want)
        apply_err = max(apply_err, float((got.double() - want.double())
                                         .abs().nan_to_num().max()))
    views = views_agree(x, taus)
    exact.update(exponent_histogram=exact["exponent_histogram"]
                 and all(views["exponent_histogram"].values()),
                 count_ge=count_ok and all(views["count_ge"].values()),
                 apply_threshold=apply_ok
                 and all(views["apply_threshold"].values()),
                 topk_mask=measure.bitwise(got_mask, want_mask))
    for name in PER_ARRAY:
        errs[name] = max(errs.get(name, 0.0),
                         0.0 if name != "apply_threshold" else apply_err)
    phase("topk_kernel_parity", input=label, n=x.numel(), taus=taus,
          exact=exact, views=views, kept=int((got_mask != 0).sum()))
    bad = [name for name, ok in exact.items() if not ok]
    if bad:
        fail(f"per-array kernels disagree with their plain versions "
             f"({label}): {bad}")
    return exact


def library_call(fn, v):
    """A call of ``fn(v)`` that returns nothing (the timers read a returned
    value as a launcher's error code)."""
    def call():
        fn(v)
    return call


def time_topk(label: str, x, launches: dict) -> dict:
    """Kernels 6–8 and the whole ``ops.topk_mask`` at one input: device
    time out of L2 (C launchers back to back over rotating copies) and
    warm, the wrapper's and the plain version's time per call, the bytes
    bound and the library yardsticks: for ``apply_threshold``
    ``hardshrink(x, nextafter(tau, 0))`` (back to back and the profiler's
    time a call, and whether it equals the kernel's output bit for bit on
    ``x``), for the pipeline ``torch.topk(|x|, k)`` plus a scatter."""
    import torch
    from repro_torch.kernels import build, measure, ops
    from repro_torch.kernels import topk_mask as tk
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    n = x.numel()
    l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
    copies = max(2, -(-4 * l2 // x.nbytes))
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    outs = [torch.empty_like(x) for _ in range(copies)]
    hist = torch.empty(128, dtype=torch.int32, device=x.device)
    cnt = torch.empty((), dtype=torch.int32, device=x.device)
    tau = torch.tensor(float(x.abs().median()), device=x.device)
    # hardshrink keeps |x| > lam: for fp32 x and tau > 0, |x| >= tau.
    lam = float(torch.nextafter(tau.cpu(), torch.zeros(())))
    libraries = {"apply_threshold": (
        LIBRARY_APPLY, lambda v: torch.nn.functional.hardshrink(v, lam))}

    def launcher(name, i):
        p = xs[i].data_ptr()
        if name == "exponent_histogram":
            return lambda: lib.topk_histogram_launch(p, n, hist.data_ptr(),
                                                     stream)
        if name == "count_ge":
            return lambda: lib.topk_count_launch(p, n, tau.data_ptr(),
                                                 cnt.data_ptr(), stream)
        return lambda: lib.topk_apply_launch(p, n, tau.data_ptr(),
                                             outs[i].data_ptr(), stream)

    work = {  # wrapper, plain, bytes
        "exponent_histogram": (tk.exponent_histogram,
                               tk.exponent_histogram_plain, 4 * n + 512),
        "count_ge": (lambda v: tk.count_ge(v, tau),
                     lambda v: tk.count_ge_plain(v, tau), 4 * n + 8),
        "apply_threshold": (lambda v: tk.apply_threshold(v, tau),
                            lambda v: tk.apply_threshold_plain(v, tau),
                            8 * n + 4),
    }
    results = {}
    for name, (wrapper, plain, nbytes) in work.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n / FP32_OPS_PER_S * 1e3
        kernels = [launcher(name, i) for i in range(copies)]
        rec = {"ms": measure.cuda_loop_ms(kernels),
               "warm_ms": measure.cuda_loop_ms(kernels[:1]),
               **measure.device_ms(kernels, kernel_symbol(name)),
               "wrapper_ms": cuda_ms([lambda v=v: wrapper(v) for v in xs]),
               "plain_ms": cuda_ms([lambda v=v: plain(v) for v in xs],
                                   reps=5),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": None, "bytes": nbytes, "launches_per_call": 1,
               "path_launches": launches[name], "buffers": copies}
        # Device records a kernel record: 1 when a call puts nothing but
        # the kernel on the stream (a record the tracer lost drops from
        # both counts).
        rec["records_per_call"] = (rec["device_records"]
                                   / rec["kernel_records"])
        if name in libraries:
            desc, fn = libraries[name]
            calls = [library_call(fn, v) for v in xs]
            # Like for like: hardshrink into the kernel's rotating outputs
            # (as ``device_ms``), and the kernel into one output (as the
            # caching allocator hands the wrapper, and hardshrink, one
            # block), each beside the other's regime.
            into = [library_call(lambda v, o=o: torch.ops.aten.hardshrink.out(
                v, lam, out=o), v) for v, o in zip(xs, outs)]
            one = [lambda p=v.data_ptr(): lib.topk_apply_launch(
                p, n, tau.data_ptr(), outs[0].data_ptr(), stream)
                for v in xs]
            dev = measure.device_ms(into, "")
            rec["library_device_ms_same_outputs"] = (
                dev["device_ms"] * dev["kernel_records"] / dev["calls"])
            rec["one_output_device_ms"] = measure.device_ms(
                one, kernel_symbol(name))["device_ms"]
            dev = measure.device_ms(calls, "")
            rec.update(library=desc, library_ms=measure.cuda_loop_ms(calls),
                       library_device_ms=dev["device_ms"]
                       * dev["kernel_records"] / dev["calls"],
                       library_equal=measure.bitwise(
                           fn(x), tk.apply_threshold(x, tau)))
            if (float(tau) > 0 and not torch.isnan(x).any()
                    and not rec["library_equal"]):
                fail(f"{desc} differs from apply_threshold ({label})")
        results[name] = rec
        phase("kernel_time", shape=label, kernel=name, **rec)
        if (rec["records_per_call"] != 1
                or rec["kernel_records"] > rec["calls"]):
            fail(f"{name} put more than its kernel on the stream a call "
                 f"({label}): {rec['device_records']} records, "
                 f"{rec['kernel_records']} of the kernel, {rec['calls']} "
                 f"calls")
    k = max(1, round(0.5 * n))

    def library(v):
        idx = torch.topk(v.abs(), k, sorted=False).indices
        return torch.zeros_like(v).scatter_(0, idx, v.gather(0, idx))

    with plain_kernels():
        plain_ms = cuda_ms([lambda v=v: ops.topk_mask(v, 0.5) for v in xs],
                           reps=5)
    reset_all_counts()
    ops.topk_mask(x, 0.5)
    per_call = sum(tk.launch_counts().values())
    nbytes = (2 + PER_ARRAY_ITERS) * 4 * n + 4 * n
    rec = {"ms": cuda_ms([lambda v=v: ops.topk_mask(v, 0.5) for v in xs]),
           "warm_ms": cuda_ms([lambda: ops.topk_mask(x, 0.5)]),
           "plain_ms": plain_ms,
           "library_ms": cuda_ms([lambda v=v: library(v) for v in xs]),
           "library": "torch.topk(|x|, k, sorted=False) + scatter",
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bytes": nbytes, "launches_per_call": per_call,
           "launches_want": PER_ARRAY_ITERS + 2}
    phase("topk_mask_time", shape=label, n=n, k=k, **rec)
    if per_call != PER_ARRAY_ITERS + 2:
        fail(f"topk_mask launched {per_call} kernels per call")
    results["topk_mask"] = rec
    del xs, outs
    return results


def small_lm_agreement(model: str, policy: str) -> None:
    """A VGG/GRU path on the card against the same run on the CPU at the
    small size, with the same injected mask scores under random masking:
    participants and bytes exact, losses and parameters within SMALL_RTOL.
    The GRU's embedding backward accumulates with atomics on the card, so
    a second card run is compared with the first and its difference
    reported as it is."""
    import torch
    mask_scores = None
    if policy == "random":
        _, _, _, init, _, _, M = model_setup(model, full=False)
        shapes = {k: tuple(v.shape) for k, v in init("cpu").items()
                  if v.numel() >= 256}

        def mask_scores(t, m):
            gen = torch.Generator().manual_seed(1000 + t)
            return {k: torch.rand((m,) + s, generator=gen).numpy()
                    for k, s in shapes.items()}
    runs = {}
    devices = ("cuda", "cuda", "cpu") if model == "gru" else ("cuda", "cpu")
    for i, device in enumerate(devices):
        server, batches, ns, _ = lm_server(model, policy, device, full=False,
                                           mask_scores=mask_scores)
        server.run(batches, ns, 4)
        runs[(device, i)] = server
    gpu, cpu = runs[("cuda", 0)], runs[(devices[-1], len(devices) - 1)]
    sampled = [[r.num_sampled for r in s.history] for s in (gpu, cpu)]
    loss = [[r.mean_loss for r in s.history] for s in (gpu, cpu)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(*loss))
    param_err = max(float((gpu.params[k].cpu() - v).abs().max())
                    for k, v in cpu.params.items())
    rec = {"model": model, "policy": policy, "num_sampled": sampled[0],
           "loss_rel_err": rel, "max_param_abs_err": param_err,
           "transport_bytes": [gpu.summary()["transport_bytes"],
                               cpu.summary()["transport_bytes"]]}
    if ("cuda", 1) in runs:
        again = runs[("cuda", 1)]
        rec["card_run_to_run_max_param_abs_diff"] = max(
            float((again.params[k] - v).abs().max())
            for k, v in gpu.params.items())
        rec["note"] = ("the embedding backward accumulates with atomics on "
                       "the card: two card runs may differ in the last bits")
    phase("small_agreement", **rec)
    if sampled[0] != sampled[1]:
        fail(f"participants differ card vs CPU: {sampled}")
    if rec["transport_bytes"][0] != rec["transport_bytes"][1]:
        fail("transport bytes differ card vs CPU")
    if rel > SMALL_RTOL or param_err > SMALL_RTOL:
        fail(f"{model}/{policy}: card and CPU runs disagree: loss rel {rel}, "
             f"param {param_err}")
    if not all(bool(torch.isfinite(v).all()) for v in gpu.params.values()):
        fail("non-finite parameters on the card")


# ---------------------------------------------------------------------------
# The client-state store: the store form at fleet scale, resume, seeds
# ---------------------------------------------------------------------------
def seed_hashes() -> dict:
    """sha256 of the LeNet main path's seed-0 data (the synthetic images,
    their IID and Dirichlet(0.5) partitions), which must equal the values
    pinned on the CPU against the reference's arrays, and of the seed-0
    ``init_lenet()`` leaves, reported with the torch version whose CPU
    generator made them."""
    import hashlib
    import numpy as np
    import torch
    from repro_torch.data.partition import (dirichlet_partition_images,
                                            iid_partition_images)
    from repro_torch.data.synthetic import class_gaussian_images
    from repro_torch.models import paper_models as pm

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    ds = class_gaussian_images(num_train=MAIN_M * 8 * MAIN_BATCH,
                               image_size=28, seed=0)
    data = {f"images.{k}": sha(getattr(ds, k))
            for k in ("train_x", "train_y", "test_x", "test_y")}
    for name, split in (("iid", iid_partition_images),
                        ("dirichlet", dirichlet_partition_images)):
        kw = {"alpha": 0.5} if name == "dirichlet" else {}
        xs, ys, n = split(ds.train_x, ds.train_y, MAIN_M, MAIN_BATCH, seed=0,
                          **kw)
        data.update({f"{name}.xs": sha(xs), f"{name}.ys": sha(ys),
                     f"{name}.n": sha(n)})
    params = pm.init_lenet(torch.Generator().manual_seed(0), image_size=28,
                           device="cpu")
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].numpy().tobytes())
    init = h.hexdigest()
    moved = sorted(k for k, v in data.items() if v != SEED_DATA_HASHES[k])
    phase("seed_hashes", data=data, data_match=not moved,
          init_lenet=init, torch=torch.__version__, numpy=np.__version__)
    if moved:
        fail(f"seeded data differs from the pinned reference arrays: {moved}")
    return {"data": data, "init": init}


class deterministic_cudnn:
    """Within the block cuDNN picks deterministic algorithms and does not
    benchmark: the rounds whose bit-identity is checked run here."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = self.on
        torch.backends.cudnn.benchmark = False
        return self

    def __exit__(self, *exc):
        import torch
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.saved


class recorded_importance_draws:
    """Within the block every importance-sampler selection keeps its
    inputs and participants; on leaving it, each appends ``(participant
    ids, margin)`` to ``log``.  The margin is the smallest distance between
    one of the round's m_t scaled draws and the CDF entry on either side of
    it, in ulps of that entry (a draw within a few ulps could pick another
    client on another device).  It is computed on leaving, so a round's
    ``wall_s`` holds only the copies of the scores and norms."""

    def __init__(self, log: list):
        self.log = log

    def __enter__(self):
        from repro_torch.core import sampling
        cls = sampling.ImportanceSampler
        self.real = real = cls.select
        self.kept = kept = []

        def select(smp, scores, schedule, t, num_registered, n_samples,
                   norms=None):
            part, weights = real(smp, scores, schedule, t, num_registered,
                                 n_samples, norms)
            kept.append((part.clone(), smp, scores.clone(), schedule, t,
                         num_registered, norms.clone()))
            return part, weights

        cls.select = select
        return self

    def __exit__(self, *exc):
        from repro_torch.core import sampling
        sampling.ImportanceSampler.select = self.real
        for part, *args in self.kept:
            self.log.append((part.nonzero().reshape(-1).tolist(),
                             draw_margin_ulps(*args)))


def draw_margin_ulps(smp, scores, schedule, t, num_registered, norms):
    """See :class:`recorded_importance_draws`."""
    import numpy as np
    import torch
    from repro_torch.core.sampling import _cumsum
    m = schedule.num_clients(t, num_registered)
    cdf = _cumsum(smp.probabilities(norms.cpu())).numpy()
    v = (scores[:m].cpu() * float(cdf[-1])).numpy().astype(np.float32)
    d = np.clip(np.searchsorted(cdf, v, side="right"), 0,
                num_registered - 1)
    hi = cdf[d].astype(np.float64)
    lo = np.where(d > 0, cdf[np.maximum(d - 1, 0)], 0.0).astype(np.float64)
    vd = v.astype(np.float64)
    below = np.where(d > 0, (vd - lo) / np.spacing(np.float32(lo)), np.inf)
    above = (hi - vd) / np.spacing(cdf[d])
    return float(np.min(np.minimum(np.abs(below), np.abs(above))))


def store_strategy(M: int, cohort: int, min_clients: int):
    """The reference's store-scaling operating point
    (``benchmarks/client_store.py``): fig5 with error feedback and the
    importance sampler, c(t) rescaled so round 1 holds about ``cohort``
    clients (beta 0.05), selective masking (gamma 0.5) on the kernels, the
    COO wire."""
    from repro_torch.core import strategy
    from repro_torch.core.sampling import DynamicSampling, ImportanceSampler
    return strategy.get(
        "fig5", sampling=DynamicSampling(initial_rate=cohort / M, beta=0.05,
                                         min_clients=min_clients),
        sampler=ImportanceSampler(), error_feedback=True,
        masking=strategy.MaskPolicy.selective(0.5, backend="kernel"))


def store_setup(device: str, full: bool = True, masking=None,
                kind: str = "sharded"):
    """A VGG server on a ``ShardedStore`` with a batch provider over a pool
    of synthetic shards on ``device`` (client i serves shard i mod pool):
    full width at M = 100,000 with a window of 1024, or the small VGG at
    M = 64 with a window of 16 (or, with ``kind="dense"``, on the dense
    store with the stacked batches).  ``masking`` replaces the store
    path's kernel top-k.  Returns ``(server, provider or batches,
    n_samples, eval_data)``."""
    import numpy as np
    import torch
    from repro_torch.core.client_store import ShardedStore
    from repro_torch.core.server import FederatedServer
    from repro_torch.data.partition import iid_partition_images
    from repro_torch.data.synthetic import class_gaussian_images
    from repro_torch.models import paper_models as pm
    M, retention, pool, cohort, min_clients = (STORE_FULL if full
                                               else STORE_SMALL)
    size, widths, batch = ((32, (32, 64, 128, 128), MAIN_BATCH) if full
                           else (16, (16, 32, 64), 16))
    ds = class_gaussian_images(num_train=pool * STORE_BATCHES * batch,
                               image_size=size, channels=3, noise=0.6,
                               seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, pool, batch,
                                      seed=0)
    xs_d, ys_d = (torch.as_tensor(a).to(device) for a in (xs, ys))

    def provider(ids):
        idx = torch.from_numpy(np.asarray(ids) % pool).to(device)
        return xs_d.index_select(0, idx), ys_d.index_select(0, idx)

    params = pm.init_vgg(torch.Generator().manual_seed(0), size, 3,
                         widths=widths, device=device)
    st = store_strategy(M, cohort, min_clients)
    if masking is not None:
        st = st.with_masking(masking)
    store = (ShardedStore(M, params, retention, track_norms=True)
             if kind == "sharded" else None)
    server = FederatedServer.from_strategy(
        st, pm.classifier_loss(pm.vgg_forward),
        params, M, eval_fn=pm.classifier_accuracy(pm.vgg_forward), seed=0,
        device=device, store=store)
    eval_data = (torch.as_tensor(ds.test_x).to(device),
                 torch.as_tensor(ds.test_y).to(device))
    if kind == "dense":
        provider = provider(np.arange(M))
    return server, provider, np.full((M,), int(ns[0])), eval_data


def store_rounds(server, provider, ns, eval_data, rounds: int, log: list,
                 after=None) -> list:
    """``rounds`` rounds one at a time (eval on the last), each round's
    record with the store's eviction count after it; ``after(t)`` runs
    after round t."""
    out = []
    start = server._round
    for t in range(start + 1, start + rounds + 1):
        with recorded_importance_draws(log):
            server.run(provider, ns, 1, eval_every=int(t == start + rounds),
                       eval_data=eval_data)
        out.append((server.history[-1], server.store.evictions))
        if after is not None:
            after(t)
    return out


def store_buckets() -> list:
    """The store path's cohort bucket each round, from its strategy's
    plan: the cohort buffers kernels 1-5 are launched on there."""
    M, _, _, cohort, min_clients = STORE_FULL
    st = store_strategy(M, cohort, min_clients)
    return [st.sampler.cohort_bucket(st.sampling,
                                     st.sampling.num_clients_host(t, M), M)
            for t in range(1, STORE_ROUNDS + 1)]


def store_kernel_parity(clients: int) -> dict:
    """Kernels 1-5 against their plain versions on a ``clients``-client
    full-width VGG cohort buffer (every maskable leaf, packed as the round
    packs it, one segment a leaf a client): the store path's buckets, and
    ``STORE_STRESS_CLIENTS`` past 2^28 elements and 1 GB."""
    import torch
    from repro_torch.kernels import packing as pk
    from repro_torch.models import paper_models as pm
    params = pm.init_vgg(torch.Generator().manual_seed(0), 32, 3,
                         widths=(32, 64, 128, 128), device="cpu")
    spec = pk.build_pack_spec([v for v in params.values()
                               if v.numel() >= 256])
    gen = torch.Generator(device="cuda").manual_seed(5)
    x2d = 1e-3 * torch.randn((clients * spec.rows, SEG_LANE), generator=gen,
                             device="cuda")
    seg_ids = spec.seg_ids(clients, device="cuda")
    k = torch.tensor([max(1, round(0.5 * ls.size)) for ls in spec.leaves],
                     dtype=torch.int32).repeat(clients).cuda()
    errs = check_kernels(f"vgg_cohort{clients}", x2d, seg_ids, k,
                         candidates=())
    del x2d
    torch.cuda.empty_cache()
    return errs


def run_store_path(ckpt_dir: str) -> dict:
    """The store form at fleet scale: full-width VGG, M = 100,000 on a
    ``ShardedStore(retention=1024)`` with a batch provider, 8 rounds under
    deterministic cuDNN, ``save_state`` after round 4.  The launch counts
    are set to 0 just before the rounds and read just after."""
    import torch
    from repro_torch.kernels import segmented as seg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server, provider, ns, eval_data = store_setup("cuda")
    M, retention = STORE_FULL[:2]
    if server._num_params != LM_PARAMS["vgg"]:
        fail(f"store path VGG has {server._num_params} parameters")
    timing = {}

    norms = recorded_norms(server)

    def after(t):
        norms.check(t, ns)
        if t == STORE_SAVE_AFTER:
            t0 = time.perf_counter()
            server.save_state(ckpt_dir)
            timing["save_s"] = time.perf_counter() - t0

    draws = []
    reset_all_counts()
    t0 = time.perf_counter()
    with deterministic_cudnn(), norms:
        rounds = store_rounds(server, provider, ns, eval_data, STORE_ROUNDS,
                              draws, after=after)
    wall = time.perf_counter() - t0
    launches = seg.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    prev = 0
    for (rec, evictions), (_, margin), nb in zip(rounds, draws,
                                                 norms.results):
        phase("store_round", round=rec.round, m_t=ns_round(server, rec.round),
              bucket=rec.cohort_size, participants=rec.num_sampled,
              transport_bytes=rec.transport_bytes, evictions=evictions,
              evictions_this_round=evictions - prev, wall_s=rec.wall_s,
              compile_s=rec.compile_s, mean_loss=rec.mean_loss,
              min_draw_margin_ulps=margin,
              norm_bits_card_eq_cpu=nb["norm_bits_equal"],
              next_participants_card_eq_cpu=nb["next_participants_equal"])
        prev = evictions
    equal_rounds = sum(nb["norm_bits_equal"] and nb["norm_vectors_equal"]
                       and nb["next_participants_equal"]
                       for nb in norms.results)
    mem = server.store.memory_bytes()
    summ = server.summary()
    hist = [rec for rec, _ in rounds]
    walls = [r.wall_s for r in hist]
    plan = store_buckets()
    want = {k: STORE_ROUNDS * MASK_PER_ROUND.get(k, 0) for k in SEGMENTED}
    bound_ok = mem["residual_bytes"] * M <= \
        (retention + 1) * mem["dense_equiv_bytes"]
    phase("store_path", model="vgg", params=server._num_params,
          num_clients=M, retention=retention, pool=STORE_FULL[2],
          rounds=len(hist), codec=summ["codec"], sampler=summ["sampler"],
          buckets=[r.cohort_size for r in hist],
          participants=[r.num_sampled for r in hist],
          transport_bytes=summ["transport_bytes"],
          client_upload_bytes=summ["client_upload_bytes"],
          evictions=server.store.evictions, launches=launches,
          memory_bytes=mem,
          store_bytes=mem["residual_bytes"] + mem["vector_bytes"],
          residual_bound_ok=bound_ok,
          dense_store_bytes_avoided=mem["dense_equiv_bytes"],
          max_memory_allocated=peak, final_eval=summ["final_eval"],
          steady_round_s_median=statistics.median(walls[1:]),
          first_round_s=walls[0], compile_s=[r.compile_s for r in hist],
          checkpoint_save_s=timing.get("save_s"), run_wall_s=wall,
          min_draw_margin_ulps=min(m for _, m in draws),
          norm_bits_equal_rounds=f"{equal_rounds}/{len(norms.results)}",
          norm_max_abs_diff=max(nb["max_abs_diff"] for nb in norms.results),
          row_l2_cost=norms.cost, cudnn_deterministic=True)
    if equal_rounds != STORE_ROUNDS or len(norms.results) != STORE_ROUNDS:
        fail(f"store path: card and CPU norms or participants differ: "
             f"{norms.results}")
    if launches != want:
        fail(f"store path: launches {launches}, expected {want}")
    if [r.cohort_size for r in hist] != plan:
        fail(f"store path: buckets {[r.cohort_size for r in hist]} != {plan}")
    if any(r.num_sampled > r.cohort_size for r in hist):
        fail("store path: more participants than the bucket")
    if summ["client_upload_bytes"] != LM_PATHS["vgg-fig5"][2] or \
            summ["transport_bytes"] != sum(r.num_sampled for r in hist) \
            * summ["client_upload_bytes"]:
        fail(f"store path: bytes {summ['transport_bytes']}")
    if not server.store.evictions > 0:
        fail("store path: no client was evicted")
    if not bound_ok:
        fail(f"store path: residual backing {mem['residual_bytes']} over "
             f"(retention + 1) / M of {mem['dense_equiv_bytes']}")
    if "save_s" not in timing:
        fail("store path: no checkpoint after round 4")
    check_finite("store path", server)
    return {"server": server, "rounds": rounds, "provider": provider,
            "n_samples": ns, "eval_data": eval_data, "launches": launches,
            "peak": peak, "history": hist}


def ns_round(server, t: int) -> int:
    """The schedule's nominal m_t for round t."""
    return server.schedule.num_clients(t, server.cfg.num_clients)


def check_finite(label: str, server) -> None:
    """Parameters and every store tree and vector finite."""
    import torch
    state = dict(server.params)
    state.update({f"slots/{k}": v for k, v in server.store.slots.items()}
                 if server.store.kind == "sharded" else
                 server.store.residuals_dense())
    if server.store.norms is not None:
        state["norms"] = server.store.norms
    for key, leaf in state.items():
        if not bool(torch.isfinite(leaf).all()):
            fail(f"{label}: non-finite {key}")


def same_run(a, b, rounds_a, rounds_b) -> dict:
    """Which parts of two servers' results are bit-identical: parameters,
    every store tree, the slot directory, versions, norms and the given
    rounds' records."""
    import numpy as np
    import torch

    def trees(s):
        if s.store.kind == "sharded":
            return {f"{n}/{k}": v for n, pool in s.store._pools.items()
                    for k, v in pool.items()}
        return {f"{n}/{k}": v for n in s.store.trees
                for k, v in s.store.dense_view(n).items()}

    tb = trees(b)
    out = {"params": all(torch.equal(v, b.params[k])
                         for k, v in a.params.items()),
           "store_trees": all(torch.equal(v, tb[k])
                              for k, v in trees(a).items()),
           "versions": bool(np.array_equal(a.store.versions,
                                           b.store.versions)),
           "norms": (a.store.norms is None) or bool(
               torch.equal(a.store.norms, b.store.norms))}
    if a.store.kind == "sharded":
        out["slot_directory"] = bool(
            np.array_equal(a.store._slot_ids, b.store._slot_ids)
            and np.array_equal(a.store._slot_round, b.store._slot_round))
    for field in ("num_sampled", "transport_bytes", "cohort_size",
                  "mean_loss"):
        out[field] = [getattr(r, field) for r in rounds_a] == \
            [getattr(r, field) for r in rounds_b]
    return out


def store_resume(path: dict, ckpt_dir: str) -> dict:
    """A fresh store-path server restores the round-4 checkpoint and runs
    rounds 5-8 under deterministic cuDNN: bit-identical to the
    uninterrupted run (evictions compared round by round).  Then rounds
    9-11 on both servers, the uninterrupted one deterministic and the
    resumed one not: the cost of deterministic cuDNN on the same work."""
    import torch
    full = path["server"]
    server, provider, ns, eval_data = store_setup("cuda")
    t0 = time.perf_counter()
    step = server.restore_state(ckpt_dir)
    restore_s = time.perf_counter() - t0
    with deterministic_cudnn():
        rounds = store_rounds(server, provider, ns, eval_data,
                              STORE_ROUNDS - STORE_SAVE_AFTER, [])
    base = path["rounds"][STORE_SAVE_AFTER - 1][1]
    want_ev = [ev - base for _, ev in path["rounds"][STORE_SAVE_AFTER:]]
    exact = same_run(full, server, path["history"][STORE_SAVE_AFTER:],
                     [rec for rec, _ in rounds])
    exact["evictions"] = [ev for _, ev in rounds] == want_ev
    ckpt_bytes = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*")
                     if f.is_file())
    extra = {}
    for label, srv, det in (("deterministic", full, True),
                            ("default", server, False)):
        with deterministic_cudnn(det):
            recs = store_rounds(srv, path["provider"], ns, path["eval_data"],
                                STORE_COST_ROUNDS, [])
        extra[f"{label}_round_s"] = [r.wall_s for r, _ in recs]
    det_s = statistics.median(extra["deterministic_round_s"])
    default_s = statistics.median(extra["default_round_s"])
    phase("store_resume", path="vgg-store", step=step,
          checkpoint_bytes=ckpt_bytes, checkpoint_restore_s=restore_s,
          exact=exact,
          evictions_rounds_5_8=[ev for _, ev in rounds],
          deterministic_round_s_median=det_s,
          default_round_s_median=default_s,
          deterministic_cost=det_s / default_s - 1.0, **extra)
    if step != STORE_SAVE_AFTER or not all(exact.values()):
        fail(f"store resume is not bit-identical: {exact}")
    del server
    torch.cuda.empty_cache()
    return {"restore_s": restore_s, "exact": exact,
            "deterministic_cost": det_s / default_s - 1.0}


def dense_resume_lenet(ckpt_dir: str) -> dict:
    """The LeNet ``fig5`` main path on the dense store, 4 rounds,
    ``save_state``, 4 more, against a fresh server that restores and runs
    the last 4, under deterministic cuDNN: bit-identical."""
    with deterministic_cudnn():
        full, batches, ns, _ = fig5_server(MAIN_M, 28, MAIN_M * 8 * MAIN_BATCH,
                                           MAIN_BATCH, "cuda")
        full.run(batches, ns, 4)
        full.save_state(ckpt_dir)
        full.run(batches, ns, 4)
        resumed, _, _, _ = fig5_server(MAIN_M, 28, MAIN_M * 8 * MAIN_BATCH,
                                       MAIN_BATCH, "cuda")
        step = resumed.restore_state(ckpt_dir)
        resumed.run(batches, ns, 4)
    exact = same_run(full, resumed, full.history[4:], resumed.history)
    phase("store_resume", path="lenet-fig5-dense", step=step, exact=exact,
          num_sampled=[r.num_sampled for r in full.history])
    if step != 4 or not all(exact.values()):
        fail(f"dense resume is not bit-identical: {exact}")
    if [r.num_sampled for r in full.history] != MAIN_SAMPLED:
        fail(f"dense resume: num_sampled {full.history}")
    return exact


def small_store_agreement() -> dict:
    """The store path at the small VGG size (M = 64, window 16, 6 rounds)
    on the card against the CPU: participants, the slot directory,
    evictions, versions and bytes exact; losses, parameters, the residual
    pool and norms within SMALL_RTOL."""
    import numpy as np
    runs, draws = [], []
    for device in ("cuda", "cpu"):
        server, provider, ns, _ = store_setup(device, full=False)
        draws.append([])
        with recorded_importance_draws(draws[-1]):
            server.run(provider, ns, STORE_SMALL_ROUNDS)
        runs.append(server)
    gpu, cpu = runs

    def err(a: dict, b: dict) -> float:
        return max(float((a[k].cpu() - v).abs().max()) for k, v in b.items())

    exact = {
        "participants": [p for p, _ in draws[0]] == [p for p, _ in draws[1]],
        "slot_ids": bool(np.array_equal(gpu.store._slot_ids,
                                        cpu.store._slot_ids)),
        "slot_round": bool(np.array_equal(gpu.store._slot_round,
                                          cpu.store._slot_round)),
        "evictions": gpu.store.evictions == cpu.store.evictions,
        "versions": bool(np.array_equal(gpu.store.versions,
                                        cpu.store.versions))}
    for field in ("num_sampled", "cohort_size", "transport_bytes"):
        exact[field] = [getattr(r, field) for r in gpu.history] == \
            [getattr(r, field) for r in cpu.history]
    loss = [[r.mean_loss for r in s.history] for s in runs]
    errs = {"loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(*loss)),
            "max_param_abs_err": err(gpu.params, cpu.params),
            "max_slots_abs_err": err(gpu.store.slots, cpu.store.slots),
            "max_norm_abs_err": float((gpu.store.norms.cpu()
                                       - cpu.store.norms).abs().max())}
    phase("small_store_agreement", num_clients=gpu.cfg.num_clients,
          retention=gpu.store.retention, rounds=len(gpu.history),
          participants=[r.num_sampled for r in gpu.history],
          evictions=gpu.store.evictions,
          min_draw_margin_ulps=min(m for _, m in draws[0]), exact=exact,
          **errs)
    if not all(exact.values()):
        fail(f"small store run: card and CPU differ in {exact}")
    if not gpu.store.evictions > 0:
        fail("small store run: no client was evicted")
    if max(errs.values()) > SMALL_RTOL:
        fail(f"small store run: card and CPU disagree: {errs}")
    check_finite("small store run", gpu)
    return errs


# ---------------------------------------------------------------------------
# The async engine and random masking on the store
# ---------------------------------------------------------------------------
def kernel_masking(st):
    """``st`` with fig5's masking: selective top-k (gamma 0.5) on the
    kernels, the COO wire."""
    from repro_torch.core import strategy
    return st.with_masking(strategy.MaskPolicy.selective(0.5,
                                                         backend="kernel"))


def record_async_stats(server) -> list:
    """Every async round's host stats (``AsyncRoundRunner.run_round``'s
    ``stats``: K, sends, deadline, expiries), appended to the list
    returned."""
    log = []
    runner = server._async
    inner = runner.run_round

    def run_round(*args, **kwargs):
        out = inner(*args, **kwargs)
        log.append(out[-1])
        return out

    runner.run_round = run_round
    return log


def async_params_finite(server) -> bool:
    import torch
    return all(bool(torch.isfinite(v).all()) for v in server.params.values())


def run_async_path() -> dict:
    """``async_path``: full-width VGG, M = 32, 8 rounds on
    ``async-mobile``'s schedule, fleet and ``AsyncConfig`` with fig5's
    kernel masking, one round at a time; the launch counts are set to 0
    just before the rounds and read after each."""
    import torch
    from repro_torch.core import strategy
    from repro_torch.core.server import FederatedServer
    from repro_torch.kernels import segmented as seg
    batches, ns, evald, init, loss_fn, eval_fn, M = model_setup("vgg")
    batches = [torch.as_tensor(a).cuda() for a in batches]
    eval_data = tuple(torch.as_tensor(a).cuda() for a in evald)
    st = kernel_masking(strategy.get("async-mobile"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = FederatedServer.from_strategy(
        st, loss_fn, init("cuda"), M, eval_fn=eval_fn, seed=0,
        engine="async")
    if server._num_params != LM_PARAMS["vgg"]:
        fail(f"async path VGG has {server._num_params} parameters")
    stats = record_async_stats(server)
    per_round = []
    reset_all_counts()
    t0 = time.perf_counter()
    for t in range(1, ASYNC_ROUNDS + 1):
        before = dict(seg.launch_counts())
        server.run(batches, ns, 1, eval_every=int(t == ASYNC_ROUNDS),
                   eval_data=eval_data)
        after = seg.launch_counts()
        per_round.append({k: after[k] - before.get(k, 0)
                          for k in SEGMENTED[:3]})
    wall = time.perf_counter() - t0
    launches = seg.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = server.history
    upload = server.client_upload_bytes
    for rec, st_r, n in zip(hist, stats, per_round):
        phase("async_round", round=rec.round,
              m_t=ns_round(server, rec.round), bucket=rec.cohort_size,
              K=st_r["buffer_size"], participants=rec.num_sampled,
              sends=st_r["sends"], arrivals=rec.arrivals,
              timeouts=rec.timeouts, retries=rec.retries,
              dropped=rec.dropped, quarantined=rec.quarantined,
              flushes=rec.flushes, mean_staleness=rec.mean_staleness,
              transport_bytes=rec.transport_bytes,
              sim_round_s=rec.sim_round_s, deadline_s=st_r["deadline_s"],
              wall_s=rec.wall_s, compile_s=rec.compile_s,
              mean_loss=rec.mean_loss, launches=n)
    summ = server.summary()
    walls = [r.wall_s for r in hist]
    phase("async_path", model="vgg", params=server._num_params,
          num_clients=M, rounds=len(hist), preset="async-mobile",
          codec=summ["codec"], client_upload_bytes=upload,
          transport_bytes=summ["transport_bytes"],
          sends=sum(x["sends"] for x in stats),
          arrivals=summ["arrivals"], timeouts=summ["timeouts"],
          retries=summ["retries"], flushes=summ["flushes"],
          mean_staleness=summ["mean_staleness"],
          sim_total_s=summ["sim_total_s"], final_eval=summ["final_eval"],
          launches=launches, steady_round_s_median=statistics.median(
              walls[1:]), first_round_s=walls[0],
          compile_s=[r.compile_s for r in hist],
          max_memory_allocated=peak, run_wall_s=wall)
    if upload != LM_PATHS["vgg-fig5"][2]:
        fail(f"async path: {upload} bytes an upload")
    for rec, st_r, n in zip(hist, stats, per_round):
        if rec.transport_bytes != st_r["sends"] * upload:
            fail(f"async path round {rec.round}: bytes {rec.transport_bytes}"
                 f" != {st_r['sends']} sends x {upload}")
        if n != MASK_PER_ROUND:
            fail(f"async path round {rec.round}: launches {n}")
    if not async_params_finite(server):
        fail("async path: non-finite parameters")
    return {"server": server, "batches": batches, "n_samples": ns,
            "history": hist, "launches": launches, "peak": peak}


def async_keystone() -> dict:
    """``async_keystone``: the ideal fleet with ``AsyncConfig()`` on
    LeNet-28, M = 32, 4 rounds, ``fig5`` with kernel masking and
    ``fig3-importance``, both with error feedback: the async engine equals
    the cohort engine bit for bit on the card."""
    import torch
    from repro_torch.core import strategy
    from repro_torch.core.async_engine import AsyncConfig
    from repro_torch.core.hetero import HeteroModel
    ideal = HeteroModel(profile="ideal")
    out = {}
    for name in ("fig5", "fig3-importance"):
        st = strategy.get(name, hetero=ideal, error_feedback=True,
                          async_cfg=AsyncConfig())
        if name == "fig5":
            st = kernel_masking(st)
        runs = []
        with deterministic_cudnn():
            for engine in ("cohort", "async"):
                server, batches, ns, _ = lenet_server(
                    st, MAIN_M, 28, MAIN_M * 8 * MAIN_BATCH, MAIN_BATCH,
                    "cuda", engine=engine)
                server.run(batches, ns, ASYNC_KEYSTONE_ROUNDS)
                runs.append(server)
        sync, buf = runs
        rs, ra = sync.store.residuals_dense(), buf.store.residuals_dense()
        exact = {
            "params": all(torch.equal(v, buf.params[k])
                          for k, v in sync.params.items()),
            "residuals": all(torch.equal(v, ra[k]) for k, v in rs.items()),
            "norms": sync.store.norms is None or torch.equal(
                sync.store.norms, buf.store.norms),
            "transport_bytes": sync.summary()["transport_bytes"]
            == buf.summary()["transport_bytes"],
            "num_sampled": [r.num_sampled for r in sync.history]
            == [r.arrivals for r in buf.history]}
        phase("async_keystone", preset=name, rounds=len(buf.history),
              num_sampled=[r.num_sampled for r in buf.history],
              flushes=[r.flushes for r in buf.history],
              transport_bytes=buf.summary()["transport_bytes"], exact=exact)
        if not all(exact.values()):
            fail(f"async keystone {name}: async and cohort differ in {exact}")
        out[name] = exact
    return out


def param_errs(a: dict, b: dict) -> tuple:
    """``(largest entrywise difference, largest over leaves of that leaf's
    largest difference relative to its largest magnitude)``, ``b`` the
    reference."""
    diffs = [(float((v.cpu() - b[k].cpu()).abs().max()),
              float(b[k].cpu().abs().max())) for k, v in a.items()]
    return (max(d for d, _ in diffs),
            max(d / m if m > 0 else d for d, m in diffs))


def host_copy(out: dict) -> dict:
    """A copy on the host of a cohort sweep's output (``uploads``,
    ``wired``, ``new_res``, ``new_drift``, ``losses``)."""
    return {k: None if v is None else
            {n: x.detach().cpu().clone() for n, x in v.items()}
            if isinstance(v, dict) else v.detach().cpu().clone()
            for k, v in out.items()}


def tap_sweep(server, wrap) -> None:
    """Run ``server``'s store-form rounds with their cohort sweep (the
    store round's ``compute``) replaced by ``wrap(compute)``."""
    import dataclasses
    inner = server._round_fn

    def round_fn(bucket, form="dense"):
        prog, seconds = inner(bucket, form)
        return dataclasses.replace(prog, compute=wrap(prog.compute)), seconds

    server._round_fn = round_fn


def small_async_agreement() -> dict:
    """``small_async_agreement``: ``async-flaky`` with corrupt_rate 0.1,
    LeNet-28, M = 32, 6 rounds, on the card (deterministic cuDNN) against
    the CPU, both fed the same participant scores and event seeds, under
    fig5's kernel masking and under random masking (gamma 0.5).

    Each round is held alone.  Before it the CPU server takes the card's
    parameters and store state, and in it the card's cohort sweep output
    (local updates, masks, wire round trip, losses): the gate, the event
    loop, the flushes, the aggregation and the commits then run on both
    devices from the same inputs.  Every round's ledger must be exact, its
    parameters within SMALL_RTOL (the largest difference, and each leaf's
    largest difference relative to its largest magnitude), and no
    quarantined row may reach Θ.  The CPU's own sweep of the round runs
    too: its cohort's mean loss must be within SMALL_RTOL of the card's.
    Its parameters are not compared: from one state, LeNet's local SGD
    grows the devices' rounding differences to up to a third of a
    client's largest update entry in one round, which moves kernel
    masking's top-k and Θ by up to 1.1e-3 on an H100
    (``tests/async_sweep_diag.py`` measures it)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import strategy
    base = strategy.get("async-flaky")
    chaos = base.replace(async_cfg=dataclasses.replace(base.async_cfg,
                                                       corrupt_rate=0.1))
    rng = np.random.default_rng(11)
    draws = {t: rng.random(MAIN_M).astype(np.float32)
             for t in range(1, ASYNC_SMALL_ROUNDS + 1)}
    ledger = ("num_sampled", "arrivals", "timeouts", "retries", "dropped",
              "quarantined", "flushes", "transport_bytes", "sim_round_s")
    out = {}
    for label, st in (("kernel", kernel_masking(chaos)),
                      ("random", chaos.with_masking(
                          strategy.MaskPolicy.random(0.5)))):
        runs = []
        for device in ("cuda", "cpu"):
            server, batches, ns, _ = lenet_server(
                st, MAIN_M, 28, MAIN_M * 8 * MAIN_BATCH, MAIN_BATCH, device,
                engine="async", scores=lambda t, m: draws[t],
                event_seed=lambda t: [t, 2026])
            runs.append((server, batches, ns, record_async_stats(server)))
        (gpu, _, _, gs), (cpu, _, _, cs) = runs
        sweeps = {}

        def on_card(compute):
            def run(*args):
                res = compute(*args)
                sweeps["card"] = host_copy(res)
                return res
            return run

        def on_cpu(compute):
            def run(*args):
                sweeps["cpu"] = compute(*args)
                return host_copy(sweeps["card"])
            return run

        tap_sweep(gpu, on_card)
        tap_sweep(cpu, on_cpu)
        errs = {"param_abs": [], "param_rel": [], "sweep_loss_rel": []}
        exact = {field: [] for field in ledger + ("sends", "versions")}
        for _ in range(ASYNC_SMALL_ROUNDS):
            cpu.params = {k: v.detach().cpu().clone()
                          for k, v in gpu.params.items()}
            cpu.store.load_state(gpu.store.state())
            for server, batches, ns, _ in runs:
                with deterministic_cudnn():
                    server.run(batches, ns, 1)
            a, r = param_errs(gpu.params, cpu.params)
            errs["param_abs"].append(a)
            errs["param_rel"].append(r)
            lg = float(sweeps["card"]["losses"].mean())
            lc = float(sweeps["cpu"]["losses"].mean())
            errs["sweep_loss_rel"].append(abs(lg - lc) / abs(lc))
            for field in ledger:
                exact[field].append(getattr(gpu.history[-1], field)
                                    == getattr(cpu.history[-1], field))
            exact["sends"].append(gs[-1]["sends"] == cs[-1]["sends"])
            exact["versions"].append(bool(np.array_equal(
                gpu.store.versions, cpu.store.versions)))
        quarantined = [r.quarantined for r in gpu.history]
        phase("small_async_agreement", preset="async-flaky", masking=label,
              corrupt_rate=0.1, num_clients=MAIN_M, rounds=len(gpu.history),
              participants=[r.num_sampled for r in gpu.history],
              sends=[x["sends"] for x in gs],
              arrivals=[r.arrivals for r in gpu.history],
              retries=[r.retries for r in gpu.history],
              timeouts=[r.timeouts for r in gpu.history],
              quarantined=quarantined,
              exact={k: all(v) for k, v in exact.items()},
              param_abs_err_by_round=errs["param_abs"],
              param_rel_err_by_round=errs["param_rel"],
              sweep_loss_rel_err_by_round=errs["sweep_loss_rel"],
              rtol=SMALL_RTOL)
        wrong = {k: [t + 1 for t, ok in enumerate(v) if not ok]
                 for k, v in exact.items() if not all(v)}
        if wrong:
            fail(f"small async run ({label}): card and CPU differ in "
                 f"{wrong} (field: rounds)")
        if not sum(quarantined) > 0:
            fail(f"small async run ({label}): nothing was quarantined")
        if not (async_params_finite(gpu) and async_params_finite(cpu)):
            fail(f"small async run ({label}): a quarantined row reached Θ")
        if max(max(v) for v in errs.values()) > SMALL_RTOL:
            fail(f"small async run ({label}): a round's card and CPU results "
                 f"differ past {SMALL_RTOL}: {errs}")
        out[label] = errs
    return out


def async_store() -> dict:
    """``async_store``: ``async-crossround`` with fig5's kernel masking and
    error feedback on LeNet-28, M = 1,024, 6 rounds: the dense store and a
    sharded store that holds every client bit-identical, uploads carried;
    then a sharded window of ASYNC_EVICT_RETENTION, which evicts."""
    import numpy as np
    import torch
    from repro_torch.core import strategy
    from repro_torch.core.client_store import ShardedStore
    M = ASYNC_STORE_M
    st = kernel_masking(strategy.get("async-crossround",
                                     error_feedback=True))
    runs = {}
    for label, retention in (("dense", None), ("sharded", M),
                             ("evicting", ASYNC_EVICT_RETENTION)):
        make = (None if retention is None else
                (lambda p, r=retention: ShardedStore(M, p, r)))
        with deterministic_cudnn():
            server, batches, ns, _ = lenet_server(
                st, M, 28, M * 2 * MAIN_BATCH, MAIN_BATCH, "cuda",
                make_store=make, engine="async")
            stats = record_async_stats(server)
            server.run(batches, ns, ASYNC_STORE_ROUNDS)
        runs[label] = (server, stats)
        torch.cuda.empty_cache()
    dense, sharded = runs["dense"][0], runs["sharded"][0]
    rd, rs = dense.store.residuals_dense(), sharded.store.residuals_dense()
    exact = {"params": all(torch.equal(v, sharded.params[k])
                           for k, v in dense.params.items()),
             "residuals": all(torch.equal(v, rs[k]) for k, v in rd.items()),
             "versions": bool(np.array_equal(dense.store.versions,
                                             sharded.store.versions))}
    for field in ("num_sampled", "arrivals", "timeouts", "carried",
                  "pending", "transport_bytes"):
        exact[field] = [getattr(r, field) for r in dense.history] == \
            [getattr(r, field) for r in sharded.history]
    out = {}
    for label, (server, stats) in runs.items():
        hist = server.history
        out[label] = dict(
            store=server.store.kind,
            retention=getattr(server.store, "retention", None),
            participants=[r.num_sampled for r in hist],
            arrivals=[r.arrivals for r in hist],
            carried=[r.carried for r in hist],
            pending=[r.pending for r in hist],
            timeouts=[r.timeouts for r in hist],
            superseded=[x["superseded"] for x in stats],
            expired=[x["expired"] for x in stats],
            evictions=getattr(server.store, "evictions", 0),
            wall_s=[r.wall_s for r in hist],
            finite=async_params_finite(server))
    phase("async_store", preset="async-crossround", num_clients=M,
          rounds=ASYNC_STORE_ROUNDS, exact=exact, **out)
    if not all(exact.values()):
        fail(f"async store: dense and sharded differ in {exact}")
    if not sum(out["dense"]["carried"]) > 0:
        fail("async store: no upload was carried across rounds")
    if not all(o["finite"] for o in out.values()):
        fail("async store: non-finite parameters")
    if not out["evicting"]["evictions"] > 0:
        fail("async store: the small window evicted nothing")
    return out


def async_resume(ckpt_dir: str) -> dict:
    """``async_resume``: ``async-mobile`` on LeNet-28 (M = 32), 4 rounds,
    ``save_state``, a server built with another seed restores and runs 4
    more: bit-identical to 8 straight rounds."""
    import torch
    from repro_torch.core import strategy
    st = strategy.get("async-mobile")
    args = (st, MAIN_M, 28, MAIN_M * 8 * MAIN_BATCH, MAIN_BATCH, "cuda")
    with deterministic_cudnn():
        full, batches, ns, _ = lenet_server(*args, engine="async")
        full.run(batches, ns, 2 * ASYNC_KEYSTONE_ROUNDS)
        first = lenet_server(*args, engine="async")[0]
        first.run(batches, ns, ASYNC_KEYSTONE_ROUNDS)
        first.save_state(ckpt_dir)
        resumed = lenet_server(*args, engine="async", seed=999)[0]
        step = resumed.restore_state(ckpt_dir)
        resumed.run(batches, ns, ASYNC_KEYSTONE_ROUNDS)
    exact = {"params": all(torch.equal(v, resumed.params[k])
                           for k, v in full.params.items())}
    for field in ("num_sampled", "arrivals", "timeouts", "retries",
                  "flushes", "transport_bytes", "sim_round_s"):
        exact[field] = [getattr(r, field) for r in
                        full.history[ASYNC_KEYSTONE_ROUNDS:]] == \
            [getattr(r, field) for r in resumed.history]
    phase("async_resume", preset="async-mobile", step=step, exact=exact,
          retries=[r.retries for r in full.history],
          timeouts=[r.timeouts for r in full.history])
    if step != ASYNC_KEYSTONE_ROUNDS or not all(exact.values()):
        fail(f"async resume is not bit-identical: {exact}")
    return exact


def random_mask_store() -> dict:
    """``random_mask_store``: the store path (full-width VGG, M = 100,000,
    ``ShardedStore(retention=1024)``) under random masking, gamma 0.5, 3
    rounds, drawing the cohort's scores only; then the masks of the dense
    and the store form bitwise at M = 64, and one cohort's default draw on
    the card against the CPU's, bitwise."""
    import numpy as np
    import torch
    from repro_torch.core import strategy
    from repro_torch.core.masking import client_mask_scores, random_keep
    policy = strategy.MaskPolicy.random(0.5)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server, provider, ns, eval_data = store_setup("cuda", masking=policy)
    reset_all_counts()
    t0 = time.perf_counter()
    rounds = store_rounds(server, provider, ns, eval_data,
                          RANDOM_STORE_ROUNDS, [])
    wall = time.perf_counter() - t0
    launches = {k: v for m in kernel_modules()
                for k, v in m.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    hist = [rec for rec, _ in rounds]
    upload = server.client_upload_bytes
    leaves = server._mask_leaves
    M = server.cfg.num_clients
    dense_bytes = 4 * M * sum(int(np.prod(s)) for s in leaves.values())
    ids = np.sort(np.random.default_rng(0).choice(M, 32, replace=False))
    on_card = client_mask_scores(1, 1, ids, leaves, "cuda")
    on_cpu = client_mask_scores(1, 1, ids, leaves, "cpu")
    card_cpu = all(torch.equal(v.cpu(), on_cpu[k])
                   for k, v in on_card.items())
    keep_card_cpu = all(torch.equal(
        random_keep(v.reshape(len(ids), -1), 0.5).cpu(),
        random_keep(on_cpu[k].reshape(len(ids), -1), 0.5))
        for k, v in on_card.items())
    del on_card, on_cpu, server
    torch.cuda.empty_cache()
    small = {kind: store_setup("cuda", full=False, masking=policy,
                               kind=kind)[0]
             for kind in ("dense", "sharded")}
    cohort = torch.arange(0, 64, 4, device="cuda")
    full = small["dense"].round_mask_scores(2)
    rows = small["sharded"]._cohort_mask_scores(2, cohort)
    dense_store = all(
        torch.equal(full[k].index_select(0, cohort), v) and torch.equal(
            random_keep(full[k].index_select(0, cohort).reshape(
                len(cohort), -1), 0.5),
            random_keep(v.reshape(len(cohort), -1), 0.5))
        for k, v in rows.items())
    phase("random_mask_store", model="vgg", num_clients=M,
          rounds=len(hist), gamma=0.5,
          participants=[r.num_sampled for r in hist],
          buckets=[r.cohort_size for r in hist],
          transport_bytes=[r.transport_bytes for r in hist],
          wall_s=[r.wall_s for r in hist],
          compile_s=[r.compile_s for r in hist], launches=launches,
          max_memory_allocated=peak, dense_draw_bytes_avoided=dense_bytes,
          dense_vs_store_masks_m64=dense_store,
          card_vs_cpu_draw_32_clients=card_cpu,
          card_vs_cpu_keep_32_clients=keep_card_cpu, run_wall_s=wall)
    if any(r.transport_bytes != r.num_sampled * upload for r in hist):
        fail("random mask store: bytes are not participants x upload")
    if any(launches.values()):
        fail(f"random mask store: kernels launched: {launches}")
    if not (dense_store and card_cpu and keep_card_cpu):
        fail("random mask store: masks differ between forms or devices")
    return {"peak": peak, "history": hist}


# ---------------------------------------------------------------------------
# Byzantine attacks and robust aggregation
# ---------------------------------------------------------------------------
class timed_aggregator:
    """Within the block the strategy's aggregation call is bracketed by
    CUDA events: ``ms()`` gives each call's device time after the run."""

    def __init__(self, st):
        self.st = st
        self.events = []

    def strategy(self):
        import dataclasses
        import torch
        agg = self.st.aggregator
        events = self.events

        def fn(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = agg.fn(*args, **kwargs)
            end.record()
            events.append((start, end))
            return out

        return self.st.replace(aggregator=dataclasses.replace(agg, fn=fn))

    def ms(self) -> list:
        import torch
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def run_robust_path(honest_loss: float) -> dict:
    """``robust_path``: full-width VGG, M = 32, 8 rounds on the cohort
    engine for each of the three Byzantine presets with fig5's masking on
    the kernels; the launch counts set to 0 just before each run and read
    just after (8/16/8), each aggregation call timed on the card."""
    import torch
    from repro_torch.core import strategy
    from repro_torch.core.server import FederatedServer
    from repro_torch.kernels import segmented as seg
    batches, ns, evald, init, loss_fn, eval_fn, M = model_setup("vgg")
    batches = [torch.as_tensor(a).cuda() for a in batches]
    eval_data = tuple(torch.as_tensor(a).cuda() for a in evald)
    out = {}
    for name in ROBUST_PRESETS:
        timer = timed_aggregator(kernel_masking(strategy.get(name)))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        server = FederatedServer.from_strategy(
            timer.strategy(), loss_fn, init("cuda"), M, eval_fn=eval_fn,
            seed=0)
        if server._num_params != LM_PARAMS["vgg"]:
            fail(f"{name}: VGG has {server._num_params} parameters")
        reset_all_counts()
        t0 = time.perf_counter()
        server.run(batches, ns, MAIN_ROUNDS, eval_every=MAIN_ROUNDS,
                   eval_data=eval_data)
        wall = time.perf_counter() - t0
        launches = seg.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        agg_ms = timer.ms()
        hist = server.history
        summ = server.summary()
        for rec, ms in zip(hist, agg_ms):
            phase("robust_round", preset=name, round=rec.round,
                  m_t=ns_round(server, rec.round), bucket=rec.cohort_size,
                  participants=rec.num_sampled, adversarial=rec.adversarial,
                  quarantined=rec.quarantined,
                  transport_bytes=rec.transport_bytes, wall_s=rec.wall_s,
                  compile_s=rec.compile_s, aggregation_ms=ms,
                  mean_loss=rec.mean_loss)
        walls = [r.wall_s for r in hist]
        want = {k: MAIN_ROUNDS * MASK_PER_ROUND.get(k, 0) for k in SEGMENTED}
        phase("robust_path", preset=name, model="vgg",
              params=server._num_params, num_clients=M, rounds=len(hist),
              aggregator=server.strategy.aggregator.name,
              attack=summ.get("attack"),
              codec=summ["codec"], launches=launches,
              adversarial_uploads=summ.get("adversarial_uploads"),
              quarantined=summ["quarantined"],
              transport_bytes=summ["transport_bytes"],
              steady_round_s_median=statistics.median(walls[1:]),
              first_round_s=walls[0],
              aggregation_ms_median=statistics.median(agg_ms),
              aggregation_ms=agg_ms, max_memory_allocated=peak,
              allocated_before_run=held,
              final_loss=summ["final_loss"],
              honest_fig5_final_loss=honest_loss,
              final_eval=summ["final_eval"], run_wall_s=wall)
        if launches != want:
            fail(f"{name}: launches {launches}, expected {want}")
        if [r.num_sampled for r in hist] != MAIN_SAMPLED:
            fail(f"{name}: participants {[r.num_sampled for r in hist]}")
        if summ["transport_bytes"] != sum(MAIN_SAMPLED) * \
                LM_PATHS["vgg-fig5"][2]:
            fail(f"{name}: transport_bytes {summ['transport_bytes']}")
        if not sum(r.adversarial for r in hist) > 0:
            fail(f"{name}: no adversary took part")
        if len(agg_ms) != MAIN_ROUNDS:
            fail(f"{name}: {len(agg_ms)} aggregation calls")
        if not async_params_finite(server):
            fail(f"{name}: non-finite parameters")
        out[name] = {"history": hist, "peak": peak, "aggregation_ms": agg_ms,
                     "launches": launches}
        del server
    return out


class fed_sweeps:
    """Within the block ``federated.stacked_client_update`` (a round's
    local SGD and masking) either appends host copies of what it returns
    to ``log`` or, with ``replay``, returns the logged copies in order on
    the caller's device.  The card's run logs and the CPU's replays, so
    the CPU holds everything after the sweep (wire, attack, gate,
    aggregation, commits) on the card's inputs: from one state LeNet-28's
    local SGD alone already differs between the devices by more than
    1e-3 in a round (``tests/async_sweep_diag.py``)."""

    def __init__(self, log: list, replay: bool):
        self.log, self.replay, self.used = log, replay, 0

    def __enter__(self):
        from repro_torch.core import federated
        self.real = real = federated.stacked_client_update

        def move(x, device):
            if x is None:
                return None
            if isinstance(x, dict):
                return {k: v.detach().to(device).clone()
                        for k, v in x.items()}
            return x.detach().to(device).clone()

        def sweep(loss_fn, params, *args, **kwargs):
            if not self.replay:
                out = real(loss_fn, params, *args, **kwargs)
                self.log.append(tuple(move(x, "cpu") for x in out))
                return out
            device = next(iter(params.values())).device
            self.used += 1
            return tuple(move(x, device) for x in self.log[self.used - 1])

        federated.stacked_client_update = sweep
        return self

    def __exit__(self, *exc):
        from repro_torch.core import federated
        federated.stacked_client_update = self.real


def attack_runs(kind: str, device: str, logs: dict,
                replay: bool = False) -> dict:
    """One attack kind on LeNet-28 (M = 12, 5 rounds, fig5 with error
    feedback) on the full, cohort and store forms on ``device``; each
    form's sweeps logged in, or replayed from, ``logs[form]``."""
    import torch
    from repro_torch.core import strategy
    from repro_torch.core.attacks import AttackModel
    from repro_torch.core.client_store import ShardedStore
    st = strategy.get("fig5", error_feedback=True).replace(
        attack=AttackModel(kind=kind, **ATTACK_KNOBS))
    runs = {}
    with deterministic_cudnn():
        for form in ("full", "cohort", "store"):
            make = ((lambda p: ShardedStore(ATTACK_M, p, ATTACK_M))
                    if form == "store" else None)
            server, batches, ns, _ = lenet_server(
                st, ATTACK_M, 28, ATTACK_M * 8 * MAIN_BATCH, MAIN_BATCH,
                device, make_store=make,
                engine="full" if form == "full" else "cohort")
            if form == "store":
                xs, ys = (torch.as_tensor(a).to(device) for a in batches)

                def provider(ids, xs=xs, ys=ys):
                    idx = torch.as_tensor(ids).to(xs.device)
                    return xs.index_select(0, idx), ys.index_select(0, idx)
                batches = provider
            with fed_sweeps(logs.setdefault(form, []), replay) as fed:
                server.run(batches, ns, ATTACK_ROUNDS)
            if replay and fed.used != len(fed.log):
                fail(f"attack {kind} {form}: {fed.used} sweeps replayed "
                     f"of {len(fed.log)}")
            runs[form] = server
    return runs


def ledger(server) -> list:
    return [(r.num_sampled, r.cohort_size, r.adversarial, r.quarantined,
             r.transport_bytes) for r in server.history]


def bit_equal(a, b) -> bool:
    import torch
    pa, pb = a.params, b.params
    ra, rb = a.store.residuals_dense(), b.store.residuals_dense()
    return (all(torch.equal(v, pb[k]) for k, v in pa.items())
            and all(torch.equal(v, rb[k]) for k, v in ra.items()))


def attack_agreement(devices=("cuda", "cpu")) -> dict:
    """``attack_agreement``: every attack kind on the full, cohort and
    store forms at LeNet-28, M = 12, 5 rounds, on the card against the
    CPU, which replays the card's client sweeps (``fed_sweeps``):
    participants, adversarial, quarantined and bytes exact, parameters
    within ATTACK_TOL of the leaf's scale; and on the card cohort == full
    == store bit for bit."""
    out = {}
    for kind in ATTACK_KINDS:
        logs = {}
        gpu = attack_runs(kind, devices[0], logs)
        cpu = attack_runs(kind, devices[1], logs, replay=True)
        errs, exact = {}, {}
        for form in gpu:
            a, b = gpu[form], cpu[form]
            exact[form] = ledger(a) == ledger(b)
            errs[form] = max(
                float((a.params[k].cpu() - v).abs().max())
                / max(1.0, float(v.abs().max()))
                for k, v in b.params.items())
        same = {"cohort==full": bit_equal(gpu["cohort"], gpu["full"]),
                "store==cohort": bit_equal(gpu["store"], gpu["cohort"])}
        hist = gpu["cohort"].history
        phase("attack_agreement", kind=kind, num_clients=ATTACK_M,
              rounds=len(hist), knobs=ATTACK_KNOBS,
              participants=[r.num_sampled for r in hist],
              buckets=[r.cohort_size for r in hist],
              adversarial=[r.adversarial for r in hist],
              quarantined=[r.quarantined for r in hist],
              ledger_card_vs_cpu_exact=exact,
              max_param_err_over_scale=errs, cpu_replays_card_sweeps=True,
              card_bit_identical=same,
              final_loss={f: s.summary()["final_loss"]
                          for f, s in gpu.items()})
        if not all(exact.values()):
            fail(f"attack {kind}: card and CPU ledgers differ: {exact}")
        if max(errs.values()) > ATTACK_TOL:
            fail(f"attack {kind}: card and CPU parameters differ: {errs}")
        if not all(same.values()):
            fail(f"attack {kind}: the card's forms differ: {same}")
        if min(r.cohort_size for r in hist) >= ATTACK_M:
            fail(f"attack {kind}: the cohort body never ran")
        if not sum(r.adversarial for r in hist) > 0:
            fail(f"attack {kind}: no adversary took part")
        if kind == "nan" and [r.quarantined for r in hist] != \
                [r.adversarial for r in hist]:
            fail("attack nan: quarantined != adversarial")
        for s in gpu.values():
            if not async_params_finite(s):
                fail(f"attack {kind}: non-finite parameters")
        out[kind] = {"errs": errs, "exact": exact, "same": same}
    return out


def attack_noise_agreement() -> dict:
    """``attack_noise``: the gauss attack's draws
    (``attacks.client_attack_noise``) for 32 clients over every full-width
    VGG leaf on the card against the CPU: entries that differ and the
    largest difference in fp32 ulps of the CPU's value (at most 1)."""
    import torch
    from repro_torch.core.attacks import client_attack_noise
    from repro_torch.models import paper_models as pm
    params = pm.init_vgg(torch.Generator().manual_seed(0), 32, 3,
                         widths=(32, 64, 128, 128), device="cpu")
    leaves = {k: tuple(v.shape) for k, v in params.items()}
    ids = list(range(0, 3200, 100))
    card = client_attack_noise(0, 1, ids, leaves, "cuda")
    cpu = client_attack_noise(0, 1, ids, leaves, "cpu")
    entries = differ = 0
    ulps = 0.0
    for k, v in cpu.items():
        d = (card[k].cpu() - v).abs()
        spacing = torch.nextafter(v.abs(), torch.tensor(float("inf"))) \
            - v.abs()
        entries += v.numel()
        differ += int((d > 0).sum())
        ulps = max(ulps, float((d / spacing).max()))
    phase("attack_noise", clients=len(ids), entries=entries,
          entries_that_differ=differ, max_ulps=ulps)
    if ulps > 1.0:
        fail(f"gauss noise: card and CPU {ulps} ulps apart")
    return {"entries": entries, "differ": differ, "max_ulps": ulps}


def async_attack(device: str = "cuda") -> dict:
    """``async_attack``: the async keystone (ideal fleet, ``AsyncConfig()``,
    async == cohort bit for bit) on the three Byzantine presets at
    LeNet-28, M = 32, 4 rounds, with error feedback and fig5's masking on
    the kernels; then a nan attack (f = 0.3) on ``async-flaky``,
    quarantined event by event: finite parameters, quarantined uploads
    only from adversaries, the adversaries' residuals untouched."""
    import torch
    from repro_torch.core import strategy
    from repro_torch.core.async_engine import AsyncConfig
    from repro_torch.core.attacks import AttackModel
    from repro_torch.core.hetero import HeteroModel
    ideal = HeteroModel(profile="ideal")
    out = {}
    for name in ROBUST_PRESETS:
        st = kernel_masking(strategy.get(name, hetero=ideal,
                                         error_feedback=True,
                                         async_cfg=AsyncConfig()))
        runs = []
        with deterministic_cudnn():
            for engine in ("cohort", "async"):
                server, batches, ns, _ = lenet_server(
                    st, MAIN_M, 28, MAIN_M * 8 * MAIN_BATCH, MAIN_BATCH,
                    device, engine=engine)
                server.run(batches, ns, ASYNC_KEYSTONE_ROUNDS)
                runs.append(server)
        sync, buf = runs
        exact = {"params_residuals": bit_equal(sync, buf),
                 "adversarial": [r.adversarial for r in sync.history]
                 == [r.adversarial for r in buf.history],
                 "transport_bytes": sync.summary()["transport_bytes"]
                 == buf.summary()["transport_bytes"],
                 "num_sampled": [r.num_sampled for r in sync.history]
                 == [r.arrivals for r in buf.history]}
        phase("async_attack", preset=name, check="keystone",
              rounds=len(buf.history),
              num_sampled=[r.num_sampled for r in buf.history],
              adversarial=[r.adversarial for r in buf.history],
              flushes=[r.flushes for r in buf.history], exact=exact)
        if not all(exact.values()):
            fail(f"async attack keystone {name}: differs in {exact}")
        if not sum(r.adversarial for r in buf.history) > 0:
            fail(f"async attack keystone {name}: no adversary took part")
        out[name] = exact
    attack = AttackModel(kind="nan", fraction=0.3)
    st = kernel_masking(strategy.get("async-flaky", error_feedback=True,
                                     attack=attack))
    server, batches, ns, _ = lenet_server(
        st, MAIN_M, 28, MAIN_M * 8 * MAIN_BATCH, MAIN_BATCH, device,
        engine="async")
    stats = record_async_stats(server)
    server.run(batches, ns, ASYNC_ROUNDS)
    hist = server.history
    adv = torch.from_numpy(attack.adversary_mask(MAIN_M).astype(bool))
    res = server.store.residuals_dense()
    untouched = all(not bool(v.cpu()[adv].any()) for v in res.values())
    summ = server.summary()
    phase("async_attack", preset="async-flaky", check="nan quarantine",
          attack=summ["attack"], rounds=len(hist),
          participants=[r.num_sampled for r in hist],
          adversarial=[r.adversarial for r in hist],
          quarantined=[r.quarantined for r in hist],
          arrivals=[r.arrivals for r in hist],
          sends=[s["sends"] for s in stats],
          dropped=[r.dropped for r in hist],
          timeouts=[r.timeouts for r in hist],
          adversary_residuals_untouched=untouched)
    if not async_params_finite(server):
        fail("async nan attack: non-finite parameters")
    if not summ["quarantined"] > 0:
        fail("async nan attack: nothing was quarantined")
    if any(r.quarantined > r.adversarial for r in hist):
        fail("async nan attack: an honest upload was quarantined")
    if not untouched:
        fail("async nan attack: an adversary's residual moved")
    out["async-flaky-nan"] = summ["quarantined"]
    return out


def old_row_l2(stacked: dict):
    """The norm before the repair: ``torch.sum`` per leaf, whose order is
    the device's; the yardstick of the repair's cost."""
    import torch
    return torch.sqrt(sum(
        torch.sum(torch.square(stacked[k].float()).reshape(
            stacked[k].shape[0], -1), 1) for k in sorted(stacked)))


class recorded_norms:
    """Within the block each norm-tracker update of ``server``'s rounds
    keeps a device copy of the payload it read, the card's norms of it,
    the cohort rows' old EMA values, the commit mask and the rows' ids.
    ``check(t, n_samples)``, called between rounds (outside ``wall_s``),
    recomputes the norms on the CPU from the payload and compares their
    bits; folds each set into the store's norm vector; compares the
    participants the CPU selection draws from the two vectors for round
    t + 1 (the server's next participant scores); and drops the copies.
    The first call also times ``_row_l2`` and the ``torch.sum`` form it
    replaced on the first payload."""

    def __init__(self, server):
        self.server = server
        self.kept, self.results, self.cost = [], [], None

    def __enter__(self):
        import numpy as np
        from repro_torch.core import federated
        self.real = (federated._row_l2, federated._norm_ema)
        real_l2, real_ema = self.real
        kept, store = self.kept, self.server.store
        real_update = store.update_norms

        def row_l2(stacked):
            obs = real_l2(stacked)
            kept.append({"payload": {k: v.clone()
                                     for k, v in stacked.items()},
                         "obs": obs})
            return obs

        def norm_ema(smp, old, obs, commit):
            kept[-1].update(old=old.clone(), commit=commit.clone())
            return real_ema(smp, old, obs, commit)

        def update_norms(ids, values):
            kept[-1]["ids"] = np.array(ids, dtype=np.int64)
            return real_update(ids, values)

        federated._row_l2, federated._norm_ema = row_l2, norm_ema
        store.update_norms = update_norms
        return self

    def __exit__(self, *exc):
        from repro_torch.core import federated
        federated._row_l2, federated._norm_ema = self.real
        del self.server.store.update_norms

    def check(self, t: int, n_samples) -> None:
        import numpy as np
        import torch
        real_l2, real_ema = self.real
        server = self.server
        smp, M = server.strategy.sampler, server.cfg.num_clients
        if self.cost is None and self.kept:
            payload = self.kept[0]["payload"]
            self.cost = {
                "rows": int(next(iter(payload.values())).shape[0]),
                "row_l2_ms": cuda_ms([lambda: real_l2(payload)], 10),
                "torch_sum_l2_ms": cuda_ms([lambda: old_row_l2(payload)],
                                           10)}
        card_norms = server.store.norms.cpu()
        cpu_norms = card_norms.clone()
        bits, diff = True, 0.0
        for rec in self.kept:
            card = rec["obs"].cpu()
            cpu = real_l2({k: v.cpu() for k, v in rec["payload"].items()})
            bits = bits and torch.equal(card, cpu)
            diff = max(diff, float((card - cpu).abs().max()))
            cpu_norms[torch.from_numpy(rec["ids"])] = real_ema(
                smp, rec["old"].cpu(), cpu, rec["commit"].cpu())
        gen = torch.Generator()
        gen.set_state(server._generator.get_state())
        scores = torch.rand((M,), generator=gen)
        ns = torch.as_tensor(np.asarray(n_samples), dtype=torch.float32)
        parts = [smp.select(scores, server.schedule, t + 1, M, ns, norms)[0]
                 for norms in (card_norms, cpu_norms)]
        self.results.append({
            "round": t, "updates": len(self.kept), "norm_bits_equal": bits,
            "max_abs_diff": diff,
            "norm_vectors_equal": torch.equal(card_norms, cpu_norms),
            "next_participants_equal": torch.equal(parts[0], parts[1])})
        self.kept.clear()


# ---------------------------------------------------------------------------
# The model zoo's serving slice: rwkv6-1.6b and hymba-1.5b
# ---------------------------------------------------------------------------
def zoo_counts() -> dict:
    """Launch counts of every kernel the port has."""
    counts = {}
    for module in kernel_modules():
        counts.update(module.launch_counts())
    return counts


def wkv6_inputs(B: int, T: int, H: int, D: int, seed: int,
                strong: bool = False):
    """r, k, v ~ N(0, 1), logw = -exp(U(-4, 1)) (decays from -0.02 to -2.7
    a step, past the reference's overflow point), u = 0.1 N(0, 1),
    s0 ~ N(0, 1), drawn on the card; ``strong`` puts the model's clip,
    logw = -e^4, on half the channels."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda")
               for _ in range(3))
    logw = -torch.exp(torch.empty((B, T, H, D), device="cuda").uniform_(
        -4.0, 1.0, generator=gen))
    if strong:
        logw[..., : D // 2] = -float(torch.tensor(4.0).exp())
    u = 0.1 * torch.randn((H, D), generator=gen, device="cuda")
    s0 = torch.randn((B, H, D, D), generator=gen, device="cuda")
    return [r, k, v, logw, u, s0]


def ssm_inputs(B: int, T: int, d: int, N: int, seed: int):
    """a = sigmoid(N(0, 1)), bx, c, h0 ~ N(0, 1), drawn on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, T, d, N), generator=gen,
                                  device="cuda"))
    bx = torch.randn((B, T, d, N), generator=gen, device="cuda")
    c = torch.randn((B, T, N), generator=gen, device="cuda")
    h0 = torch.randn((B, d, N), generator=gen, device="cuda")
    return [a, bx, c, h0]


def wkv6_step_loop(r, k, v, logw, u, s0):
    """The model's single-token recurrence (rwkv.wkv6_step), T times."""
    import torch
    from repro_torch.models import rwkv
    S, ys = s0, []
    for t in range(r.shape[1]):
        y, S = rwkv.wkv6_step(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                              logw[:, t:t + 1], u, S)
        ys.append(y)
    return torch.cat(ys, 1), S


def zoo_kernel_parity() -> dict:
    """wkv6 and ssm_scan against their plain versions on the card: at the
    full-width serving shapes, at D = 32, at T not a multiple of 64, at
    T = 1, and (wkv6) at the model's strongest decay, which must stay
    finite and match the step recurrence.  Returns the largest abs error
    of each kernel at its serving shape."""
    import torch
    from repro_torch.kernels import ssm_scan as ssk
    from repro_torch.kernels import wkv6 as wk
    errs = {}
    wkv6_cases = {"serving": (WKV6_SHAPE, False), "D32": ((2, 300, 4, 32),
                                                          False),
                  "T100": ((2, 100, 4, 64), False), "T1": ((3, 1, 4, 64),
                                                           False),
                  "strong_decay": ((2, 200, 4, 64), True)}
    for label, (shape, strong) in wkv6_cases.items():
        x = wkv6_inputs(*shape, seed=7, strong=strong)
        y, s = wk.wkv6(*x)
        torch.cuda.synchronize()
        yp, sp = wk.wkv6_plain(*x)
        err = max(float((y - yp).abs().max()), float((s - sp).abs().max()))
        ok = bool(torch.allclose(y, yp, **WKV6_TOL)
                  and torch.allclose(s, sp, **WKV6_TOL))
        finite = bool(y.isfinite().all() and s.isfinite().all())
        rec = {"max_abs_err": err, "max_abs_y": float(yp.abs().max()),
               "finite": finite}
        if strong:
            ys, ss = wkv6_step_loop(*x)
            rec["step_max_abs_err"] = max(float((y - ys).abs().max()),
                                          float((s - ss).abs().max()))
            ok = ok and bool(torch.allclose(y, ys, **WKV6_TOL)
                             and torch.allclose(s, ss, **WKV6_TOL))
        phase("zoo_kernel_parity", kernel="wkv6", case=label, shape=shape,
              tol=WKV6_TOL, **rec)
        if not (ok and finite):
            fail(f"wkv6 kernel disagrees with its plain version ({label})")
        if label == "serving":
            errs["wkv6"] = err
        del x, y, s, yp, sp
    ssm_cases = {"serving": SSM_SHAPE, "T100": (2, 100, 1600, 16),
                 "T1": (2, 1, 1600, 16), "N4_odd_d": (2, 77, 19, 4)}
    for label, shape in ssm_cases.items():
        x = ssm_inputs(*shape, seed=8)
        y, h = ssk.ssm_scan(*x)
        torch.cuda.synchronize()
        yp, hp = ssk.ssm_scan_plain(*x)
        err = max(float((y - yp).abs().max()), float((h - hp).abs().max()))
        ok = bool(torch.allclose(y, yp, **SSM_TOL)
                  and torch.allclose(h, hp, **SSM_TOL))
        phase("zoo_kernel_parity", kernel="ssm_scan", case=label,
              shape=shape, tol=SSM_TOL, max_abs_err=err,
              max_abs_y=float(yp.abs().max()))
        if not ok:
            fail(f"ssm_scan kernel disagrees with its plain version "
                 f"({label})")
        if label == "serving":
            errs["ssm_scan"] = err
        del x, y, h, yp, hp
    return errs


def is_audio(cfg) -> bool:
    """Whether the config takes (B, K, T) codebook grids."""
    from repro_torch.models.transformer import is_audio as audio
    return audio(cfg)


def serve_config(arch: str):
    """The config serve_path runs: ``arch`` at full width, cut to
    SERVE_DEPTH's layers or SERVE_PATTERN's pattern positions where the
    whole model does not fit the card beside its prefill."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    if arch in SERVE_PATTERN:
        pattern = tuple(cfg.layer_pattern[i] for i in SERVE_PATTERN[arch])
        cfg = dataclasses.replace(cfg, layer_pattern=pattern,
                                  num_layers=len(pattern))
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=SERVE_DEPTH[arch])
    return cfg


def token_batch(cfg, B: int, T: int, gen) -> dict:
    """{"tokens"} of (B, T) ids, or (B, K, T) codebook grids for audio,
    drawn on the card from ``gen``; a vision config's batch also holds (B,
    P, d) prefix embeddings at the embedding's scale (d^-0.5), in bf16 as
    the reference's ``batch_specs`` gives them."""
    import torch
    shape = (B, cfg.num_codebooks, T) if is_audio(cfg) else (B, T)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                     generator=gen, device="cuda")}
    if cfg.modality == "vision_stub":
        batch["prefix_embeds"] = (torch.randn(
            (B, cfg.num_prefix_embeddings, cfg.d_model), generator=gen,
            device="cuda") * cfg.d_model ** -0.5).to(torch.bfloat16)
    return batch


def serve_path(arch: str, trace: bool = False) -> dict:
    """The serving path of one arch at full width with bf16 params and
    compute, at full depth unless serve_config cuts it: init on the card,
    ``make_prefill_step`` on 8 x 2048 tokens (SERVE_SHAPE's otherwise;
    audio: 4 codebooks of them; vision: with 256 prefix embeddings) with
    the counts set to 0 just before and read just after (its kernel once
    per layer, nothing else), then ``generate`` on 8 prompts of 64 tokens
    plus 32 greedy tokens twice (no kernel launch, identical tokens; a
    vision config decodes its text alone: ``generate`` takes no prefix, as
    the reference's reads none).  For SERVE_ROUTING's archs the first
    prefill's MoE routing is held to the CPU's (:func:`card_routing`).
    With ``trace``, one more prefill and a short generate (11 decode steps)
    under the profiler.  Returns the launch counts and the times."""
    import contextlib
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer as tr
    kernel, layers, n_params = ZOO_ARCHS[arch]
    full = get_arch(arch)
    full_count = tr.param_count(steps.params_specs(full))
    if full_count != n_params:
        fail(f"{arch}: {full_count} parameters at full depth, not "
             f"{n_params}")
    cfg = serve_config(arch)
    want_count = tr.param_count(steps.params_specs(cfg))
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = tr.init_params(gen, cfg, cfg.param_dtype_serve, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    count = tr.param_count(params)
    if count != want_count:
        fail(f"{arch}: {count} parameters, not {want_count}")
    B, T = SERVE_SHAPE.get(arch, (SERVE_B, SERVE_T))
    batch = token_batch(cfg, B, T, gen)
    prefill = steps.make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    routes = []
    t0 = time.perf_counter()
    with (routing_log(routes) if arch in SERVE_ROUTING
          else contextlib.nullcontext()):
        logits = prefill(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = zoo_counts()
    want = {name: 0 for name in launches}
    if kernel:
        want[kernel] = layers
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    routing = card_routing(cfg, params, routes) if routes else None
    del routes
    walls = []
    for _ in range(PREFILL_REPS):
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    finite = bool(logits.isfinite().all())

    if B == SERVE_B:
        gen_prompts = batch["tokens"][..., :GEN_PROMPT].contiguous()
    else:
        gen_prompts = token_batch(cfg, SERVE_B, GEN_PROMPT, gen)["tokens"]
    max_seq = GEN_PROMPT + GEN_TOKENS + 1
    reset_all_counts()
    runs, gen_walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(serve.generate(cfg, params, gen_prompts, GEN_TOKENS,
                                   max_seq))
        torch.cuda.synchronize()
        gen_walls.append(time.perf_counter() - t0)
    gen_launches = zoo_counts()
    toks = runs[0]
    steps_per_run = GEN_PROMPT + GEN_TOKENS - 1
    decode_step_ms = gen_walls[1] / steps_per_run * 1e3
    prefix = cfg.num_prefix_embeddings if "prefix_embeds" in batch else 0
    phase("serve_path", arch=arch, dtype=cfg.param_dtype_serve,
          params=count, full_params=n_params, layers=cfg.num_layers,
          full_layers=full.num_layers,
          pattern=[f"{s.attn}/{s.mlp}" for s in cfg.layer_pattern],
          init_s=init_s, batch=B, prompt_tokens=T,
          codebooks=cfg.num_codebooks if is_audio(cfg) else 1,
          prefix_embeddings=prefix,
          logits_shape=list(logits.shape), logits_finite=finite,
          logits_abs_max=float(logits.abs().max()),
          prefill_launches=launches, first_prefill_s=first_s,
          prefill_s=walls, prefill_s_median=statistics.median(walls),
          prefill_tokens_per_s=B * (T + prefix) / statistics.median(walls),
          prefill_peak_gb=peak_gb, routing=routing,
          generate_prompt=GEN_PROMPT, generate_tokens=GEN_TOKENS,
          generate_launches=gen_launches, generate_wall_s=gen_walls,
          decode_step_ms=decode_step_ms,
          decode_ms_per_token=decode_step_ms / SERVE_B,
          tokens_first_row=toks[0].tolist())
    want_logits = [B, cfg.num_codebooks, cfg.vocab_size] if is_audio(cfg) \
        else [B, tr.padded_vocab(cfg)]
    if list(logits.shape) != want_logits or not finite:
        fail(f"{arch}: prefill logits {list(logits.shape)}, finite {finite}")
    if launches != want:
        fail(f"{arch}: prefill launches {launches}, expected {want}")
    if any(gen_launches.values()):
        fail(f"{arch}: generate launched kernels {gen_launches}")
    want_toks = (SERVE_B, cfg.num_codebooks, GEN_TOKENS) if is_audio(cfg) \
        else (SERVE_B, GEN_TOKENS)
    if toks.shape != want_toks or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        fail(f"{arch}: generated tokens {tuple(toks.shape)} out of range")
    if not torch.equal(runs[0], runs[1]):
        fail(f"{arch}: two generate runs differ")
    if trace:
        profile_device(f"{arch} prefill", lambda: prefill(
            params, batch), 1, "prefill")
        profile_device(f"{arch} decode", lambda: serve.generate(
            cfg, params, gen_prompts[..., :8], 4, 13), 11, "decode_step")
    del params, logits, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": statistics.median(walls),
            "decode_step_ms": decode_step_ms}


def card_routing(cfg, params: dict, routes: list) -> dict:
    """Every MoE layer's routing in one forward on the card (``routes``,
    group-major as the layers run) against ``moe.route`` on the CPU over
    the same grouped router inputs and the same router: expert ids,
    capacity positions and keep masks must be equal, and no padded expert
    picked."""
    import torch
    from repro_torch.models import moe
    moe_positions = [p for p, spec in enumerate(cfg.layer_pattern)
                     if spec.mlp == "moe"]
    if len(routes) != len(moe_positions) * cfg.num_groups:
        fail(f"{cfg.name}: {len(routes)} MoE routings in one forward")
    same, dropped, max_id = True, [], 0
    t0 = time.perf_counter()
    for i, r in enumerate(routes):
        g, p = divmod(i, len(moe_positions))
        router = params[f"layers.{moe_positions[p]}.moe.router"][g].cpu()
        cpu = moe.route(router, r.xg.cpu(), topk=cfg.moe_topk,
                        real_experts=cfg.moe_experts)
        same &= cpu.capacity == r.capacity and all(
            torch.equal(a.cpu(), b) for a, b in (
                (r.expert_ids, cpu.expert_ids), (r.positions, cpu.positions),
                (r.keep, cpu.keep)))
        dropped.append([int((~r.keep).sum()), int((~cpu.keep).sum())])
        max_id = max(max_id, int(r.expert_ids.max()))
    rec = {"layers": len(routes), "groups": int(routes[0].xg.shape[0]),
           "group": int(routes[0].xg.shape[1]),
           "capacity": routes[0].capacity, "experts": cfg.moe_experts,
           "topk": cfg.moe_topk, "routing_equal": bool(same),
           "dropped_card_cpu": dropped, "max_expert_id": max_id,
           "cpu_s": time.perf_counter() - t0}
    if not same:
        fail(f"{cfg.name}: the MoE routing on the card differs from the "
             f"CPU's: {rec}")
    if max_id >= cfg.moe_experts:
        fail(f"{cfg.name}: picked padded expert {max_id}")
    return rec


def serve_consistency(arch: str) -> dict:
    """The reference's serve == prefill check at full width in fp32 (params
    and compute), at CONSISTENCY_DEPTH's layers where given: ``forward``
    over 160 tokens (2.5 wkv6 chunks, so the tail runs; audio: 4 codebooks
    of them; vision: after a zero-length prefix) and 160 ``decode_step``s
    agree at every position within atol 2e-3, rtol 1e-3.  Not for the MoEs
    (CONSISTENCY_ARCHS says why); qwen2.5-14b's fp32 weights take 59.1 GB,
    so the card must hold nothing else."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    kernel, layers, _ = ZOO_ARCHS[arch]
    full = get_arch(arch)
    cfg = dataclasses.replace(
        full, compute_dtype="float32",
        num_layers=CONSISTENCY_DEPTH.get(arch, full.num_layers))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tr.init_params(gen, cfg, "float32", device="cuda")
    shape = (2, cfg.num_codebooks, CONSISTENCY_T) if is_audio(cfg) \
        else (2, CONSISTENCY_T)
    toks = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         device="cuda")
    prefix = torch.zeros((2, 0, cfg.d_model), device="cuda") \
        if cfg.modality == "vision_stub" else None
    with torch.no_grad():
        reset_all_counts()
        fwd = tr.forward(params, cfg, toks, prefix)[0]
        if not is_audio(cfg):
            fwd = fwd[..., :cfg.vocab_size]
        launches = zoo_counts()[kernel] if kernel else \
            sum(zoo_counts().values())
        state = tr.init_decode_state(cfg, 2, CONSISTENCY_T + 1, "float32",
                                     device="cuda")
        dec = []
        view = tr.layer_view(params, cfg)
        for t in range(CONSISTENCY_T):
            lg, state = tr.decode_step(view, cfg, state, toks[..., t:t + 1])
            dec.append(lg)
        dec = torch.cat(dec, 1)
    err = (fwd - dec).abs()
    ok = bool(torch.allclose(dec, fwd, **CONSISTENCY_TOL))
    worst = (err - CONSISTENCY_TOL["rtol"] * fwd.abs()).max()
    phase("serve_consistency", arch=arch, dtype="float32",
          layers=cfg.num_layers, full_layers=full.num_layers,
          tokens=CONSISTENCY_T, batch=2,
          codebooks=cfg.num_codebooks if is_audio(cfg) else 1,
          prefix_embeddings=0 if prefix is not None else None,
          launches={kernel or "all": launches},
          params_gb=4 * tr.param_count(params) / 1e9,
          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
          max_abs_err=float(err.max()), logits_abs_max=float(fwd.abs().max()),
          max_excess_over_rtol=float(worst), tol=CONSISTENCY_TOL,
          err_by_quarter=[float(q.max()) for q in err.chunk(4, dim=1)])
    if launches != layers:
        fail(f"{arch}: forward launched {kernel or 'kernels'} {launches} "
             f"times")
    if not ok:
        fail(f"{arch}: forward and decode disagree by {float(err.max())}")
    del params, fwd, dec, state
    torch.cuda.empty_cache()
    return {"max_abs_err": float(err.max())}


def wkv6_work(B: int, T: int, H: int, D: int):
    """Bytes the wkv6 function must move (r, k, v, logw, u, s0 read once; y
    and sT written once), the operations the function needs, and the
    kernel's own work.  The function needs what the step recurrence does
    per token and head: k v^T (D^2), r^T S (2 D^2) and the decayed update
    w S + k v^T (2 D^2), plus the O(D) terms (w = exp(logw), the bonus
    r (u k) v).  The bound is set by the function's work.

    The kernel (csrc/wkv6.cu) runs every chunk as 64 rows (the tail
    zero-filled) in blocks of one (b, h) and EV = D / 2 value columns, and
    each of the D / EV blocks of a head recomputes the prefix sums, the pair
    matrix A, q, kc and the bonus.  Per chunk and block: exponentials (an
    exp2, a subtract, a multiply each) for the diagonal blocks (4 x 56 x D:
    14 for the split lower-left quarter, 42 pairs of the two diagonal
    quarters; the pair s = t - 1 takes none), q~ (48 D), k~ (96 D),
    q (63 D), kc (64 D) and the decay (D); the diagonal pair terms (a
    multiply and an add each, 4 x 120 x D); the products, each counted once
    though 3xTF32 runs it as three TF32 products: the off-diagonal blocks
    of A (2 D 16 x 16 x 6), q S (2 C D EV), A v over the lower blocks
    (2 EV 16 x 16 x 10) and kc^T v (2 C D EV); the scan (2 C D), the bonus
    (3 C D), y's bonus term (2 C EV) and the decay of S (D EV)."""
    C, EV = 64, D // 2
    bytes_ = 4 * (5 * B * T * H * D + 2 * B * H * D * D + H * D)
    ops = B * H * T * (5 * D * D + 5 * D)
    exps = (4 * 56 + 48 + 96 + 63 + 64 + 1) * D
    block_ops = (3 * exps + 2 * 4 * 120 * D
                 + 2 * D * 16 * 16 * 6 + 2 * C * D * EV
                 + 2 * EV * 16 * 16 * 10 + 2 * C * D * EV
                 + 2 * C * D + 3 * C * D + 2 * C * EV + D * EV)
    blocks = B * H * (D // EV) * -(-T // C)
    return {"bytes": bytes_, "operations": ops,
            "kernel_operations": block_ops * blocks,
            "kernel_exponentials": exps * blocks}


def wkv6_build_record(lib) -> dict:
    """The wkv6 kernels' resources from the build's ``-Xptxas -v`` log
    (registers, stack, spills), the launch shape from ``wkv6_config``
    (threads, blocks a head, dynamic shared memory), and, where the toolkit
    has ``cuobjdump``, the count of TF32 tensor-core products (HMMA) and of
    exponentials (MUFU.EX2) in each kernel's SASS."""
    import ctypes
    import re
    import shutil
    from repro_torch.kernels import build
    log = build.build_log().read_text()
    kernels = {}
    for m in re.finditer(r"Compiling entry function '(\S*wkv6_kernel\S*)'"
                         r"(.*?)(?=Compiling entry function|== |\Z)", log,
                         re.S):
        body = m.group(2)
        nums = {key: re.search(pat, body) for key, pat in (
            ("registers", r"Used (\d+) registers"),
            ("stack_bytes", r"(\d+) bytes stack frame"),
            ("spill_stores", r"(\d+) bytes spill stores"),
            ("spill_loads", r"(\d+) bytes spill loads"))}
        head_dim = int(re.search(r"ILi(\d+)E", m.group(1)).group(1))
        kernels[head_dim] = {key: int(v.group(1)) if v else None
                             for key, v in nums.items()}
    for head_dim, rec in kernels.items():
        threads, slices, smem = (ctypes.c_int(), ctypes.c_int(),
                                 ctypes.c_int())
        err = lib.wkv6_config(head_dim, ctypes.byref(threads),
                              ctypes.byref(slices), ctypes.byref(smem))
        if err:
            fail(f"wkv6_config({head_dim}) returned {err}")
        rec.update(threads=threads.value, blocks_per_head=slices.value,
                   dynamic_smem_bytes=smem.value)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass_counts = None
    if Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass", lib._name],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        sass_counts = {}
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            name = part.split("\n", 1)[0]
            if "wkv6_kernel" in name:
                head_dim = int(re.search(r"ILi(\d+)E", name).group(1))
                sass_counts[head_dim] = {
                    "hmma_tf32": len(re.findall(r"\bHMMA\.\w*\.F32\.TF32",
                                                part)),
                    "mufu_ex2": len(re.findall(r"\bMUFU\.EX2", part))}
        for head_dim, counts in sass_counts.items():
            kernels[head_dim]["sass"] = counts
            if counts["hmma_tf32"] == 0:
                fail(f"wkv6 kernel (D = {head_dim}) has no TF32 HMMA")
    if sorted(kernels) != [32, 64]:
        fail(f"wkv6 kernels in the build log: {sorted(kernels)}")
    return {"kernels": {str(d): kernels[d] for d in sorted(kernels)},
            "cuobjdump": sass_counts is not None}


def ssm_work(B: int, T: int, d: int, N: int):
    """Bytes (a, bx, c, h0 read once; y, hT written once) and operations
    (a multiply-add for h, a multiply and an add for y per (t, c, n)),
    which the kernel does as they are."""
    bytes_ = 4 * (2 * B * T * d * N + B * T * N + 2 * B * d * N + B * T * d)
    ops = 4 * B * T * d * N
    return {"bytes": bytes_, "operations": ops, "kernel_operations": ops}


def time_zoo_kernels() -> dict:
    """Each kernel at its serving shape: ``ms`` (the C launcher back to
    back on rotating copies of inputs and outputs over four times the L2
    size), ``warm_ms`` (one buffer), ``wrapper_ms`` (one Python wrapper
    call with its checks and allocations), ``plain_ms`` and the bound."""
    import torch
    from repro_torch.kernels import build, measure
    from repro_torch.kernels import ssm_scan as ssk
    from repro_torch.kernels import wkv6 as wk
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    B, T, H, D = WKV6_SHAPE
    Bs, Ts, d, N = SSM_SHAPE
    specs = {  # inputs, output shapes, C launcher + its ints, wrapper, plain
        "wkv6": (wkv6_inputs(*WKV6_SHAPE, seed=9),
                 [WKV6_SHAPE, (B, H, D, D)], lib.wkv6_launch,
                 (B, T, H, D), wk.wkv6, wk.wkv6_plain,
                 wkv6_work(*WKV6_SHAPE)),
        "ssm_scan": (ssm_inputs(*SSM_SHAPE, seed=9),
                     [(Bs, Ts, d), (Bs, d, N)], lib.ssm_scan_launch,
                     (Bs, Ts, d, N), ssk.ssm_scan, ssk.ssm_scan_plain,
                     ssm_work(*SSM_SHAPE)),
    }
    results = {}
    for name, (x, out_shapes, fn, ints, wrapper, plain, work) in \
            specs.items():
        nbytes, ops = work["bytes"], work["operations"]
        copies = max(2, -(-4 * l2 // sum(t.nbytes for t in x)))
        xs = [x] + [[t.clone() for t in x] for _ in range(copies - 1)]
        ys = [[torch.empty(s, device="cuda") for s in out_shapes]
              for _ in range(copies)]
        ptrs = [[t.data_ptr() for t in xs[i] + ys[i]] for i in range(copies)]
        kernels = [lambda p=p: fn(*p, *ints, stream) for p in ptrs]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        rec = {"shape": list(ints),
               "ms": measure.cuda_loop_ms(kernels, launches=20),
               "warm_ms": measure.cuda_loop_ms(kernels[:1], launches=20),
               "wrapper_ms": cuda_ms([lambda v=v: wrapper(*v) for v in xs],
                                     reps=10),
               "plain_ms": cuda_ms([lambda v=v: plain(*v) for v in xs],
                                   reps=3),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes_ms": bytes_ms, "ops_ms": ops_ms, "library_ms": None,
               **work,
               "kernel_ops_ms": work["kernel_operations"] / FP32_OPS_PER_S
               * 1e3,
               "buffers": copies,
               "l2_bytes": l2}
        results[name] = rec
        phase("kernel_time", case="serving", kernel=name, **rec)
        del x, xs, ys, kernels
        specs[name] = None
        torch.cuda.empty_cache()
    return results


def fresh_process_compile_s() -> dict:
    """The fig5 path (LeNet-28, M = 32, 8 rounds) in a fresh process with an
    empty build directory (``python -m repro_torch.launch.round_time``):
    the kernel library's nvcc build lands in round 1's ``compile_s``, the
    first-call setup of eager PyTorch in its ``wall_s``.  ``compile_s``
    must be nonzero exactly where the bucket changes."""
    import os
    import shutil
    build_dir = ROOT / "build" / "compile_s_probe"
    shutil.rmtree(build_dir, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TORCH_BUILD_DIR": str(build_dir)}
    try:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.round_time",
             "--device", "cuda"], capture_output=True, text=True, env=env,
            cwd=ROOT, timeout=300)
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)
    if out.returncode != 0:
        fail(f"round_time exited {out.returncode}: {out.stderr[-2000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    phase("fresh_process_round_time", **rec)
    changes = [i == 0 or b != rec["buckets"][i - 1]
               for i, b in enumerate(rec["buckets"])]
    if [c > 0 for c in rec["compile_s"]] != changes:
        fail(f"compile_s {rec['compile_s']} is not nonzero exactly on the "
             f"bucket changes of {rec['buckets']}")
    if rec["buckets"] != MAIN_BUCKETS:
        fail(f"fresh-process buckets {rec['buckets']} != {MAIN_BUCKETS}")
    return rec


# ---------------------------------------------------------------------------
# The pod round and the training path on full-width qwen2-1.5b
# ---------------------------------------------------------------------------
def pod_strategy():
    """fig5 with its selective masking on the segmented kernels (fig5
    itself names the bisection backend)."""
    from repro_torch.core import strategy
    from repro_torch.core.strategy import MaskPolicy
    return strategy.get("fig5").with_masking(
        MaskPolicy.selective(0.5, backend="kernel"))


def pod_batches(cfg, rounds: int, seed: int = 0) -> list:
    """Per round {"tokens", "labels"} of (C, E, 1, T), or (C, E, 1, K, T)
    for audio: markov_text tokens, as ``launch.train.synth_batches`` cuts
    them."""
    import torch
    from repro_torch.launch import train
    K = cfg.num_codebooks if is_audio(cfg) else 1
    steps = train.synth_batches(cfg, POD_C * POD_B * K, POD_T,
                                POD_E * rounds, seed)
    shape = (POD_E, POD_C, POD_B) + ((K,) if K > 1 else ()) + (POD_T,)
    out = []
    for t in range(rounds):
        sl = steps[t * POD_E:(t + 1) * POD_E]
        out.append({k: torch.stack([b[k] for b in sl]).reshape(shape)
                    .transpose(0, 1).contiguous()
                    for k in ("tokens", "labels")})
    return out


def lm_batches(cfg, steps: int, seed: int = 0) -> list:
    """``steps`` training batches of 1 x 4096 markov_text tokens (audio:
    (1, K, 4096) grids; vision: also (1, 256, d) prefix embeddings at the
    embedding's scale from a CPU generator seeded ``seed``), CPU tensors."""
    import torch
    from repro_torch.launch import train
    K = cfg.num_codebooks if is_audio(cfg) else 1
    out = train.synth_batches(cfg, POD_B * K, POD_T, steps, seed)
    gen = torch.Generator().manual_seed(seed)
    for b in out:
        if K > 1:
            b.update({k: v.reshape(POD_B, K, POD_T) for k, v in b.items()})
        if cfg.modality == "vision_stub":
            b["prefix_embeds"] = torch.randn(
                (POD_B, cfg.num_prefix_embeddings, cfg.d_model),
                generator=gen) * cfg.d_model ** -0.5
    return out


def plain_slice_mask(delta: dict, fed_cfg):
    """The kernel route's masking of one (1, ...)-stacked client delta on
    the kernels' plain versions: (masked leaves, kept per segment, k per
    segment)."""
    import torch
    from repro_torch.core.masking import _refine_sweeps_for
    from repro_torch.kernels import ops
    from repro_torch.kernels import packing as pk
    from repro_torch.kernels import segmented as seg
    names, spec, x2d, seg_ids, nc = ops._packed_cohort(
        delta, fed_cfg.min_leaf_size, True)
    k = ops._segment_k(spec, fed_cfg.gamma, nc, x2d.device)
    hist = seg.segmented_histogram_plain(x2d, seg_ids, k.numel())
    lo, hi, cnt_lo, cnt_hi = seg.select_thresholds(hist, k)
    for sweep in range(_refine_sweeps_for(fed_cfg.bisect_iters)):
        cand = seg.candidate_taus(lo, hi, ops.DEFAULT_CANDIDATES,
                                  geometric=(sweep == 0))
        counts = seg.segmented_count_plain(x2d, seg_ids, cand)
        lo, hi, cnt_lo, cnt_hi = seg.shrink_brackets(
            lo, hi, cnt_lo, cnt_hi, cand, counts, k)
    out, kept = seg.segmented_apply_plain(
        x2d, seg_ids, torch.where(cnt_hi >= 1, hi, lo))
    del x2d
    leaves = dict(zip(names, pk.unpack_stacked(out, spec)))
    return leaves, kept[:, 0], k, spec.num_segments


def pod_segments(params: dict, min_leaf_size: int) -> int:
    """Segments of one client's delta on the kernel route: one per
    first-axis slice of a maskable leaf of ndim >= 2, one per maskable
    vector."""
    return sum((p.shape[0] if p.dim() >= 2 else 1) for p in params.values()
               if p.numel() >= min_leaf_size)


def fed_pod_path(arch: str = "qwen2-1.5b", trace: bool = True) -> dict:
    """``make_fed_round`` on a full-width arch of POD_ARCHS (fp32 master
    weights, bf16 compute) for POD_ROUNDS rounds of fig5 on the kernels,
    the counts set to 0 just before each round and read just after; round
    1's first client held against the plain versions; then, with
    ``trace``, one traced round.  Full depth unless POD_DEPTH cuts it."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.sampling import participation_mask
    from repro_torch.launch import fedtrain as ft
    from repro_torch.models import transformer as tr
    cfg = get_arch(arch)
    if arch in POD_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=POD_DEPTH[arch])
    want_params, want_segments, zoo_launches = POD_ARCHS[arch]
    want_launches = {**POD_LAUNCHES, **zoo_launches}
    st = pod_strategy()
    fed_cfg = ft.FedPodConfig.from_strategy(st, POD_C, local_steps=POD_E)
    if not (fed_cfg.use_kernel and fed_cfg.codec.axis0_slices):
        fail(f"pod config is not the kernel route on the axis-0 wire: "
             f"{fed_cfg}")
    state = tr.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, device="cuda")
    n_params = tr.param_count(state)
    if n_params != want_params:
        fail(f"{arch} has {n_params} parameters")
    segments = pod_segments(state, fed_cfg.min_leaf_size)
    if segments != want_segments:
        fail(f"the {arch} pod delta packs into {segments} segments")
    batches = pod_batches(cfg, POD_ROUNDS + 2)
    gen = torch.Generator().manual_seed(0)
    n_samples = torch.ones(POD_C)
    kept_client = {}

    def observe(client, delta, masked):
        if not kept_client and client == 0:
            kept_client.update(delta=delta, masked=masked)

    fed_round = ft.make_fed_round(cfg, fed_cfg, observe=observe)
    log = []
    for t in range(1, POD_ROUNDS + 1):
        part = participation_mask(torch.rand(POD_C, generator=gen),
                                  st.sampling, t, POD_C)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts()
        t0 = time.perf_counter()
        state, m = fed_round(state, batches[t - 1], n_samples, part,
                             key=(1, t))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in zoo_counts().items() if v}
        rec = {"arch": arch, "round": t, "wall_s": wall,
               "mean_loss": float(m["mean_loss"]),
               "num_sampled": float(m["num_sampled"]),
               "participation": part.tolist(), "launches": counts,
               "segments": segments,
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9}
        print(json.dumps({"phase": "fed_pod_round", **rec}), flush=True)
        log.append(rec)
        if counts != want_launches:
            fail(f"{arch} pod round {t} launched {counts}, not "
                 f"{want_launches}")
        if not math.isfinite(rec["mean_loss"]):
            fail(f"pod round {t} loss {rec['mean_loss']}")
        if rec["num_sampled"] != float(part.sum()):
            fail(f"pod round {t} sampled {rec['num_sampled']}")
        if t == 1:
            torch.cuda.synchronize()
            plain, kept, k, S = plain_slice_mask(kept_client["delta"],
                                                 fed_cfg)
            same = all(torch.equal(plain[n], kept_client["masked"][n])
                       for n in plain)
            within = bool((kept <= k).all())
            phase("fed_pod_keep_bits", arch=arch, client=0, segments=S,
                  elements=sum(v.numel() for v in plain.values()),
                  keep_bits_equal_plain=same, kept_within_slots=within,
                  kept_total=int(kept.sum()), slots_total=int(k.sum()))
            del plain, kept_client["delta"], kept_client["masked"]
            if not (same and within):
                fail("pod round 1: kernel masks differ from the plain "
                     "versions or overflow a slice's slots")
    bad = [n for n, v in state.items() if not torch.isfinite(v).all()]
    if bad:
        fail(f"non-finite parameters after the pod rounds: {bad[:4]}")
    if trace:
        part = participation_mask(torch.rand(POD_C, generator=gen),
                                  st.sampling, POD_ROUNDS + 1, POD_C)
        profile_device("fed_pod_round", lambda: fed_round(
            state, batches[POD_ROUNDS], n_samples, part,
            key=(1, POD_ROUNDS + 1)), 1, "round")
    phase("fed_pod_path", arch=cfg.name, params=n_params,
          layers=cfg.num_layers, full_layers=get_arch(arch).num_layers,
          compute_dtype=cfg.compute_dtype, clients=POD_C,
          local_steps=POD_E, tokens_per_step=POD_B * POD_T,
          strategy="fig5 + kernel masking", codec=fed_cfg.codec.name,
          rounds=len(log), wall_s=[r["wall_s"] for r in log],
          mean_loss=[r["mean_loss"] for r in log],
          num_sampled=[r["num_sampled"] for r in log],
          peak_gb=max(r["max_memory_allocated_gb"] for r in log))
    launches = {}
    for rec in log:
        for name, n in rec["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return {"cfg": cfg, "fed_cfg": fed_cfg, "state": state,
            "batches": batches, "gen": gen, "strategy": st, "log": log,
            "launches": launches}


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def fed_pod_cohort(pod: dict) -> None:
    """``make_cohort_fed_round`` on NCCL, world size 1, against
    ``make_fed_round`` from the same state and batches on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.sampling import participation_mask
    from repro_torch.launch import fedtrain as ft
    cfg, fed_cfg, state = pod["cfg"], pod["fed_cfg"], pod["state"]
    t = POD_ROUNDS + 2
    part = participation_mask(torch.rand(POD_C, generator=pod["gen"]),
                              pod["strategy"].sampling, t, POD_C)
    batches = pod["batches"][t - 1]
    masks, equal = {}, []

    def keep_full(client, delta, masked):
        masks[client] = torch.cat([(v != 0).reshape(-1)
                                   for v in masked.values()])

    def check_cohort(client, delta, masked):
        equal.append(bool(torch.equal(masks.pop(client), torch.cat(
            [(v != 0).reshape(-1) for v in masked.values()]))))

    t0 = time.perf_counter()
    full, m_full = ft.make_fed_round(cfg, fed_cfg, observe=keep_full)(
        state, batches, torch.ones(POD_C), part, key=(1, t))
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    full = {k: v.cpu() for k, v in full.items()}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        cohort = ft.make_cohort_fed_round(cfg, fed_cfg, POD_C,
                                          observe=check_cohort)
        t0 = time.perf_counter()
        new, m = cohort(state, batches, torch.ones(POD_C), range(POD_C),
                        part, key=(1, t))
        torch.cuda.synchronize()
        cohort_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    masks_equal = len(equal) == POD_C and all(equal)
    worst = 0.0
    ok = True
    for k, v in new.items():
        a, b = v.float().cpu(), full[k].float()
        ok &= bool(torch.allclose(a, b, rtol=1e-3, atol=1e-4))
        worst = max(worst, float((a - b).abs().max()))
    loss_rel = abs(float(m["mean_loss"]) - float(m_full["mean_loss"])) / \
        abs(float(m_full["mean_loss"]))
    phase("fed_pod_cohort", backend="nccl", world_size=1,
          num_sampled=[float(m["num_sampled"]), float(m_full["num_sampled"])],
          mean_loss=[float(m["mean_loss"]), float(m_full["mean_loss"])],
          loss_rel=loss_rel, max_param_diff=worst, masks_equal=masks_equal,
          full_round_s=full_s, cohort_round_s=cohort_s)
    if float(m["num_sampled"]) != float(m_full["num_sampled"]) or \
            loss_rel > 1e-6 or not ok:
        fail("the NCCL cohort round disagrees with the full round")


def fed_pod_agreement() -> None:
    """Reduced qwen2-1.5b (bf16 compute) on the card against the CPU: the
    CPU masks the card's deltas (plain versions) and aggregates its own
    masks; keep masks exact, parameters within 1e-6 of the aggregate's
    scale."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import fedtrain as ft
    from repro_torch.models import transformer as tr
    cfg = get_arch("qwen2-1.5b").reduced()
    fed_cfg = ft.FedPodConfig.from_strategy(pod_strategy(), 4, local_steps=2)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 2, 2, 32),
                         generator=torch.Generator().manual_seed(1))
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
    part = torch.tensor([1.0, 0.0, 1.0, 1.0])
    seen = {}
    new, m = ft.make_fed_round(cfg, fed_cfg, observe=lambda c, d, k: seen.
                               __setitem__(c, ({n: v.cpu() for n, v in
                                                d.items()},
                                               {n: v.cpu() for n, v in
                                                k.items()})))(
        {k: v.cuda() for k, v in params.items()}, batches, torch.ones(4),
        part)
    upload = ft._Upload(params, fed_cfg.codec)
    w = ft._weights(part, torch.ones(4), True)
    masks_equal = True
    for c in range(4):
        delta, masked = seen[c]
        cpu_masked = ft.mask_deltas(delta, fed_cfg)
        masks_equal &= all(torch.equal(cpu_masked[n], masked[n])
                           for n in masked)
        upload.add(cpu_masked, float(w[c]))
    cpu_new = upload.apply(params)
    scale = float(upload.flat.abs().max())
    worst = max(float((new[k].cpu() - cpu_new[k]).abs().max())
                for k in params)
    phase("fed_pod_agreement", arch=cfg.name, clients=4,
          masks_equal=masks_equal, max_param_diff=worst, aggregate_scale=scale,
          mean_loss=float(m["mean_loss"]))
    if not masks_equal or worst > 1e-6 * scale:
        fail("the pod round on the card disagrees with the CPU")


def step_time(cfg, params, batch) -> float:
    """Milliseconds of one lm_loss forward and backward (CUDA events,
    median of 3 after a warm-up)."""
    import torch
    from repro_torch.models import transformer as tr

    def once():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = tr.lm_loss(leaves, cfg, batch)
        torch.autograd.grad(loss, list(leaves.values()))
    return cuda_ms([once], reps=3)


def train_standard() -> dict:
    """``make_train_step`` (AdamW) for three steps at full width on 1 x
    4096 tokens a step; then one local step's time."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tr
    cfg = get_arch("qwen2-1.5b")
    step = steps.make_train_step(cfg, learning_rate=3e-4)
    params = tr.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
    opt_state = step.optimizer.init(params)
    batches = train.synth_batches(cfg, POD_B, POD_T, 3, seed=0)
    log = []
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        b = {k: v.cuda() for k, v in b.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        torch.cuda.synchronize()
        log.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "wall_s": time.perf_counter() - t0})
    peak = torch.cuda.max_memory_allocated() / 1e9
    del opt_state
    torch.cuda.empty_cache()
    batch = {k: v.cuda() for k, v in batches[0].items()}
    local_ms = step_time(cfg, params, batch)
    phase("train_standard", arch=cfg.name, optimizer="adamw",
          tokens_per_step=POD_B * POD_T, steps=log, peak_gb=peak,
          lm_loss_fwd_bwd_ms=local_ms)
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in log):
        fail(f"train_standard: non-finite loss or grad norm {log}")
    return {"local_step_ms": local_ms}


def flash_vjp_phase(local_step_ms: float) -> None:
    """The attention backward at qwen2-1.5b's head shapes (12 query heads
    over 2 KV heads, D 128, T 4096, bf16): (dq, dk, dv) against autograd
    of the plain attention (fp32, whole logits), the bytes each keeps for
    its backward, and their times; attention's share of a local step."""
    import torch
    from repro_torch.models import attention as attn
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (1, POD_T, 12, 128), (1, POD_T, 2, 128)
    q = torch.randn(shape[0], generator=gen, device="cuda").bfloat16()
    k = torch.randn(shape[1], generator=gen, device="cuda").bfloat16()
    v = torch.randn(shape[1], generator=gen, device="cuda").bfloat16()
    g = torch.randn(shape[0], generator=gen, device="cuda").bfloat16()

    def plain(q, k, v):
        qf = q.float().transpose(1, 2) * 128 ** -0.5
        kf = k.float().transpose(1, 2).repeat_interleave(6, 1)
        vf = v.float().transpose(1, 2).repeat_interleave(6, 1)
        logits = qf @ kf.transpose(2, 3)
        mask = torch.ones(POD_T, POD_T, dtype=torch.bool,
                          device="cuda").tril()
        p = torch.softmax(logits.masked_fill(~mask, -1e30), -1)
        return (p @ vf).transpose(1, 2)

    def run(fn, inputs):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel() * t.element_size()) or t,
                lambda t: t):
            out = fn(*inputs)
        grads = torch.autograd.grad(out, inputs, g.to(out.dtype))
        return out, grads, sum(saved)

    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out, grads, saved = run(attn.flash_attention, ins)
    ins_p = [t.float().clone().requires_grad_() for t in (q, k, v)]
    out_p, grads_p, saved_p = run(plain, ins_p)
    errs = [float((a.detach().float() - b.detach()).abs().max()
                   / b.detach().abs().max())
            for a, b in zip((out, *grads), (out_p, *grads_p))]
    del out_p, grads_p
    torch.cuda.empty_cache()
    flash_ms = cuda_ms([lambda: run(attn.flash_attention, ins)], reps=5)
    plain_ms = cuda_ms([lambda: run(plain, ins_p)], reps=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ins_s = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    library_ms = cuda_ms([lambda: torch.autograd.grad(
        sdpa(ins_s[0], ins_s[1], ins_s[2], is_causal=True,
             enable_gqa=True), ins_s, g.transpose(1, 2))], reps=5)
    share = POD_LAYERS * flash_ms / local_step_ms
    phase("flash_vjp", shape={"q": list(shape[0]), "kv": list(shape[1])},
          dtype="bfloat16", rel_err=dict(zip(("out", "dq", "dk", "dv"), errs)),
          saved_bytes=saved, plain_saved_bytes=saved_p,
          fwd_bwd_ms=flash_ms, plain_fwd_bwd_ms=plain_ms,
          library_fwd_bwd_ms=library_ms,
          library="scaled_dot_product_attention (yardstick only)",
          attention_share_of_local_step=share)
    if max(errs) > 2e-2:
        fail(f"flash VJP against the plain attention: {errs}")
    if saved * 8 > saved_p:
        fail(f"flash VJP keeps {saved} bytes, the plain one {saved_p}")


# ---------------------------------------------------------------------------
# The zoo's training path: the backward kernels, rwkv6-1.6b and hymba-1.5b
# ---------------------------------------------------------------------------
def backward_case(kernel: str, shape, seed: int, strong: bool = False):
    """Forward inputs and output adjoints on the card: (wkv6) r, k, v,
    logw, u, s0 as :func:`wkv6_inputs`, dy, dsT ~ N(0, 1); (ssm_scan) a,
    bx, c, h0 as :func:`ssm_inputs`, dy, dhT ~ N(0, 1)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    if kernel == "wkv6":
        B, T, H, D = shape
        x = wkv6_inputs(*shape, seed=seed, strong=strong)
        adj = [torch.randn((B, T, H, D), generator=gen, device="cuda"),
               torch.randn((B, H, D, D), generator=gen, device="cuda")]
    else:
        B, T, d, N = shape
        x = ssm_inputs(*shape, seed=seed)
        adj = [torch.randn((B, T, d), generator=gen, device="cuda"),
               torch.randn((B, d, N), generator=gen, device="cuda")]
    return x, adj


def rel_errs(got, want) -> list:
    """Per gradient: the largest difference over the largest magnitude."""
    return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(got, want)]


def zoo_grad_parity() -> dict:
    """Each backward kernel against its plain backward on the card: T = 1,
    a step past a chunk (wkv6's 64, ssm_scan's checkpoints of 16) and T =
    100 (a partial chunk) at B = 2, D = 32 and 64 and N = 16, the model's
    strongest decay, and the training shapes (1, 4096, 32, 64) and (1,
    4096, 1600, 16); nonzero s0 / h0 and dsT / dhT.  Each gradient's
    largest difference over its largest magnitude within GRAD_REL_TOL,
    finite, and two runs of the kernel bit for bit; then the checkpointing
    forward against its plain version; then each autograd.Function through
    ``torch.autograd.grad`` against autograd of the plain forward.
    Returns each kernel's largest abs error at its training shape."""
    import torch
    from repro_torch.kernels import ssm_scan as ssk
    from repro_torch.kernels import wkv6 as wk
    fns = {"wkv6": (wk.wkv6_backward, wk.wkv6_backward_plain,
                    ("dr", "dk", "dv", "dlogw", "du", "ds0")),
           "ssm_scan": (ssk.ssm_scan_backward, ssk.ssm_scan_backward_plain,
                        ("da", "dbx", "dc", "dh0"))}
    cases = [("wkv6", "T1_D32", (2, 1, 4, 32), False),
             ("wkv6", "T1_D64", (2, 1, 4, 64), False),
             ("wkv6", "T65_D32", (2, 65, 4, 32), False),
             ("wkv6", "T65_D64", (2, 65, 4, 64), False),
             ("wkv6", "T100_D32", (2, 100, 4, 32), False),
             ("wkv6", "T100_D64", (2, 100, 4, 64), False),
             ("wkv6", "strong_decay", (1, 200, 2, 64), True),
             ("wkv6", "strong_decay_B2_D32", (2, 130, 2, 32), True),
             ("wkv6", "training", TRAIN_WKV6_SHAPE, False),
             ("ssm_scan", "T1_N16", (2, 1, 40, 16), False),
             ("ssm_scan", "T17_N16", (2, 17, 40, 16), False),
             ("ssm_scan", "T65_N16", (2, 65, 40, 16), False),
             ("ssm_scan", "T100_N16", (2, 100, 40, 16), False),
             ("ssm_scan", "training", TRAIN_SSM_SHAPE, False)]
    errs = {}
    for kernel, label, shape, strong in cases:
        kern, plain, names = fns[kernel]
        x, adj = backward_case(kernel, shape, seed=21, strong=strong)
        first = kern(*x, *adj)
        torch.cuda.synchronize()
        again = kern(*x, *adj)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        want = plain(*x, *adj)
        rel = rel_errs(first, want)
        finite = all(bool(g.isfinite().all()) for g in first)
        phase("zoo_grad_parity", kernel=f"{kernel}_backward", case=label,
              shape=list(shape), rel_err=dict(zip(names, rel)),
              tol=GRAD_REL_TOL[kernel], bits_equal_on_rerun=same,
              finite=finite)
        if not (same and finite and max(rel) <= GRAD_REL_TOL[kernel]):
            fail(f"{kernel} backward kernel ({label}): rel errors {rel}, "
                 f"bits equal {same}, finite {finite}")
        if label == "training":
            errs[f"{kernel}_backward"] = max(
                float((a - b).abs().max()) for a, b in zip(first, want))
        del x, adj, first, again, want
        torch.cuda.empty_cache()
    # The checkpointing forward (ssm_scan_kernel<N, true>, which training
    # runs): y and hT against the plain scan, the checkpoints h_{16 k}
    # against the plain checkpointing forward, at T = 1, a pass of 16 and a
    # step, the eight-step remainder loop (T = 25), T = 65 and the training
    # shape; and y beside the serving forward's.
    for label, shape in (("T1", (2, 1, 40, 16)), ("T17", (2, 17, 40, 16)),
                         ("T25", (2, 25, 40, 16)), ("T65", (2, 65, 40, 16)),
                         ("training", TRAIN_SSM_SHAPE)):
        x = ssm_inputs(*shape, seed=24)
        y, hT, hk = ssk._forward(*x, checkpoints=True)
        y_serving = ssk._forward(*x)[0]
        torch.cuda.synchronize()
        yp, hp, hkp = ssk._ssm_scan_checkpoint_plain(*x)
        yq, hq = ssk.ssm_scan_plain(*x)
        plain_same = bool(torch.equal(yp, yq) and torch.equal(hp, hq))
        err = {name: float((got - want).abs().max()) for name, got, want in
               (("y", y, yp), ("hT", hT, hp), ("hk", hk, hkp))}
        ok = all(bool(torch.allclose(got, want, **SSM_TOL)) for got, want in
                 ((y, yp), (hT, hp), (hk, hkp)))
        finite = all(bool(t.isfinite().all()) for t in (y, hT, hk))
        phase("ssm_checkpoint_parity", case=label, shape=list(shape),
              hk_shape=list(hk.shape), max_abs_err=err, tol=SSM_TOL,
              max_abs_y=float(yp.abs().max()), finite=finite,
              plain_checkpointing_equals_plain_scan=plain_same,
              y_bits_equal_serving_forward=bool(torch.equal(y, y_serving)))
        if not (ok and finite and plain_same):
            fail(f"ssm_scan's checkpointing forward ({label}) disagrees "
                 f"with its plain version: {err}, finite {finite}")
        del x, y, hT, hk, y_serving, yp, hp, hkp, yq, hq
        torch.cuda.empty_cache()
    for kernel, shape, fwd, plain_fwd in (
            ("wkv6", (2, 100, 4, 64), wk.wkv6, wk.wkv6_plain),
            ("ssm_scan", (2, 100, 40, 16), ssk.ssm_scan,
             ssk.ssm_scan_plain)):
        x, adj = backward_case(kernel, shape, seed=22)
        grads = []
        for fn in (fwd, plain_fwd):
            leaves = [t.clone().requires_grad_() for t in x]
            outs = fn(*leaves)
            loss = sum((o * a).sum() for o, a in zip(outs, adj))
            grads.append(torch.autograd.grad(loss, leaves))
        rel = rel_errs(*grads)
        phase("zoo_grad_autograd", kernel=kernel, shape=list(shape),
              rel_err_against_autograd_of_plain=rel, tol=GRAD_REL_TOL[kernel])
        if max(rel) > GRAD_REL_TOL[kernel]:
            fail(f"{kernel}'s Function disagrees with autograd of its plain "
                 f"forward: {rel}")
    return errs


def traced_fwd_bwd(cfg, params, batch, kernel: str) -> dict:
    """One ``lm_loss`` forward and backward under the profiler: the device
    time of the recurrence's forward and backward kernels and of all
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tr

    def once():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = tr.lm_loss(leaves, cfg, batch)
        torch.autograd.grad(loss, list(leaves.values()))
    once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        once()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    def ms(match):
        return sum(e.time_range.elapsed_us() for e in events
                   if match(e.name)) / 1e3
    return {"device_ms": ms(lambda n: True),
            "forward_kernel_device_ms": ms(lambda n: f"{kernel}_kernel" in n),
            "backward_kernels_device_ms": ms(lambda n: f"{kernel}_bwd" in n),
            "backward_kernel_records": sum(f"{kernel}_bwd" in e.name
                                           for e in events),
            "device_records": len(events)}


def train_zoo(arch: str) -> dict:
    """``make_train_step`` (AdamW) for three steps of 1 x 4096 tokens on
    full-width ``arch`` (fp32 master weights, bf16 compute): per step the
    loss, grad norm, wall time and the launches of its recurrence's forward
    and backward kernels (counts set to 0 just before each step and read
    just after), the peak memory; then one ``lm_loss`` fwd+bwd's time and,
    from one traced fwd+bwd, the backward kernels' share of it."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tr
    kernel, fwd_want, bwd_want = ZOO_TRAIN[arch]
    n_params = ZOO_ARCHS[arch][2]
    cfg = get_arch(arch)
    step = steps.make_train_step(cfg, learning_rate=3e-4)
    params = tr.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
    if tr.param_count(params) != n_params:
        fail(f"{arch}: {tr.param_count(params)} parameters")
    opt_state = step.optimizer.init(params)
    batches = train.synth_batches(cfg, POD_B, POD_T, 3, seed=0)
    log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        b = {k: v.cuda() for k, v in b.items()}
        reset_all_counts()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = zoo_counts()
        log.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]), "wall_s": wall,
                    "launches": {kernel: counts[kernel],
                                 f"{kernel}_backward":
                                     counts[f"{kernel}_backward"]}})
    peak = torch.cuda.max_memory_allocated() / 1e9
    del opt_state
    torch.cuda.empty_cache()
    batch = {k: v.cuda() for k, v in batches[0].items()}
    local_ms = step_time(cfg, params, batch)
    traced = traced_fwd_bwd(cfg, params, batch, kernel)
    predicted = {kernel: fwd_want, f"{kernel}_backward": bwd_want}
    phase("train_zoo", arch=arch, params=n_params, optimizer="adamw",
          compute_dtype=cfg.compute_dtype, tokens_per_step=POD_B * POD_T,
          steps=log, peak_gb=peak, lm_loss_fwd_bwd_ms=local_ms,
          predicted_launches_per_step=predicted,
          launches_as_predicted=all(r["launches"] == predicted for r in log),
          backward_share_of_fwd_bwd=traced["backward_kernels_device_ms"]
          / local_ms, traced=traced)
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in log):
        fail(f"train_zoo {arch}: non-finite loss or grad norm {log}")
    if any(min(r["launches"].values()) == 0 for r in log):
        fail(f"train_zoo {arch}: a step did not run both kernels {log}")
    del params
    torch.cuda.empty_cache()
    return {"launches_per_step": log[0]["launches"],
            "launches": {k: sum(r["launches"][k] for r in log)
                         for k in predicted},
            "lm_loss_fwd_bwd_ms": local_ms}


def zoo_train_agreement() -> None:
    """Reduced rwkv6-1.6b and hymba-1.5b (head dim 32, N 16; fp32 compute,
    2 x 100 tokens: a partial wkv6 chunk): one ``lm_loss``'s gradients on
    the card (the kernels forward and backward) against the port's CPU run
    (the plain versions), each leaf within rtol ZOO_AGREE_RTOL and atol
    ZOO_AGREE_ATOL of its largest magnitude (fp32 sums in other orders on
    the two devices and the kernels' own chunkings), TF32 off."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    for arch, (kernel, _, _) in ZOO_TRAIN.items():
        cfg = dataclasses.replace(get_arch(arch).reduced(),
                                  compute_dtype="float32")
        params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 100),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
        runs = []
        for dev in ("cpu", "cuda"):
            reset_all_counts()
            leaves = {k: v.to(dev).requires_grad_() for k, v in params.items()}
            loss = tr.lm_loss(leaves, cfg, {k: v.to(dev)
                                            for k, v in batch.items()})
            grads = torch.autograd.grad(loss, list(leaves.values()))
            runs.append((float(loss.detach()), [g.cpu() for g in grads],
                         zoo_counts()))
        (cpu_loss, cpu_g, _), (card_loss, card_g, launches) = runs
        worst, ok = 0.0, True
        for a, b in zip(card_g, cpu_g):
            scale = float(b.abs().max())
            worst = max(worst, float((a - b).abs().max()) / max(scale, 1e-30))
            ok &= bool(torch.allclose(a, b, rtol=ZOO_AGREE_RTOL,
                                      atol=ZOO_AGREE_ATOL * scale))
        phase("zoo_train_agreement", arch=cfg.name, layers=cfg.num_layers,
              loss=[card_loss, cpu_loss], worst_rel_to_leaf_max=worst,
              rtol=ZOO_AGREE_RTOL, atol_of_leaf_max=ZOO_AGREE_ATOL,
              launches={k: launches[k]
                        for k in (kernel, f"{kernel}_backward")})
        if not ok or launches[f"{kernel}_backward"] == 0:
            fail(f"{arch}: lm_loss gradients on the card disagree with the "
                 f"CPU (worst {worst}) or skipped the backward kernel")


# ---------------------------------------------------------------------------
# gemma2-2b, qwen2.5-14b and qwen2-moe-a2.7b: the MoE on the card against
# the CPU, and the training runs
# ---------------------------------------------------------------------------
def routing_log(log: list, group_size: int = 0):
    """A context in which every ``moe.route`` call appends its ``Routing``
    to ``log`` and, if ``group_size`` is given, groups tokens by it
    (``moe_ffn`` takes its grouping from the routing, so the forward runs
    with those groups)."""
    import contextlib
    from repro_torch.models import moe

    @contextlib.contextmanager
    def patched():
        original = moe.route

        def record(*args, **kw):
            if group_size:
                kw = {**kw, "group_size": group_size}
            r = original(*args, **kw)
            log.append(r)
            return r
        moe.route = record
        try:
            yield log
        finally:
            moe.route = original
    return patched()


def moe_agreement_cases() -> dict:
    """label -> (reduced config, routing group) of moe_card_agreement."""
    import dataclasses
    from repro_torch.configs import get_arch
    fp32 = dict(compute_dtype="float32", param_dtype_serve="float32")
    cases = {f"qwen2-moe-a2.7b/{real}": (dataclasses.replace(
        get_arch("qwen2-moe-a2.7b").reduced(), num_layers=2,
        moe_experts=real, moe_pad_experts=True, moe_topk=4, **fp32),
        MOE_AGREE_GROUP) for real in MOE_AGREE_EXPERTS}
    cases["llama4-maverick-400b-a17b"] = (dataclasses.replace(
        get_arch("llama4-maverick-400b-a17b").reduced(), **fp32),
        MOE_AGREE_LLAMA4_GROUP)
    return cases


def moe_card_agreement() -> dict:
    """Reduced qwen2-moe-a2.7b (d 256, 2 layers, top 4 over 60 experts
    padded to 64, then 37 padded to 48), then reduced llama4 (its 4-layer
    pattern: top 1 of 4 experts and a shared expert on alternating layers,
    chunked attention in windows of 32), fp32, TF32 off: ``forward`` over
    2 x 128 tokens in groups of 64 (llama4: 16; capacity 5 slots an expert,
    so picks are dropped) and 16 ``decode_step``s (groups of the 2 tokens,
    capacity 1) on the card and on the CPU from the same weights.  Every
    call's expert ids, capacity positions and keep mask, and so the dropped
    counts, must be equal; no padded expert may be picked; the logits must
    agree within SMALL_RTOL of their largest magnitude; no kernel of the
    port launches.  Then :func:`moe_full_width_layer`."""
    import torch
    from repro_torch.models import transformer as tr
    out = {}
    for label, (cfg, group) in moe_agreement_cases().items():
        real = cfg.moe_experts
        moe_layers = cfg.num_groups * sum(s.mlp == "moe"
                                          for s in cfg.layer_pattern)
        params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                                "float32", device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (MOE_AGREE_B, MOE_AGREE_T),
                             generator=torch.Generator().manual_seed(1))
        runs = {}
        for dev in ("cuda", "cpu"):
            log = []
            on = {k: v.to(dev) for k, v in params.items()}
            reset_all_counts()
            with torch.no_grad(), routing_log(log, group):
                logits = tr.forward(on, cfg, toks.to(dev))[0]
                state = tr.init_decode_state(cfg, MOE_AGREE_B,
                                             MOE_AGREE_STEPS + 1, "float32",
                                             device=dev)
                view = tr.layer_view(on, cfg)
                dec = []
                for t in range(MOE_AGREE_STEPS):
                    lg, state = tr.decode_step(view, cfg, state,
                                               toks[:, t:t + 1].to(dev))
                    dec.append(lg)
            runs[dev] = {
                "logits": logits.cpu(), "decode": torch.cat(dec, 1).cpu(),
                "routes": [(r.expert_ids.cpu(), r.positions.cpu(),
                            r.keep.cpu(), r.gates.cpu(), r.capacity)
                           for r in log],
                "launches": sum(zoo_counts().values())}
        card, cpu = runs["cuda"], runs["cpu"]
        same = len(card["routes"]) == len(cpu["routes"]) == \
            moe_layers * (1 + MOE_AGREE_STEPS)
        gate_err = 0.0
        for a, b in zip(card["routes"], cpu["routes"]):
            same &= all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
            same &= a[4] == b[4]
            gate_err = max(gate_err, float((a[3] - b[3]).abs().max()))
        n_fwd = moe_layers
        dropped = {dev: [int((~r[2]).sum()) for r in run["routes"]]
                   for dev, run in runs.items()}
        max_id = max(int(r[0].max()) for r in card["routes"])
        errs = {}
        for key in ("logits", "decode"):
            scale = float(cpu[key].abs().max())
            errs[key] = float((card[key] - cpu[key]).abs().max()) / scale
        rec = {"case": label, "real_experts": real,
               "padded_experts": cfg.padded_experts,
               "topk": cfg.moe_topk, "layers": cfg.num_layers,
               "moe_layers": moe_layers,
               "shared_d_ff": cfg.moe_shared_d_ff,
               "tokens": MOE_AGREE_B * MOE_AGREE_T, "group": group,
               "forward_capacity": card["routes"][0][4],
               "decode_capacity": card["routes"][-1][4],
               "decode_steps": MOE_AGREE_STEPS,
               "routing_equal": bool(same),
               "forward_dropped": dropped["cuda"][:n_fwd],
               "decode_dropped": sum(dropped["cuda"][n_fwd:]),
               "dropped_equal": dropped["cuda"] == dropped["cpu"],
               "max_expert_id": max_id, "gate_max_abs_err": gate_err,
               "rel_err": errs, "rtol_of_max": SMALL_RTOL,
               "launches": card["launches"]}
        phase("moe_card_agreement", **rec)
        if not (same and rec["dropped_equal"]):
            fail(f"MoE routing on the card differs from the CPU's "
                 f"({label})")
        if max_id >= real:
            fail(f"the MoE picked padded expert {max_id} of "
                 f"{cfg.padded_experts} ({real} real)")
        if sum(rec["forward_dropped"]) == 0:
            fail("the MoE agreement's capacity did not bind")
        if max(errs.values()) > SMALL_RTOL or card["launches"]:
            fail(f"MoE logits on the card disagree with the CPU: {errs}, "
                 f"launches {card['launches']}")
        out[label] = rec
    out["full_width"] = moe_full_width_layer()
    return out


def moe_full_width_layer() -> dict:
    """One full-width qwen2-moe-a2.7b MoE layer (d 2048, top 4 over 60
    experts padded to 64, experts 1408 wide, the 5632-wide shared FFN;
    fp32, TF32 off) over 1 x 4096 tokens in ``moe_ffn``'s default groups
    of 512 (capacity 42 slots an expert), on the card and on the CPU from
    the same weights.  The expert ids, capacity positions and keep mask
    must be equal, no padded expert picked, y within SMALL_RTOL of its
    largest magnitude and the aux loss within SMALL_RTOL of its own; no
    kernel of the port launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    cfg = get_arch("qwen2-moe-a2.7b")
    params = moe.init_moe_params(
        torch.Generator().manual_seed(0), cfg.d_model, cfg.padded_experts,
        cfg.moe_d_ff, cfg.moe_shared_d_ff, cfg.gated_mlp, torch.float32,
        device="cpu")
    x = torch.randn((POD_B, POD_T, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev in ("cuda", "cpu"):
        log = []
        on = {k: v.to(dev) for k, v in params.items()}
        reset_all_counts()
        t0 = time.perf_counter()
        with torch.no_grad(), routing_log(log):
            y, aux = moe.moe_ffn(on, x.to(dev), topk=cfg.moe_topk,
                                 act=cfg.act, gated=cfg.gated_mlp,
                                 real_experts=cfg.moe_experts)
            y = y.cpu()
        r = log[0]
        runs[dev] = {"y": y, "aux": float(aux), "seconds":
                     time.perf_counter() - t0, "capacity": r.capacity,
                     "route": [t.cpu() for t in (r.expert_ids, r.positions,
                                                 r.keep)],
                     "launches": sum(zoo_counts().values())}
        del on, log, r
    del params
    torch.cuda.empty_cache()
    card, cpu = runs["cuda"], runs["cpu"]
    same = card["capacity"] == cpu["capacity"] and all(
        torch.equal(a, b) for a, b in zip(card["route"], cpu["route"]))
    ids, _, keep = card["route"]
    y_err = float((card["y"] - cpu["y"]).abs().max()) / \
        float(cpu["y"].abs().max())
    aux_err = abs(card["aux"] - cpu["aux"]) / abs(cpu["aux"])
    rec = {"d_model": cfg.d_model, "real_experts": cfg.moe_experts,
           "padded_experts": cfg.padded_experts, "topk": cfg.moe_topk,
           "expert_d_ff": cfg.moe_d_ff, "shared_d_ff": cfg.moe_shared_d_ff,
           "tokens": POD_B * POD_T, "groups": int(ids.shape[0]),
           "group": int(ids.shape[1]), "capacity": card["capacity"],
           "routing_equal": bool(same), "dropped": int((~keep).sum()),
           "max_expert_id": int(ids.max()), "y_rel_err": y_err,
           "aux": card["aux"], "aux_rel_err": aux_err,
           "rtol_of_max": SMALL_RTOL, "card_s": card["seconds"],
           "cpu_s": cpu["seconds"], "launches": card["launches"]}
    phase("moe_full_width_layer", **rec)
    if not same:
        fail("the full-width MoE layer's routing on the card differs from "
             "the CPU's")
    if rec["max_expert_id"] >= cfg.moe_experts:
        fail(f"the full-width MoE layer picked padded expert "
             f"{rec['max_expert_id']}")
    if max(y_err, aux_err) > SMALL_RTOL or card["launches"]:
        fail(f"the full-width MoE layer on the card disagrees with the "
             f"CPU: y {y_err}, aux {aux_err}, launches {card['launches']}")
    return rec


def train_lm(arch: str) -> dict:
    """``make_train_step`` (AdamW) for three steps of 1 x 4096 tokens
    (:func:`lm_batches`: audio 4 codebooks of them, vision 256 prefix
    embeddings before them) on ``arch`` at full width, at TRAIN_DEPTH[arch]
    layers (fp32 master weights, bf16 compute): per step the loss, grad
    norm and wall time, no launch of a kernel of the port (counts set to 0
    just before each step and read just after), the peak memory; then the
    forward's aux loss at the trained weights and one ``lm_loss`` fwd+bwd's
    time."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    full = get_arch(arch)
    layers = TRAIN_DEPTH[arch]
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = steps.make_train_step(cfg, learning_rate=3e-4, optimizer="adamw")
    params = tr.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
    n_params = tr.param_count(params)
    opt_state = step.optimizer.init(params)
    batches = lm_batches(cfg, 3, seed=0)
    log = []
    for b in batches:
        b = {k: v.cuda() for k, v in b.items()}
        torch.cuda.synchronize()
        reset_all_counts()
        t0 = time.perf_counter()
        new_params, new_state, m = step(params, opt_state, b)
        torch.cuda.synchronize()
        log.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "wall_s": time.perf_counter() - t0,
                    "launches": sum(zoo_counts().values())})
        # the step consumes its dicts: the forward below reads the
        # trained weights through the dict it passed in
        if new_params is not params or new_state is not opt_state:
            fail(f"train_lm {arch}: the step returned new dicts")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del opt_state
    torch.cuda.empty_cache()
    batch = {k: v.cuda() for k, v in batches[0].items()}
    with torch.no_grad():
        aux = float(tr.forward(params, cfg, batch["tokens"],
                               batch.get("prefix_embeds"))[1])
    local_ms = step_time(cfg, params, batch)
    per_period = sum(v.numel() for k, v in params.items()
                     if k.startswith("layers.")) / cfg.num_groups
    phase("train_lm", arch=arch, params=n_params, layers=layers,
          full_layers=full.num_layers, optimizer="adamw",
          compute_dtype=cfg.compute_dtype, tokens_per_step=POD_B * POD_T,
          tokens_shape=list(batch["tokens"].shape),
          prefix_embeddings=(list(batch["prefix_embeds"].shape)
                             if "prefix_embeds" in batch else None),
          steps=log, peak_gb=peak, aux_loss=aux,
          lm_loss_fwd_bwd_ms=local_ms,
          next_period_state_gb=16 * per_period / 1e9,
          card_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in log):
        fail(f"train_lm {arch}: non-finite loss or grad norm {log}")
    if any(r["launches"] for r in log):
        fail(f"train_lm {arch}: a step launched a kernel of the port {log}")
    if full.moe_experts and not aux > 0:
        fail(f"train_lm {arch}: MoE aux loss {aux}")
    del params
    torch.cuda.empty_cache()
    return {"peak_gb": peak, "layers": layers, "steps": log}


def wkv6_bwd_work(B: int, T: int, H: int, D: int) -> dict:
    """Bytes the wkv6 gradient must move (r, k, v, logw, dy, s0, dsT, u read
    once; dr, dk, dv, dlogw, ds0, du written once) and the operations its
    step recurrence needs a step and head: the forward state update again
    (3 D^2: decay, outer product, sum), the adjoint's products G v and
    G^T k (2 D^2 each), dlogw's rowsum of G * S (2 D^2), dr's S dy (2 D^2)
    and the adjoint's update (3 D^2): 14 D^2, plus O(D) terms."""
    bytes_ = 4 * (9 * B * T * H * D + 3 * B * H * D * D + 2 * H * D)
    ops = B * H * T * (14 * D * D + 12 * D)
    return {"bytes": bytes_, "operations": ops}


def ssm_bwd_work(B: int, T: int, d: int, N: int) -> dict:
    """Bytes (a, bx, c, h0, dy, dhT read once; da, dbx, dc, dh0 written
    once) and operations (per (t, c, n): h again, a multiply-add; g's
    multiply-add and decay; da's multiply; dC's multiply and add: 8)."""
    bytes_ = 4 * (4 * B * T * d * N + 2 * B * T * N + 3 * B * d * N
                  + B * T * d)
    return {"bytes": bytes_, "operations": 8 * B * T * d * N}


def time_zoo_backward() -> dict:
    """Each backward kernel at its training shape: ``ms`` (the C launcher
    back to back on rotating copies of inputs, outputs and scratch over
    four times the L2 size), ``warm_ms`` (one set), ``device_ms`` (the
    profiler's time of its kernels a call), ``wrapper_ms`` (one Python
    call with its checks and allocations), ``plain_ms`` and the bound.
    ssm_scan_backward takes the checkpoints its forward wrote (h every 16
    steps); the forward at that shape is timed without and with them, in
    turns (phase ``ssm_scan_checkpoint_time``)."""
    import torch
    from repro_torch.kernels import build, measure
    from repro_torch.kernels import ssm_scan as ssk
    from repro_torch.kernels import wkv6 as wk
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    B, T, H, D = TRAIN_WKV6_SHAPE
    Bs, Ts, d, N = TRAIN_SSM_SHAPE
    chunks = -(-Ts // ssk.CHECKPOINT)

    def with_checkpoints(x):
        """(a, bx, c, h0, dy, dhT) -> the launcher's (a, bx, c, hk, dy,
        dhT) and the wrapper's keyword."""
        hk = ssk._forward(*x[:4], checkpoints=True)[2]
        return [*x[:3], hk, *x[4:]], {"hk": hk}
    specs = {  # output and scratch shapes, C launcher + ints, wrapper, plain
        "wkv6_backward": (
            "wkv6", TRAIN_WKV6_SHAPE,
            [TRAIN_WKV6_SHAPE] * 4 + [(H, D), (B, H, D, D)]
            + list(wk.backward_scratch_shapes(B, T, H, D)),
            lib.wkv6_backward_launch, (B, T, H, D), wk.wkv6_backward,
            wk.wkv6_backward_plain, wkv6_bwd_work(*TRAIN_WKV6_SHAPE),
            lambda x: (x, {})),
        "ssm_scan_backward": (
            "ssm_scan", TRAIN_SSM_SHAPE,
            [TRAIN_SSM_SHAPE] * 2 + [(Bs, Ts, N), (Bs, d, N)]
            + list(ssk.backward_scratch_shapes(Bs, Ts, d, N)),
            lib.ssm_scan_backward_launch, (Bs, Ts, d, N),
            ssk.ssm_scan_backward, ssk.ssm_scan_backward_plain,
            ssm_bwd_work(*TRAIN_SSM_SHAPE), with_checkpoints)}
    results = {}
    for name, (kernel, shape, out_shapes, fn, ints, wrapper, plain, work,
               prep) in specs.items():
        x, adj = backward_case(kernel, shape, seed=23)
        x = x + adj
        copies = max(2, -(-4 * l2 // sum(t.nbytes for t in x)))
        xs = [x] + [[t.clone() for t in x] for _ in range(copies - 1)]
        preps = [prep(v) for v in xs]
        ys = [[torch.empty(s, device="cuda") for s in out_shapes]
              for _ in range(copies)]
        ptrs = [[t.data_ptr() for t in preps[i][0] + ys[i]]
                for i in range(copies)]
        kernels = [lambda p=p: fn(*p, *ints, stream) for p in ptrs]
        bytes_ms = work["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = work["operations"] / FP32_OPS_PER_S * 1e3
        # The profiler has lost every record of a backward kernel in three
        # sessions in a row on the card, and some of them in one session
        # (5 of wkv6_backward's 40): the time between CUDA events then
        # stands in, marked by ``device_source``.
        dev = measure.device_ms(kernels, f"{kernel}_bwd", launches=10,
                                events_fallback=True)
        traced = dev["kernel_records"] == BWD_KERNELS[kernel] * dev["calls"]
        if dev["kernel_records"] is not None and not traced:
            dev.update(device_ms=measure.cuda_loop_ms(kernels, launches=10),
                       device_source="cuda_events")
        rec = {"shape": list(shape),
               "ms": measure.cuda_loop_ms(kernels, launches=10),
               "warm_ms": measure.cuda_loop_ms(kernels[:1], launches=10),
               "device_ms": dev["device_ms"] * dev["kernel_records"]
               / dev["calls"] if traced else dev["device_ms"],
               "device_source": dev.get("device_source", "trace"),
               "device_records": dev["device_records"],
               "kernel_records": dev["kernel_records"], "calls": dev["calls"],
               "wrapper_ms": cuda_ms([lambda v=v, kw=p[1]: wrapper(*v, **kw)
                                      for v, p in zip(xs, preps)], reps=5),
               "plain_ms": cuda_ms([lambda v=v: plain(*v) for v in xs],
                                   reps=3),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes_ms": bytes_ms, "ops_ms": ops_ms, "library_ms": None,
               **work, "buffers": copies,
               "scratch_shapes": [list(s) for s in
                                  out_shapes[6 if kernel == "wkv6" else 4:]]}
        results[name] = rec
        phase("kernel_time", case="training", kernel=name, **rec)
        if kernel == "ssm_scan":
            # The forward at the training shape without and with its
            # checkpoints, in turns (plain, saving, saving, plain).
            fwd = []
            for i in range(copies):
                a, bx, c, h0 = xs[i][:4]
                y = torch.empty((Bs, Ts, d), device="cuda")
                hT = torch.empty((Bs, d, N), device="cuda")
                hk = torch.empty((Bs, chunks, d, N), device="cuda")
                fwd.append([t.data_ptr() for t in (a, bx, c, h0, y, hT)]
                           + [hk.data_ptr()])
                xs[i] += [y, hT, hk]
            plain_fwd = [lambda p=p: lib.ssm_scan_launch(
                *p[:6], Bs, Ts, d, N, stream) for p in fwd]
            saving = [lambda p=p: lib.ssm_scan_checkpoint_launch(
                *p, Bs, Ts, d, N, stream) for p in fwd]
            turns = [("no_checkpoints", plain_fwd), ("checkpoints", saving),
                     ("checkpoints", saving), ("no_checkpoints", plain_fwd)]
            times = {"no_checkpoints": [], "checkpoints": []}
            for label, fns in turns:
                times[label].append(measure.cuda_loop_ms(fns, launches=10))
            rec_f = {"shape": list(shape),
                     "ms_no_checkpoints": times["no_checkpoints"],
                     "ms_checkpoints": times["checkpoints"],
                     "checkpoint_bytes": Bs * chunks * d * N * 4,
                     "extra_ms": statistics.median(times["checkpoints"])
                     - statistics.median(times["no_checkpoints"])}
            results["ssm_scan_checkpoint_time"] = rec_f
            phase("ssm_scan_checkpoint_time", **rec_f)
        del x, adj, xs, ys, kernels, preps
        torch.cuda.empty_cache()
    return results


def at_large(rec: dict) -> dict:
    """A kernel's times and bound on the 2^26-element input."""
    return {key: rec[key] for key in ("ms", "warm_ms", "device_ms",
                                      "wrapper_ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}


def main(argv) -> int:
    """Run the phases; returns the exit code."""
    trace = "--profile" in argv
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"FAIL: the repository's src/repro_torch is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    # ---- 1. environment -------------------------------------------------
    card = gpu_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from repro_torch.kernels import build, measure
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for line in build.build_log().read_text().splitlines()
             if "registers" in line or "Compiling entry" in line]
    phase("environment", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(),
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          matmul_precision=torch.get_float32_matmul_precision(),
          kernel_build_s=build_s, ptxas=ptxas)
    phase("wkv6_build", **wkv6_build_record(build.library()))
    phase("wire_build", kernels=wire_build_record())
    seed_hashes()

    # ---- 2. kernel parity ----------------------------------------------
    main_in = [t.cuda() for t in measure.lenet_cohort_buffer(seed=1)]
    if tuple(main_in[0].shape) != (MAIN_M * 106, SEG_LANE):
        fail(f"main-path buffer is {tuple(main_in[0].shape)}")
    errs = check_kernels("lenet28_cohort32", *main_in)
    large_in = [t.cuda() for t in measure.large_buffer(seed=2)]
    check_kernels("2^26", *large_in)
    wire_edge_parity()
    # ---- 3. main paths ---------------------------------------------------
    mains = {preset: run_main_path(preset) for preset in MAIN_PATHS}
    fused = mains["fig5-fused-int8"]
    wire_identity(fused)
    small_agreement("fig5")
    small_agreement("fig5-fused-int8", error_feedback=True)
    lms = {name: run_lm_path(name) for name in LM_PATHS}
    small_lm_agreement("vgg", "selective")
    small_lm_agreement("gru", "selective")
    small_lm_agreement("gru", "random")
    adaptive = {name: run_adaptive_path(name) for name in ADAPTIVE_PATHS}
    for name in ADAPTIVE_PATHS:
        small_adaptive_agreement(name)
    # ---- 3b. the client-state store --------------------------------------
    for clients in sorted(set(store_buckets()) | {STORE_STRESS_CLIENTS}):
        store_kernel_parity(clients)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        store = run_store_path(ckpt)
        store_resume(store, ckpt)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        dense_resume_lenet(ckpt)
    small_store_agreement()
    round_time_line("vgg-store", store["history"])
    if trace:
        profile_device("vgg-store", lambda: store_rounds(
            store["server"], store["provider"], store["n_samples"],
            store["eval_data"], 2, []), 2, "round")
    del store["server"]
    torch.cuda.empty_cache()
    random_store = random_mask_store()
    round_time_line("vgg-store-random", random_store["history"])
    # ---- 3c. the async engine --------------------------------------------
    async_run = run_async_path()
    round_time_line("vgg-async", async_run["history"])
    if trace:
        profile_device("vgg-async", lambda: async_run["server"].run(
            async_run["batches"], async_run["n_samples"], 2), 2, "round")
    del async_run["server"]
    torch.cuda.empty_cache()
    async_keystone()
    small_async_agreement()
    async_store()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        async_resume(ckpt)
    # ---- 3d. Byzantine attacks and robust aggregation ---------------------
    robust = run_robust_path(lms["vgg-fig5"]["history"][-1].mean_loss)
    for name, run in robust.items():
        round_time_line(f"vgg-{name}", run["history"])
    attack_agreement()
    attack_noise_agreement()
    async_attack()

    # ---- 4. the per-array path and kernels 6–8 ---------------------------
    deltas = {"vgg": client_delta(lms["vgg-fig5"]),
              "gru": client_delta(lms["gru-fig5"])}
    per_array = per_array_path(deltas)
    topk_errs = {}
    for (model, name), leaf in per_array["leaves"].items():
        check_topk_kernels(f"{model}:{name}", leaf.reshape(-1).contiguous(),
                           topk_errs)
    vgg_flat = torch.cat([v.reshape(-1) for v in deltas["vgg"].values()])
    check_topk_kernels(f"vgg_delta_{vgg_flat.numel()}", vgg_flat, topk_errs)
    big = measure.large_vector(seed=3).cuda()
    check_topk_kernels("2^26", big, topk_errs)
    check_topk_kernels("edges_2^20",
                       measure.edge_vector(1 << 20, seed=4).cuda(),
                       topk_errs)

    # ---- 5. timing -------------------------------------------------------
    times = time_kernels("lenet28_cohort32", *main_in)
    large_times = time_kernels("2^26", *large_in,
                               count_candidates=LARGE_COUNT_CANDIDATES)
    leaf = deltas["vgg"]["conv3b.w"].reshape(-1).contiguous()
    if leaf.numel() != LARGEST_VGG_LEAF:
        fail(f"largest VGG leaf has {leaf.numel()} entries")
    topk_times = time_topk(f"vgg_leaf_{LARGEST_VGG_LEAF}", leaf,
                           per_array["launches"])
    large_topk_times = time_topk("2^26", big, per_array["launches"])
    del big
    for preset, main_run in {**mains, **lms}.items():
        walls = [r.wall_s for r in main_run["history"]]
        phase("round_time", preset=preset,
              steady_round_s_median=statistics.median(walls[1:]),
              full_rounds_s=walls[1:6], cohort16_rounds_s=walls[6:],
              first_round_s=walls[0],
              compile_s=[r.compile_s for r in main_run["history"]])
    for name, run in adaptive.items():
        round_time_line(name, run["history"])
    fresh_process_compile_s()

    # ---- 6. the model zoo's serving slice ---------------------------------
    del main_in, large_in
    torch.cuda.empty_cache()
    zoo_errs = zoo_kernel_parity()
    section_t0 = time.perf_counter()
    serves = {arch: serve_path(arch, trace) for arch in ZOO_ARCHS}
    for arch in CONSISTENCY_ARCHS:
        serve_consistency(arch)
    moe_card_agreement()
    phase("serving_section", seconds=time.perf_counter() - section_t0)
    zoo_times = time_zoo_kernels()
    # ---- 7. the pod round and the training path ---------------------------
    torch.cuda.empty_cache()
    section_t0 = time.perf_counter()
    zoo_grad_errs = zoo_grad_parity()
    pod = fed_pod_path()
    fed_pod_cohort(pod)
    pod_launches = pod["launches"]
    del pod
    torch.cuda.empty_cache()
    fed_pod_agreement()
    trained = train_standard()
    torch.cuda.empty_cache()
    flash_vjp_phase(trained["local_step_ms"])
    phase("pod_and_training_section", seconds=time.perf_counter() - section_t0)
    # ---- 7b. the zoo's training path: rwkv6-1.6b and hymba-1.5b ----------
    section_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    zoo_train = {arch: train_zoo(arch) for arch in ZOO_TRAIN}
    zoo_pod = fed_pod_path("rwkv6-1.6b", trace=False)
    zoo_pod_launches = zoo_pod["launches"]
    del zoo_pod
    torch.cuda.empty_cache()
    zoo_train_agreement()
    zoo_bwd_times = time_zoo_backward()
    phase("zoo_training_section", seconds=time.perf_counter() - section_t0)
    # ---- 7c. gemma2-2b, qwen2.5-14b, qwen2-moe-a2.7b: training, pod round -
    section_t0 = time.perf_counter()
    for arch in ("gemma2-2b", "qwen2.5-14b", "qwen2-moe-a2.7b"):
        train_lm(arch)
    gemma_pod = fed_pod_path("gemma2-2b", trace=False)
    gemma_pod_launches = gemma_pod["launches"]
    del gemma_pod
    torch.cuda.empty_cache()
    phase("new_archs_training_section",
          seconds=time.perf_counter() - section_t0)
    # ---- 7d. musicgen-medium and internvl2-26b: training, the pod round ---
    section_t0 = time.perf_counter()
    train_lm("musicgen-medium")
    music_pod = fed_pod_path("musicgen-medium", trace=False)
    music_pod_launches = music_pod["launches"]
    del music_pod
    torch.cuda.empty_cache()
    train_lm("internvl2-26b")
    phase("last_archs_training_section",
          seconds=time.perf_counter() - section_t0)
    if trace:
        profile_rounds(fused, "fig5-fused-int8")
        profile_rounds(lms["vgg-fig5"], "vgg-fig5")
        profile_rounds(adaptive["noniid-dyn"], "noniid-dyn")

    replaces = {"segmented_histogram": "src/repro/kernels/segmented.py:145",
                "segmented_count": "src/repro/kernels/segmented.py:202",
                "segmented_apply": "src/repro/kernels/segmented.py:248",
                "segmented_stats": "src/repro/kernels/segmented.py:316",
                "segmented_encode": "src/repro/kernels/segmented.py:399"}
    rounds = len(fused["history"])
    kernels = []
    for name, path in replaces.items():
        rec = times[name]
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segmented.cu",
            "replaces": path,
            "launches": fused["launches"][name],
            "launches_per_round": fused["launches"][name] / rounds,
            "store_path_launches": store["launches"][name],
            "async_path_launches": async_run["launches"][name],
            "robust_path_launches": {p: r["launches"][name]
                                     for p, r in robust.items()},
            "fed_pod_path_launches": pod_launches.get(name, 0),
            "fed_pod_launches_per_round": pod_launches.get(name, 0)
            / POD_ROUNDS,
            "gemma2_pod_path_launches": gemma_pod_launches.get(name, 0),
            "gemma2_pod_launches_per_round":
                gemma_pod_launches.get(name, 0) / POD_ROUNDS,
            "musicgen_pod_path_launches": music_pod_launches.get(name, 0),
            "musicgen_pod_launches_per_round":
                music_pod_launches.get(name, 0) / POD_ROUNDS,
            "max_abs_err": errs[name], "ms": rec["ms"],
            "warm_ms": rec["warm_ms"], "device_ms": rec["device_ms"],
            "device_source": rec.get("device_source", "trace"),
            "wrapper_ms": rec["wrapper_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_note": LIBRARY_NOTE}
        entry["at_2^26"] = at_large(large_times[name])
        if name == "segmented_count":
            for c in LARGE_COUNT_CANDIDATES:
                entry[f"at_2^26_c{c}"] = at_large(
                    large_times[f"segmented_count_c{c}"])
        if name == "segmented_encode":
            fp32 = times["segmented_encode_fp32"]
            entry.update(variant="int8", fp32_ms=fp32["ms"],
                         fp32_warm_ms=fp32["warm_ms"],
                         fp32_device_ms=fp32["device_ms"],
                         fp32_bound_ms=fp32["bound_ms"],
                         fp32_plain_ms=fp32["plain_ms"],
                         fp32_max_abs_err=errs["segmented_encode_fp32"])
            entry["fp32_at_2^26"] = at_large(
                large_times["segmented_encode_fp32"])
        kernels.append(entry)
    topk_replaces = {"exponent_histogram": "src/repro/kernels/topk_mask.py:89",
                     "count_ge": "src/repro/kernels/topk_mask.py:118",
                     "apply_threshold": "src/repro/kernels/topk_mask.py:144"}
    for name, path in topk_replaces.items():
        rec = topk_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_mask.cu",
            "replaces": path, "launches": per_array["launches"][name],
            "launches_per_leaf": per_array["launches"][name]
            / len(per_array["leaves"]),
            "path": "per-array ops.topk_mask on one client's VGG and GRU "
                    "deltas", "shape": LARGEST_VGG_LEAF,
            "max_abs_err": topk_errs[name], "ms": rec["ms"],
            "warm_ms": rec["warm_ms"], "device_ms": rec["device_ms"],
            "wrapper_ms": rec["wrapper_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            **({key: rec[key] for key in (
                "library", "library_device_ms",
                "library_device_ms_same_outputs", "one_output_device_ms")}
               if "library" in rec else {}),
            "device_records": rec["device_records"],
            "kernel_records": rec["kernel_records"],
            "records_per_call": rec["records_per_call"],
            "at_2^26": at_large(large_topk_times[name]),
            "library_note": PER_ARRAY_LIBRARY_NOTE})
    zoo_replaces = {"wkv6": ("src/repro/kernels/wkv6.py:72", "rwkv6-1.6b"),
                    "ssm_scan": ("src/repro/kernels/ssm_scan.py:62",
                                 "hymba-1.5b")}
    for name, (path, arch) in zoo_replaces.items():
        rec = zoo_times[name]
        launches = serves[arch]["launches"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": path,
            "path": f"{arch} prefill step, bf16, {SERVE_B} x {SERVE_T} "
                    f"tokens, full width and depth",
            "launches": launches, "launches_per_prefill": launches,
            "shape": rec["shape"], "max_abs_err": zoo_errs[name],
            "ms": rec["ms"], "warm_ms": rec["warm_ms"],
            "wrapper_ms": rec["wrapper_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "kernel_operations": rec["kernel_operations"],
            **({"kernel_exponentials": rec["kernel_exponentials"]}
               if "kernel_exponentials" in rec else {}),
            "launches_per_train_step":
                zoo_train[arch]["launches_per_step"][name],
            "library_note": ZOO_LIBRARY_NOTE})
    for name, arch in (("wkv6_backward", "rwkv6-1.6b"),
                       ("ssm_scan_backward", "hymba-1.5b")):
        rec = zoo_bwd_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      + ("wkv6_backward.cu" if name == "wkv6_backward"
                         else "ssm_scan.cu"),
            "replaces": None, "replaces_note": ZOO_BWD_REPLACES_NOTE[name],
            "path": f"{arch} make_train_step (AdamW), 3 steps of "
                    f"{POD_B} x {POD_T} tokens, full width and depth",
            "launches": zoo_train[arch]["launches"][name],
            "launches_per_train_step":
                zoo_train[arch]["launches_per_step"][name],
            **({"fed_pod_path_launches": zoo_pod_launches[name],
                "fed_pod_launches_per_round": zoo_pod_launches[name]
                / POD_ROUNDS} if name in zoo_pod_launches else {}),
            "shape": rec["shape"], "max_abs_err": zoo_grad_errs[name],
            "ms": rec["ms"], "warm_ms": rec["warm_ms"],
            "device_ms": rec["device_ms"],
            "device_source": rec["device_source"],
            "wrapper_ms": rec["wrapper_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_note": ZOO_BWD_LIBRARY_NOTE})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
