"""The port's checkpoints (``repro_torch/checkpoint``) against the
reference's ``repro/checkpoint/checkpoint.py``, on the CPU, and the hashes
of the seeded data a checkpoint resumes on.

A tree of fp32, int64, uint8 and bf16 leaves written by either package
restores in the other byte for byte, and both write the same manifest.
``latest_step`` ignores a half-written ``.tmp`` step; a structure or shape
mismatch raises.  The seed-0 synthetic images and their IID and
Dirichlet(0.5) partitions (the LeNet main path's data) hash the same from
both packages and equal the pinned sha256 values ``chip_smoke.py`` checks
on the card; the port's seed-0 LeNet init is pinned as this machine gives
it.
"""

import hashlib
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.models import paper_models as tpm


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend (six workers with torch's default
    threads made the port's files more than ten times slower).  Restored
    after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "params": {"conv1.w": rng.standard_normal((3, 4)).astype(np.float32),
                   "emb": rng.standard_normal((5, 2)).astype(
                       ml_dtypes.bfloat16)},
        "count": rng.integers(-2**40, 2**40, (3,), dtype=np.int64),
        "rng": {"drop": rng.integers(0, 256, (7,), dtype=np.uint8)},
        "scalar": np.array(2.5, np.float32),
    }


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        return leaf.numpy().tobytes()
    return np.asarray(leaf).tobytes()


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _flat(tree[k], f"{path}/{k}")]
    return [(path, tree)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_between_the_packages(tmp_path, writer):
    """Written by one package, restored by the other: every leaf's bytes
    and dtype, the step and ``extra``; the manifests are the same."""
    tree = _arrays()
    extra = {"round": 3, "store": "sharded"}
    for name, save in (("reference", jck.save_checkpoint),
                       ("port", tck.save_checkpoint)):
        src = tree if name == "reference" else _torch(tree)
        save(str(tmp_path / name), 3, src, extra=extra)
    manifests = [json.loads((tmp_path / name / "step_00000003" /
                             "manifest.json").read_text())
                 for name in ("reference", "port")]
    assert manifests[0] == manifests[1]
    assert manifests[1]["keys"][:2] == ["['count']", "['params']['conv1.w']"]
    assert "bfloat16" in manifests[1]["dtypes"]
    path = str(tmp_path / writer)
    if writer == "reference":
        got, step, got_extra = tck.restore_checkpoint(path, _torch(tree))
        for (_, a), (_, b) in zip(_flat(got), _flat(_torch(tree))):
            assert a.dtype == b.dtype and _bytes(a) == _bytes(b)
    else:
        got, step, got_extra = jck.restore_checkpoint(path, tree)
        for (_, a), (_, b) in zip(_flat(got), _flat(tree)):
            assert np.asarray(a).dtype == b.dtype
            assert _bytes(a) == _bytes(b)
    assert step == 3 and got_extra == extra


def test_latest_step_ignores_a_half_written_step(tmp_path):
    tree = {"a": torch.ones(2)}
    assert tck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path), tree)
    tck.save_checkpoint(str(tmp_path), 1, tree)
    tck.save_checkpoint(str(tmp_path), 5, {"a": torch.full((2,), 5.0)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert tck.latest_step(str(tmp_path)) == 5
    assert jck.latest_step(str(tmp_path)) == 5
    got, step, _ = tck.restore_checkpoint(str(tmp_path), tree)
    assert step == 5 and got["a"].tolist() == [5.0, 5.0]
    got, step, _ = tck.restore_checkpoint(str(tmp_path), tree, step=1)
    assert step == 1 and got["a"].tolist() == [1.0, 1.0]
    assert tck.read_manifest(str(tmp_path))["step"] == 5


@pytest.mark.parametrize("like", [
    {"a": torch.ones(3)},                          # shape
    {"a": torch.ones(2), "b": torch.ones(1)},      # structure
    {"x": torch.ones(2)},                          # key
])
def test_restore_rejects_a_mismatch(tmp_path, like):
    tck.save_checkpoint(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="mismatch"):
        tck.restore_checkpoint(str(tmp_path), like)


def test_restore_follows_the_like_leaf_dtype_and_nesting(tmp_path):
    tree = {"p": {"w": torch.arange(4.0)}, "n": None,
            "l": [torch.tensor([1, 2]), torch.tensor(3.0)]}
    tck.save_checkpoint(str(tmp_path), 2, tree)
    assert tck.read_manifest(str(tmp_path))["keys"] == [
        "['l'][0]", "['l'][1]", "['p']['w']"]
    like = {"p": {"w": torch.zeros(4, dtype=torch.float64)}, "n": None,
            "l": [torch.zeros(2, dtype=torch.int64), torch.zeros(())]}
    got, _, _ = tck.restore_checkpoint(str(tmp_path), like)
    assert got["p"]["w"].dtype == torch.float64
    assert got["p"]["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert got["n"] is None and isinstance(got["l"], list)
    assert got["l"][0].tolist() == [1, 2] and float(got["l"][1]) == 3.0


# ---- the seeded data a checkpoint resumes on ------------------------------
def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# chip_smoke.py's SEED_DATA_HASHES: the LeNet main path's data at seed 0.
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


def _seed_data(syn, part):
    ds = syn.class_gaussian_images(num_train=32 * 8 * 32, image_size=28,
                                   seed=0)
    out = {f"images.{k}": getattr(ds, k)
           for k in ("train_x", "train_y", "test_x", "test_y")}
    for name, split in (("iid", part.iid_partition_images),
                        ("dirichlet", part.dirichlet_partition_images)):
        kw = {"alpha": 0.5} if name == "dirichlet" else {}
        xs, ys, n = split(ds.train_x, ds.train_y, 32, 32, seed=0, **kw)
        out.update({f"{name}.xs": xs, f"{name}.ys": ys, f"{name}.n": n})
    return out


def test_seed_data_hashes_are_the_reference_arrays_and_pinned():
    ref = {k: _sha(v) for k, v in _seed_data(jsyn, jpart).items()}
    port = {k: _sha(v) for k, v in _seed_data(tsyn, tpart).items()}
    assert port == ref
    assert port == SEED_DATA_HASHES


def _init_hash(seed):
    params = tpm.init_lenet(torch.Generator().manual_seed(seed),
                            image_size=28, device="cpu")
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].numpy().tobytes())
    return h.hexdigest()


def test_seed_init_hash_is_pinned():
    """The seed-0 init is pinned by its seed on one torch build: two fresh
    generators hash alike and another seed does not.  Its value is not
    held to a constant, since torch's CPU generator differs between
    versions; chip_smoke.py reports the card machine's."""
    assert _init_hash(0) == _init_hash(0)
    assert _init_hash(0) != _init_hash(1)
