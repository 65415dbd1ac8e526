"""Port parity: the RHD dataset on PNGs and on the decoded cache.

* The port's and the JAX package's ``write_synthetic_rhd`` give the same
  decoded pixels and the same annotations for one seed;
* ``RHDDataset.raw_batch`` equals the JAX one on the PNG path (its
  native decoder and its cv2 route) and on the cache path;
* both packages write the cache byte for byte alike, and each reads the
  other's without decoding (the PNGs are removed first);
* the cache is built in chunks: a split larger than one chunk.
"""

import os
import pickle
import shutil

import numpy as np
import pytest

from handpose_tpu.data import rhd as jrhd
from handpose_tpu_torch.data import rhd as trhd
from _torch_port import port_worker_niced  # noqa: F401

N, S = 12, 48


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    pytest.importorskip("cv2")
    base = tmp_path_factory.mktemp("rhd")
    ours, theirs = str(base / "ours"), str(base / "theirs")
    trhd.write_synthetic_rhd(ours, "training", n=N, seed=8, image_size=S)
    jrhd.write_synthetic_rhd(theirs, "training", n=N, seed=8, image_size=S)
    return ours, theirs


def _assert_raw_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_writers_give_the_same_samples(trees):
    ours, theirs = trees
    name = os.path.join("training", "anno_training.pickle")
    with open(os.path.join(ours, name), "rb") as f, \
            open(os.path.join(theirs, name), "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert sorted(a) == sorted(b) == list(range(N))
    for i in a:
        for k in ("uv_vis", "xyz", "K"):
            np.testing.assert_array_equal(a[i][k], b[i][k])
    idx = list(range(N))
    _assert_raw_equal(trhd.RHDDataset(ours, "training", image_size=S)
                      .raw_batch(idx),
                      trhd.RHDDataset(theirs, "training", image_size=S)
                      .raw_batch(idx))


@pytest.mark.parametrize("native", [True, False], ids=["native", "cv2"])
def test_raw_batch_equals_jax_on_pngs(trees, native):
    ours, theirs = trees
    idx = [11, 0, 5, 6, 7]
    for root in trees:
        want = jrhd.RHDDataset(root, "training", num_decode_threads=2,
                               image_size=S, use_native_decode=native)
        got = trhd.RHDDataset(root, "training", num_decode_threads=2,
                              image_size=S)
        _assert_raw_equal(want.raw_batch(idx), got.raw_batch(idx))


def test_caches_are_the_same_bytes_and_each_reads_the_others(trees,
                                                             tmp_path):
    ours, theirs = trees
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(ours, a)
    shutil.copytree(ours, b)
    jrhd.RHDDataset(a, "training", image_size=S, cache_decoded=True)
    trhd.RHDDataset(b, "training", image_size=S, cache_decoded=True)
    for name in (f"decoded_color_{S}.u8", f"decoded_mask_{S}.u8"):
        with open(os.path.join(a, "training", name), "rb") as f, \
                open(os.path.join(b, "training", name), "rb") as g:
            assert f.read() == g.read(), name
    for root in (a, b):
        for d in ("color", "mask"):
            shutil.rmtree(os.path.join(root, "training", d))
    ref = trhd.RHDDataset(ours, "training", image_size=S)
    idx = [3, 4, 5, 1, 9]
    got_ours = trhd.RHDDataset(a, "training", image_size=S,
                               cache_decoded=True)
    got_theirs = jrhd.RHDDataset(b, "training", image_size=S,
                                 cache_decoded=True)
    _assert_raw_equal(ref.raw_batch(idx), got_ours.raw_batch(idx))
    _assert_raw_equal(ref.raw_batch(idx), got_theirs.raw_batch(idx))
    # the cache path's raw batch equals JAX's cache path's
    _assert_raw_equal(got_theirs.raw_batch(idx), got_ours.raw_batch(idx))


def test_cache_builds_in_chunks(trees, tmp_path, monkeypatch):
    ours, _ = trees
    root = str(tmp_path / "r")
    shutil.copytree(ours, root)
    monkeypatch.setattr(trhd, "CACHE_CHUNK", 5)     # 12 = 5 + 5 + 2
    cached = trhd.RHDDataset(root, "training", num_decode_threads=3,
                             image_size=S, cache_decoded=True)
    assert not [f for f in os.listdir(os.path.join(root, "training"))
                if ".tmp." in f]
    idx = list(range(N))
    _assert_raw_equal(trhd.RHDDataset(ours, "training", image_size=S)
                      .raw_batch(idx), cached.raw_batch(idx))
