"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Each test hands the same numpy arrays to the JAX package and to its
PyTorch port.  Model weights come from the JAX model's own init, with
the BatchNorm parameters and statistics redrawn from a numpy seed so that
the weight transfer of every leaf is exercised.
"""

import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

# The suite runs in several pytest-xdist workers beside XLA's own thread
# pools; torch's default of one intra-op thread per core oversubscribes
# the host and slows every worker.  These tests use small shapes, so one
# thread each is enough.
torch.set_num_threads(1)

# the lowest priority: the run ends when the worker that runs
# tests/test_train.py, the suite's longest file, left at 0, does
PORT_NICE = 19


def lower_priority(nice: int = PORT_NICE) -> None:
    """Run every thread of this process (XLA's and torch's pools
    included: Linux keeps a nice value per thread) at ``nice``, and so
    every thread and process they start later.  Never lowers a value
    that is already higher."""
    try:
        tids = [int(t) for t in os.listdir("/proc/self/task")]
    except FileNotFoundError:                   # no procfs: this thread
        tids = [0]
    for tid in tids:
        try:
            if os.getpriority(os.PRIO_PROCESS, tid) < nice:
                os.setpriority(os.PRIO_PROCESS, tid, nice)
        except ProcessLookupError:              # the thread has ended
            pass


@pytest.fixture(scope="module", autouse=True)
def port_worker_niced():
    """The port's test files yield the CPU to the suite's other workers:
    the xdist worker that runs one is niced (``PORT_NICE``) from its
    first port test on, and so are the processes its tests start.  A
    fixture rather than an import-time call, because every worker
    imports every test module, ``tests/test_train.py``'s too."""
    lower_priority()
    yield

RAW_FIELDS = ("image", "mask", "keypoint_uv", "keypoint_vis",
              "keypoint_xyz", "camera_K")
MODEL = "Hand3DPosePriorNetwork"


def seeded_raw(B: int, S: int, seed: int) -> dict:
    """An RHD-like raw batch of B samples at S x S: keypoints projected
    from plausible 3-D hands, random image and mask."""
    rng = np.random.default_rng(seed)
    K = np.tile(np.asarray([[S, 0, S / 2], [0, S, S / 2], [0, 0, 1]],
                           np.float32), (B, 1, 1))
    xyz = (rng.normal(size=(B, 42, 3)) * 0.05 +
           np.asarray([0, 0, 0.6])).astype(np.float32)
    uvw = np.einsum("bij,bkj->bki", K, xyz)
    return dict(
        image=rng.integers(0, 255, (B, S, S, 3), dtype=np.uint8),
        mask=rng.integers(0, 34, (B, S, S), dtype=np.uint8),
        keypoint_uv=(uvw[..., :2] / uvw[..., 2:3]).astype(np.float32),
        keypoint_vis=rng.uniform(size=(B, 42)) > 0.3,
        keypoint_xyz=xyz, camera_K=K)


def jax_raw(raw: dict):
    import jax.numpy as jnp
    from handpose_tpu.data.preprocess import RawBatch
    return RawBatch(*(jnp.asarray(raw[k]) for k in RAW_FIELDS))


def torch_raw(raw: dict):
    import torch
    from handpose_tpu_torch.data.preprocess import RawBatch
    return RawBatch(*(torch.from_numpy(np.ascontiguousarray(raw[k]))
                      for k in RAW_FIELDS))


def unflatten(flat: dict) -> dict:
    """``a/b/c`` -> nested dict of jax arrays."""
    import jax.numpy as jnp
    tree: dict = {}
    for k, v in flat.items():
        d = tree
        parts = k.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(v)
    return tree


def flax_weights(crop: int, channels: int = 21, seed: int = 0,
                 model: str = MODEL, **cfg_kw) -> dict:
    """Flattened variables of the JAX ``model`` (default
    Hand3DPosePriorNetwork; ``cfg_kw`` are further Config fields): the
    variable tree of its ``init`` (traced with ``jax.eval_shape``, not
    compiled), filled from ``seed`` -- He/LeCun-scaled kernels, and
    BatchNorm scale/bias/mean/var away from their init values so that
    every leaf's transfer is exercised."""
    import jax
    import jax.numpy as jnp
    from handpose_tpu.config import Config
    from handpose_tpu.models import build_model

    cfg = Config(model_name=model, input_channels=channels,
                 input_img_shape=(crop, crop), compute_dtype="float32",
                 **cfg_kw)
    shapes = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, crop, crop, channels)),
                            jnp.tile(jnp.eye(3), (1, 1, 1)),
                            jnp.ones((1, 1)), jnp.zeros((1, 3)))
    return seeded_variables(shapes, seed)


def seeded_variables(shapes, seed: int) -> dict:
    """A flax variable tree of ``jax.ShapeDtypeStruct`` leaves, flattened
    and filled from ``seed``: He-scaled conv and LeCun-scaled dense
    kernels, small biases and means, scales and variances in [0.5, 1.5]."""
    import jax
    from handpose_tpu_torch.convert import flatten_variables
    flat = flatten_variables(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)))
    rng = np.random.default_rng(seed)
    for k, v in sorted(flat.items()):
        leaf = k.rsplit("/", 1)[1]
        if leaf == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            gain = 2.0 if v.ndim == 4 else 1.0
            w = rng.normal(0.0, np.sqrt(gain / fan_in), v.shape)
        elif leaf in ("scale", "var"):
            w = rng.uniform(0.5, 1.5, v.shape)
        else:                                     # bias, mean
            w = rng.normal(0.0, 0.1, v.shape)
        flat[k] = w.astype(np.float32)
    return flat


def array_ranges(side: dict, keys) -> dict:
    """{key: {name: max |array|, at least 1e-12}} of the arrays under each
    of ``keys`` in ``side``: a drift's denominators, each array's range
    as :func:`max_rel_err` takes it."""
    return {key: {k: max(float(np.abs(v).max()), 1e-12)
                  for k, v in side[key].items()} for key in keys}


def max_rel_err(ref, out) -> float:
    """max |out - ref| over max |ref|: the error as a share of the
    output's range."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12))


def train_cfgs(crop: int, **kw):
    """(JAX Config, port Config) for a train-step test: the flagship with
    21 scoremap channels unless ``kw`` names others, ``crop``, and ``kw``
    (compute_dtype, grad_accum, lr, max_epoch, ...) on both."""
    from handpose_tpu.config import Config as JConfig
    from handpose_tpu_torch.config import Config
    args = dict(dict(model_name=MODEL, input_channels=21), **kw,
                input_img_shape=(crop, crop))
    return JConfig(**args), Config(**args)


def pp_kwargs(crop: int) -> dict:
    return dict(crop_size=crop, sigma=25.0, switch_joint_order=True)


def jax_train_state(flat: dict, jcfg, steps_per_epoch: int):
    """(flax model, TrainState) with ``flat`` and the repo's Adam +
    cosine schedule; a fresh copy of every array (the train step donates
    its state)."""
    from handpose_tpu.models import build_model
    from handpose_tpu.train.state import TrainState, make_optimizer
    model = build_model(jcfg)
    var = unflatten(flat)
    tx = make_optimizer(jcfg.lr, jcfg.lr_min, jcfg.max_epoch,
                        steps_per_epoch)
    return model, TrainState.create(apply_fn=model.apply,
                                    params=var["params"], tx=tx,
                                    batch_stats=var["batch_stats"])


def torch_train_state(flat: dict, cfg, steps_per_epoch: int):
    """(port model with ``flat``, its TrainState) on the host."""
    from handpose_tpu_torch.convert import load_flax_variables
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.train.state import create_train_state
    model = load_flax_variables(build_model(cfg), flat)
    return model, create_train_state(model, cfg, steps_per_epoch)


def jax_variables(state) -> dict:
    """A JAX TrainState's params and batch_stats, flattened."""
    from handpose_tpu_torch.convert import flatten_variables
    return flatten_variables({"params": state.params,
                              "batch_stats": state.batch_stats})


def assert_trajectory_close(want: dict, got: dict):
    """Variables after a few Adam steps in both packages: every leaf to
    1e-2 of its range, and at least 99% of all elements to 1e-4 of their
    leaf's range.  Adam divides each gradient element by its own
    magnitude, so an element whose gradient sits at float32 noise level
    steps by up to +-lr in either package whatever its sign; the
    statistics of later layers follow those parameters."""
    assert sorted(got) == sorted(want)
    n_off = n_all = 0
    for path, w in want.items():
        diff = np.abs(got[path] - np.asarray(w, np.float32)) \
            / max(float(np.abs(w).max()), 1e-12)
        assert diff.max() <= 1e-2, (path, float(diff.max()))
        n_off += int((diff > 1e-4).sum())
        n_all += diff.size
    assert n_off <= n_all // 100, (n_off, n_all)


def jax_draws(key, B: int, image_hw, map_hw, random_crop_size: int = 0):
    """The augmentation draws of the JAX ``preprocess_batch`` for ``key``,
    made as that function makes them (``jax.random.split(key, 7)``, then
    one call per augmentation, ``fold_in(rngs[6], 1)`` for the random
    crop's x offset), as the port's ``AugmentDraws`` on the host.  Drawn
    in one jitted function, as the JAX function draws them inside its
    own."""
    import jax
    import jax.numpy as jnp
    from handpose_tpu_torch.data.preprocess import AugmentDraws
    H, W = image_hw
    rc = random_crop_size

    @jax.jit
    def draw(k):
        r = jax.random.split(k, 7)
        return (2.5 * jax.random.normal(r[0], (B, 42, 2)),
                jax.random.uniform(r[1], (B,), minval=-0.1, maxval=0.1),
                20.0 * jax.random.normal(r[2], (B, 2)),
                jax.random.uniform(r[3], (B,)) * 0.2 + 1.0,
                10.0 * jax.random.normal(r[4], (B, 2)),
                jax.random.bernoulli(r[5], 1.0 - 0.8, (B, 21) + tuple(map_hw)),
                jnp.stack([jax.random.randint(r[6], (B,), 0, H - rc + 1),
                           jax.random.randint(jax.random.fold_in(r[6], 1),
                                              (B,), 0, W - rc + 1)], -1))

    out = [torch.from_numpy(np.array(a)) for a in draw(key)]
    out[-1] = out[-1].to(torch.int64)
    return AugmentDraws(*out)


def jax_interhand_draws(key, B: int, map_hw):
    """The draws of the JAX ``preprocess_interhand_batch`` for ``key``
    (``jax.random.split(key, 2)``: uv noise from the first, the dropout's
    keep mask from the second), as the port's ``AugmentDraws``."""
    import jax
    from handpose_tpu_torch.data.preprocess import AugmentDraws

    @jax.jit
    def draw(k):
        r = jax.random.split(k, 2)
        return (2.5 * jax.random.normal(r[0], (B, 42, 2)),
                jax.random.bernoulli(r[1], 1.0 - 0.8,
                                     (B, 21) + tuple(map_hw)))

    uv, keep = (torch.from_numpy(np.array(a)) for a in draw(key))
    return AugmentDraws(uv_noise=uv, dropout_keep=keep)


IH_FIELDS = ("image", "keypoint_uv", "keypoint_vis", "keypoint_xyz",
             "camera_K", "hand_left", "bbox", "orig_wh")


def interhand_raws(raw):
    """(JAX ``InterHandRawBatch``, port ``InterHandRawBatch``) of one
    numpy raw batch (a NamedTuple or a dict of ``IH_FIELDS``)."""
    import jax.numpy as jnp
    from handpose_tpu.data.preprocess import InterHandRawBatch as JBatch
    from handpose_tpu_torch.data.preprocess import InterHandRawBatch
    d = raw if isinstance(raw, dict) else raw._asdict()
    return (JBatch(*(jnp.asarray(d[k]) for k in IH_FIELDS)),
            InterHandRawBatch(*(torch.from_numpy(np.ascontiguousarray(d[k]))
                                for k in IH_FIELDS)))


AUG_FLAGS = ("coord_uv_noise", "hue_aug", "crop_center_noise",
             "crop_scale_noise", "crop_offset_noise", "scoremap_dropout")


def write_mano_pickle(path, m):
    """A MANO_RIGHT.pkl-like pickle of ``m``: the template pickled as a
    chumpy ``Ch`` (what the licensed file embeds), the regressor as a
    scipy CSC matrix, the kintree as MANO's (2, 16) table."""
    import scipy.sparse

    class Ch:
        pass

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    fake = {"chumpy": types.ModuleType("chumpy"),
            "chumpy.ch": types.ModuleType("chumpy.ch")}
    fake["chumpy.ch"].Ch = Ch
    saved = {k: sys.modules.pop(k, None) for k in
             ("chumpy", "chumpy.ch", "chumpy.reordering")}
    sys.modules.update(fake)
    try:
        template = Ch()
        template.x = m.v_template.astype(np.float64)
        ids = np.arange(16)
        kt = np.stack([np.where(np.asarray(m.parents) < 0, 2 ** 32 - 1,
                                m.parents), ids]).astype(np.int64)
        dd = {"v_template": template, "shapedirs": m.shapedirs,
              "posedirs": m.posedirs, "weights": m.weights,
              "J_regressor": scipy.sparse.csc_matrix(m.J_regressor),
              "hands_components": m.hands_components,
              "hands_mean": m.hands_mean, "kintree_table": kt,
              "f": np.arange(1538 * 3).reshape(1538, 3) % 778}
        with open(path, "wb") as f:
            pickle.dump(dd, f, protocol=2)
    finally:
        for k in fake:
            sys.modules.pop(k, None)
        sys.modules.update({k: v for k, v in saved.items() if v is not None})
