"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Each test hands the same numpy arrays to the JAX package and to its
PyTorch port.  Model weights come from the JAX model's own init, with
the BatchNorm parameters and statistics redrawn from a numpy seed so that
the weight transfer of every leaf is exercised.
"""

import numpy as np
import torch

# The suite runs in several pytest-xdist workers beside XLA's own thread
# pools; torch's default of one intra-op thread per core oversubscribes
# the host and slows every worker.  These tests use small shapes, so one
# thread each is enough.
torch.set_num_threads(1)

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


def flax_weights(crop: int, channels: int = 21, seed: int = 0) -> dict:
    """Flattened variables of the JAX Hand3DPosePriorNetwork: the variable
    tree of its ``init`` (traced with ``jax.eval_shape``, not compiled),
    filled from ``seed`` -- He/LeCun-scaled kernels, and BatchNorm
    scale/bias/mean/var away from their init values so that every leaf's
    transfer is exercised."""
    import jax
    import jax.numpy as jnp
    from handpose_tpu.config import Config
    from handpose_tpu.models import build_model
    from handpose_tpu_torch.convert import flatten_variables

    cfg = Config(model_name=MODEL, input_channels=channels,
                 input_img_shape=(crop, crop), compute_dtype="float32")
    model = build_model(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, crop, crop, channels)),
                            jnp.tile(jnp.eye(3), (1, 1, 1)),
                            jnp.ones((1, 1)), jnp.zeros((1, 3)))
    flat = flatten_variables(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                          dict(shapes)))
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


def max_rel_err(ref, out) -> float:
    """max |out - ref| over max |ref|: the error as a share of the
    output's range."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12))


def train_cfgs(crop: int, **kw):
    """(JAX Config, port Config) of the flagship for a train-step test:
    21 scoremap channels, ``crop``, and ``kw`` (compute_dtype, grad_accum,
    lr, max_epoch, ...) on both."""
    from handpose_tpu.config import Config as JConfig
    from handpose_tpu_torch.config import Config
    args = dict(model_name=MODEL, input_channels=21,
                input_img_shape=(crop, crop), **kw)
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
