"""Port parity: the diffusion stack against the JAX package.

``handpose_tpu_torch.nn.diffusion`` (schedules, layers, ``Unet1D``,
``GaussianDiffusion1D`` and its samplers, ``DiffusionJointEstimation``),
``nn.diffusion2d`` (``Unet2D``, ``GaussianDiffusion``) and
``utils.fid``, each on the same numpy inputs and the JAX module's
variables (its traced init refilled from a seed,
``_torch_port.seeded_variables``) carried across by
``convert.load_flax_variables``.

Tolerances, as a share of the output's range (``max_rel_err``):
- schedules, ladders and coefficient tables: bit for bit (the same numpy
  code);
- one layer or one ``Unet1D`` call: 1e-5 (float32 sums in another
  order);
- the loss and each gradient leaf: 1e-5 and 2e-5 (the backward sums over
  the batch and the positions; measured <= 2.5e-6);
- a sampler from an injected x_T and JAX's own per-step noise
  (recomputed from the key splits of ``diffusion.py:596-616`` and
  ``:625-651``), at T <= 20 and on the 200-step DDIM ladder at dim 8:
  1e-4 (each step's rounding carried through the next steps; measured
  <= 1.2e-5);
- hoist on against off in the port: 2e-5 absolute, as the JAX test holds
  its own two routes.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu.nn import diffusion as jd
from handpose_tpu.nn import diffusion2d as jd2
from handpose_tpu.utils import fid as jfid
from handpose_tpu_torch.convert import load_flax_variables
from handpose_tpu_torch.nn import diffusion as td
from handpose_tpu_torch.nn import diffusion2d as td2
from handpose_tpu_torch.utils import fid as tfid

from _torch_port import max_rel_err, seeded_variables, unflatten
from _torch_port import port_worker_niced  # noqa: F401

COND = 32
LAYER_TOL, UNET_TOL, GRAD_TOL, SAMPLE_TOL = 1e-5, 1e-5, 2e-5, 1e-4


def _variables(module, *args, seed=0, **kw):
    """Flattened, seeded variables of a flax module's init on ``args``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(seed), *args,
                            **kw)
    return seeded_variables(shapes, seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# ---- schedules ----


@pytest.mark.parametrize("total,sampling", [(400, 200), (8, 4), (100, 33)])
def test_schedules_ladders_and_tables_equal_jax_bit_for_bit(total, sampling):
    """Every buffer of both beta schedules under the three objectives,
    the DDIM ladder, and the per-step coefficient tables both samplers
    build, equal to JAX's bit for bit."""
    np.testing.assert_array_equal(td.ddim_time_pairs(total, sampling),
                                  jd.ddim_time_pairs(total, sampling))
    for beta, objective in itertools.product(
            ("linear", "cosine"), ("pred_noise", "pred_x0", "pred_v")):
        # T = 8 linear: betas up to 2.5, alphas below 0, NaN square roots
        # in both packages alike (assert_array_equal holds NaN equal)
        with np.errstate(invalid="ignore"):
            want = jd.DiffusionSchedule(total, beta, objective)
            got = td.DiffusionSchedule(total, beta, objective)
        assert sorted(vars(got)) == sorted(vars(want))
        for k, v in vars(want).items():
            assert getattr(got, k).dtype == np.float32, k
            np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
        with np.errstate(invalid="ignore"):
            jg = jd.GaussianDiffusion1D(63, timesteps=total,
                                        sampling_timesteps=sampling,
                                        objective=objective,
                                        beta_schedule=beta)
            tg = td.GaussianDiffusion1D(63, timesteps=total,
                                        sampling_timesteps=sampling,
                                        objective=objective,
                                        beta_schedule=beta)
        time = td.ddim_time_pairs(total, sampling)[:, 0]
        for k, v in jg._x_start_coefs(time).items():
            np.testing.assert_array_equal(tg._x_start_coefs(time)[k], v)
    with pytest.raises(ValueError, match="beta schedule"):
        td.DiffusionSchedule(total, "quadratic")


# ---- layers ----


def _layer_case(name, rng):
    """(flax module, its args, a builder of the port's module, the port's
    args) for one layer; JAX takes (B, L, C), the port (B, C, L)."""
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    to_cl = lambda a: _t(a).transpose(1, 2)       # (B, L, C) -> (B, C, L)
    if name == "rmsnorm":
        return (jd.RMSNorm(16), (x,), lambda: td.RMSNorm(16), (to_cl(x),))
    if name == "linear_attention":
        return (jd.LinearAttention(16), (x,),
                lambda: td.LinearAttention(16), (to_cl(x),))
    if name == "attention":
        return (jd.Attention(16), (x,), lambda: td.Attention(16),
                (to_cl(x),))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["rmsnorm", "linear_attention",
                                  "attention"])
def test_norm_and_attention_layers_match_jax(name):
    rng = np.random.default_rng(len(name))
    jm, jargs, build, targs = _layer_case(name, rng)
    flat = _variables(jm, *jargs)
    want = jm.apply(unflatten(flat), *jargs)
    port = load_flax_variables(build(), flat)
    got = port(*targs).transpose(1, 2)
    assert max_rel_err(want, _np(got)) <= LAYER_TOL


def test_prenorm_residual_both_kinds_match_jax():
    x = np.random.default_rng(3).normal(size=(2, 7, 16)).astype(np.float32)
    for kind in ("linear", "full"):
        jm = jd.PreNormResidual(16, kind)
        flat = _variables(jm, x, seed=1)
        want = jm.apply(unflatten(flat), x)
        port = load_flax_variables(td.PreNormResidual(16, kind), flat)
        got = port(_t(x).transpose(1, 2)).transpose(1, 2)
        assert max_rel_err(want, _np(got)) <= LAYER_TOL, kind


def test_sinusoidal_embedding_and_nearest_resize_match_jax():
    """The embedding of integer times (t cast to float32), and the
    nearest resize by integer index at the UNet's odd lengths."""
    t = np.asarray([0, 1, 57, 399], np.int32)
    want = jd.SinusoidalPosEmb(16).apply({}, t)
    got = td.sinusoidal_pos_emb(_t(t).long(), 16)
    assert got.dtype == torch.float32
    assert max_rel_err(want, _np(got)) <= LAYER_TOL
    x = np.random.default_rng(0).normal(size=(2, 31, 3)).astype(np.float32)
    for L in (7, 15, 31):
        for out in (2 * L, 2 * L + 1):
            want = jd._nearest_resize_1d(jnp.asarray(x[:, :L]), out)
            got = td._nearest_resize_1d(_t(x[:, :L]).transpose(1, 2), out)
            np.testing.assert_array_equal(_np(got.transpose(1, 2)), want)


def test_float64_model_embeds_time_in_float64():
    """A float64 Unet1D, the samplers' rounding reference, embeds its
    times in float64 (numpy's float64 formula to 1e-13 absolute; the
    angles reach 399 rad); narrower weights keep JAX's float32 cast."""
    t = np.asarray([0, 1, 57, 201, 399])
    freqs = np.exp(np.arange(8) * -(np.log(10000.0) / 7))
    want = np.concatenate([np.sin(t[:, None] * freqs),
                           np.cos(t[:, None] * freqs)], -1)
    got = td.sinusoidal_pos_emb(torch.from_numpy(t), 16,
                                dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-13)
    for dtype in (torch.bfloat16, torch.float32):
        assert td.sinusoidal_pos_emb(torch.from_numpy(t), 16,
                                     dtype=dtype).dtype == torch.float32
    unet = td.Unet1D(8, condition_feat_dim=4).double()
    g = torch.Generator().manual_seed(0)
    emb = {}
    unet.time_mlp_1.register_forward_hook(
        lambda m, a, o: emb.update(x=a[0]))
    with torch.no_grad():
        unet(torch.randn(2, 63, 1, generator=g, dtype=torch.float64),
             torch.tensor([3, 399]),
             torch.randn(2, 4, generator=g, dtype=torch.float64))
    assert emb["x"].dtype == torch.float64
    assert torch.equal(emb["x"], td.sinusoidal_pos_emb(
        torch.tensor([3, 399]), 8, dtype=torch.float64))


def test_block_with_flax_group_norm_matches_jax():
    """conv3 -> flax's GroupNorm (one-pass variance clipped at 0, eps
    1e-5) -> scale/shift -> SiLU, with and without the scale and shift;
    an input with a large common offset, where the one-pass variance
    differs from the two-pass one."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 9, 8)) + 30.0).astype(np.float32)
    ss = [rng.normal(size=(2, 1, 16)).astype(np.float32) for _ in range(2)]
    jm = jd.Block(16)
    flat = _variables(jm, x, seed=2)
    port = load_flax_variables(td.Block(8, 16), flat)
    for scale_shift in (None, ss):
        want = jm.apply(unflatten(flat), x, scale_shift)
        tss = None if scale_shift is None else [
            _t(a).transpose(1, 2) for a in scale_shift]
        got = port(_t(x).transpose(1, 2), tss).transpose(1, 2)
        assert max_rel_err(want, _np(got)) <= LAYER_TOL


def test_resnet_block_three_modes_match_jax():
    """``time_emb``; the precompute mode (x=None) on (S, B, T) embeddings;
    and an injected ``time_proj``; 8 -> 16 channels (``res_conv``)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 8)).astype(np.float32)
    temb = rng.normal(size=(2, 32)).astype(np.float32)
    steps = rng.normal(size=(3, 2, 32)).astype(np.float32)
    jm = jd.ResnetBlock(8, 16)
    flat = _variables(jm, x, temb, seed=3)
    var = unflatten(flat)
    port = load_flax_variables(td.ResnetBlock(8, 16, 32), flat)
    want = jm.apply(var, x, temb)
    got = port(_t(x).transpose(1, 2), _t(temb)).transpose(1, 2)
    assert max_rel_err(want, _np(got)) <= LAYER_TOL
    tab = jm.apply(var, None, steps)
    ttab = port(None, _t(steps))
    assert tuple(ttab.shape) == (3, 2, 32)
    assert max_rel_err(tab, _np(ttab)) <= LAYER_TOL
    want = jm.apply(var, x, time_proj=tab[1])
    got = port(_t(x).transpose(1, 2), time_proj=ttab[1]).transpose(1, 2)
    assert max_rel_err(want, _np(got)) <= LAYER_TOL


# ---- Unet1D ----


def _unet_inputs(seed=0, B=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 63, 1)).astype(np.float32),
            np.asarray([0, 7, 19][:B], np.int32),
            rng.normal(size=(B, COND)).astype(np.float32))


@pytest.mark.parametrize("conditioned", [True, False])
def test_unet1d_three_modes_match_jax(conditioned):
    """dim 16, mults 1/2/4/8, L 63 (the length chain 63 -> 31 -> 15 -> 7
    and back): plain; x=None, the tables of every time-conditioned block
    in ``_block_specs`` order, (S, B|1, 2 dim_out); ``time_tables``."""
    x, t, c = _unet_inputs()
    c = c if conditioned else None
    jnet = jd.Unet1D(dim=16, condition_feat_dim=COND if conditioned
                     else None)
    flat = _variables(jnet, x, t, c)
    var = unflatten(flat)
    port = load_flax_variables(
        td.Unet1D(16, condition_feat_dim=COND if conditioned else None),
        flat)
    tc = None if c is None else _t(c)
    times = np.asarray([19.0, 9.0, 0.0], np.float32)

    @jax.jit
    def modes(v, x, t, c):
        tabs = jnet.apply(v, None, times, c)
        step = {k: a[1] for k, a in tabs.items()}
        return (jnet.apply(v, x, t, c), tabs,
                jnet.apply(v, x, t, c, time_tables=step))

    plain, tabs, tabled = modes(var, x, t, c)
    with torch.no_grad():
        got = port(_t(x), _t(t).long(), tc)
        assert got.shape == (3, 63, 1)
        assert max_rel_err(plain, _np(got)) <= UNET_TOL
        ttabs = port(None, _t(times), tc)
        names = [n for n, _, _ in jnet._block_specs(
            list(zip([16, 16, 32, 64], [16, 32, 64, 128])))]
        assert list(ttabs) == names == port.block_specs()
        for k, v in tabs.items():
            assert tuple(ttabs[k].shape) == v.shape == (
                3, 3 if conditioned else 1, v.shape[-1])
            assert max_rel_err(v, _np(ttabs[k])) <= UNET_TOL, k
        got = port(_t(x), _t(t).long(), tc,
                   time_tables={k: v[1] for k, v in ttabs.items()})
        assert max_rel_err(tabled, _np(got)) <= UNET_TOL


@pytest.fixture(scope="module")
def unet16():
    """(flax Unet1D dim 16 with a condition, its flat variables, the
    port's Unet1D with them)."""
    x, t, c = _unet_inputs()
    jnet = jd.Unet1D(dim=16, condition_feat_dim=COND)
    flat = _variables(jnet, x, t, c, seed=4)
    return jnet, flat, load_flax_variables(
        td.Unet1D(16, condition_feat_dim=COND), flat)


OBJECTIVES = ("pred_noise", "pred_x0", "pred_v")


@pytest.fixture(scope="module")
def loss_case(unet16):
    """The loss inputs, and JAX's (loss, gradient) under each objective,
    from one compiled program."""
    jnet, flat, _ = unet16
    rng = np.random.default_rng(7)
    x0 = rng.uniform(size=(4, 63, 1)).astype(np.float32)
    c = rng.normal(size=(4, COND)).astype(np.float32)
    t = np.asarray([0, 3, 11, 19], np.int32)
    noise = rng.normal(size=(4, 63, 1)).astype(np.float32)

    @jax.jit
    def jloss(params):
        return {obj: jax.value_and_grad(lambda p: jd.GaussianDiffusion1D(
            63, timesteps=20, objective=obj).loss(
                lambda a, b, cc: jnet.apply({"params": p}, a, b, cc), x0, c,
                jax.random.PRNGKey(0), t=t, noise=noise))(params)
                for obj in OBJECTIVES}

    return (x0, c, t, noise), jloss(unflatten(flat)["params"])


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_loss_with_injected_draws_and_gradients_match_jax(unet16, loss_case,
                                                          objective):
    """``loss`` with injected t and noise (normalised space) under each
    objective's SNR weight: the value to 1e-5, each gradient leaf to 2e-5
    of its range."""
    _, _, port = unet16
    (x0, c, t, noise), wants = loss_case
    want, grads = wants[objective]
    tg = td.GaussianDiffusion1D(63, timesteps=20, objective=objective)
    port.zero_grad(set_to_none=True)
    got = tg.loss(port, _t(x0), _t(c), t=_t(t), noise=_t(noise))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LAYER_TOL)
    from handpose_tpu_torch.convert import (export_flax_variables,
                                            flatten_variables)
    want_g = flatten_variables({"params": grads})
    got_g = export_flax_variables(port, grads=True)
    assert sorted(got_g) == sorted(want_g)
    for k, v in want_g.items():
        assert max_rel_err(v, got_g[k]) <= GRAD_TOL, k


def test_conversions_predictions_and_posterior_match_jax():
    """The four conversions, ``model_predictions`` (with and without the
    clip) and ``q_posterior`` under each objective, on a stand-in
    denoiser (the conversions' arithmetic, not the UNet's), 1e-5."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(3, 63, 1)).astype(np.float32)
    x0 = rng.normal(size=(3, 63, 1)).astype(np.float32)
    t = np.asarray([0, 9, 19], np.int32)
    tt = _t(t).long()
    for objective in OBJECTIVES:
        jg = jd.GaussianDiffusion1D(63, timesteps=20, objective=objective)
        tg = td.GaussianDiffusion1D(63, timesteps=20, objective=objective)
        pairs = [(jg.predict_start_from_noise(x, t, x0),
                  tg.predict_start_from_noise(_t(x), tt, _t(x0))),
                 (jg.predict_noise_from_start(x, t, x0),
                  tg.predict_noise_from_start(_t(x), tt, _t(x0))),
                 (jg.predict_v(x0, t, x), tg.predict_v(_t(x0), tt, _t(x))),
                 (jg.predict_start_from_v(x, t, x0),
                  tg.predict_start_from_v(_t(x), tt, _t(x0)))]
        pairs += list(zip(jg.q_posterior(x0, x, t),
                          tg.q_posterior(_t(x0), _t(x), tt)))
        for clip in (False, True):
            pairs += list(zip(
                jg.model_predictions(lambda a, b, c: a * 0.5 + 0.1, x, t,
                                     None, clip),
                tg.model_predictions(lambda a, b, c: a * 0.5 + 0.1, _t(x),
                                     tt, None, clip)))
        for want, got in pairs:
            assert max_rel_err(want, _np(got)) <= LAYER_TOL, objective


# ---- samplers ----


def _jax_step_noise(key, S, shape):
    """JAX's per-step sampler noise for ``key``: ``rng, _ =
    split(key)``, then ``split(rng, S)``, one normal draw of ``shape``
    each (``diffusion.py:596-616``, ``:625-651``)."""
    rng, _ = jax.random.split(key)
    keys = jax.random.split(rng, S)
    return np.stack([np.asarray(jax.random.normal(k, shape)) for k in keys])


SAMPLERS = {"ddim_eta0": (20, 10, 0.0), "ddim_eta0.5": (20, 10, 0.5),
            "ddpm": (12, 12, 0.0)}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_samplers_match_jax_on_injected_draws(unet16, name):
    """DDIM at eta 0 and 0.5 and ancestral DDPM at T <= 20, b3, from an
    injected x_T, the port fed JAX's own per-step noise."""
    jnet, flat, port = unet16
    T, S, eta = SAMPLERS[name]
    _, _, c = _unet_inputs(1)
    rng = np.random.default_rng(8)
    shape = (3, 63, 1)
    x_T = rng.normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jg = jd.GaussianDiffusion1D(63, timesteps=T, sampling_timesteps=S,
                                ddim_sampling_eta=eta)
    tg = td.GaussianDiffusion1D(63, timesteps=T, sampling_timesteps=S,
                                ddim_sampling_eta=eta)
    assert tg.is_ddim_sampling == (S < T)
    var = unflatten(flat)
    want = jax.jit(lambda v, cc, init: jg.sample(
        lambda a, b, cond: jnet.apply(v, a, b, cond), 3, cc, key,
        init_noise=init))(var, c, x_T)
    noise = (_jax_step_noise(key, S, shape)
             if eta or not tg.is_ddim_sampling else None)
    got = tg.sample(port, 3, _t(c), init_noise=_t(x_T), step_noise=noise)
    assert got.shape == shape and not got.requires_grad
    assert max_rel_err(want, _np(got)) <= SAMPLE_TOL
    # the noise mattered: without it (x_T kept) the sample moves
    if noise is not None:
        other = tg.sample(port, 3, _t(c), init_noise=_t(x_T),
                          generator=torch.Generator().manual_seed(0))
        assert max_rel_err(want, _np(other)) > 100 * SAMPLE_TOL


def test_ddim_full_ladder_matches_jax_at_dim_8():
    """One DDIM pass on the full T = 400, S = 200 ladder, dim 8, b2."""
    x, t, c = _unet_inputs(2, B=2)
    jnet = jd.Unet1D(dim=8, condition_feat_dim=COND)
    flat = _variables(jnet, x, t, c, seed=5)
    port = load_flax_variables(td.Unet1D(8, condition_feat_dim=COND), flat)
    x_T = np.random.default_rng(9).normal(size=(2, 63, 1)).astype(
        np.float32)
    jg = jd.GaussianDiffusion1D(63, timesteps=400, sampling_timesteps=200)
    tg = td.GaussianDiffusion1D(63, timesteps=400, sampling_timesteps=200)
    want = jax.jit(lambda v, cc, init: jg.sample(
        lambda a, b, cond: jnet.apply(v, a, b, cond), 2, cc,
        jax.random.PRNGKey(0), init_noise=init))(unflatten(flat), c, x_T)
    got = tg.sample(port, 2, _t(c), init_noise=_t(x_T))
    assert max_rel_err(want, _np(got)) <= SAMPLE_TOL


@pytest.mark.parametrize("T,S", [(20, 10), (8, 8)])
def test_sampler_hoist_on_and_off(T, S):
    """``DiffusionJointEstimation`` in the reference's (B, 1, 63) layout:
    the port's hoisted sampler equals JAX's to 1e-4 of range, and the
    port's two routes agree to 2e-5 absolute; DDIM and DDPM ('auto'
    hoists at B <= 32)."""
    rng = np.random.default_rng(10)
    x0 = rng.uniform(size=(2, 1, 63)).astype(np.float32)
    c = rng.normal(size=(2, COND)).astype(np.float32)
    x_T = rng.normal(size=(2, 1, 63)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jm = jd.DiffusionJointEstimation(condition_feat_dim=COND,
                                     num_timesteps=T,
                                     num_sampling_timesteps=S, dim=16,
                                     sampler_hoist=True)
    flat = _variables(jm, x0, c, key, seed=6)
    want = jax.jit(lambda v, cc, init: jm.apply(
        v, cc, key, init_noise=init, method=jm.sample))(
            unflatten(flat), c, x_T)
    noise = None
    if S == T:     # DDPM: JAX's per-step draws, in the (B, 1, 63) layout
        noise = _jax_step_noise(key, S, (2, 63, 1)).transpose(0, 1, 3, 2)
    outs = {}
    for hoist in ("auto", True, False):
        port = load_flax_variables(td.DiffusionJointEstimation(
            condition_feat_dim=COND, num_timesteps=T,
            num_sampling_timesteps=S, dim=16, sampler_hoist=hoist), flat)
        assert port.hoists(2) == (hoist is not False)
        outs[hoist] = _np(port.sample(_t(c), init_noise=_t(x_T),
                                      step_noise=noise))
        assert outs[hoist].shape == (2, 1, 63)
    assert port.hoists(33) is False and td.DiffusionJointEstimation(
        sampler_hoist="auto").hoists(33) is False
    assert max_rel_err(want, outs[True]) <= SAMPLE_TOL
    np.testing.assert_array_equal(outs["auto"], outs[True])
    np.testing.assert_allclose(outs[True], outs[False], atol=2e-5)


# ---- 2-D diffusion and FID ----


@pytest.fixture(scope="module")
def unet2d():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    t = np.asarray([0, 5], np.int32)
    c = rng.normal(size=(2, 8)).astype(np.float32)
    jnet = jd2.Unet2D(dim=16, dim_mults=(1, 2), channels=3,
                      condition_feat_dim=8)
    flat = _variables(jnet, x, t, c, seed=7)
    port = load_flax_variables(td2.Unet2D(16, (1, 2), 3, 8), flat)
    return jnet, flat, port, (x, t, c)


def test_unet2d_matches_jax(unet2d):
    """Forward at 8x8 (the x2 nearest upsample between the two levels,
    ``jax.image.resize(..., 'nearest')``), with the condition."""
    jnet, flat, port, (x, t, c) = unet2d
    want = jnet.apply(unflatten(flat), x, t, c)
    with torch.no_grad():
        got = port(_t(x), _t(t).long(), _t(c))
    assert got.shape == (2, 8, 8, 3)
    assert max_rel_err(want, _np(got)) <= UNET_TOL
    up = np.random.default_rng(0).normal(size=(1, 3, 5, 2)).astype(
        np.float32)
    want = jax.image.resize(up, (1, 6, 10, 2), method="nearest")
    got = _t(up).permute(0, 3, 1, 2).repeat_interleave(2, 2)\
        .repeat_interleave(2, 3).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(_np(got), want)


def test_generic_diffusion_loss_and_ddim_match_jax(unet2d):
    """``GaussianDiffusion`` on (8, 8, 3) data: the loss with injected t
    and noise, and a DDIM pass (T 6, S 3) from an injected x_T."""
    jnet, flat, port, (x, t, c) = unet2d
    var = unflatten(flat)
    rng = np.random.default_rng(13)
    x0 = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    x_T = rng.normal(size=x0.shape).astype(np.float32)
    jg = jd2.GaussianDiffusion((8, 8, 3), timesteps=6, sampling_timesteps=3)
    tg = td2.GaussianDiffusion((8, 8, 3), timesteps=6, sampling_timesteps=3)
    denoise = lambda a, b, cc: jnet.apply(var, a, b, cc)
    want = jg.loss(denoise, x0, c, jax.random.PRNGKey(0), t=t, noise=noise)
    with torch.no_grad():
        got = tg.loss(port, _t(x0), _t(c), t=_t(t), noise=_t(noise))
    np.testing.assert_allclose(float(got), float(want), rtol=LAYER_TOL)
    want = jax.jit(lambda init: jg.ddim_sample(
        denoise, (2, 8, 8, 3), c, jax.random.PRNGKey(0),
        init_noise=init))(x_T)
    got = tg.sample(port, 2, _t(c), init_noise=_t(x_T))
    assert got.shape == (2, 8, 8, 3)
    assert max_rel_err(want, _np(got)) <= SAMPLE_TOL


def _stripes(seed, n, size=16):
    r = np.random.default_rng(seed)
    ang = r.uniform(0, np.pi, n)
    f = r.uniform(1, 3, n)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    proj = (xx[None] * np.cos(ang)[:, None, None] +
            yy[None] * np.sin(ang)[:, None, None])
    img = 0.5 + 0.5 * np.sin(2 * np.pi * f[:, None, None] * proj)
    return np.stack([img, 1 - img, img ** 2], -1).astype(np.float32)


def test_frechet_distance_equals_jax_and_the_closed_form():
    rng = np.random.default_rng(0)
    a = rng.normal(0.0, 1.0, (4000, 3))
    b = rng.normal([2.0, 0.0, -1.0], [1.0, 3.0, 0.5], (4000, 3))
    assert tfid.frechet_distance(a, b) == jfid.frechet_distance(a, b)
    expect = (4.0 + 0.0 + 1.0) + (0.0 + 4.0 + 0.25)
    assert abs(tfid.frechet_distance(a, b) - expect) / expect < 0.1
    assert tfid.frechet_distance(a, a) < 1e-6


def test_random_conv_features_match_jax_on_its_kernels():
    """The proxy's three 'SAME' convolutions (stride 1, 2, 2) and average
    pool on JAX's own kernels (``fid.py:58-66``'s key splits), 1e-5 of
    range at 16x16 and at an odd 15x15; then the port's seeded proxy
    scores a matched image set far below noise."""
    real1, real2 = _stripes(1, 64), _stripes(2, 64)
    key = jax.random.PRNGKey(0)
    kernels, c_in = [], 3
    for w in (32, 64, 64):
        key, sub = jax.random.split(key)
        kernels.append(np.asarray(jax.random.normal(
            sub, (3, 3, c_in, w)) * np.sqrt(2.0 / (9 * c_in))))
        c_in = w
    for imgs in (real1, real1[:8, :15, :15]):
        want = jfid.random_conv_features(imgs)
        got = tfid.random_conv_features(imgs, kernels=kernels)
        assert got.shape == want.shape
        assert max_rel_err(want, got) <= LAYER_TOL
    noise = np.random.default_rng(3).uniform(
        size=real1.shape).astype(np.float32)
    assert tfid.fid_score(real1, real2) < 0.2 * tfid.fid_score(noise, real2)
    k0 = tfid.random_conv_kernels(3)[0]
    assert tuple(k0.shape) == (3, 3, 3, 32)
    assert torch.equal(k0, tfid.random_conv_kernels(3)[0])
