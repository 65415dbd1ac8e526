"""The training harness: the JAX package's ``Worker``.

Port of ``handpose_tpu/train/trainer.py:44-549``: the RHD and
InterHand2.6M datasets (decoded per batch, or through their decoded
caches with ``cfg.cache_decoded``; InterHand's mixed capture sizes
zero-padded to one frame), ``steps_per_epoch = max(len(train) //
batch_size, 1)``, a shuffled epoch order with the remainder dropped for
training, pinned prefetch, the fused train step with the train-time
augmentations (drawn on the card from one ``torch.Generator`` seeded
``cfg.seed + 17``), then validation over the whole split (trailing
partial batch included) through the fused eval step (a model that draws
in its forward, DiffusionHandPose, trains on the Worker's generator and
validates on one seeded ``cfg.seed`` afresh each pass); fake and synthetic
data (10 steps an epoch of ``fake_sample_batch`` through the non-fused
steps); ``fast_debug`` (3 iterations per epoch); the NaN abort; the run
directory with its config and provenance, TensorBoard scalars,
``log.txt`` and the step against input-stall times; a checkpoint at
every epoch's end (``model_best`` on a new best), resume and finetune;
and preemption-safe training; ``cfg.profile_epoch`` traces that epoch's
training into ``run_dir/profile/`` (a ``torch.profiler`` chrome trace,
the card's kernels included, with the program's phases as ``hp.*``
ranges), and ``cfg.compilation_cache_dir`` names where the native
libraries are built and found.  Under any profiler session the epoch, the
wait for each batch, each step's phases and the reads of its losses are
spans of ``utils/tracing.py``.

The Worker's knobs, as the JAX Worker's: ``fuse_preprocess=False``
preprocesses each batch as its own pass (augmented from a generator
seeded ``cfg.seed * 7919 + epoch``) and trains ``make_train_step`` on the
sample dicts; ``steps_per_dispatch`` k > 1 runs each full group of k
training batches through ``make_fused_multi_step`` with preemption
checked between groups (a partly buffered group is dropped at a request)
and an epoch's tail one step at a time; ``remat`` and ``debug_nans`` act
in the steps.

Under a process group (``parallel.initialize_distributed``, then
``Worker(cfg)`` on every rank) the Worker is one rank of the JAX
package's global program: the model replicated (DDP, global BatchNorm,
the global batch's losses), each rank loading its shard of every
global batch (``HostShardSampler``, validation padded with the pad rows'
visibility zeroed and the MPJPE and loss sums all-reduced in float64),
the draws made for the global batch on every rank and cut to its rows,
the preemption flag agreed by all ranks at each step boundary, and the
run directory, logs, checkpoints and profile on rank 0 only.

``cfg.mesh_shape`` over ``cfg.mesh_axis_names`` lays the ranks out as
the JAX Worker's ``make_mesh`` does (``parallel.sharding.config_mesh``):
``(-1,)`` over ``("data",)``, the default, puts every rank on "data"; a
("data", "model") shape such as ``(2, 2)`` replicates the whole state
and shards each global batch over "data" only, so the ranks of one
"data" coordinate load, train on and validate the same rows (the
BatchNorm sums, the loss gathers and the validation sums are the data
axis's, with the same bits on every rank, and DDP averages over every
rank), as ``handpose_tpu/train/trainer.py:161-163`` replicates its
state over its mesh.  Other axis names, or a shape whose product is not
the world, raise ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import (open_dataset, raw_device_batches,
                             sampled_device_batches)
from ..data.preprocess import preprocess_fn_for
from ..data.synthetic import fake_sample_batch
from ..device import resolve_device
from ..models import build_model, mano_source_of
from ..parallel import distributed as dist_
from ..parallel.mesh import replicate
from ..parallel.sharding import config_mesh
from ..utils.logging import NullLogger, RunLogger, StepStats, make_run_dir
from ..utils.tracing import count, span
from .checkpoints import (filtered_resume, reconcile_schedule_count,
                          save_checkpoint)
from .preemption import PreemptionGuard
from .state import create_train_state
from .steps import (make_eval_step, make_fused_eval_step,
                    make_fused_multi_step, make_fused_train_step,
                    make_train_step, pass_draws, train_module)

AUG_FLAGS = ("hue_aug", "coord_uv_noise", "crop_center_noise",
             "crop_scale_noise", "crop_offset_noise", "scoremap_dropout")
# the two augmentations the reference's InterHand loader applies
# (dataloaderInterHand2M6.py:317-318,549-552)
INTERHAND_AUG_FLAGS = ("coord_uv_noise", "scoremap_dropout")
DATASETS = ("RHD", "InterHand2.6M")
FAKE_STEPS_PER_EPOCH = 10


def _check_supported(cfg: Config):
    if cfg.scale_to_size or cfg.random_crop_to_size:
        # as the JAX Worker: both transforms replace the sample dict with
        # one no model can take
        raise ValueError(
            "scale_to_size / random_crop_to_size produce reduced dataset "
            "outputs incompatible with training; use the data pipeline "
            "directly")
    if not _is_fake(cfg) and cfg.dataset_name not in DATASETS:
        raise ValueError(f"dataset {cfg.dataset_name!r} not in {DATASETS} "
                         "or 'synthetic'")
    if cfg.steps_per_dispatch > 1 and not cfg.fuse_preprocess:
        raise ValueError(
            "steps_per_dispatch > 1 (the default is 8) requires "
            "fuse_preprocess=True -- the multi-step scan consumes "
            "raw device batches; pass --set steps_per_dispatch=1 "
            "alongside fuse_preprocess=False")
    if dist_.world() > 1 and not cfg.fuse_preprocess and not _is_fake(cfg):
        raise ValueError(
            "multi-host training requires the fused step path: keep "
            "fuse_preprocess=True (host-local preprocessing would "
            "correlate augmentation draws across hosts and bounce "
            "batches device->host->device)")


def _is_fake(cfg: Config) -> bool:
    return cfg.use_fake_data or cfg.dataset_name == "synthetic"


class Worker:
    """Epoch-loop trainer on the card (``device=None``) or, when asked
    for, the host (``device="cpu"``).  ``weights`` is what the Evaluator
    takes: None (the seeded init), an ``.npz`` path, a checkpoint
    directory or a mapping of flattened flax variables;
    ``cfg.resume_weight_path`` (a checkpoint directory) then resumes or
    finetunes from it."""

    def __init__(self, cfg: Config, run_dir: Optional[str] = None,
                 weights=None, device=None):
        # the infer package imports the train steps; import it here
        from ..infer.evaluator import load_weights, serving_kwargs
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.distributed = dist_.is_distributed()
        self.rank, self.world = dist_.rank(), dist_.world()
        # the ranks of one "data" coordinate hold the same rows
        self.mesh = config_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
        dist_.set_mesh(self.mesh)
        self.data_rank, self.dp = dist_.data_rank(), dist_.data_world()
        self.is_lead = self.rank == 0
        if cfg.compilation_cache_dir:
            from ..utils.device_info import enable_compilation_cache
            enable_compilation_cache(cfg.compilation_cache_dir)
        self.model = load_weights(build_model(cfg), weights).to(self.device)
        fake = _is_fake(cfg)
        self.fused = cfg.fuse_preprocess and not fake
        if not fake:
            if cfg.dataset_name == "InterHand2.6M":
                train_split, val_split = "train", "val"
            else:
                train_split = ("evaluation" if cfg.use_val_dataset_to_debug
                               else "training")
                val_split = "evaluation"
            self.train_ds = open_dataset(cfg, train_split)
            self.val_ds = open_dataset(cfg, val_split)
            self.steps_per_epoch = max(len(self.train_ds) // cfg.batch_size,
                                       1)
            self.pp_kwargs = serving_kwargs(cfg)
            names = (INTERHAND_AUG_FLAGS
                     if cfg.dataset_name == "InterHand2.6M" else AUG_FLAGS)
            self.aug_flags = {f: getattr(cfg, f) for f in names}
            what = (f"{len(self.train_ds)} {cfg.dataset_name} "
                    f"{train_split} samples")
        else:
            self.train_ds = self.val_ds = None
            self.steps_per_epoch = FAKE_STEPS_PER_EPOCH
            self.aug_flags = {}
            what = "fake batches"
        self.state = create_train_state(self.model, cfg, self.steps_per_epoch)
        if self.is_lead:
            mano = mano_source_of(cfg)
            self.run_dir = run_dir if run_dir is not None else make_run_dir(
                cfg.save_log_dir, cfg.model_name, cfg.dataset_name,
                cfg.to_json(),
                provenance=None if mano is None else {"mano": mano})
            os.makedirs(self.run_dir, exist_ok=True)
            self.logger = RunLogger(self.run_dir)
        else:
            # named in messages only, never created
            self.run_dir = run_dir if run_dir is not None else os.path.join(
                cfg.save_log_dir, f"nonlead_rank{self.rank}")
            self.logger = NullLogger()
        self.log_path = self.logger.log_path
        self.stats = StepStats()
        self.start_epoch = 0
        self.best_mpjpe = float(np.inf)
        # the augmentations' and the model's training draws, on the card
        # (JAX: PRNGKey(seed + 17)); equal on every rank, which draws the
        # global batch's and takes its rows
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 17)
        # a model that draws in its forward (DiffusionHandPose) takes the
        # generator in training too
        self.stochastic = getattr(self.model, "stochastic", False)
        self.preempt: Optional[PreemptionGuard] = None
        aug = [f for f, on in self.aug_flags.items() if on]
        ranks = (f", rank {self.rank} of {self.world}" if self.distributed
                 else "")
        if self.mesh.tp > 1:
            ranks += (f", mesh {self.mesh.shape} at ({self.mesh.data_index},"
                      f" {self.mesh.model_index})")
        self.logger.text(
            f"training {cfg.model_name} on {self.device}{ranks}: {what}, "
            f"batch {cfg.batch_size}, {self.steps_per_epoch} steps per "
            f"epoch, bn_variance {cfg.bn_mode}, compute {cfg.compute_dtype},"
            f" augmentations {aug or 'off'}"
            + ("" if self.fused or fake else ", preprocessing unfused")
            + (", remat" if cfg.remat else "")
            + (", debug_nans" if cfg.debug_nans else ""))
        if cfg.resume_weight_path:
            # every rank resumes from the same directory
            self.state, self.start_epoch, self.best_mpjpe, finetune = \
                filtered_resume(self.state, cfg.resume_weight_path)
            if not finetune:
                # the stored count is the writing run's; re-pin it so the
                # cosine LR resumes at epoch start_epoch
                self.state = reconcile_schedule_count(
                    self.state, self.start_epoch, self.steps_per_epoch)
            mode = "finetune" if finetune else "resume"
            self.logger.text(f"loaded {cfg.resume_weight_path} as {mode}; "
                             f"start_epoch={self.start_epoch}")
        # under a process group the steps run the replicated model (world
        # 1 included: its collectives are then sums over one rank)
        net = self.model
        if self.distributed:
            net = replicate(train_module(self.model, cfg),
                            find_unused_parameters=not getattr(
                                self.model, "trains_every_parameter", True))
        self.multi_step = None
        if self.fused:
            # preprocessing=None: the steps take the raw batch's own
            self.train_step = make_fused_train_step(
                net, cfg, None, self.pp_kwargs, self.aug_flags)
            self.eval_step = make_fused_eval_step(self.model, cfg, None,
                                                  self.pp_kwargs)
            if cfg.steps_per_dispatch > 1:
                self.multi_step = make_fused_multi_step(
                    net, cfg, None, self.pp_kwargs, self.aug_flags)
        else:
            self.train_step = make_train_step(net, cfg)
            self.eval_step = make_eval_step(self.model, cfg)
        k = cfg.steps_per_dispatch
        if self.multi_step is not None:
            self.logger.text(
                f"steps_per_dispatch={k}: full groups of {k} steps, "
                "preemption checked between groups; an epoch's "
                f"{self.steps_per_epoch % k} last steps one by one")
        elif k > 1:
            self.logger.text(f"steps_per_dispatch={k}: fake data trains one "
                             "step at a time")

    def text(self, info: str):
        """Print a log line and append it to ``<run_dir>/log.txt``."""
        self.logger.text(info)

    def enable_preemption_save(self, guard: Optional[PreemptionGuard] = None
                               ) -> PreemptionGuard:
        """Arm preemption-safe training: on SIGTERM (or ``guard``'s
        signals) the epoch loop stops at the next step boundary,
        :meth:`run` writes a resumable ``checkpoint`` pinned to the
        interrupted epoch and returns; resuming restarts that epoch."""
        self.preempt = (guard or PreemptionGuard()).install()
        return self.preempt

    def _preempt_now(self) -> bool:
        """The preemption flag, agreed by every rank under a process
        group (an all-reduce MAX of the local flags at each step
        boundary), so that all ranks stop at the same boundary rather
        than one leaving its peers in the next collective; arm the guard
        on every rank."""
        if self.preempt is None:
            return False
        if not self.distributed:
            return self.preempt.requested
        return dist_.all_reduce_max_flag(self.preempt.requested, self.device)

    def _epoch_batches(self, split: str, epoch: int) -> Iterator:
        cfg = self.cfg
        if self.train_ds is None:
            # each data rank draws distinct samples: the global batch is
            # the data ranks' batches, not copies of one
            rank_off = self.data_rank * 1_000_003
            for i in range(self.steps_per_epoch):
                batch = fake_sample_batch(min(cfg.batch_size, 8),
                                          cfg.crop_size, cfg.input_channels,
                                          epoch * 1000 + i + rank_off)
                yield {k: v.to(self.device) for k, v in batch.items()}
            return
        is_train = split == "training"
        ds = self.train_ds if is_train else self.val_ds
        shuffle = is_train and cfg.shuffle \
            and not cfg.use_val_dataset_to_debug
        depth = max(cfg.prefetch_depth, 2)
        if self.dp > 1:
            # this data rank's shard of each global batch: training's in the
            # grad_accum layout of the JAX step's microbatches, the
            # validation split whole, padded, its pad rows weighing 0
            sampler = dist_.HostShardSampler(len(ds), cfg.batch_size,
                                             shuffle=shuffle, seed=cfg.seed)
            chunks = (sampler.local_batches(epoch, cfg.grad_accum)
                      if is_train else sampler.local_batches_padded(epoch))
            raws = sampled_device_batches(ds, chunks, self.device,
                                          depth=depth)
        else:
            # validation sees the whole split, its trailing partial batch
            raws = raw_device_batches(
                ds, cfg.batch_size, self.device, shuffle=shuffle,
                seed=cfg.seed * 100003 + epoch, drop_remainder=is_train,
                depth=depth)
        yield from raws

    def _unfused_preprocess(self, split: str, epoch: int):
        """With ``fuse_preprocess=False`` on a dataset, the epoch's
        preprocessing of a raw batch, as its own pass before each step,
        the augmentations drawn from a per-epoch generator (JAX:
        PRNGKey(seed * 7919 + epoch)); None where the steps take the raw
        batches (fused) or the batches come preprocessed (fake data)."""
        if self.fused or self.train_ds is None:
            return None
        flags = {f: True for f, on in self.aug_flags.items()
                 if on and split == "training"}
        g = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed * 7919 + epoch) if flags else None

        def preprocess(raw):
            with torch.no_grad():
                return preprocess_fn_for(raw)(raw, **self.pp_kwargs,
                                              **flags, generator=g)

        return preprocess

    def _waited(self, batches: Iterator) -> Iterator:
        """``batches``, the main thread's wait for each timed
        (``stats.input``, the span ``hp.data.wait``)."""
        end = object()
        while True:
            with span("hp.data.wait"):
                self.stats.input.tic()
                batch = next(batches, end)
                self.stats.input.toc()
            if batch is end:
                return
            yield batch

    def _train_on(self, batch, preprocess=None):
        if preprocess is not None:
            # the step's unit holds the pass that preprocesses its batch
            with span("hp.train.step"):
                with span("hp.train.preprocess"):
                    batch = preprocess(batch)
                return self.train_step(self.state, batch,
                                       generator=self.generator)
        if self.train_ds is not None or self.stochastic:
            return self.train_step(self.state, batch,
                                   generator=self.generator)
        return self.train_step(self.state, batch)

    def _finish_train_metrics(self, metrics: dict, epoch: int, idx: int,
                              losses_acc: dict):
        """NaN abort, loss accumulation and periodic logging of a step:
        the host's blocking reads of its losses (span ``hp.train.sync``,
        each read counted in ``syncs``)."""
        with span("hp.train.sync"):
            if self.cfg.nan_check:
                loss_val = float(metrics["loss"])
                count("syncs")
                if not np.isfinite(loss_val):
                    self.text(f"FATAL: non-finite loss {loss_val} at epoch "
                              f"{epoch} iter {idx}; aborting (resume from "
                              f"the last checkpoint in {self.run_dir})")
                    raise FloatingPointError(f"non-finite training loss at "
                                             f"epoch {epoch} iter {idx}")
            for k, v in metrics.items():
                losses_acc[k] = losses_acc.get(k, 0.0) + float(v)
            count("syncs", len(metrics))
            every = self.cfg.log_every_steps
            if every and idx % every == 0:
                count("syncs", len(metrics))
                terms = ", ".join(f"{k}: {float(v):.5f}"
                                  for k, v in metrics.items())
                self.text(f"  epoch {epoch:03d} iter {idx:05d}/"
                          f"{self.steps_per_epoch:05d} | {terms} | "
                          f"{self.stats.summary()}")

    def _run_group(self, group: list, epoch: int, losses_acc: dict) -> int:
        """A full ``steps_per_dispatch`` group of ``(idx, raw)`` through
        the multi-step, each step's losses booked as a single step's; its
        host time is shared equally among its steps."""
        batches = [b for _, b in group]
        stack = type(batches[0])(*(torch.stack(xs) for xs in
                                   zip(*batches)))
        self.stats.step.tic()
        self.state, losses_k = self.multi_step(self.state, stack,
                                               generator=self.generator)
        for j, (idx, _) in enumerate(group):
            self._finish_train_metrics({k: v[j] for k, v in losses_k.items()},
                                       epoch, idx, losses_acc)
        self.stats.train_toc(len(group))
        return len(group)

    def _train_one(self, batch, epoch: int, idx: int, losses_acc: dict,
                   preprocess=None):
        self.stats.step.tic()
        self.state, metrics = self._train_on(batch, preprocess)
        self._finish_train_metrics(metrics, epoch, idx, losses_acc)
        self.stats.train_toc()

    def run_epoch(self, epoch: int, split: str,
                  fast_debug: bool = False) -> Optional[float]:
        """One pass over ``split`` ('training' or 'validation') in the span
        ``hp.epoch``; returns the validation MPJPE (None for training, or
        when no joint was visible)."""
        with span("hp.epoch"):
            return self._run_epoch(epoch, split, fast_debug)

    def _run_epoch(self, epoch: int, split: str,
                   fast_debug: bool) -> Optional[float]:
        is_train = split == "training"
        losses_acc: dict = {}
        mpjpe_sum = mpjpe_count = 0.0
        n = 0
        draws = {} if is_train else pass_draws(self.model, self.cfg,
                                               self.device)
        group_k = (self.cfg.steps_per_dispatch
                   if is_train and self.multi_step is not None else 1)
        group: list = []
        preprocess = self._unfused_preprocess(split, epoch)
        for idx, batch in enumerate(self._waited(
                self._epoch_batches(split, epoch))):
            if fast_debug and idx > 2:
                break
            if self._preempt_now():
                # a buffered group is dropped: the checkpoint pins the
                # interrupted epoch, which resume restarts
                self.text(f"preemption requested: stopping {split} at "
                          f"epoch {epoch} iter {idx}")
                group = []
                break
            if group_k > 1:
                group.append((idx, batch))
                if len(group) == group_k:
                    n += self._run_group(group, epoch, losses_acc)
                    group = []
            elif is_train:
                self._train_one(batch, epoch, idx, losses_acc, preprocess)
                n += 1
            else:
                self.stats.step.tic()
                if preprocess is not None:
                    batch = preprocess(batch)
                metrics = self.eval_step(batch, **draws)
                mpjpe_sum += float(metrics["mpjpe_sum"])
                mpjpe_count += float(metrics["mpjpe_count"])
                self.stats.step.toc()
                for k, v in metrics.items():
                    if k not in ("mpjpe_sum", "mpjpe_count"):
                        losses_acc[k] = losses_acc.get(k, 0.0) + float(v)
                n += 1
        # an epoch's tail that did not fill a group: one step at a time
        for idx, batch in group:
            self._train_one(batch, epoch, idx, losses_acc)
            n += 1
        if not is_train and self.distributed:
            # every rank's sums, in float64, so that each returns the same
            # MPJPE over the whole split
            keys = sorted(losses_acc)
            total = dist_.all_reduce_float64(
                [mpjpe_sum, mpjpe_count, n] + [losses_acc[k] for k in keys],
                self.device)
            mpjpe_sum, mpjpe_count, n = total[:3]
            losses_acc = dict(zip(keys, total[3:]))
        means = {k: v / max(n, 1) for k, v in losses_acc.items()}
        # a validation that saw no visible joint has no metric: 0.0 would
        # read as a perfect MPJPE and poison the best checkpoint
        epoch_mpjpe = None
        if not is_train and mpjpe_count:
            epoch_mpjpe = mpjpe_sum / mpjpe_count
        tag = "Training" if is_train else "Validation"
        info = f"{tag} Epoch: {epoch:03d} ({self.stats.summary()}), " + \
            ", ".join(f"{k}: {v:.5f}" for k, v in means.items())
        if epoch_mpjpe is not None:
            info += f", MPJPE: {epoch_mpjpe:.5f}"
            self.logger.scalar(f"{tag} epoch MPJPE", epoch_mpjpe, epoch)
        else:
            self.logger.scalar(f"{tag} epoch loss", means.get("loss", 0.0),
                               epoch)
        self.text(info)
        return epoch_mpjpe

    def run(self, fast_debug: bool = False,
            max_epoch: Optional[int] = None) -> float:
        """Train and validate each epoch from ``start_epoch``, writing a
        checkpoint at each epoch's end; returns the best validation
        MPJPE."""
        end = max_epoch if max_epoch is not None else self.cfg.max_epoch
        run_dir = os.path.abspath(self.run_dir)
        for epoch in range(self.start_epoch, end):
            if epoch == self.cfg.profile_epoch and self.is_lead:
                from ..utils.device_info import profile_trace
                with profile_trace(os.path.join(run_dir, "profile")):
                    self.run_epoch(epoch, "training", fast_debug)
            else:
                self.run_epoch(epoch, "training", fast_debug)
            if self._preempt_now():
                # the epoch ran in part: resume restarts it
                self._save_preemption_checkpoint(epoch)
                return self.best_mpjpe
            val = self.run_epoch(epoch, "validation", fast_debug)
            if self._preempt_now():
                # training finished but validation was cut: the partial
                # MPJPE is biased, so best and model_best stay; resume
                # continues at the next epoch
                self._save_preemption_checkpoint(epoch + 1)
                return self.best_mpjpe
            is_best = val is not None and val < self.best_mpjpe
            if is_best:
                self.best_mpjpe = val
            if self.is_lead:
                save_checkpoint(run_dir, self.state, epoch + 1,
                                self.best_mpjpe, is_best)
        self.logger.close()
        return self.best_mpjpe

    def _save_preemption_checkpoint(self, start_epoch: int) -> None:
        if self.is_lead:
            save_checkpoint(os.path.abspath(self.run_dir), self.state,
                            start_epoch, self.best_mpjpe, is_best=False)
        self.text(f"preemption checkpoint written (resumes at epoch "
                  f"{start_epoch}); resume with --resume "
                  f"{self.run_dir}/checkpoint")
        self.logger.close()
