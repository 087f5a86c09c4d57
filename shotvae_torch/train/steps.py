"""The SHOT-VAE and M2 train steps, the VAE eval step, the classifier's
train and eval steps and the smooth-ELBO train and eval steps.

Port of shotvae_tpu/train/steps.py:30-44, 108-124, 185-462, 470-528,
536-596 and 597-689. The SHOT-VAE step keeps the reference's four forwards (labeled,
label-smoothed labeled, unlabeled, mixed unlabeled) with one backward over
``loss_supervised + loss_unsupervised`` (the gradient of the sum equals the
reference's two accumulated ``.backward()`` calls) and one SGD update.
Stop-gradients are ``.detach()``. The BatchNorm running statistics update
in all four forwards, the decoder's included, as the JAX step threads
``batch_stats`` through them. With ``fused_streams`` it runs the JAX
step's two forwards of both streams at once instead.

Randomness: ``generator`` is a host (CPU) ``torch.Generator``. Every random
site seeds from it (the card is not synchronised for that): the crops and
flips and the latent draws on the model's device, the mixup weights on the
host, the mixup permutations on the device. The sites take their draws
through a ``sampling.StepDraws`` (the step's own, or a chunk runner's in
place of ``generator``): persistent device generators seeded in turn, and
the mixup weights as 0-d float32 slots; so do the draws over the global
batch of several ranks, from ``shared_generator`` (a ``StepDraws`` of its
own), so that a mixup weight is the same float32 value whether the step
runs alone or in a chunk. ``sched`` enters as 0-d float32
tensors on the model's device (Python floats are converted), as the JAX
loop puts it on the device. So the SHOT-VAE, M2 and classifier steps read
no host value that changes from step to step, and a CUDA graph can
capture them (``train.chunk``). ``inject`` replays pre-drawn
randomness instead, under the JAX step's keys ``eps_1..eps_4``, ``unif_3``,
``unif_4``, ``lam_sm``, ``perm_sm``, ``lam_mx``, ``perm_mx``, plus
``aug_l`` / ``aug_u``, the ``(off_y, off_x, flip)`` of ``augment_batch``.

The M2 step (the Kingma M2 baseline) takes two forwards, the labeled one
with its labels' one-hots in place of the discrete draw, and no mixup; its
draws replay under ``eps_1``, ``eps_2``, ``unif_2``, ``aug_l`` and
``aug_u``. The classifier step takes one forward of the labeled images and
the softmax cross entropy; its crops and flips replay under ``aug``.

The smooth-ELBO step (the one-stage MNIST and SVHN trainers) takes one
forward of each stream on images normalised to [-1, 1], without
augmentation, one backward over the unlabeled plus the labeled loss and one
Adam update; its draws replay under the JAX step's own layout,
``{"u": {"eps", "unif": [...]}, "l": {"eps", "unif": [...]}}``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from shotvae_torch.data.pipeline import augment_batch, to_float
from shotvae_torch.ops import losses, mixup
from shotvae_torch.ops.sampling import (StepDraws, device_generator,
                                        label_onehot)
from shotvae_torch.parallel.mesh import (BN_STATS_POLICIES, DataParallel,
                                         global_mean, set_bn_group)
from shotvae_torch.train.state import TrainState
from shotvae_torch.utils.spans import span


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _prepare(images_u8, device, *, augment: bool, generator=None,
             offsets=None, normalize: bool = False) -> torch.Tensor:
    """uint8 NHWC -> float NCHW (channels_last) on ``device``, in [0, 1]
    or, with ``normalize``, [-1, 1]; ``augment``: the train-time pad 4,
    32x32 crop and flip of ``augment_batch``."""
    x = to_float(torch.as_tensor(images_u8).to(device), normalize=normalize)
    if augment:
        gen = None if offsets is not None else device_generator(generator,
                                                                 device)
        x = augment_batch(x, generator=gen, offsets=offsets)
    return x.permute(0, 3, 1, 2)


def _step_draws(own: dict, generator, device):
    """The draws of one step: a ``StepDraws`` as given (a chunk runner's);
    a host generator through the step's own slots (``own``, by device),
    drawn as the sites ask; None as None (torch's default generators)."""
    if generator is None or isinstance(generator, StepDraws):
        return generator
    if device not in own:
        own[device] = StepDraws(device)
    return own[device].draw(generator)


def _sched(sched: dict, device) -> dict:
    """The loss weights as 0-d float32 tensors on ``device``."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in sched.items()}


def _noise(inject, device, eps_key: str, unif_key: Optional[str] = None):
    """The ``noise`` dict of one forward from the injected draws."""
    if not inject:
        return None
    out = {name: torch.as_tensor(inject[key]).to(device)
           for name, key in (("eps", eps_key), ("unif", unif_key))
           if key in inject}
    return out or None


# the Gumbel uniforms of the labeled rows of a fused forward: the labels'
# one-hots replace their draw (``discrete_latent``'s ``where``), so any
# value in (0, 1) gives the same step
_LABELED_UNIF = 0.5


def _fused_noise(inject, device, eps_keys, unif_key: str, batch_l: int):
    """The ``noise`` dict of one fused forward from the four-forward
    step's keys: the two streams' Gaussian draws ``eps_keys`` stacked, and
    the unlabeled stream's uniforms under ``_LABELED_UNIF`` rows for the
    labeled stream."""
    if not inject:
        return None
    out = {}
    if all(k in inject for k in eps_keys):
        out["eps"] = torch.cat([torch.as_tensor(inject[k]).to(device)
                                for k in eps_keys])
    if unif_key in inject:
        u = torch.as_tensor(inject[unif_key]).to(device)
        out["unif"] = torch.cat([u.new_full((batch_l, *u.shape[1:]),
                                            _LABELED_UNIF), u])
    return out or None


class _Ranks(NamedTuple):
    """How a train step spans the ranks of ``dp`` (None: one process)."""

    dp: Optional[DataParallel]
    sync: bool                # sync-BN: global statistics and hinges
    bn_stats: Optional[str]   # the per-replica running-statistics policy
    global_mixup: bool        # mixup draws over the global batch


def _ranks(model, dp: Optional[DataParallel], bn_per_replica: bool,
           bn_stats: str, global_mixup: bool) -> _Ranks:
    """Check a step's data-parallel arguments (those of the JAX steps:
    ``axis_name`` is ``bn_per_replica`` here) and give ``model``'s BN sites
    the group they pool over."""
    if bn_stats not in BN_STATS_POLICIES:
        raise ValueError(f"unknown bn_stats policy {bn_stats!r}")
    if global_mixup and not bn_per_replica:
        raise ValueError("global_mixup requires the per-replica-BN mode "
                         "(bn_per_replica); the sync-BN batch is already "
                         "global")
    if dp is None or dp.group is None:
        return _Ranks(None, False, None, False)
    sync = not bn_per_replica
    set_bn_group(model, dp.group if sync else None)
    return _Ranks(dp, sync, None if sync else bn_stats,
                  sync or global_mixup)


# per-row draws of the SHOT-VAE and M2 steps, sliced to each rank's rows
_ROW_KEYS = ("eps_1", "eps_2", "eps_3", "eps_4", "unif_2", "unif_3",
             "unif_4", "aug_l", "aug_u", "aug")


def _local_inject(inject, ranks: _Ranks) -> dict:
    """A rank's view of the global ``inject``: each per-row draw's rows of
    this rank; the mixup weights and partners as given where the mixup
    spans the global batch; under a mixup within each rank's rows, each
    rank's own partners in its rows of ``perm_*`` and its own weight in
    ``lam_*`` (one value, or one per rank)."""
    inj = dict(inject or {})
    dp = ranks.dp
    if dp is None or not inj:
        return inj
    for k in _ROW_KEYS:
        if k in inj:
            v = inj[k]
            inj[k] = (tuple(dp.shard(a) for a in v)
                      if isinstance(v, (tuple, list)) else dp.shard(v))
    if not ranks.global_mixup:
        for k in ("perm_sm", "perm_mx"):
            if k in inj:
                inj[k] = dp.shard(inj[k])
        for k in ("lam_sm", "lam_mx"):
            if k in inj and np.ndim(inj[k]) == 1:
                inj[k] = inj[k][dp.rank]
    return inj


def _mixup(ranks: _Ranks, fn, arrays, generator, shared_generator, **kw):
    """``fn`` (a mixup draw) on this rank's ``arrays``: over the global
    batch of the ranks with the generator they share where the mixup is
    global, else over the rank's rows with its own generator."""
    if not ranks.global_mixup:
        return fn(*arrays, generator=generator, **kw)
    if shared_generator is None and (kw.get("lam") is None
                                     or kw.get("index") is None):
        raise ValueError("a mixup over the global batch of several ranks "
                         "draws from shared_generator, a generator every "
                         "rank seeds alike; none was given")
    return mixup.gather_mixup(ranks.dp, fn, arrays,
                              generator=shared_generator, **kw)


def _elbo(x, recon, mean, log_sigma, log_alpha, sched, *, num_classes: int,
          bce: bool, x_sigma: float, dp: Optional[DataParallel] = None):
    """recon + beta_c |KL_c - cmi| + beta_d |KL_d - dmi|, and its three
    terms. With ``dp`` (sync-BN over its ranks) the KL batch means in the
    hinges are the global batch's, as the JAX package's GSPMD step takes
    them."""
    r, ckl, dkl = losses.elbo_terms(x, recon, mean, log_sigma, log_alpha,
                                    num_classes=num_classes, bce=bce,
                                    x_sigma=x_sigma)
    ckl, dkl = global_mean(ckl, dp), global_mean(dkl, dp)
    return (r + sched["kl_beta_c"] * losses.mi_hinge(ckl, sched["cmi"])
            + sched["kl_beta_d"] * losses.mi_hinge(dkl, sched["dmi"])), \
        (r, ckl, dkl)


def _update(state: TrainState, loss, ranks: Optional[_Ranks] = None) -> None:
    """One backward of ``loss`` and one SGD update of ``state``; over
    several ranks, the gradients averaged over them between the two, and
    in the per-replica mode the running statistics resolved by its
    policy (the JAX step's ``_cross_replica``)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if ranks is not None and ranks.dp is not None:
        ranks.dp.mean_gradients(state.model.parameters())
        if ranks.bn_stats is not None:
            ranks.dp.sync_running_stats(state.model, ranks.bn_stats)
    state.apply_gradients()


def _check_state(state: TrainState, model, optimizer) -> None:
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("state holds another model or optimizer than the "
                         "step was made for")


def _vae_train_step(model, optimizer, loss_fn, aug: bool, ranks: _Ranks):
    """The two-stream step around ``loss_fn(x_l, lab_l, x_u, lab_u, sched,
    generator, inject, shared_generator) -> (total, metrics)``."""

    own, own_shared = {}, {}

    def step(state: TrainState, img_l, lab_l, img_u, lab_u, sched,
             generator: Optional[torch.Generator] = None, inject=None,
             shared_generator: Optional[torch.Generator] = None):
        _check_state(state, model, optimizer)
        inj = _local_inject(inject, ranks)
        dev = _device(model)
        generator = _step_draws(own, generator, dev)
        shared_generator = _step_draws(own_shared, shared_generator, dev)
        sched = _sched(sched, dev)
        model.train()
        x_l = _prepare(img_l, dev, augment=aug, generator=generator,
                       offsets=inj.get("aug_l"))
        x_u = _prepare(img_u, dev, augment=aug, generator=generator,
                       offsets=inj.get("aug_u"))
        lab_l = torch.as_tensor(lab_l).to(dev).long()
        lab_u = torch.as_tensor(lab_u).to(dev).long()
        total, metrics = loss_fn(x_l, lab_l, x_u, lab_u, sched, generator,
                                 inj, shared_generator)
        _update(state, total, ranks)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return ranks.dp.mean_metrics(metrics) if ranks.dp else metrics

    return step


def _cont_posterior(mean, log_sigma, target: mixup.MixupBatch, batch: int):
    return (((mean - target.z_mean) ** 2).sum()
            + ((torch.exp(log_sigma) - target.z_sigma) ** 2).sum()) / batch


def _shot_loss(sched, num_classes: int, lab_l, elbo_l, elbo_u, sm, mx,
               post_sm, post_mx, terms_l, terms_u, inference_kl):
    """The SHOT-VAE loss and metrics from each stream's ELBO and its
    (recon, KL_c, KL_d) ``terms_*``, the two interpolation targets
    ``sm`` / ``mx`` and the posteriors (mean, log-sigma, log-alpha) of
    their forwards ``post_sm`` / ``post_mx``."""
    (mean_sm, ls_sm, la_sm), (mean_mx, ls_mx, la_mx) = post_sm, post_mx
    disc_post_l = (sm.lam * losses.cls_nll(la_sm,
                                           label_onehot(lab_l, num_classes))
                   + (1.0 - sm.lam) * losses.cls_nll(
                       la_sm, label_onehot(sm.partner_labels, num_classes)))
    elbo_l = elbo_l + sched["kl_beta_c"] * sched["pwm"] * \
        _cont_posterior(mean_sm, ls_sm, sm, mean_sm.shape[0])
    loss_supervised = sched["ew"] * elbo_l + disc_post_l
    disc_post_u = losses.cls_nll(la_mx, mx.disc_alpha)
    elbo_u = elbo_u + sched["kl_beta_c"] * sched["pwm"] * \
        _cont_posterior(mean_mx, ls_mx, mx, mean_mx.shape[0])
    loss_unsupervised = sched["ew"] * elbo_u + sched["ucw"] * disc_post_u
    total = loss_supervised + loss_unsupervised
    (r_l, ckl_l, dkl_l), (r_u, ckl_u, dkl_u) = terms_l, terms_u
    return total, {
        "loss": total,
        "loss_supervised": loss_supervised,
        "loss_unsupervised": loss_unsupervised,
        "recon_l": r_l, "cont_kl_l": ckl_l, "disc_kl_l": dkl_l,
        "recon_u": r_u, "cont_kl_u": ckl_u, "disc_kl_u": dkl_u,
        "kl_inference": inference_kl,
    }


def make_shot_vae_train_step(model, optimizer, *, num_classes: int, bce: bool,
                             x_sigma: float, epsilon: float,
                             optimal_match: bool, aug: bool = True,
                             fused_streams: bool = False,
                             dp: Optional[DataParallel] = None,
                             bn_per_replica: bool = False,
                             bn_stats: str = "replica0",
                             global_mixup: bool = False):
    """The SHOT-VAE step: ``step(state, img_l, lab_l, img_u, lab_u, sched,
    generator, inject=None, shared_generator=None) -> metrics``.

    ``state`` is the ``TrainState`` of this ``model`` and ``optimizer``;
    the step puts the model in train mode, updates its parameters and BN
    running statistics in place and advances ``state.step``. Images are
    uint8 NHWC batches, labels integer class indices (``lab_u`` feeds only
    the ``kl_inference`` metric). ``sched`` is the dict of
    ``ops.schedules.shot_vae_epoch_schedules``. Returns the JAX step's
    metrics as 0-d tensors on the model's device. ``aug=False`` turns the
    crops and flips off.

    ``dp``: the ranks of a data-parallel run (``parallel.DataParallel``),
    each calling the step on its rows of the global batch (the JAX step
    under ``DataParallel.jit_step``). By default sync-BN: the model's BN
    sites pool over the global batch, the hinges take the global KL means,
    and both interpolations draw over the global batch from
    ``shared_generator``, which every rank seeds alike (the optimal match
    included). ``bn_per_replica`` (the JAX step's ``axis_name``, under
    ``shard_map_step``): each rank's own statistics and mixup, the running
    statistics by ``bn_stats`` (``"replica0"`` or ``"mean"``), and with
    ``global_mixup`` the interpolations over the global batch. Either way
    the gradients and metrics are the mean over the ranks. ``generator``
    is the rank's own (crops, flips, latent draws) and ``inject`` holds
    the global batch's draws (``_local_inject``).

    ``fused_streams`` (the JAX step's keyword, steps.py:176-183) runs the
    two streams through two forwards of 2B rows in place of four of B:
    forward A on ``[x_l | x_u]`` with the labels ``[lab_l | -1...]`` (the
    -1 rows keep the Gumbel draw), forward B on the two interpolations
    ``[smoothed_l | mixed_u]`` with the smoothing's one-hot mixup on the
    labeled rows. The ELBO terms, the posterior terms and ``kl_inference``
    are taken on each stream's slice of the outputs, and the
    interpolations draw as in the four-forward step. The loss is the same
    function of the outputs, but train-mode BatchNorm pools its
    statistics over the 2B rows of each forward, and the running
    statistics update twice a step, not four times. Both data-parallel
    modes take it; ``global_mixup`` does not (NotImplementedError, as
    JAX). ``inject`` takes the four-forward step's keys: forward A's
    ``eps`` is ``[eps_1 ; eps_3]`` and its uniforms ``[. ; unif_3]``,
    forward B's ``[eps_2 ; eps_4]`` and ``[. ; unif_4]``, where ``.`` is
    ``_LABELED_UNIF`` for the labeled rows, whose draw the one-hots
    replace (JAX's fused step takes no ``inject``).
    """
    ranks = _ranks(model, dp, bn_per_replica, bn_stats, global_mixup)
    if global_mixup and fused_streams:
        raise NotImplementedError(
            "global_mixup is only supported on the 4-forward path")
    elbo = functools.partial(_elbo, num_classes=num_classes, bce=bce,
                             x_sigma=x_sigma,
                             dp=ranks.dp if ranks.sync else None)

    def fused_loss_fn(x_l, lab_l, x_u, lab_u, sched, generator, inj,
                      shared):
        dev = x_l.device
        batch_l, batch_u = x_l.shape[0], x_u.shape[0]
        no_label_u = torch.full((batch_u,), -1, dtype=lab_l.dtype,
                                device=dev)
        l_rows, u_rows = slice(0, batch_l), slice(batch_l, None)

        # forward A: [labeled (one-hot) | unlabeled (Gumbel-softmax)]
        recon_a, mean_a, ls_a, la_a = model(
            torch.cat([x_l, x_u]), labels=torch.cat([lab_l, no_label_u]),
            noise=_fused_noise(inj, dev, ("eps_1", "eps_3"), "unif_3",
                               batch_l),
            generator=generator)
        mean_l, ls_l, la_l = mean_a[l_rows], ls_a[l_rows], la_a[l_rows]
        mean_u, ls_u, la_u = mean_a[u_rows], ls_a[u_rows], la_a[u_rows]
        elbo_l, terms_l = elbo(x_l, recon_a[l_rows], mean_l, ls_l, la_l,
                               sched)
        elbo_u, terms_u = elbo(x_u, recon_a[u_rows], mean_u, ls_u, la_u,
                               sched)
        inference_kl = losses.inference_kl_metric(la_u.detach(), lab_u,
                                                  num_classes)

        # the stop-gradient interpolation targets, per stream
        sm = _mixup(ranks, mixup.label_smoothing,
                    (x_l, mean_l.detach(), ls_l.detach(), la_l.detach(),
                     lab_l), generator, shared, epsilon=epsilon,
                    lam=inj.get("lam_sm"), index=inj.get("perm_sm"))
        mx = _mixup(ranks, mixup.mixup_vae_data,
                    (x_u, mean_u.detach(), ls_u.detach(), la_u.detach()),
                    generator, shared, optimal_match=optimal_match,
                    lam=inj.get("lam_mx"), index=inj.get("perm_mx"))

        # forward B: [smoothed labeled (one-hot mixup) | mixed unlabeled];
        # its reconstruction enters no loss
        _, mean_b, ls_b, la_b = model(
            torch.cat([sm.image, mx.image]),
            labels=torch.cat([lab_l, no_label_u]), mixup=True,
            labels_mixup=torch.cat([sm.partner_labels, no_label_u]),
            mixup_lam=sm.lam,
            noise=_fused_noise(inj, dev, ("eps_2", "eps_4"), "unif_4",
                               batch_l),
            generator=generator)
        return _shot_loss(sched, num_classes, lab_l, elbo_l, elbo_u, sm, mx,
                          (mean_b[l_rows], ls_b[l_rows], la_b[l_rows]),
                          (mean_b[u_rows], ls_b[u_rows], la_b[u_rows]),
                          terms_l, terms_u, inference_kl)

    def loss_fn(x_l, lab_l, x_u, lab_u, sched, generator, inj, shared):
        dev = x_l.device

        # labeled forward 1: the ground-truth label path
        recon_l, mean_l, ls_l, la_l = model(
            x_l, labels=lab_l, noise=_noise(inj, dev, "eps_1"),
            generator=generator)
        elbo_l, terms_l = elbo(x_l, recon_l, mean_l, ls_l, la_l, sched)

        # labeled forward 2: the label-smoothing interpolation
        sm = _mixup(ranks, mixup.label_smoothing,
                    (x_l, mean_l.detach(), ls_l.detach(), la_l.detach(),
                     lab_l), generator, shared, epsilon=epsilon,
                    lam=inj.get("lam_sm"), index=inj.get("perm_sm"))
        _, *post_sm = model(
            sm.image, labels=lab_l, mixup=True,
            labels_mixup=sm.partner_labels, mixup_lam=sm.lam,
            noise=_noise(inj, dev, "eps_2"), generator=generator)

        # unlabeled forward 3: the Gumbel-softmax path
        recon_u, mean_u, ls_u, la_u = model(
            x_u, noise=_noise(inj, dev, "eps_3", "unif_3"),
            generator=generator)
        elbo_u, terms_u = elbo(x_u, recon_u, mean_u, ls_u, la_u, sched)
        inference_kl = losses.inference_kl_metric(la_u.detach(), lab_u,
                                                  num_classes)

        # unlabeled forward 4: the posterior mixup
        mx = _mixup(ranks, mixup.mixup_vae_data,
                    (x_u, mean_u.detach(), ls_u.detach(), la_u.detach()),
                    generator, shared, optimal_match=optimal_match,
                    lam=inj.get("lam_mx"), index=inj.get("perm_mx"))
        _, *post_mx = model(
            mx.image, noise=_noise(inj, dev, "eps_4", "unif_4"),
            generator=generator)
        return _shot_loss(sched, num_classes, lab_l, elbo_l, elbo_u, sm, mx,
                          post_sm, post_mx, terms_l, terms_u, inference_kl)

    return _vae_train_step(model, optimizer,
                           fused_loss_fn if fused_streams else loss_fn, aug,
                           ranks)


def make_m2_train_step(model, optimizer, *, num_classes: int, bce: bool,
                       x_sigma: float, aug: bool = True,
                       dp: Optional[DataParallel] = None,
                       bn_per_replica: bool = False,
                       bn_stats: str = "replica0"):
    """The M2 step, with ``make_shot_vae_train_step``'s signature and
    metrics: ``elbo = recon + beta_c |KL_c - cmi| + beta_d |KL_d - dmi|`` on
    each stream, ``loss_supervised = ew * elbo_l + NLL(q(y|x_l), y_l)`` and
    ``loss_unsupervised = ew * elbo_u``; ``sched`` needs ``ew``,
    ``kl_beta_c``, ``kl_beta_d``, ``cmi`` and ``dmi``. ``dp``,
    ``bn_per_replica`` and ``bn_stats`` as the SHOT-VAE step's (M2 has no
    mixup)."""
    ranks = _ranks(model, dp, bn_per_replica, bn_stats, False)
    elbo = functools.partial(_elbo, num_classes=num_classes, bce=bce,
                             x_sigma=x_sigma,
                             dp=ranks.dp if ranks.sync else None)

    def loss_fn(x_l, lab_l, x_u, lab_u, sched, generator, inj, shared):
        dev = x_l.device
        # labeled: the one-hots of the labels replace the discrete draw
        recon_l, mean_l, ls_l, la_l = model(
            x_l, labels=lab_l, noise=_noise(inj, dev, "eps_1"),
            generator=generator)
        elbo_l, (r_l, ckl_l, dkl_l) = elbo(x_l, recon_l, mean_l, ls_l, la_l,
                                           sched)
        loss_supervised = sched["ew"] * elbo_l + losses.cls_nll(
            la_l, label_onehot(lab_l, num_classes))

        # unlabeled: the Gumbel-softmax draw
        recon_u, mean_u, ls_u, la_u = model(
            x_u, noise=_noise(inj, dev, "eps_2", "unif_2"),
            generator=generator)
        elbo_u, (r_u, ckl_u, dkl_u) = elbo(x_u, recon_u, mean_u, ls_u, la_u,
                                           sched)
        loss_unsupervised = sched["ew"] * elbo_u
        inference_kl = losses.inference_kl_metric(la_u.detach(), lab_u,
                                                  num_classes)

        total = loss_supervised + loss_unsupervised
        metrics = {
            "loss": total,
            "loss_supervised": loss_supervised,
            "loss_unsupervised": loss_unsupervised,
            "recon_l": r_l, "cont_kl_l": ckl_l, "disc_kl_l": dkl_l,
            "recon_u": r_u, "cont_kl_u": ckl_u, "disc_kl_u": dkl_u,
            "kl_inference": inference_kl,
        }
        return total, metrics

    return _vae_train_step(model, optimizer, loss_fn, aug, ranks)


def make_vae_eval_step(model, *, num_classes: int, bce: bool, x_sigma: float):
    """The eval pass: ``step(img, lab, weight, generator=None, inject=None)
    -> (metrics, sigmoid reconstruction NHWC)``.

    BN uses the running statistics, but z and y are still sampled (the
    reference's ``Sample`` has no eval switch), by the ``fused_sample``
    kernel unless ``inject`` ({"eps", "unif"}) replays the draws.
    ``weight`` is a per-sample 0/1 mask, so a ragged tail batch padded to
    the full batch biases no metric; the metrics are weighted SUMS plus
    the effective ``count``, as shotvae_tpu/train/steps.py:470-528. A
    profiler sees each call as an ``eval.step`` span.
    """

    @torch.inference_mode()
    def step(img, lab, weight, generator: Optional[torch.Generator] = None,
             inject=None):
        with span("eval.step", rows=len(img)):
            return _step(img, lab, weight, generator, inject)

    def _step(img, lab, weight, generator, inject):
        dev = _device(model)
        model.eval()
        x = _prepare(img, dev, augment=False)
        recon, mean, ls, la = model(x, noise=_noise(inject, dev, "eps",
                                                    "unif"),
                                    generator=generator)
        w = torch.as_tensor(weight).to(dev).to(torch.float32)
        lab = torch.as_tensor(lab).to(dev).long()
        if bce:
            recon_per = losses.bce_per_sample(recon, x)
        else:
            recon_per = ((torch.sigmoid(recon) - x) ** 2).flatten(1).sum(1) \
                / (2 * x_sigma**2)
        lss = 2.0 * ls
        ckl_per = 0.5 * (mean**2 + torch.exp(lss) - lss - 1.0).sum(1)
        dkl_per = (torch.exp(la) * (la - math.log(1.0 / num_classes))).sum(1)
        recon_sig = torch.sigmoid(recon)
        mse_per = ((recon_sig - x) ** 2).flatten(1).sum(1) / (2 * x_sigma**2)
        elbo_per = mse_per + 0.01 * (ckl_per + dkl_per)  # the reference's
        probs = torch.exp(la)                            # ad-hoc "ELBO"
        top1_per = torch.argmax(probs, 1) == lab
        topk = torch.topk(probs, min(5, num_classes), dim=1).indices
        top5_per = (topk == lab[:, None]).any(1)
        metrics = {
            "recon_sum": (recon_per * w).sum(),
            "cont_kl_sum": (ckl_per * w).sum(),
            "disc_kl_sum": (dkl_per * w).sum(),
            "mse_sum": (mse_per * w).sum(),
            "elbo_sum": (elbo_per * w).sum(),
            "top1_count": (top1_per * w).sum(),
            "top5_count": (top5_per * w).sum(),
            "count": w.sum(),
        }
        return metrics, recon_sig.permute(0, 2, 3, 1)

    return step


def softmax_ce(logits, labels):
    """``F.cross_entropy`` of the f32 logits: the batch mean of
    -log_softmax[label]."""
    return F.cross_entropy(logits.to(torch.float32), labels)


def make_classifier_train_step(model, optimizer, *, aug: bool = True,
                               dp: Optional[DataParallel] = None,
                               bn_per_replica: bool = False,
                               bn_stats: str = "replica0"):
    """The classifier step: ``step(state, img, lab, generator=None,
    inject=None) -> {"cls_loss"}``, one forward of the augmented labeled
    images, the cross entropy, one backward and one SGD update of
    ``state``; ``generator`` draws the crops and flips and the dropout
    masks, ``inject`` replays the crops and flips under ``aug``. ``dp``,
    ``bn_per_replica`` and ``bn_stats`` as the SHOT-VAE step's: each rank
    passes its rows, ``inject`` holds the global batch's."""
    ranks = _ranks(model, dp, bn_per_replica, bn_stats, False)
    own = {}

    def step(state: TrainState, img, lab,
             generator: Optional[torch.Generator] = None, inject=None):
        _check_state(state, model, optimizer)
        inj = _local_inject(inject, ranks)
        dev = _device(model)
        generator = _step_draws(own, generator, dev)
        model.train()
        x = _prepare(img, dev, augment=aug, generator=generator,
                     offsets=inj.get("aug"))
        loss = softmax_ce(model(x, generator=generator),
                          torch.as_tensor(lab).to(dev).long())
        _update(state, loss, ranks)
        metrics = {"cls_loss": loss.detach()}
        return ranks.dp.mean_metrics(metrics) if ranks.dp else metrics

    return step


def make_classifier_eval_step(model, *, num_classes: int):
    """The classifier's eval pass: ``step(img, lab, weight) -> {
    "cls_loss_sum", "top1_count", "top5_count", "count"}``, each summed
    over the batch with the per-sample 0/1 ``weight`` (top 5 is top
    min(5, K)); BN uses the running statistics."""

    @torch.inference_mode()
    def step(img, lab, weight):
        dev = _device(model)
        model.eval()
        logits = model(_prepare(img, dev, augment=False)).to(torch.float32)
        w = torch.as_tensor(weight).to(dev).to(torch.float32)
        lab = torch.as_tensor(lab).to(dev).long()
        nll_per = -F.log_softmax(logits, 1).gather(1, lab[:, None])[:, 0]
        probs = F.softmax(logits, 1)
        top1_per = torch.argmax(probs, 1) == lab
        topk = torch.topk(probs, min(5, num_classes), dim=1).indices
        top5_per = (topk == lab[:, None]).any(1)
        return {"cls_loss_sum": (nll_per * w).sum(),
                "top1_count": (top1_per * w).sum(),
                "top5_count": (top5_per * w).sum(),
                "count": w.sum()}

    return step


def _smooth_noise(inject, device):
    """One forward's injected draws: ``{"eps", "unif": [...]}`` as
    tensors on ``device``."""
    if not inject:
        return None
    out = {}
    if inject.get("eps") is not None:
        out["eps"] = torch.as_tensor(inject["eps"]).to(device)
    if inject.get("unif") is not None:
        out["unif"] = [torch.as_tensor(u).to(device) for u in inject["unif"]]
    return out


def make_smooth_elbo_train_step(model, optimizer, *, alpha: float,
                                cont_capacity, disc_capacity, disc_dims):
    """The smooth-ELBO step: ``step(state, img_u, img_l, lab_l,
    generator=None, inject=None) -> metrics``.

    Per stream: the per-sample squared error, gamma_c |C_c(t) - KL_c| and
    gamma_d |C_d(t) - KL_d| with the capacities annealed over the global
    step t = ``state.step + 1`` (``cont_capacity`` / ``disc_capacity``:
    (min, max, num_iters, gamma)), the discrete one capped at sum(log K_i);
    the labeled stream adds ``alpha * BCE(q(y|x), one-hot)``. One backward
    of the sum, one update of ``state``'s optimizer. Returns the JAX
    step's metrics as tensors on the model's device, 0-d but for
    ``kl_cont_per_dim`` (the unlabeled stream's per-dimension KL)."""
    theoretical_max = float(sum(math.log(d) for d in disc_dims))

    def one_loss(x, labels, step_t, generator, noise):
        recon, dist, _, _ = model(x, labels=labels, noise=noise,
                                  generator=generator)
        r = losses.smooth_recon_loss(x, recon)
        mean, logvar = dist["cont"]
        kl_cont, kl_cont_per_dim = losses.kl_normal_loss(mean, logvar)
        cont_cap = losses.capacity_loss(kl_cont, step_t, *cont_capacity)
        kl_disc = losses.kl_multiple_discrete_loss(dist["disc"])
        disc_cap = losses.capacity_loss(kl_disc, step_t, *disc_capacity,
                                        theoretical_max=theoretical_max)
        loss = r + cont_cap + disc_cap
        cls = torch.zeros((), device=x.device)
        if labels is not None:
            cls = alpha * losses.bce_probs_mean(
                dist["disc"][0], label_onehot(labels, disc_dims[0]))
            loss = loss + cls
        return loss, (r, cont_cap, disc_cap, cls, kl_cont, kl_cont_per_dim,
                      kl_disc)

    def step(state: TrainState, img_u, img_l, lab_l,
             generator: Optional[torch.Generator] = None, inject=None):
        _check_state(state, model, optimizer)
        inj = inject or {}
        dev = _device(model)
        model.train()
        x_u = _prepare(img_u, dev, augment=False, normalize=True)
        x_l = _prepare(img_l, dev, augment=False, normalize=True)
        lab_l = torch.as_tensor(lab_l).to(dev).long()
        step_t = state.step + 1
        loss_u, (r_u, cc_u, dc_u, _, klc_u, klc_dim_u, kld_u) = one_loss(
            x_u, None, step_t, generator, _smooth_noise(inj.get("u"), dev))
        loss_l, (r_l, cc_l, dc_l, cls, _, _, _) = one_loss(
            x_l, lab_l, step_t, generator, _smooth_noise(inj.get("l"), dev))
        total = loss_u + loss_l
        _update(state, total)
        metrics = {
            "loss": total,
            "u_recon": r_u, "u_cont_cap": cc_u, "u_disc_cap": dc_u,
            "l_recon": r_l, "l_cont_cap": cc_l, "l_disc_cap": dc_l,
            "classification": cls,
            "kl_cont": klc_u, "kl_disc": kld_u,
            "kl_cont_per_dim": klc_dim_u,
        }
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_smooth_elbo_eval_step(model):
    """The smooth-ELBO eval pass: ``step(img, lab, weight) ->
    {"correct_count", "count"}``, the argmax of q(y|x)'s first head against
    the labels, summed with the per-sample 0/1 ``weight``; eval mode draws
    nothing."""

    @torch.inference_mode()
    def step(img, lab, weight):
        dev = _device(model)
        model.eval()
        _, dist, _, _ = model(_prepare(img, dev, augment=False,
                                       normalize=True))
        w = torch.as_tensor(weight).to(dev).to(torch.float32)
        lab = torch.as_tensor(lab).to(dev).long()
        pred = torch.argmax(dist["disc"][0], dim=1)
        return {"correct_count": ((pred == lab) * w).sum(), "count": w.sum()}

    return step
