"""The SHOT-VAE train step in plain PyTorch, and what it needs worked out
again from the seeds: the semi-supervised split, the batches of epoch 0,
each step's random draws and the loss weights.

Equations: FengHZ/SHOT-VAE ``main_shot_vae.py`` ``train()`` (four
forwards: labeled, label-smoothed labeled, unlabeled, mixed unlabeled; one
backward of their sum; SGD with momentum 0.9 and coupled weight decay),
``lib/criterion.py`` (reconstruction by BCE with logits, the KL terms and
their mutual-information hinges) and ``lib/utils/mixup.py`` (the
interpolations; ``--om``: each unlabeled row's partner is the other row of
least Gaussian KL, its products at bfloat16 operands). Imports nothing of
the program under test.

The draws follow the documented stream layout: step i of epoch e seeds a
host generator from ``SeedSequence([seed + 1000, e, i])``; each random
site, in program order, takes one 31-bit draw of it, to seed a fresh device
generator (crops and flips, latent noise, permutations) or a numpy
generator that draws a Beta weight.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import Net, matmul_precision, onehot

# ------------------------------------------------------------ data streams


def ssl_split(labels: np.ndarray, valid_per_class: int, labeled_per_class: int,
              num_classes: int, seed: int):
    """Per class: shuffle, the first ``valid_per_class`` for validation,
    the next ``labeled_per_class`` labeled; unlabeled = all but the
    validation part."""
    rng = np.random.default_rng(seed)
    valid, labeled, unlabeled = [], [], []
    for c in range(num_classes):
        loc = rng.permutation(np.flatnonzero(labels == c))
        valid += loc[:valid_per_class].tolist()
        labeled += loc[valid_per_class:valid_per_class
                       + labeled_per_class].tolist()
        unlabeled += loc[valid_per_class:].tolist()
    return (np.asarray(valid, np.int64), np.asarray(labeled, np.int64),
            np.asarray(unlabeled, np.int64))


def epoch_batches(rng, indices, batch: int):
    order = rng.permutation(indices)
    return [order[s:s + batch]
            for s in range(0, len(order) // batch * batch, batch)]


def endless_batches(rng, indices, batch: int):
    """Full batches of a reshuffled pool, wrapping into a new shuffle."""
    pool, pos = rng.permutation(indices), 0
    while True:
        if pos + batch <= len(pool):
            yield pool[pos:pos + batch]
            pos += batch
        else:
            parts = [pool[pos:]]
            need = batch - len(parts[0])
            while need > 0:
                pool = rng.permutation(indices)
                take = min(need, len(pool))
                parts.append(pool[:take])
                need -= take
            pos = 0 if len(parts[-1]) == len(pool) else len(parts[-1])
            yield np.concatenate(parts)


def index_batches(seed: int, labeled, unlabeled, batch: int, steps: int):
    """The (labeled, unlabeled) index batches of epoch 0's first steps."""
    lab = endless_batches(np.random.default_rng([seed + 1, 0]), labeled,
                          batch)
    unl = epoch_batches(np.random.default_rng([seed + 2, 0]), unlabeled,
                        batch)
    return [(next(lab), unl[i]) for i in range(steps)]


def ramp(epoch: int, max_epoch, top: float) -> float:
    if max_epoch <= 0:
        return top
    return top * math.exp(-5.0 * (1.0 - min(1.0, epoch / max_epoch)) ** 2)


def loss_weights(epoch: int, cli: dict) -> dict:
    """The loss weights of ``epoch`` (main_shot_vae.py's ``alpha_schedule``
    calls)."""
    return {"cmi": ramp(epoch, cli["akb"], cli["cmi"]),
            "dmi": ramp(epoch, cli["akb"], cli["dmi"]),
            "ew": ramp(epoch, cli["aew"], cli["ewm"]),
            "kl_beta_c": ramp(epoch, cli["akb"], cli["kbmc"]),
            "kl_beta_d": ramp(epoch, cli["akb"], cli["kbmd"]),
            "pwm": ramp(epoch, cli["apw"], cli["pwm"]),
            "ucw": ramp(epoch, round(cli["wmf"] * cli["epochs"]),
                        cli["wrd"])}


def learning_rate(cli: dict, step: int, steps_per_epoch: int) -> float:
    """The base rate times 0.2 through epoch 0, then the milestones."""
    lr = cli["lr"] * 0.2
    if step >= steps_per_epoch:
        lr /= 0.2
    for m in cli["adjust_lr"]:
        if step >= (m + 1) * steps_per_epoch:
            lr *= 0.1
    return lr


# ------------------------------------------------------------ draws


class Draws:
    """One step's random sites, each seeded by one draw of the step's host
    generator, in the order the sites come."""

    def __init__(self, seed: int, epoch: int, step: int, device):
        state = np.random.SeedSequence([seed + 1000, epoch, step])
        self.host = torch.Generator().manual_seed(
            int(state.generate_state(1)[0]))
        self.device = device

    def _seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))

    def gen(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self._seed())

    def beta(self, a: float, b: float) -> torch.Tensor:
        value = float(np.random.default_rng(self._seed()).beta(a, b))
        return torch.tensor(value, dtype=torch.float32, device=self.device)


def augment(x, gen):
    """Reflect-pad 4, a random crop of the image's size, a flip at 1/2, of
    (B, H, W, C)."""
    b, h, w, _ = x.shape
    pad = 4
    padded = F.pad(x.permute(0, 3, 1, 2), (pad,) * 4,
                   mode="reflect").permute(0, 2, 3, 1)
    kw = dict(generator=gen, device=x.device)
    off_y = torch.randint(0, 2 * pad + 1, (b,), **kw)
    off_x = torch.randint(0, 2 * pad + 1, (b,), **kw)
    flip = torch.rand((b,), **kw) < 0.5
    steps = torch.arange(h, device=x.device)
    rows = off_y[:, None] + steps[None, :]
    cols = steps[None, :].expand(b, w)
    cols = off_x[:, None] + torch.where(flip[:, None], w - 1 - cols, cols)
    batch = torch.arange(b, device=x.device)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]


# ------------------------------------------------------------ losses


def bce_sum(logits, x):
    return (torch.clamp(logits, min=0.0) - logits * x
            + torch.log1p(torch.exp(-logits.abs()))).sum()


def elbo(x, recon, mean, log_sigma, log_alpha, w, k: int):
    b = x.shape[0]
    r = bce_sum(recon, x) / b
    ls2 = 2.0 * log_sigma
    ckl = 0.5 * (mean * mean + torch.exp(ls2) - ls2 - 1.0).sum() / b
    dkl = (torch.exp(log_alpha) * (log_alpha - math.log(1.0 / k))).sum() / b
    total = (r + w["kl_beta_c"] * torch.abs(ckl - w["cmi"])
             + w["kl_beta_d"] * torch.abs(dkl - w["dmi"]))
    return total, (r, ckl, dkl)


def nll(log_probs, target):
    return -(log_probs * target).sum(1).mean()


def pairwise_kl(mean, log_sigma):
    """KL[N_i || N_j] of every pair, its three products at bfloat16
    operands with float32 sums."""
    def mm(a, b):
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().T

    var, inv = torch.exp(2.0 * log_sigma), torch.exp(-2.0 * log_sigma)
    ls = log_sigma.sum(1)
    sq = mean * mean
    return (ls[None, :] - ls[:, None] + 0.5 * mm(var, inv)
            + 0.5 * (mm(sq, inv) - 2.0 * mm(mean, mean * inv)
                     + (sq * inv).sum(1)[None, :]) - 0.5 * mean.shape[1])


def mix(lam, t, index):
    return lam * t + (1.0 - lam) * t[index]


def shot_step(t: dict, model: dict, cli: dict, trunk: str, img_l, lab_l,
              img_u, draws: Draws, w: dict):
    """One forward and backward of the SHOT-VAE loss on uint8 batches; the
    gradients land in the ``.grad`` of ``t``'s parameters. Returns the
    loss."""
    k = model["num_classes"]
    with matmul_precision(trunk):
        x_l = augment(img_l.to(torch.float32) / 255.0, draws.gen())
        x_u = augment(img_u.to(torch.float32) / 255.0, draws.gen())
        x_l, x_u = x_l.permute(0, 3, 1, 2), x_u.permute(0, 3, 1, 2)
        net = Net(t, model, trunk, train=True)

        recon_l, mean_l, ls_l, la_l = net.forward(x_l, draws.gen(),
                                                  labels=lab_l)
        elbo_l, _ = elbo(x_l, recon_l, mean_l, ls_l, la_l, w, k)

        lam_sm = draws.beta(cli["epsilon"], cli["epsilon"])
        perm = torch.randperm(x_l.shape[0], generator=draws.gen(),
                              device=x_l.device)
        _, mean_sm, ls_sm, la_sm = net.forward(
            mix(lam_sm, x_l, perm), draws.gen(), labels=lab_l,
            partner_labels=lab_l[perm], lam=lam_sm)

        recon_u, mean_u, ls_u, la_u = net.forward(x_u, draws.gen())
        elbo_u, _ = elbo(x_u, recon_u, mean_u, ls_u, la_u, w, k)

        lam_mx = draws.beta(2.0, 2.0)
        with torch.no_grad():
            kl = pairwise_kl(mean_u, ls_u)
            kl = kl + torch.eye(kl.shape[0], device=kl.device) * 3.4e38
            partner = torch.argmin(kl, dim=1)
        _, mean_mx, ls_mx, la_mx = net.forward(
            mix(lam_mx, x_u, partner), draws.gen())

        def posterior(mean, ls, t_mean, t_sigma):
            return (((mean - t_mean) ** 2).sum()
                    + ((torch.exp(ls) - t_sigma) ** 2).sum()) / mean.shape[0]

        d = lambda v: v.detach()  # noqa: E731
        disc_l = (lam_sm * nll(la_sm, onehot(lab_l, k))
                  + (1.0 - lam_sm) * nll(la_sm, onehot(lab_l[perm], k)))
        elbo_l = elbo_l + w["kl_beta_c"] * w["pwm"] * posterior(
            mean_sm, ls_sm, mix(lam_sm, d(mean_l), perm),
            mix(lam_sm, torch.exp(d(ls_l)), perm))
        supervised = w["ew"] * elbo_l + disc_l
        disc_u = nll(la_mx, mix(lam_mx, torch.exp(d(la_u)), partner))
        elbo_u = elbo_u + w["kl_beta_c"] * w["pwm"] * posterior(
            mean_mx, ls_mx, mix(lam_mx, d(mean_u), partner),
            mix(lam_mx, torch.exp(d(ls_u)), partner))
        total = supervised + w["ew"] * elbo_u + w["ucw"] * disc_u
        total.backward()
    return float(total.detach())


def sgd(params: dict, momentum: dict, lr: float, wd: float,
        beta: float = 0.9) -> None:
    """p -= lr * buf, buf = beta * buf + (g + wd * p) (the first step:
    buf = g + wd * p)."""
    with torch.no_grad():
        for name, p in params.items():
            d_p = p.grad + wd * p
            if name in momentum:
                momentum[name].mul_(beta).add_(d_p)
            else:
                momentum[name] = d_p.clone()
            p.sub_(lr * momentum[name])
            p.grad = None


def first_steps(t: dict, model: dict, cli: dict, trunk: str, images, labels,
                seed: int, steps: int):
    """The first ``steps`` SHOT-VAE steps of epoch 0 from the tensors ``t``
    (changed in place): each step's loss, the first step's gradients
    (weight decay not added) and the SGD momentum after the last."""
    _, labeled, unlabeled = ssl_split(labels.cpu().numpy(),
                                      cli["valid_per_class"],
                                      cli["labeled_per_class"],
                                      model["num_classes"], seed)
    batch = cli["batch_size"]
    steps_per_epoch = len(unlabeled) // batch
    w = {k: torch.tensor(v, dtype=torch.float32, device=images.device)
         for k, v in loss_weights(0, cli).items()}
    params = {n: v for n, v in t.items() if v.requires_grad}
    momentum, losses, first_grad = {}, [], None
    for i, (il, iu) in enumerate(index_batches(seed, labeled, unlabeled,
                                               batch, steps)):
        il = torch.from_numpy(il).to(images.device)
        iu = torch.from_numpy(iu).to(images.device)
        losses.append(shot_step(t, model, cli, trunk, images[il], labels[il],
                                images[iu], Draws(seed, 0, i, images.device),
                                w))
        if i == 0:
            first_grad = {n: p.grad.detach().clone()
                          for n, p in params.items()}
        sgd(params, momentum, learning_rate(cli, i, steps_per_epoch),
            cli["wd"], cli["beta1"])
    return losses, first_grad, momentum

