"""The ``serve_reconstruct`` traffic: one caller in a closed loop sends
``ShotVaeInference.reconstruct`` calls of ``batch`` uint8 images, each
drawn by the seed from the test images held on the host and copied to the
card by the call, and waits for the (batch, H, W, C) sigmoid
reconstructions on the host before it sends the next. Call ``c`` passes a
host generator seeded from the seed and ``c``, from which the program's
sampler takes the key of its latent draw. The caller reads each call's
9.4 MB of float32 back into one pinned host buffer that it keeps, as
serving front ends stage large outputs: NVIDIA Triton Inference Server
copies them through a pinned pool (``--pinned-memory-pool-byte-size``),
and PyTorch's CUDA notes advise pinned buffers for copies between host
and card (https://pytorch.org/docs/stable/notes/cuda.html, "Use pinned
memory buffers"). A caller that reads into fresh pageable memory
(``.cpu()``, as the ``serve_closed`` caller reads its 30 KB of
probabilities) waits besides on the driver's staging and the host's page
faults: 10 to 20 ms more a call beside 26.5 ms of device time on an H100
80GB HBM3's host, unsteady from run to run; the end-to-end metrics leave
that out. Whether a call's output is finite is read on the card before
the copy.

Set-up makes the test images on the card, keeps them on the host, builds
the serving model in float32 with the benchmark's weights, and makes
``warmup_calls`` calls at the served shape. The window times every call
until ``seconds`` have passed; a traced run traces ``traced_calls`` calls
in its place. A sample of the window's calls, drawn from the seed, is
kept and judged after the window against the plain reference: its eval
forward in float32 (TF32 off), its latent drawn by ``eval_pass.sample``
under the same key, then the sigmoid.

``correct`` compares ``recon_mean``, the mean absolute gap of the sampled
calls' reconstructions over every pixel and channel: the mean, as
``probs_mean`` is, because where the heads' bfloat16-rounded operands
straddle a rounding boundary one row's latent moves in both a sound run
and a TF32 one, while the TF32 trunk moves every row.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench.lib import check, inputs
from portbench.lib.serve_closed import _calls
from portbench.lib.trace import span, traced
from portbench.lib.train_epochs import phase
from portbench.reference.eval_pass import sample
from portbench.reference.model import (Net, matmul_precision, param_spec,
                                       to_images)

CALL_TAG = 6  # beside lib/inputs.py's TAGS: each call's generator


def call_seed(seed: int, c: int) -> int:
    """The 64-bit seed of call ``c``'s host generator."""
    return int(np.random.SeedSequence([seed, CALL_TAG, c]).generate_state(
        1, np.uint64)[0])


def call_key(seed: int, c: int) -> int:
    """The key the sampler takes from call ``c``'s generator: its first
    31-bit draw."""
    gen = torch.Generator().manual_seed(call_seed(seed, c))
    return int(torch.randint(0, 2**31 - 1, (1,), generator=gen))


def _program(cell, dev, t_start: float) -> dict:
    from shotvae_torch.api import ShotVaeInference
    from shotvae_torch.models.vae import VariationalAutoEncoder

    phase("imports", t_start)
    model_cfg = cell.config["model"]
    data_cfg = dict(cell.config["data"], **cell.sizes.get("data", {}))
    traffic = dict(cell.traffic, **cell.sizes.get("traffic", {}))
    batch = traffic["batch"]
    images, _ = inputs.dataset(cell.seed, data_cfg, model_cfg, dev)["test"]
    host = images.cpu().numpy()
    del images
    with torch.random.fork_rng(devices=[]):
        model = VariationalAutoEncoder(
            model_cfg["net_name"],
            num_input_channels=model_cfg["input_channels"],
            img_size=(model_cfg["image_size"],) * 2,
            continuous_latent_dim=model_cfg["ldc"],
            disc_latent_dim=model_cfg["num_classes"],
            sample_temperature=model_cfg["temperature"], device=dev)
    model.load_state_dict(inputs.weights(cell.seed, param_spec(model_cfg),
                                         dev), strict=True)
    api = ShotVaeInference(model, device=dev)
    reconstruct = api.reconstruct
    if "altered" in cell.faults():  # an answer altered where it is produced
        def reconstruct(images_u8, generator):
            recon = api.reconstruct(images_u8, generator=generator).clone()
            recon[0] = recon[0].flip(0)
            return recon

    phase("model", t_start)
    stream = _calls(cell.seed, len(host), batch)

    def generator(c: int):
        return torch.Generator().manual_seed(call_seed(cell.seed, c))

    pinned = []  # the caller's output buffer, made at the first call

    def read_back(recon):
        """(the host buffer holding ``recon``, whether all of it is
        finite)."""
        finite = torch.isfinite(recon).all()
        if not pinned:
            pinned.append(torch.empty(recon.shape, dtype=recon.dtype,
                                      pin_memory=dev.type == "cuda"))
        return pinned[0].copy_(recon), bool(finite)

    warmup = traffic["warmup_calls"]
    for c in range(warmup):
        read_back(reconstruct(host[next(stream)], generator(c)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    phase("warmup", t_start)
    rng = np.random.default_rng(inputs.sub_seed(cell.seed, "sample"))
    sample_calls = set(rng.choice(traffic["sample_from"],
                                  traffic["sample_calls"],
                                  replace=False).tolist())
    kept, latencies, failed = [], [], [0]

    def call(c: int) -> None:
        with span("call"):
            with span("prepare"):
                idx = next(stream)
                batch_u8 = host[idx]
                gen = generator(warmup + c)
            t0 = time.perf_counter()
            with span("reconstruct"):
                recon = reconstruct(batch_u8, gen)
            with span("readback"):
                out, finite = read_back(recon)
            latencies.append(time.perf_counter() - t0)
        failed[0] += not finite
        if c in sample_calls:
            kept.append((idx, warmup + c, out.clone()))

    out = {"setup_s": time.time() - t_start}
    c = 0
    if cell.trace:
        with traced() as holder:
            for c in range(traffic["traced_calls"]):
                call(c)
        out["trace"] = holder.trace
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < cell.seconds:
            call(c)
            c += 1
        out["window_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_reserved(dev)
    out.update(latencies=latencies, kept=kept, batch=batch, failed=failed[0],
               host=host)
    return out


def drive(cell, dev, t_start: float) -> dict:
    run = _program(cell, dev, t_start)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run["host_images"] = run.pop("host")
    run["reference"] = reference(cell, dev, run["kept"], run["host_images"])
    n = len(run["latencies"])
    run["program"] = {"recon": torch.cat([r for _, _, r in run["kept"]])}
    if not cell.trace:
        lat = sorted(run["latencies"])
        run["metrics"] = {
            "serve_ms_p95": 1e3 * lat[min(n - 1, math.ceil(0.95 * n) - 1)],
            "serve_img_per_s": n * run["batch"] / run["window_s"]}
    run["attempted"] = n
    run["counts"] = {"calls": n}
    return run


def numbers(run: dict) -> dict:
    gap = run["program"]["recon"].double() - run["reference"]["recon"].double()
    return {"recon_mean": float(gap.abs().mean())}


def control(cell, dev, run: dict) -> dict:
    """The plain reference one precision below the configuration's (TF32
    for float32), put in the program's place (control.py)."""
    trunk = check.LOWER[cell.config["precision"]["serve_trunk"]]
    return reference(cell, dev, run["kept"], run["host_images"], trunk)


def reference(cell, dev, kept, host, trunk: str = None) -> dict:
    """The plain reference's reconstructions (B, H, W, C) of the kept
    calls' images, each call's latent drawn under its generator's key, at
    ``trunk`` (default: the configuration's serving precision)."""
    model_cfg = cell.config["model"]
    trunk = trunk or cell.config["precision"]["serve_trunk"]
    t = inputs.weights(cell.seed, param_spec(model_cfg), dev)
    out = []
    with torch.no_grad(), matmul_precision(trunk):
        net = Net(t, model_cfg, trunk, train=False)
        for idx, c, _ in kept:
            x = to_images(torch.from_numpy(host[idx]).to(dev))
            mean, log_sigma, log_alpha = net.encode(x)
            latent = sample(mean, log_sigma, log_alpha,
                            model_cfg["temperature"],
                            call_key(cell.seed, c))
            out.append(torch.sigmoid(net.decode(latent)).permute(
                0, 2, 3, 1).cpu())
    return {"recon": torch.cat(out)}
