"""The ``serve_closed`` traffic: one caller in a closed loop sends
``ShotVaeInference.classify`` calls of ``batch`` uint8 images, each drawn by
the seed from the test images held on the host and copied to the card by
the call, and waits for the (batch, K) probabilities on the host before it
sends the next.

Set-up makes the test images on the card, keeps them on the host, builds
the serving model in float32 with the benchmark's weights, and makes
``warmup_calls`` calls at the served shape. The window times every call
until ``seconds`` have passed; a traced run traces ``traced_calls`` calls
in its place. A sample of the window's calls, drawn from the seed, is
kept and judged after the window against the plain reference.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench.lib import check, inputs
from portbench.lib.trace import span, traced
from portbench.lib.train_epochs import phase
from portbench.reference.model import classify, param_spec


def _calls(seed: int, n_images: int, batch: int):
    """Each call's image indices: a seeded stream of draws without
    replacement within a call."""
    rng = np.random.default_rng(inputs.sub_seed(seed, "calls"))
    while True:
        yield rng.choice(n_images, batch, replace=False)


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
    classify_fn = api.classify
    if "altered" in cell.faults():  # an answer altered where it is produced
        def classify_fn(images_u8):
            probs = api.classify(images_u8).clone()
            probs[0] = probs[0].roll(1)
            return probs

    phase("model", t_start)
    stream = _calls(cell.seed, len(host), batch)
    for _ in range(traffic["warmup_calls"]):
        classify_fn(host[next(stream)]).cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    phase("warmup", t_start)
    rng = np.random.default_rng(inputs.sub_seed(cell.seed, "sample"))
    sample = set(rng.choice(traffic["sample_from"], traffic["sample_calls"],
                            replace=False).tolist())
    kept, latencies, failed = [], [], [0]

    def call(c: int) -> None:
        with span("call"):
            with span("prepare"):
                idx = next(stream)
                batch_u8 = host[idx]
            t0 = time.perf_counter()
            with span("classify"):
                probs = classify_fn(batch_u8)
            with span("readback"):
                out = probs.cpu()
            latencies.append(time.perf_counter() - t0)
        failed[0] += not bool(torch.isfinite(out).all())
        if c in sample:
            kept.append((idx, out))

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
    run["program"] = {"probs": torch.cat([p for _, p in run["kept"]])}
    if not cell.trace:
        lat = sorted(run["latencies"])
        run["metrics"] = {
            "serve_ms_p95": 1e3 * lat[min(n - 1, math.ceil(0.95 * n) - 1)],
            "serve_img_per_s": n * run["batch"] / run["window_s"]}
    run["attempted"] = n
    run["counts"] = {"calls": n}
    return run


def numbers(run: dict) -> dict:
    return check.serve_numbers(run["program"]["probs"],
                               run["reference"]["probs"])


def control(cell, dev, run: dict) -> dict:
    """The plain reference one precision below the configuration's, put in
    the program's place (control.py)."""
    trunk = check.LOWER[cell.config["precision"]["serve_trunk"]]
    return reference(cell, dev, run["kept"], run["host_images"], trunk)


def reference(cell, dev, kept, host, trunk: str = None) -> dict:
    """The plain reference's probabilities of the kept calls' images, at
    ``trunk`` (default: the configuration's serving precision)."""
    model_cfg = cell.config["model"]
    trunk = trunk or cell.config["precision"]["serve_trunk"]
    t = inputs.weights(cell.seed, param_spec(model_cfg), dev)
    probs = [classify(t, model_cfg, torch.from_numpy(host[idx]).to(dev),
                      trunk).cpu() for idx, _ in kept]
    return {"probs": torch.cat(probs)}
