"""The SHOT-VAE's equations in plain PyTorch: the encoders (WideResNet,
PreActResNet-18), the three latent heads, the latent draw and the DCGAN
decoder, with the parameter names of the reference's state_dict
(FengHZ/SHOT-VAE ``shot_vae_model/vae.py``).

Nothing here imports the program under test. The tensors live in one flat
dict ``{name: tensor}``; every layer reads its weights by name.

Precision (``trunk``):
  * ``"bfloat16"``: the configuration's training precision. Every conv and
    transposed conv takes bfloat16 operands and gives a bfloat16 output
    (float32 sums inside the library); BatchNorm takes its batch statistics
    in float32 from the bfloat16 input and rounds its activated output to
    bfloat16; residual adds and the pooled features are bfloat16, cast to
    float32 for the heads.
  * ``"float32"``: the serving precision, TF32 off.
  * ``"fp8"``: the control of ``"bfloat16"``, fp8 training as the H100's
    fp8 tensor cores run it: each conv's two operands are rounded to float8
    e4m3 and the gradient of its output to float8 e5m2, each with one scale
    per tensor (its largest magnitude at the format's largest value), the
    products then in bfloat16.
  * ``"tf32"``: the control of ``"float32"``: TF32 on in cuDNN and cuBLAS.
The heads' products take bfloat16-rounded operands and add in float32,
forward and backward, in every mode: that is the configuration's stated
arithmetic for them.
"""

from __future__ import annotations

import contextlib
import re

import torch
import torch.nn.functional as F

LEAKY = 0.01
RELU = 0.0
IDENTITY = 1.0
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
GUMBEL_EPS = 1e-12
FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}

PREACT = {"preactresnet18": (2, 2, 2, 2)}


def compute_dtype(trunk: str) -> torch.dtype:
    return torch.float32 if trunk in ("float32", "tf32") else torch.bfloat16


@contextlib.contextmanager
def matmul_precision(trunk: str):
    """TF32 in cuDNN and cuBLAS on for ``"tf32"``, off otherwise; the
    caller's switches restored on leaving."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = trunk == "tf32"
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved


# ------------------------------------------------------------ parameters


def _bn(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "bn_weight"),
            (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "bn_mean"),
            (f"{name}.running_var", (c,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "bn_count")]


def _conv(name: str, cin: int, cout: int, k: int, bias: bool = False):
    out = [(f"{name}.weight", (cout, cin, k, k), "conv")]
    return out + ([(f"{name}.bias", (cout,), "bias")] if bias else [])


def encoder_units(net_name: str):
    """The trunk's units in order: (prefix, cin, cout, stride); its stem
    width and feature width."""
    if net_name.startswith("wideresnet"):
        depth, width = (int(v) for v in re.findall(r"\d+", net_name))
        n = (depth - 4) // 6
        units, cin = [], 16
        for g, feats in enumerate((16 * width, 32 * width, 64 * width), 1):
            for i in range(1, n + 1):
                stride = 2 if (g > 1 and i == 1) else 1
                units.append((f"feature_extractor.encoder.wideblock{g}."
                              f"wide_block.wideunit{i}", cin, feats, stride))
                cin = feats
        return units, 16, 64 * width
    blocks = PREACT[net_name]
    units, cin, feats = [], 64, 64
    for g, depth in enumerate(blocks, 1):
        for i in range(1, depth + 1):
            stride = 2 if (g > 1 and i == 1) else 1
            units.append((f"feature_extractor.encoder.block{g}.preact_block."
                          f"unit{i}", cin, feats, stride))
            cin = feats
        feats *= 2
    return units, 64, cin


def decoder_widths(model: dict) -> list:
    nf = model["decoder_num_feature"]
    return [nf * 16, nf * 8, nf * 4, nf * 2, nf]


def param_spec(model: dict) -> list:
    """(name, shape, kind) of every parameter and buffer of the VAE of
    ``model`` (the configuration's ``model`` section), as the reference's
    state_dict names them."""
    units, stem, feat = encoder_units(model["net_name"])
    spec = _conv("feature_extractor.encoder.pre_process.conv0",
                 model["input_channels"], stem, 3, bias=True)
    for prefix, cin, cout, stride in units:
        spec += _bn(f"{prefix}.f_block.norm1", cin)
        spec += _conv(f"{prefix}.f_block.conv1", cin, cout, 3)
        spec += _bn(f"{prefix}.f_block.norm2", cout)
        spec += _conv(f"{prefix}.f_block.conv2", cout, cout, 3)
        if cin != cout or stride != 1:
            spec += _bn(f"{prefix}.i_block.norm", cin)
            spec += _conv(f"{prefix}.i_block.conv", cin, cout, 1)
    spec += _bn("feature_extractor.encoder.transition.norm", feat)
    dc, k = model["ldc"], model["num_classes"]
    for name, out in (("continuous_inference.mean.fc", dc),
                      ("continuous_inference.log_sigma.fc", dc),
                      ("disc_latent_inference.fc", k)):
        spec += [(f"{name}.weight", (out, feat), "linear"),
                 (f"{name}.bias", (out,), "bias")]
    widths = decoder_widths(model)
    cin = dc + k
    for i, cout in enumerate(widths):
        size = 1 if i == 0 else 4
        spec.append((f"feature_reconstructor.decoder.{3 * i}.weight",
                     (cin, cout, size, size), "convT"))
        spec += _bn(f"feature_reconstructor.decoder.{3 * i + 1}", cout)
        cin = cout
    spec.append(("feature_reconstructor.decoder.15.weight",
                 (cin, model["input_channels"], 4, 4), "convT"))
    return spec


# ------------------------------------------------------------ layers


def fp8_round(t, fmt=torch.float8_e4m3fn):
    """``t`` rounded to the fp8 format ``fmt`` at one scale per tensor."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8[fmt]
    return ((t.float() / scale).to(fmt).float() * scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    """Forward: round to e4m3; backward: the gradient passes through."""

    @staticmethod
    def forward(ctx, t):
        return fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: the identity; backward: round the gradient to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class _RoundedLinear(torch.autograd.Function):
    """x @ w.T + b with bfloat16-rounded operands and float32 sums, forward
    and backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        x, w = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
        ctx.save_for_backward(x, w)
        return x @ w.T + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gr = g.to(torch.bfloat16).float()
        return gr @ w, gr.T @ x, g.sum(0)


class Net:
    """One forward pass over the tensors ``t`` (a name -> tensor dict) in
    train or eval mode at precision ``trunk``. Train mode takes batch
    statistics and moves the running ones in place."""

    def __init__(self, t: dict, model: dict, trunk: str, train: bool):
        self.t, self.model, self.trunk, self.train = t, model, trunk, train
        self.dtype = compute_dtype(trunk)

    def _operand(self, x):
        return _Fp8.apply(x) if self.trunk == "fp8" else x

    def conv(self, name, x, stride=1, padding=1, transpose=False):
        w = self._operand(self.t[f"{name}.weight"].to(self.dtype))
        b = self.t.get(f"{name}.bias")
        b = None if b is None else b.to(self.dtype)
        x = self._operand(x.to(self.dtype))
        if transpose:
            y = F.conv_transpose2d(x, w, b, stride, padding)
        else:
            y = F.conv2d(x, w, b, stride, padding)
        return _Fp8Grad.apply(y) if self.trunk == "fp8" else y

    def bn(self, name, x, slope):
        """act(BatchNorm(x)), in the compute dtype."""
        gamma, beta = self.t[f"{name}.weight"], self.t[f"{name}.bias"]
        rm, rv = self.t[f"{name}.running_mean"], self.t[f"{name}.running_var"]
        x32 = x.to(torch.float32)
        if self.train:
            mean = x32.mean((0, 2, 3))
            var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                rm.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
                rv.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        else:
            mean, var = rm, rv
        xhat = (x32 - mean[:, None, None]) * torch.rsqrt(
            var + BN_EPS)[:, None, None]
        y = xhat * gamma[:, None, None] + beta[:, None, None]
        return torch.where(y >= 0, y, slope * y).to(self.dtype)

    def unit(self, prefix, x, cin, cout, stride, slope, shortcut_slope):
        h = self.conv(f"{prefix}.f_block.conv1",
                      self.bn(f"{prefix}.f_block.norm1", x, slope), stride)
        h = self.conv(f"{prefix}.f_block.conv2",
                      self.bn(f"{prefix}.f_block.norm2", h, slope))
        if cin != cout or stride != 1:
            x = self.conv(f"{prefix}.i_block.conv",
                          self.bn(f"{prefix}.i_block.norm", x,
                                  shortcut_slope), stride, padding=0)
        return h + x

    def encode(self, x):
        """(B, C, H, W) float32 images -> (mean, log_sigma, log_alpha)."""
        wrn = self.model["net_name"].startswith("wideresnet")
        slope = LEAKY if wrn else RELU
        units, _, _ = encoder_units(self.model["net_name"])
        h = self.conv("feature_extractor.encoder.pre_process.conv0", x)
        for prefix, cin, cout, stride in units:
            h = self.unit(prefix, h, cin, cout, stride, slope,
                          slope if wrn else IDENTITY)
        h = self.bn("feature_extractor.encoder.transition.norm", h, slope)
        avg = h.mean(dim=(2, 3)).to(torch.float32)

        def head(name):
            return _RoundedLinear.apply(avg, self.t[f"{name}.weight"],
                                        self.t[f"{name}.bias"])

        return (head("continuous_inference.mean.fc"),
                head("continuous_inference.log_sigma.fc"),
                F.log_softmax(head("disc_latent_inference.fc"), dim=1))

    def decode(self, latent):
        x = latent.to(self.dtype)[:, :, None, None]
        for i in range(5):
            x = self.conv(f"feature_reconstructor.decoder.{3 * i}", x,
                          stride=1 if i == 0 else 2,
                          padding=0 if i == 0 else 1, transpose=True)
            x = self.bn(f"feature_reconstructor.decoder.{3 * i + 1}", x,
                        RELU)
        return self.conv("feature_reconstructor.decoder.15", x, stride=2,
                         transpose=True).to(torch.float32)

    def forward(self, x, gen, *, labels=None, partner_labels=None, lam=None):
        """-> (reconstruction logits, mean, log_sigma, log_alpha); the
        latent from ``gen`` (a device generator): Gaussian noise, then
        Gumbel uniforms, drawn whether or not labels replace them."""
        mean, log_sigma, log_alpha = self.encode(x)
        eps = torch.randn(mean.shape, generator=gen, device=mean.device)
        z = mean + torch.exp(log_sigma) * eps
        unif = torch.rand(log_alpha.shape, generator=gen,
                          device=log_alpha.device)
        gumbel = -torch.log(-torch.log(unif + GUMBEL_EPS) + GUMBEL_EPS)
        y = torch.softmax((log_alpha + gumbel) / self.model["temperature"],
                          dim=1)
        if labels is not None:
            y = onehot(labels, log_alpha.shape[1])
            if partner_labels is not None:
                y = lam * y + (1.0 - lam) * onehot(partner_labels,
                                                    log_alpha.shape[1])
        recon = self.decode(torch.cat([z, y], dim=1))
        return recon, mean, log_sigma, log_alpha


def onehot(labels, k: int):
    return (labels[:, None] == torch.arange(k, device=labels.device)[None]
            ).to(torch.float32)


def to_images(u8):
    """uint8 NHWC -> float32 NCHW in [0, 1]."""
    return (u8.to(torch.float32) / 255.0).permute(0, 3, 1, 2)


def classify(t: dict, model: dict, images_u8, trunk: str = "float32"):
    """Eval-mode class probabilities of uint8 NHWC images."""
    with torch.no_grad(), matmul_precision(trunk):
        net = Net(t, model, trunk, train=False)
        return torch.exp(net.encode(to_images(images_u8))[2])


def forward_flops(model: dict, batch: int) -> dict:
    """Multiply-adds x 2 of one forward at ``batch``: {"encoder", "heads",
    "decoder", "stem"} (the stem's share of the encoder apart, since a
    train step takes no gradient of the images)."""
    units, stem, feat = encoder_units(model["net_name"])
    hw = model["image_size"]
    cin0 = model["input_channels"]
    stem_f = 2 * batch * hw * hw * 9 * cin0 * stem
    enc = stem_f
    for _, cin, cout, stride in units:
        out_hw = hw // stride
        enc += 2 * batch * out_hw * out_hw * 9 * cin * cout  # conv1
        enc += 2 * batch * out_hw * out_hw * 9 * cout * cout  # conv2
        if cin != cout or stride != 1:
            enc += 2 * batch * out_hw * out_hw * cin * cout
        hw = out_hw
    dc, k = model["ldc"], model["num_classes"]
    heads = 2 * batch * feat * (2 * dc + k)
    dec, cin, side = 0, dc + k, 1
    for i, cout in enumerate(decoder_widths(model)):
        taps = 1 if i == 0 else 16
        dec += 2 * batch * side * side * taps * cin * cout
        side = side if i == 0 else side * 2
        cin = cout
    dec += 2 * batch * side * side * 16 * cin * model["input_channels"]
    return {"encoder": enc, "stem": stem_f, "heads": heads, "decoder": dec}


