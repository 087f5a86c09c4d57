"""The sampler's Philox-4x32-10 and its plain version, on the CPU.

``shotvae_torch/csrc/fused_sample.cu`` draws its uniforms from the counters
that ``sample_counters`` states; ``philox_uniforms`` draws the same ones in
plain PyTorch, and the wrapper's CPU path runs the kernel's arithmetic on
them. Here the generator is held to Random123's published known answers,
the counter layout to a scalar loop, and the sampler on those uniforms to
the JAX package's ``sampling.joint_latent`` fed the same noise. The kernel
itself is held to the same plain version on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shotvae_tpu.ops import sampling as jax_sampling
from shotvae_torch.ops.kernels import fused_sample as fs
from shotvae_torch.ops.sampling import draw_seed

T = 0.67

# Random123's known-answer vectors for philox4x32_10 (kat_vectors):
# counter, key, output
_KAT = [
    ((0x00000000,) * 4, (0x00000000,) * 2,
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", _KAT)
def test_philox_known_answers(counter, key, want):
    """On Python ints and on int64 tensors (the path the draws take)."""
    assert fs.philox4x32(*counter, *key) == want
    words = fs.philox4x32(*(torch.tensor([c, c]) for c in counter), *key)
    assert [w.tolist() for w in words] == [[x, x] for x in want]


def test_uniforms_lie_on_the_24_bit_grid():
    u1, u2, u = fs.philox_uniforms(12345, 64, 33, 17)
    assert (u1.shape, u2.shape, u.shape) == ((64, 33), (64, 33), (64, 17))
    for x in (u1, u2, u):
        assert x.dtype == torch.float32
        scaled = x.double() * 2 ** 24
        assert torch.equal(scaled, scaled.round())
        assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0 - 2.0 ** -24
    ends = fs.uniform_from_word(torch.tensor([0, 0xFF, 0x100, 0xFFFFFFFF]))
    assert ends.tolist() == [0.0, 0.0, 2.0 ** -24, 1.0 - 2.0 ** -24]


@pytest.mark.parametrize("shape", [(768, 128, 10), (5, 127, 3), (1, 1, 1),
                                   (3, 5, 257)])
def test_gaussian_and_gumbel_counters_are_disjoint(shape):
    """No counter feeds two Philox calls of one draw."""
    gauss, gumbel = fs.sample_counters(*shape)
    b, dc, dd = shape
    as_set = lambda c: set(map(tuple, torch.stack(c, -1)  # noqa: E731
                               .reshape(-1, 4).tolist()))
    g, s = as_set(gauss), as_set(gumbel)
    assert len(g) == b * -(-dc // 2) and len(s) == b * -(-dd // 4)
    assert not g & s


def test_uniforms_follow_the_stated_counter_layout():
    """Element by element from scalar Philox calls: column c of row r takes
    words 0, 1 (c even) or 2, 3 (c odd) of pair (c // 2, 0, r, 0) as u1,
    u2; Gumbel column c word c % 4 of group (c // 4, 1, r, 0)."""
    seed, b, dc, dd = 987, 3, 5, 9
    u1, u2, u = fs.philox_uniforms(seed, b, dc, dd)
    unit = lambda w: (w >> 8) * 2.0 ** -24  # noqa: E731
    for r in range(b):
        for c in range(dc):
            w = fs.philox4x32(c // 2, 0, r, 0, seed, 0)
            assert float(u1[r, c]) == unit(w[2 * (c % 2)])
            assert float(u2[r, c]) == unit(w[2 * (c % 2) + 1])
        for c in range(dd):
            w = fs.philox4x32(c // 4, 1, r, 0, seed, 0)
            assert float(u[r, c]) == unit(w[c % 4])


def test_one_seed_one_draw():
    """The wrapper on the CPU is the plain version on the uniforms of its
    generator's seed: one seed gives one draw, two seeds two."""
    rng = np.random.default_rng(11)
    mean, log_sigma = (torch.from_numpy(rng.normal(size=(6, 8))
                                        .astype(np.float32)) for _ in range(2))
    log_alpha = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(6, 10)).astype(np.float32)), 1)
    draw = lambda s: fs.fused_joint_sample(  # noqa: E731
        mean, log_sigma, log_alpha, T,
        generator=torch.Generator().manual_seed(s))
    want = fs.joint_sample_from_uniforms(
        mean, log_sigma, log_alpha,
        *fs.philox_uniforms(draw_seed(torch.Generator().manual_seed(3)),
                            6, 8, 10), T)
    assert torch.equal(draw(3), want) and torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))
    assert all(not torch.equal(a, b) for a, b in zip(
        fs.philox_uniforms(1, 6, 8, 10), fs.philox_uniforms(2, 6, 8, 10)))


@pytest.mark.parametrize("dd", [10, 100])
def test_plain_sampler_on_philox_uniforms_matches_joint_latent(dd):
    """The kernel's plain version, fed its Philox uniforms, equals the JAX
    ``joint_latent`` given the same Gaussian and uniform draws (CIFAR-10's
    and CIFAR-100's Dd)."""
    rng = np.random.default_rng(dd)
    b, dc, seed = 8, 12, 2024
    mean = rng.normal(size=(b, dc)).astype(np.float32)
    log_sigma = (rng.normal(size=(b, dc)) * 0.3).astype(np.float32)
    logits = rng.normal(size=(b, dd)).astype(np.float32)
    log_alpha = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    t = [torch.from_numpy(a) for a in (mean, log_sigma, log_alpha)]
    u1, u2, u = fs.philox_uniforms(seed, b, dc, dd)
    got = fs.fused_joint_sample_plain(*t, T, seed=seed)
    want = jax_sampling.joint_latent(
        jax.random.key(0), jnp.asarray(mean), jnp.asarray(log_sigma),
        jnp.asarray(log_alpha), T,
        noise={"eps": jnp.asarray(fs.box_muller(u1, u2).numpy()),
               "unif": jnp.asarray(u.numpy())})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
