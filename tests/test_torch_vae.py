"""The port's causal VAE against the JAX package's on the CPU in fp32 (the
tiny VAE of tests/test_pipeline.py), unsliced and temporally sliced."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.models.vae import pipeline_vae as jv
from seedvr2_tpu_torch.core.configs import VAEConfig
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.vae import pipeline_vae as tv
from seedvr2_tpu_torch.models.vae.model import VideoAutoencoder

from .test_torch_dit import assert_bridge_matches_export, random_params

TINY = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
            latent_channels=4, norm_num_groups=4)
# fp32 convolutions summed in other orders by XLA and by PyTorch's CPU
# kernels: observed 1e-6 on latents of ~0.7 and 5e-6 on pixels of ~2.
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def vae_params():
    return random_params(lambda k: jv.init_vae_params(
        k, JVAEConfig(**TINY), dtype=jnp.float32), seed=1)


@pytest.fixture(scope="module")
def vae_pair(vae_params):
    model = VideoAutoencoder(VAEConfig(**TINY), dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(vae_params), strict=True)
    return (jv.VideoVAE(vae_params, JVAEConfig(**TINY), dtype=jnp.float32),
            tv.VideoVAE(model, torch.float32))


def test_weight_bridge_matches_export_vae(vae_params):
    assert_bridge_matches_export(
        vae_params, VideoAutoencoder(VAEConfig(**TINY), dtype=torch.float32))


# 5 frames: one slice (unsliced); 9 and 13 frames: first slice of 5 frames
# then 4-frame slices carrying the causal-conv tails (latents 2 + 1 + 1)
@pytest.mark.parametrize("frames", [1, 5, 9, 13])
def test_encode_decode_match_jax(vae_pair, frames):
    jvae, tvae = vae_pair
    x = np.random.default_rng(frames).uniform(
        -1, 1, (1, frames, 32, 24, 3)).astype(np.float32)
    z_ref = np.asarray(jvae.encode(jnp.asarray(x)))
    z = tvae.encode(torch.from_numpy(x))
    assert z.shape == (1, (frames - 1) // 4 + 1, 4, 3, 4)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    y_ref = np.asarray(jvae.decode(jnp.asarray(z_ref)))
    y = tvae.decode(torch.from_numpy(z_ref.copy()))
    assert y.shape == (1, frames, 32, 24, 3)
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)


def test_sliced_decode_carries_state(vae_pair):
    """Decoding 3 latent frames in slices differs from decoding each slice
    fresh: the carried causal tails are what make the slices one video."""
    _, tvae = vae_pair
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 3, 4, 3, 4)).astype(np.float32))
    whole = tvae.decode(z)           # frames 0-4 from latents 0-1, 5-8 from 2
    fresh = tvae.decode(z[:, 1:])    # latent 1 as a first slice, then 2
    assert whole.shape[1] == 9 and fresh.shape[1] == 5
    assert not torch.allclose(whole[:, 5:], fresh[:, 1:], atol=1e-3)
