"""Seeding discipline of the port's pipeline.

Every stochastic draw comes from a torch.Generator on the request's device,
made from the request's seed, so the same seed gives the same output on one
device. The draws are not JAX's (another generator), by design; the JAX
package's utils/seed.py keys play the same roles:

 - diffusion noise: `noise_generator(seed)`, made anew for every batch, so
   every batch sees the same base noise (JAX: PRNGKey(seed) per batch);
 - latent-noise augmentation: the second draw of that same generator, after
   the base noise (JAX: k2 of split(PRNGKey(seed)), after k1);
 - input noise: `input_noise_generator(seed, bi)`, one stream per batch
   index from seed + VAE_SEED_OFFSET (JAX: fold_in(PRNGKey(seed +
   VAE_SEED_OFFSET), bi)).
"""

import torch

VAE_SEED_OFFSET = 1_000_000


def noise_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def input_noise_generator(seed: int, batch_index: int,
                          device) -> torch.Generator:
    """seed + VAE_SEED_OFFSET folded with the batch index: the index takes
    the low 16 bits, so no two (seed, batch index) pairs share a stream
    while seeds stay below 2^47."""
    if not 0 <= batch_index < 1 << 16:
        raise ValueError(f"batch index {batch_index} outside [0, 65536)")
    return torch.Generator(device).manual_seed(
        ((seed + VAE_SEED_OFFSET) << 16 | batch_index) % (1 << 64))
