"""Diffusion of the port: the DDIM sampler and the latent-diffusion orchestration."""
