"""Training of the port: the diffusion train step, AdamW, the CLAP
contrastive loss (``train``) and the parameter EMA (``ema``)."""
