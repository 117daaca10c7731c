"""Training and multi-device serving of the port: the diffusion train step,
AdamW, the CLAP contrastive loss (``train``), the parameter EMA (``ema``),
and the dp x tp mesh over ``torch.distributed`` (``mesh``, its collectives
``collectives``, ``ShardedGenerator`` in ``serve``, one process per rank
started by ``launch``)."""
