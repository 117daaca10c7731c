"""Models of the port: UNet, VAE decoder, vocoder, T5, RoBERTa, CLAP text,
GPT-2, the sequence generator and the conditioners."""
