"""Models of the port: UNet, VAE decoder, vocoder, T5, conditioners."""
