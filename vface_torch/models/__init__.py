"""The UNet, the VAE and the model bundle."""
