"""The port's WGAN-GP trainer."""
