"""Training losses of the port: pixel, VGG19 content and GAN terms."""
