"""Parameters, latent moments and the prediction paths."""
