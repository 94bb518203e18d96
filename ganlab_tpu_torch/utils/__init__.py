"""Small host-side utilities: latent sampling, image grids, metric logging."""
