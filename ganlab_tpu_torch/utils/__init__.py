"""Host-side utilities: latent sampling, image grids, metric logging, and
the latent projector."""
