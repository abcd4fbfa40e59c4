"""Training step: losses, latent-edit sampling, optimizer, train/eval
steps."""
