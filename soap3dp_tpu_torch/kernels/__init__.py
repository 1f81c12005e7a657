"""Hand-written device kernels (with their plain-torch versions)."""
