"""Multi-device and multi-host alignment (port of soap3dp_tpu/distributed)."""
