"""Paired-end pipeline of the port (see soap3dp_tpu/pipeline)."""
