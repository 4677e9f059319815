"""Counterpart of ``tiflash_tpu/core``."""
