"""Counterpart of ``tiflash_tpu/bench``."""
