"""Counterpart of ``tiflash_tpu/storage``."""
