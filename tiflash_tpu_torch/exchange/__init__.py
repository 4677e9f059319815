"""Counterpart of ``tiflash_tpu/exchange``: row concatenation so far."""
