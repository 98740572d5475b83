"""Utilities of the port (counterpart of ``paddle_tpu/utils``)."""
