"""Operator layer of the port (counterpart of ``paddle_tpu/ops``)."""
