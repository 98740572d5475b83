"""Neural-network helpers of the port (counterpart of ``paddle_tpu/nn``)."""
