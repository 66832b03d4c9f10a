"""Framework pieces of the port (counterpart of ``paddle_tpu/framework``)."""
