"""Experimental features (counterpart of ``paddle_tpu/incubate``); the
port has the mixture-of-experts layer so far."""
from . import distributed  # noqa: F401
