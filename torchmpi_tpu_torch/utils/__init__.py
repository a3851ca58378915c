"""Host-side utilities of the port: synthetic data (``data``) and the
background host-to-card input pipeline (``input_pipeline``)."""

from . import data, input_pipeline  # noqa: F401
