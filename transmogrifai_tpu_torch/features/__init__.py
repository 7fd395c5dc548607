from .feature import Feature  # noqa: F401
