from .dataset import Column, Dataset  # noqa: F401
