from .serde import load_model  # noqa: F401
from .workflow import WorkflowModel  # noqa: F401
