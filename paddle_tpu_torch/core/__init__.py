from . import framework, unique_name  # noqa: F401
