from .auto_cast import decorate  # noqa: F401
