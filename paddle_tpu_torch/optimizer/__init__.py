from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401
