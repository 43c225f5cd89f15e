from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, ASGD,
                        Lamb, LBFGS, Momentum, NAdam, Optimizer, RAdam,
                        RMSProp, Rprop)
