"""``paddle.nn``'s surface as far as it is ported (counterpart of
``paddle_tpu/nn/__init__.py``): the common, convolution, loss, norm and
Transformer layers, ``initializer`` and ``functional``.  ``Layer``, the
containers and ``rnn`` are not ported (ROADMAP 'Port: remaining
modules'); the port's layers are ``torch.nn.Module``s."""
from . import functional, initializer  # noqa: F401
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
