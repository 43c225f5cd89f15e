"""Native (C++) runtime components (counterpart of
``paddle_tpu/core``).

The data-reader core (``csrc/dataio.cpp``, the reference's code) is
compiled on first use with the system's ``g++`` and loaded through
ctypes.  Its one consumer, ``io.TokenFileLoader``, keeps the
reference's python path for a host without a compiler.  The
rendezvous store (``tcp_store.cpp``) waits for ROADMAP 'Multi-device'.
"""
from .build import load_native

__all__ = ["load_native"]
